// Fused FiLM residual block, backward, for Hopper (sm_90a).
//
// Replaces pcfm/ops/pallas/film_block.py:_bwd_kernel (the TPU kernel). With
// the forward's saved per-row mean and rstd it recomputes, per row n of
// cloud b (W: torch Linear, out x in; dy, h, dh: (B, N, C)):
//
//   xhat = (h - mean) * rstd,  u = xhat * s + t,  f = u * (1 + gamma) + beta
//   p    = silu(f),            dp = dy @ W
//   df   = dy + sig(f) * (1 + f * (1 - sig(f))) * dp
//   du   = df * (1 + gamma),   dxhat = du * s
//   dh   = rstd * (dxhat - mean_c(dxhat) - xhat * mean_c(dxhat * xhat))
//
// and the parameter gradients, summed over rows: dW = dy^T @ p (out x in),
// db = sum dy, ds = sum du * xhat, dt = sum du over all B * N rows;
// dgamma = sum df * u, dbeta = sum df over each cloud's N rows. Both
// products multiply bf16 values and add in fp32 (the TPU kernel's DEFAULT
// precision).
//
// Design:
//   * a pack kernel turns the fp32 W into bf16 Wᵀ tiles once per call, in
//     the byte order of the rows pass's wgmma B operand: tiles of 128 input
//     columns x 64 output rows, K-major, 128-byte swizzled
//     (wgmma_common.cuh), in the product's order, so that a tile is one
//     16 KB bulk copy (packed_t_index / pack_wt_reference in
//     ops/film_block.py are the formula and the plain version);
//   * rows pass: a block owns ROWS = 64 rows of ONE cloud and two
//     warpgroups; warpgroup g computes dp's 128-column chunks g and g + 2
//     and keeps them in registers (128 fp32 a thread at C = 512), so that
//     the whole row's dp stays on chip until its means are known (no
//     spill: ptxas gives 255 registers). dy goes as bf16 into the swizzled
//     K-major A operand by ordinary 16-byte stores (rows past N are
//     zeros), each thread summing its 8 columns over 16 rows for db on the
//     way; one bulk store copies the tile to device memory, where it is
//     the dW pass's dy operand as it stands. Thread 0 keeps a 4-stage ring
//     of Wᵀ tile pairs (32 KB a stage, one tile for each warpgroup) full:
//     the first stages are asked for at the block's start, each again once
//     both warpgroups have released it (no producer warp). Then the tile's
//     h (prefetched into L2 at the start) comes into the freed ring, one
//     bulk copy a row. The epilogues are straight-line code on the
//     accumulators, with h, the params (one float4 a column) and dy from
//     shared memory (dy from A, rounded to bf16 for fp32 inputs: then a
//     second pass adds dy - bf16(dy), read from device memory, to df and
//     its sums, as fp32 dy's loads in the first would spill): f, a fast
//     sigmoid, df in place of dp, p = silu(f)
//     into A in place of dy (then one bulk store, in the dW pass's byte
//     order); the row sums of dxhat and dxhat * xhat meet across the two
//     warpgroups in shared memory; dh goes into the h tile in place of h,
//     then one bulk store a row. The column sums of df and df * xhat are
//     halved across the 8 lanes that hold a column pair (7 shuffles for
//     two column groups), then summed over the 4 warps in a fixed order;
//     the tile's db, dgamma, dbeta, ds and dt follow from them;
//   * dW pass: a block owns a 128 x 128 (or 128 x 256 when C % 256 == 0)
//     tile of dW and one fixed slice of the row tiles. Each stage is one
//     row tile: 16 KB of packed dy and 16 or 32 KB of packed p, two bulk
//     copies on an mbarrier, 4 stages. Both operands are MN-major (the
//     rows run along k), read with wgmma's transpose flags; warpgroup g
//     takes dW's rows 64 g .. 64 g + 63 of the block;
//   * reductions: the slices' dW tiles, the per-tile column sums of each
//     cloud and then the per-cloud sums are added in a fixed order by small
//     kernels. No float atomics: two launches are bitwise equal.
//
// Workspace (one fp32 buffer, sized by pcfm_film_block_bwd_workspace):
// the slices' dW tiles
// (16 x C x C at C = 512), the tile sums B x ceil(N / 64) x 5 x C, the
// cloud sums B x 5 x C, packed p and packed dy (each B x ceil(N / 64) x
// 64 x C bf16: 164 MB at (8, 20000, 512)) and the packed Wᵀ.
//
// What bounds it at (B, N, C) = (8, 20000, 512) (chip_smoke.py's
// film_bounds): the two C x C products over 160k rows, 168 GFLOP, take
// 0.170 ms at 989 TFLOP/s dense bf16; its bytes (dy and h read, dh
// written, ~0.5 GB in bf16) take ~0.15 ms at 3.35 TB/s. The design adds
// bytes of its own beyond that bound: p and the packed dy, each written by
// the rows pass and read by the dW pass (~0.66 GB, ~0.2 ms at 3.35 TB/s).
// The rows pass runs one block an SM (A 64 KB + ring 128 KB + sums and
// params 35 KB; 128 accumulators a thread), so a tile's dy load, product,
// h copy and epilogues run in series, and every block reads the packed
// Wᵀ (0.5 MB) from L2.
//
// What it leaves for later: overlap across tiles (a persistent block whose
// warpgroups take turns at product and epilogue), W tiles multicast to a
// cluster, a dW pass that reads dy through a tensor map instead of the
// packed copy.
//
// The wide path, MAX_C < C <= WIDE_MAX_C: a 64-row tile's fp32 dp no
// longer fits in the registers (256 KB at C = 1024), nor dy's bf16 A
// operand beside the Wᵀ ring in shared memory. So dp goes through device
// memory:
//   * dy is packed as bf16 in the rows pass's byte order (the dW pass's dy
//     operand as before), by a small kernel;
//   * dp = dy @ W is the streamed wgmma product of film_wide.cuh over the
//     packed dy's and Wᵀ's k stages, written in fp32 to the workspace
//     (1.31 GB at (8, 20000, 2048));
//   * a rows kernel owns one 64-row tile and takes the columns in chunks
//     of 256 (a warp a row, a lane 8 columns): f, df, p (packed, as the
//     narrow rows pass writes it) and the tile's column sums, chunk by
//     chunk in a fixed order, carrying each row's sums of dxhat and dxhat *
//     xhat across the chunks; then a second sweep over the same rows
//     recomputes df from dy, h and dp and writes dh. dy stays in its own
//     dtype throughout, so fp32 inputs need no second pass;
//   * the dW pass and the reductions are the narrow path's.
// What bounds it: the two products, 4 B N C^2 operations (0.679 ms at (8,
// 20000, 1024), 2.714 at C = 2048, at 989 TFLOP/s dense bf16). What the
// design adds in bytes: dy packed (2 bytes an element, written and read
// twice), dp (4, written and read twice), p (2, written and read), and the
// second sweep's dy and h; about 24 bytes an element against the bound's
// 6, so the rows kernel, bound by those bytes, takes the most time
// (PERF.md §6). It is right and simple; keeping df on chip between the
// sweeps and overlapping the rows work with the product is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "film_common.cuh"
#include "film_wide.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int ROWS = 64;            // rows of one cloud per rows-pass block
constexpr int THREADS = 256;        // two warpgroups
constexpr int TILE_BYTES = N_TILE * K_TILE * 2;  // 16 KB
constexpr int MAX_C = 512;          // 2 chunks of dp a warpgroup; wider C:
                                    // the wide path
constexpr int NQ = 5;               // tile sums: db, dgamma, dbeta, ds, dt
constexpr int NS = 3;               // column sums kept: dy, df, df * xhat
constexpr int ROWS_STAGES = 4;      // Wᵀ ring, a tile pair a stage
constexpr int DW_STAGES = 4;
constexpr int DW_M = 128;           // dW rows (out) a block
constexpr int DW_BLOCKS = 132;      // aim: one wave of dW blocks (H100 SXM)
constexpr int RED_THREADS = 256;

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

constexpr int RING_BYTES = ROWS_STAGES * 2 * TILE_BYTES;  // 128 KB

size_t rows_smem_bytes(int c) {
  return 1024 +                                           // alignment slack
         static_cast<size_t>(ROWS) * c * 2 +              // A (dy), bf16
         RING_BYTES +                                     // Wᵀ ring, then h
         static_cast<size_t>(4) * NS * c * 4 +            // column sums
         2 * ROWS * 2 * 4 +                               // row sums
         2 * ROWS * 4 +                                   // mean, rstd
         static_cast<size_t>(c) * 16 +                    // s, t, 1 + g, beta
         (2 * ROWS_STAGES + 1) * 8;                       // full, empty, h
}

// a dW stage: 64 rows of packed dy (128 columns) and of packed p (128 NB)
template <int NB>
size_t dw_smem_bytes() {
  return 1024 + static_cast<size_t>(DW_STAGES) * TILE_BYTES * (1 + NB) +
         2 * DW_STAGES * 8;
}

// offset (bf16 values) of row r < 64, column k of a 64-row tile packed for
// the dW pass: 64-column regions of 64 rows x 128 bytes, each row's 16-byte
// chunks swizzled (the rows pass's A operand, byte for byte)
__device__ __forceinline__ int tile_offset(int r, int k) {
  return (k >> 6) * (ROWS * 64) + r * 64 +
         ((((k & 63) >> 3) ^ (r & 7)) << 3) + (k & 7);
}

// W (out, in) fp32 -> bf16 Wᵀ tiles: W[o, i] lands where packed_offset puts
// row i, column o; one thread per 8 consecutive o of one column i
__global__ void __launch_bounds__(RED_THREADS)
    film_block_bwd_pack_wt_kernel(const float* __restrict__ w,
                                  __nv_bfloat16* __restrict__ packed,
                                  int c) {
  const int idx = blockIdx.x * RED_THREADS + threadIdx.x;
  if (idx >= c * (c / 8)) return;
  const int i = idx % c, o = (idx / c) * 8;
  float x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = w[static_cast<size_t>(o + e) * c + i];
  *reinterpret_cast<uint4*>(packed + packed_offset(i, o, c)) =
      pack_bf16x8(x);
}

// loads are not moved across it: the first epilogue issues two column
// groups' loads at a time, so that 128 accumulators and the loads in
// flight fit in 255 registers without a spill
__device__ __forceinline__ void hoist_barrier() {
  asm volatile("" ::: "memory");
}

// two consecutive values by an ordinary load (shared or device memory)
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// v[4 jj + 2 q + e]: a lane's sums over its two rows for column groups
// j0 + jj, columns + e, of df (q 0) and df * xhat (q 1). Summed over the 8
// lanes that hold these columns (lane bits 4, 3, 2), halving the values at
// each step: lane bits (4, 3, 2) end with v[4 b4 + 2 b3 + b2] summed, in a
// fixed order. col_sum_index says where that sum goes in a warp's colred.
__device__ __forceinline__ float lane_col_sum(const float (&v)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float w4[4], w2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = b4 ? v[4 + i] : v[i];
    const float send = b4 ? v[i] : v[4 + i];
    w4[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = b3 ? w4[2 + i] : w4[i];
    const float send = b3 ? w4[i] : w4[2 + i];
    w2[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float keep = b2 ? w2[1] : w2[0];
  const float send = b2 ? w2[0] : w2[1];
  return keep + __shfl_xor_sync(0xffffffffu, send, 4);
}
__device__ __forceinline__ int col_sum_index(int lane, int c, int ch, int j0,
                                             int ec) {
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
  return (1 + b3) * c + ch * N_TILE + 8 * (j0 + b4) + ec + b2;
}

// Rows pass: dh, packed p and dy, and the per-tile sums. Grid
// (ceil(N / ROWS), B); kEven: C / 128 is even, so that each warpgroup has
// a chunk in every pair.
template <typename T, bool kEven>
__global__ void __launch_bounds__(THREADS, 1)
    film_block_bwd_rows_kernel(const T* __restrict__ dy,
                               const T* __restrict__ h,
                               const float* __restrict__ s,
                               const float* __restrict__ t,
                               const T* __restrict__ gamma,
                               const T* __restrict__ beta,
                               const __nv_bfloat16* __restrict__ wt_packed,
                               const float* __restrict__ mean_in,
                               const float* __restrict__ rstd_in,
                               T* __restrict__ dh,
                               __nv_bfloat16* __restrict__ p_packed,
                               __nv_bfloat16* __restrict__ dy_packed,
                               float* __restrict__ part, int n_points,
                               int c) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  // A and the ring on 1024-byte boundaries (the swizzle repeats every 1024
  // bytes); ROWS * C * 2 and TILE_BYTES keep that
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_tile = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = a_tile + static_cast<size_t>(ROWS) * c * 2;
  // the tile's h in the ring after the product: rows of C + H_LD values,
  // so that the 8 rows a warp reads at once fall in different banks
  // (bf16); an fp32 tile fills the ring unpadded
  constexpr int H_LD = kBf16 ? 8 : 0;
  float* colred = reinterpret_cast<float*>(ring + RING_BYTES);
  float* rowred = colred + 4 * NS * c;
  float* s_mean = rowred + 2 * ROWS * 2;
  float* s_rstd = s_mean + ROWS;
  float4* prm = reinterpret_cast<float4*>(s_rstd + ROWS);  // 16-byte aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(prm + c);
  uint64_t* empty = full + ROWS_STAGES;
  uint64_t* h_bar = empty + ROWS_STAGES;

  const int row0 = blockIdx.x * ROWS;
  const int n_valid = min(ROWS, n_points - row0);
  const size_t tile_row0 = static_cast<size_t>(blockIdx.y) * n_points + row0;
  const size_t tile = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const T* g_c = gamma + static_cast<size_t>(blockIdx.y) * c;
  const T* be_c = beta + static_cast<size_t>(blockIdx.y) * c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, tid = threadIdx.x & 127;
  const int nch = c / N_TILE, k_tiles = c / K_TILE;
  const int npairs = (nch + 1) / 2;
  const int total = npairs * k_tiles;

  // stage i holds the Wᵀ tiles of chunks 2p and 2p + 1 (p = i / k_tiles)
  // at k tile i % k_tiles: the first for warpgroup 0, the second for 1
  auto load_stage = [&](int i) {
    const int st = i % ROWS_STAGES, p = i / k_tiles, kt = i % k_tiles;
    const int tiles = 2 * p + 1 < nch ? 2 : 1;
    mbar_arrive_expect_tx(&full[st], tiles * TILE_BYTES);
    for (int q = 0; q < tiles; ++q)
      bulk_copy_g2s(ring + (st * 2 + q) * TILE_BYTES,
                    wt_packed + (static_cast<size_t>(2 * p + q) * k_tiles +
                                 kt) * N_TILE * K_TILE,
                    TILE_BYTES, &full[st]);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < ROWS_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_init(h_bar, 1);
    mbar_fence_init();
    // the epilogue's h: in L2 by the time the product is done
    prefetch_l2(h + tile_row0 * c,
                static_cast<uint32_t>(n_valid * c * sizeof(T)));
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < ROWS_STAGES && i < total; ++i) load_stage(i);

  // ---- dy -> the bf16 A operand (rows past N: zeros), and the tile's
  // column sums of dy (db): thread t owns the 8 columns of group t % 64
  // in rows t / 64, t / 64 + 4, ... (16 rows, in order); colred[w][0]
  // takes the sums of rows = w (mod 4)
  {
    const int gi = threadIdx.x & 63, rq = threadIdx.x >> 6;
    if (gi < c / 8) {
      // all 16 rows' loads in flight at once for bf16, 8 for fp32
      constexpr int U = kBf16 ? 16 : 8;
      float db8[8] = {};
#pragma unroll
      for (int half = 0; half < 16 / U; ++half) {
        Group<T> raw[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int r = rq + 4 * (U * half + u);
          if (r < n_valid)
            raw[u].load(dy + (tile_row0 + r) * c + gi * 8);
          else
            raw[u].clear();
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int r = rq + 4 * (U * half + u);
          float x[8];
          raw[u].unpack(x);
#pragma unroll
          for (int e = 0; e < 8; ++e) db8[e] += x[e];
          *reinterpret_cast<uint4*>(a_tile + (gi >> 3) * (ROWS * 128) +
                                    r * 128 + (((gi & 7) ^ (r & 7)) << 4)) =
              pack_bf16x8(x);
        }
      }
      float4* dst = reinterpret_cast<float4*>(colred + rq * NS * c + gi * 8);
      dst[0] = make_float4(db8[0], db8[1], db8[2], db8[3]);
      dst[1] = make_float4(db8[4], db8[5], db8[6], db8[7]);
    }
  }
  if (threadIdx.x < ROWS) {
    const int r = threadIdx.x;
    s_mean[r] = r < n_valid ? mean_in[tile_row0 + r] : 0.0f;
    s_rstd[r] = r < n_valid ? rstd_in[tile_row0 + r] : 0.0f;
  }
  for (int k = threadIdx.x; k < c; k += THREADS)
    prm[k] = make_float4(s[k], t[k], 1.0f + to_f32(g_c[k]), to_f32(be_c[k]));
  // the generic-proxy stores to A before wgmma and the bulk store read it
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0)
    bulk_copy_s2g(dy_packed + tile * ROWS * c, a_tile,
                  static_cast<uint32_t>(ROWS * c * 2));

  // ---- dp = dy @ W: warpgroup wg computes chunks wg and wg + 2
  auto release = [&](int i) {
    if (tid == 0) mbar_arrive(&empty[i % ROWS_STAGES]);
    if (threadIdx.x == 0 && i + ROWS_STAGES < total) {
      mbar_wait(&empty[i % ROWS_STAGES], (i / ROWS_STAGES) & 1);
      load_stage(i + ROWS_STAGES);
    }
  };
  const uint32_t a_base = smem_u32(a_tile);
  const uint32_t b_base = smem_u32(ring) + wg * TILE_BYTES;
  float acc[2][64];
  int it = 0;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (p >= npairs) break;
    if (kEven || 2 * p + wg < nch) {
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int st = it % ROWS_STAGES;
        mbar_wait(&full[st], (it / ROWS_STAGES) & 1);
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[p][i]);
        wgmma_fence();
        const uint64_t da = desc_sw128(a_base + kt * ROWS * 128);
        const uint64_t db = desc_sw128(b_base + st * 2 * TILE_BYTES);
#pragma unroll
        for (int kk = 0; kk < K_TILE / 16; ++kk)
          wgmma_m64n128k16(acc[p], da + 2 * kk, db + 2 * kk,
                           (kt | kk) != 0);
        wgmma_commit();
        if (kt > 0) {
          wgmma_wait<1>();  // the previous stage's products are done
          release(it - 1);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[p][i]);
      release(it - 1);
    } else {  // C / 128 is odd: this warpgroup has no chunk in pair p
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        mbar_wait(&full[it % ROWS_STAGES], (it / ROWS_STAGES) & 1);
        release(it);
      }
    }
  }

  // ---- the tile's h into the ring, now free: one bulk copy a row (the
  // row stride is padded), asked for by warp 0, from L2 (prefetched); the
  // rows past N are zeros, so that the epilogues need no branch on them
  if (threadIdx.x == 0) bulk_store_wait_read();  // the dy store has read A
  __syncthreads();  // both warpgroups' products have read the ring
  if (warp == 0) {
    const uint32_t row_bytes = static_cast<uint32_t>(c * sizeof(T));
    if (lane == 0) mbar_arrive_expect_tx(h_bar, n_valid * row_bytes);
    __syncwarp();
    for (int r = lane; r < n_valid; r += 32)
      bulk_copy_g2s(ring + static_cast<size_t>(r) * (c + H_LD) * sizeof(T),
                    h + (tile_row0 + r) * c, row_bytes, h_bar);
  }
  {
    const int per_row = c * static_cast<int>(sizeof(T)) / 16;
    for (int idx = threadIdx.x; idx < (ROWS - n_valid) * per_row;
         idx += THREADS)
      reinterpret_cast<uint4*>(
          ring + static_cast<size_t>(n_valid + idx / per_row) * (c + H_LD) *
                     sizeof(T))[idx % per_row] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  mbar_wait(h_bar, 0);

  // ---- epilogue 1: df in place of dp, p (into A, in place of dy), the
  // row and column sums; straight-line code (the shuffles need a
  // converged warp). Thread (warp, lane) holds rows er and er + 8,
  // columns 8 j + ec, +1.
  const int er = (warp & 3) * 16 + (lane >> 2);
  const int ec = 2 * (lane & 3);
  float mu[2], rs[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mu[hr] = s_mean[er + 8 * hr];
    rs[hr] = s_rstd[er + 8 * hr];
  }
  __nv_bfloat16* a16 = reinterpret_cast<__nv_bfloat16*>(a_tile);
  T* hd = reinterpret_cast<T*>(ring);  // h, then dh in its place
  float m1[2] = {0.0f, 0.0f}, m2[2] = {0.0f, 0.0f};
  float* colred_w = colred + (warp & 3) * NS * c;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (p >= npairs) break;
    const int ch = 2 * p + wg;
    if (!kEven && ch >= nch) continue;
#pragma unroll
    for (int j0 = 0; j0 < N_TILE / 8; j0 += 2) {
      hoist_barrier();
      // the sums of df and df * xhat over this thread's two rows, for
      // column groups j0 and j0 + 1: v[4 jj + 2 q + e], q 0 df, 1 df * xhat
      float v[8] = {};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = j0 + jj;
        const int k = ch * N_TILE + 8 * j + ec;
        const float4 p0 = prm[k], p1 = prm[k + 1];
        const float sk[2] = {p0.x, p1.x}, tk[2] = {p0.y, p1.y};
        const float g1[2] = {p0.z, p1.z}, bk[2] = {p0.w, p1.w};
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = er + 8 * hr;
          const float2 xv = ld2(hd + r * (c + H_LD) + k);
          // dy from A: exact for bf16 inputs, rounded to bf16 for fp32
          // ones (the fp32 pass below adds what the rounding took)
          __nv_bfloat16* a_rk = a16 + tile_offset(r, k);
          const float2 dv = ld2(a_rk);
          const float x[2] = {xv.x, xv.y}, d[2] = {dv.x, dv.y};
          float pv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float xhat = (x[e] - mu[hr]) * rs[hr];
            const float f = (xhat * sk[e] + tk[e]) * g1[e] + bk[e];
            // fast exp and divide: their few-ulp error is far below the
            // bf16 rounding of p and of the product
            const float sig = __fdividef(1.0f, 1.0f + __expf(-f));
            pv[e] = r < n_valid ? f * sig : 0.0f;  // rows past N add nothing
            float& a = acc[p][4 * j + 2 * hr + e];
            const float df = d[e] + sig * (1.0f + f * (1.0f - sig)) * a;
            a = df;
            const float dx = df * g1[e] * sk[e];
            m1[hr] += dx;
            m2[hr] += dx * xhat;
            v[4 * jj + e] += df;
            v[4 * jj + 2 + e] += df * xhat;
          }
          store2(a_rk, pv[0], pv[1]);
        }
      }
      colred_w[col_sum_index(lane, c, ch, j0, ec)] = lane_col_sum(v, lane);
    }
  }
  // fp32 inputs: epilogue 1 took dy rounded to bf16 (from A, where 255
  // registers leave no room for fp32 dy's loads). Add the remainder
  // dy - bf16(dy), from device memory (L2: the block read the tile at its
  // start), to df and to its row and column sums, so that df takes the
  // fp32 dy as the plain version does
  if constexpr (!kBf16) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (p >= npairs) break;
      const int ch = 2 * p + wg;
      if (!kEven && ch >= nch) continue;
#pragma unroll
      for (int j0 = 0; j0 < N_TILE / 8; j0 += 2) {
        float v[8] = {};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = j0 + jj;
          const int k = ch * N_TILE + 8 * j + ec;
          const float4 p0 = prm[k], p1 = prm[k + 1];
          const float gs[2] = {p0.z * p0.x, p1.z * p1.x};
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = er + 8 * hr;
            const float2 xv = ld2(hd + r * (c + H_LD) + k);
            const float2 dv = r < n_valid
                                  ? ld2(dy + (tile_row0 + r) * c + k)
                                  : make_float2(0.0f, 0.0f);
            const float x[2] = {xv.x, xv.y}, d[2] = {dv.x, dv.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float xhat = (x[e] - mu[hr]) * rs[hr];
              const float rem =
                  d[e] - __bfloat162float(__float2bfloat16_rn(d[e]));
              acc[p][4 * j + 2 * hr + e] += rem;
              const float dx = rem * gs[e];
              m1[hr] += dx;
              m2[hr] += dx * xhat;
              v[4 * jj + e] += rem;
              v[4 * jj + 2 + e] += rem * xhat;
            }
          }
        }
        colred_w[col_sum_index(lane, c, ch, j0, ec)] += lane_col_sum(v, lane);
      }
    }
  }
  // the row sums over this warpgroup's columns, then over both
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m1[hr] += __shfl_xor_sync(0xffffffffu, m1[hr], o);
      m2[hr] += __shfl_xor_sync(0xffffffffu, m2[hr], o);
    }
    if ((lane & 3) == 0)
      *reinterpret_cast<float2*>(rowred + (wg * ROWS + er + 8 * hr) * 2) =
          make_float2(m1[hr], m2[hr]);
  }
  fence_proxy_async();  // p in A: generic stores before the bulk store
  __syncthreads();
  if (threadIdx.x == 0)
    bulk_copy_s2g(p_packed + tile * ROWS * c, a_tile,
                  static_cast<uint32_t>(ROWS * c * 2));

  // ---- the tile's sums: the 4 warps' column sums in order
  float* part_t = part + tile * NQ * c;
  for (int k = threadIdx.x; k < c; k += THREADS) {
    float sq[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q)
      sq[q] = ((colred[q * c + k] + colred[(NS + q) * c + k]) +
               colred[(2 * NS + q) * c + k]) +
              colred[(3 * NS + q) * c + k];
    const float4 pk = prm[k];
    const float g1 = pk.z;
    part_t[k] = sq[0];                            // db
    part_t[c + k] = pk.x * sq[2] + pk.y * sq[1];  // dgamma: df * u
    part_t[2 * c + k] = sq[1];                    // dbeta
    part_t[3 * c + k] = g1 * sq[2];               // ds: du * xhat
    part_t[4 * c + k] = g1 * sq[1];               // dt: du
  }

  // ---- epilogue 2: dh from the registers, in place of h in shared
  // memory, then one bulk store a row
  float rm1[2], rm2[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float* a = rowred + (er + 8 * hr) * 2;
    const float* b = rowred + (ROWS + er + 8 * hr) * 2;
    rm1[hr] = (a[0] + b[0]) / c;
    rm2[hr] = (a[1] + b[1]) / c;
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (p >= npairs) break;
    const int ch = 2 * p + wg;
    if (!kEven && ch >= nch) continue;
#pragma unroll
    for (int j = 0; j < N_TILE / 8; ++j) {
      const int k = ch * N_TILE + 8 * j + ec;
      const float4 p0 = prm[k], p1 = prm[k + 1];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = er + 8 * hr;
        T* hp = hd + r * (c + H_LD) + k;
        const float2 x = ld2(hp);
        const float x0 = (x.x - mu[hr]) * rs[hr];
        const float x1 = (x.y - mu[hr]) * rs[hr];
        const float dx0 = acc[p][4 * j + 2 * hr] * p0.z * p0.x;
        const float dx1 = acc[p][4 * j + 2 * hr + 1] * p1.z * p1.x;
        store2(hp, rs[hr] * (dx0 - rm1[hr] - x0 * rm2[hr]),
               rs[hr] * (dx1 - rm1[hr] - x1 * rm2[hr]));
      }
    }
  }
  fence_proxy_async();  // dh in shared memory before the bulk stores
  __syncthreads();
  if (warp == 0) {
    for (int r = lane; r < n_valid; r += 32)
      bulk_copy_s2g(dh + (tile_row0 + r) * c,
                    ring + static_cast<size_t>(r) * (c + H_LD) * sizeof(T),
                    static_cast<uint32_t>(c * sizeof(T)));
    // the bulk stores (p, dh) have read shared memory before the block's
    // memory is reused
    bulk_store_wait_read();
  }
}

// dW pass: a DW_M x (128 NB) tile of dW = dy^T p (out x in) over one slice
// of row tiles. Grid ((C / 128) * (C / (128 NB)), slices); writes
// ws_dw[slice] (C x C).
template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
    film_block_bwd_dw_kernel(const __nv_bfloat16* __restrict__ dy_packed,
                             const __nv_bfloat16* __restrict__ p_packed,
                             float* __restrict__ ws_dw, int tiles, int c,
                             int tiles_per_slice) {
  constexpr int STAGE = TILE_BYTES * (1 + NB);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DW_STAGES * STAGE);
  uint64_t* empty = full + DW_STAGES;

  const int i_tiles = c / (N_TILE * NB);
  const int o0 = (blockIdx.x / i_tiles) * DW_M;
  const int i0 = (blockIdx.x % i_tiles) * N_TILE * NB;
  const int t0 = blockIdx.y * tiles_per_slice;
  const int count = min(tiles - t0, tiles_per_slice);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, tid = threadIdx.x & 127;

  // stage i: row tile t0 + i, dy's columns o0 .. o0 + 127 (two 64-column
  // regions, adjacent) and p's columns i0 .. i0 + 128 NB - 1
  auto load_stage = [&](int i) {
    const int st = i % DW_STAGES;
    const size_t base = static_cast<size_t>(t0 + i) * ROWS * c;
    mbar_arrive_expect_tx(&full[st], STAGE);
    bulk_copy_g2s(ring + st * STAGE, dy_packed + base + (o0 / 64) * ROWS * 64,
                  TILE_BYTES, &full[st]);
    bulk_copy_g2s(ring + st * STAGE + TILE_BYTES,
                  p_packed + base + (i0 / 64) * ROWS * 64, NB * TILE_BYTES,
                  &full[st]);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < DW_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < DW_STAGES && i < count; ++i) load_stage(i);

  auto release = [&](int i) {
    if (tid == 0) mbar_arrive(&empty[i % DW_STAGES]);
    if (threadIdx.x == 0 && i + DW_STAGES < count) {
      mbar_wait(&empty[i % DW_STAGES], (i / DW_STAGES) & 1);
      load_stage(i + DW_STAGES);
    }
  };
  float acc[NB][64];
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[q][i] = 0.0f;
  const uint32_t ring_base = smem_u32(ring);
  for (int it = 0; it < count; ++it) {
    const int st = it % DW_STAGES;
    mbar_wait(&full[st], (it / DW_STAGES) & 1);
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[q][i]);
    wgmma_fence();
    const uint32_t sb = ring_base + st * STAGE;
    // A: this warpgroup's 64 dW rows = 64 dy columns, MN-major; B: p's
    // columns in 64-column regions 8 KB apart, MN-major
    const uint64_t da = desc_sw128_mn(sb + wg * (ROWS * 128), 8192, 1024);
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
      for (int q = 0; q < NB; ++q)
        wgmma_m64n128k16<1, 1>(
            acc[q], da + 128 * kk,
            desc_sw128_mn(sb + TILE_BYTES * (1 + q), 8192, 1024) + 128 * kk,
            1);
    wgmma_commit();
    if (it > 0) {
      wgmma_wait<1>();
      release(it - 1);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[q][i]);
  if (count > 0) release(count - 1);

  float* out = ws_dw + static_cast<size_t>(blockIdx.y) * c * c;
  const int orow = o0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int j = 0; j < N_TILE / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        store2(out + static_cast<size_t>(orow + 8 * hr) * c + i0 +
                   q * N_TILE + 8 * j + 2 * (lane & 3),
               acc[q][4 * j + 2 * hr], acc[q][4 * j + 2 * hr + 1]);
}

// ------------------------------------------------------ the wide path

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&x)[8]);
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float (&x)[8]) {
  *reinterpret_cast<uint4*>(p) = pack_bf16x8(x);
}
template <>
__device__ __forceinline__ void store8<float>(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// dy (b, n, c) -> bf16 tiles laid out as rows_packed_index, zeros past N
// and in the pairs' padding tile; one thread a row's 8 columns
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
    film_block_bwd_wide_pack_dy_kernel(const T* __restrict__ dy,
                                       __nv_bfloat16* __restrict__ packed,
                                       int bsz, int n_points, int c,
                                       long long items) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * RED_THREADS + threadIdx.x;
  if (idx >= items) return;
  const int groups = c / 8, gi = static_cast<int>(idx % groups);
  const long long row = idx / groups;  // tile * 64 + r
  const size_t tile = static_cast<size_t>(row / WIDE_ROWS);
  const int r = static_cast<int>(row % WIDE_ROWS);
  const int tiles = (n_points + WIDE_ROWS - 1) / WIDE_ROWS;
  const size_t b = tile / tiles;
  const int n = static_cast<int>(tile % tiles) * WIDE_ROWS + r;
  float x[8] = {};
  if (b < static_cast<size_t>(bsz) && n < n_points)
    load8(dy + (b * n_points + n) * c + gi * 8, x);
  *reinterpret_cast<uint4*>(packed + wide_a_offset(tile, r, gi * 8, c)) =
      pack_bf16x8(x);
}

// dp = dy @ W in fp32, (wide_tiles x 64, c) row-major: block i takes output
// chunks (i % nchunk) * NB .. + NB - 1 of the pair of row tiles i / nchunk
template <int NB>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    film_block_bwd_wide_dp_kernel(const __nv_bfloat16* __restrict__ dy_packed,
                                  const __nv_bfloat16* __restrict__ wt_packed,
                                  float* __restrict__ dp, int c) {
  const int nchunk = c / (N_TILE * NB);
  const int chunk0 = (blockIdx.x % nchunk) * NB;
  const size_t pair = blockIdx.x / nchunk;
  float acc[NB][64];
  wide_product<NB>(dy_packed, wt_packed, c, pair, chunk0, acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = (2 * pair + (warp >> 2)) * WIDE_ROWS + (warp & 3) * 16 +
                      (lane >> 2);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int j = 0; j < N_TILE / 8; ++j)
        store2(dp + (row0 + 8 * hr) * c + (chunk0 + q) * N_TILE + 8 * j +
                   2 * (lane & 3),
               acc[q][4 * j + 2 * hr], acc[q][4 * j + 2 * hr + 1]);
}

constexpr int WIDE_CHUNK = 256;               // columns a lane pass: 32 x 8
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
constexpr int WIDE_RPW = WIDE_ROWS / WIDE_WARPS;  // rows a warp

// The wide rows kernel: grid (ceil(N / 64), B). Warp w takes rows w, w + 8,
// ... of the tile; lane l columns k0 + 8 l .. + 7 of each 256-column chunk
template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    film_block_bwd_wide_rows_kernel(const T* __restrict__ dy,
                                    const T* __restrict__ h,
                                    const float* __restrict__ s,
                                    const float* __restrict__ t,
                                    const T* __restrict__ gamma,
                                    const T* __restrict__ beta,
                                    const float* __restrict__ dp,
                                    const float* __restrict__ mean_in,
                                    const float* __restrict__ rstd_in,
                                    T* __restrict__ dh,
                                    __nv_bfloat16* __restrict__ p_packed,
                                    float* __restrict__ part, int n_points,
                                    int c) {
  // each warp's column sums of a chunk (dy, df, df * xhat), then summed
  // over the warps in order
  __shared__ float4 colred[WIDE_WARPS][NS][WIDE_CHUNK / 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * WIDE_ROWS;
  const int n_valid = min(WIDE_ROWS, n_points - row0);
  const size_t tile = static_cast<size_t>(blockIdx.y) * gridDim.x +
                      blockIdx.x;
  const size_t tile_row0 = static_cast<size_t>(blockIdx.y) * n_points + row0;
  const T* g_c = gamma + static_cast<size_t>(blockIdx.y) * c;
  const T* be_c = beta + static_cast<size_t>(blockIdx.y) * c;
  float mu[WIDE_RPW], rs[WIDE_RPW], m1[WIDE_RPW], m2[WIDE_RPW];
#pragma unroll
  for (int i = 0; i < WIDE_RPW; ++i) {
    const int r = warp + WIDE_WARPS * i;
    mu[i] = r < n_valid ? mean_in[tile_row0 + r] : 0.0f;
    rs[i] = r < n_valid ? rstd_in[tile_row0 + r] : 0.0f;
    m1[i] = m2[i] = 0.0f;
  }
  float* part_t = part + tile * NQ * c;

  // ---- sweep 1: p, the column sums, the rows' sums
  for (int k0 = 0; k0 < c; k0 += WIDE_CHUNK) {
    const int k = k0 + 8 * lane;
    if (k < c) {
      float sv[8], tv[8], g1[8], bv[8];
      load8(s + k, sv);
      load8(t + k, tv);
      load8(g_c + k, g1);
      load8(be_c + k, bv);
#pragma unroll
      for (int e = 0; e < 8; ++e) g1[e] += 1.0f;
      float cs[NS][8] = {};
#pragma unroll
      for (int i = 0; i < WIDE_RPW; ++i) {
        // two rows' loads in flight at a time, so that the registers hold
        if (i % 2 == 0) hoist_barrier();
        const int r = warp + WIDE_WARPS * i;
        float pv[8] = {};
        if (r < n_valid) {
          float d[8], x[8], a[8];
          load8(dy + (tile_row0 + r) * c + k, d);
          load8(h + (tile_row0 + r) * c + k, x);
          load8(dp + (tile * WIDE_ROWS + r) * c + k, a);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            // the narrow rows pass's arithmetic, in its order
            const float xhat = (x[e] - mu[i]) * rs[i];
            const float f = (xhat * sv[e] + tv[e]) * g1[e] + bv[e];
            const float sig = __fdividef(1.0f, 1.0f + __expf(-f));
            pv[e] = f * sig;
            const float df = d[e] + sig * (1.0f + f * (1.0f - sig)) * a[e];
            const float dx = df * g1[e] * sv[e];
            m1[i] += dx;
            m2[i] += dx * xhat;
            cs[0][e] += d[e];
            cs[1][e] += df;
            cs[2][e] += df * xhat;
          }
        }
        *reinterpret_cast<uint4*>(p_packed + wide_a_offset(tile, r, k, c)) =
            pack_bf16x8(pv);  // rows past N: zeros
      }
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        colred[warp][q][2 * lane] =
            make_float4(cs[q][0], cs[q][1], cs[q][2], cs[q][3]);
        colred[warp][q][2 * lane + 1] =
            make_float4(cs[q][4], cs[q][5], cs[q][6], cs[q][7]);
      }
    }
    __syncthreads();
    // the tile's sums of this chunk: the warps' column sums in order
    const int kk = threadIdx.x, col = k0 + kk;
    if (col < c) {
      float sq[NS];
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const float* v = reinterpret_cast<const float*>(colred[0][q]) + kk;
        float acc = v[0];
#pragma unroll
        for (int w = 1; w < WIDE_WARPS; ++w)
          acc += v[static_cast<size_t>(w) * NS * WIDE_CHUNK];
        sq[q] = acc;
      }
      const float sk = s[col], tk = t[col];
      const float g1 = 1.0f + to_f32(g_c[col]);
      part_t[col] = sq[0];                          // db
      part_t[c + col] = sk * sq[2] + tk * sq[1];    // dgamma: df * u
      part_t[2 * c + col] = sq[1];                  // dbeta
      part_t[3 * c + col] = g1 * sq[2];             // ds: du * xhat
      part_t[4 * c + col] = g1 * sq[1];             // dt: du
    }
    __syncthreads();  // colred is rewritten by the next chunk
  }

  // ---- the rows' means, then sweep 2: dh
#pragma unroll
  for (int i = 0; i < WIDE_RPW; ++i) {
    m1[i] = warp_sum(m1[i]) / c;
    m2[i] = warp_sum(m2[i]) / c;
  }
  for (int k0 = 0; k0 < c; k0 += WIDE_CHUNK) {
    const int k = k0 + 8 * lane;
    if (k >= c) continue;
    float sv[8], tv[8], g1[8], bv[8];
    load8(s + k, sv);
    load8(t + k, tv);
    load8(g_c + k, g1);
    load8(be_c + k, bv);
#pragma unroll
    for (int e = 0; e < 8; ++e) g1[e] += 1.0f;
#pragma unroll
    for (int i = 0; i < WIDE_RPW; ++i) {
      if (i % 2 == 0) hoist_barrier();
      const int r = warp + WIDE_WARPS * i;
      if (r >= n_valid) continue;
      float d[8], x[8], a[8];
      load8(dy + (tile_row0 + r) * c + k, d);
      load8(h + (tile_row0 + r) * c + k, x);
      load8(dp + (tile * WIDE_ROWS + r) * c + k, a);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = (x[e] - mu[i]) * rs[i];
        const float f = (xhat * sv[e] + tv[e]) * g1[e] + bv[e];
        const float sig = __fdividef(1.0f, 1.0f + __expf(-f));
        const float df = d[e] + sig * (1.0f + f * (1.0f - sig)) * a[e];
        const float dx = df * g1[e] * sv[e];
        x[e] = rs[i] * (dx - m1[i] - xhat * m2[i]);
      }
      store8(dh + (tile_row0 + r) * c + k, x);
    }
  }
}

// dy packed, dp, then the wide rows kernel
template <typename T>
int launch_wide_rows(const void* dy, const void* h, const void* s,
                     const void* t, const void* gamma, const void* beta,
                     const __nv_bfloat16* wt_packed, const void* mean,
                     const void* rstd, void* dh, __nv_bfloat16* p_packed,
                     __nv_bfloat16* dy_packed, float* dp, float* part, int b,
                     int n, int c, cudaStream_t stream) {
  const long long items = wide_tiles(b, n) * WIDE_ROWS * (c / 8);
  film_block_bwd_wide_pack_dy_kernel<T>
      <<<cdiv(items, RED_THREADS), RED_THREADS, 0, stream>>>(
          static_cast<const T*>(dy), dy_packed, b, n, c, items);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = wide_nb(c);
  const unsigned blocks =
      static_cast<unsigned>(wide_tiles(b, n) / 2 * (c / (N_TILE * nb)));
  auto* dp_kernel = nb == 2 ? film_block_bwd_wide_dp_kernel<2>
                            : film_block_bwd_wide_dp_kernel<1>;
  const size_t smem = nb == 2 ? Wide<2>::smem_bytes() : Wide<1>::smem_bytes();
  err = cudaFuncSetAttribute(dp_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dp_kernel<<<blocks, WIDE_THREADS, smem, stream>>>(dy_packed, wt_packed, dp,
                                                    c);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  film_block_bwd_wide_rows_kernel<T>
      <<<dim3(cdiv(n, WIDE_ROWS), b), WIDE_THREADS, 0, stream>>>(
          static_cast<const T*>(dy), static_cast<const T*>(h),
          static_cast<const float*>(s), static_cast<const float*>(t),
          static_cast<const T*>(gamma), static_cast<const T*>(beta), dp,
          static_cast<const float*>(mean), static_cast<const float*>(rstd),
          static_cast<T*>(dh), p_packed, part, n, c);
  return static_cast<int>(cudaGetLastError());
}

// out[y, j] = sum_{i < n} in[y * in_stride + i * m + j], i in order
__global__ void __launch_bounds__(RED_THREADS)
    film_block_bwd_sum_kernel(const float* __restrict__ in,
                              float* __restrict__ out, int n, int m,
                              long long in_stride, long long out_stride) {
  const int j = blockIdx.x * RED_THREADS + threadIdx.x;
  if (j >= m) return;
  const float* p = in + blockIdx.y * in_stride + j;
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) acc += p[static_cast<size_t>(i) * m];
  out[blockIdx.y * out_stride + j] = acc;
}

// per-cloud sums (B, NQ, C) -> dgamma, dbeta (B, C) in gamma's dtype and
// db, ds, dt (C,) summed over the clouds in order
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
    film_block_bwd_finalize_kernel(const float* __restrict__ per_cloud,
                                   T* __restrict__ dg, T* __restrict__ dbe,
                                   float* __restrict__ db,
                                   float* __restrict__ ds,
                                   float* __restrict__ dt, int bsz, int c) {
  const int k = blockIdx.x * RED_THREADS + threadIdx.x;
  if (k >= c) return;
  float a_db = 0.0f, a_ds = 0.0f, a_dt = 0.0f;
  for (int b = 0; b < bsz; ++b) {
    const float* pc = per_cloud + static_cast<size_t>(b) * NQ * c;
    a_db += pc[k];
    dg[static_cast<size_t>(b) * c + k] = from_f32<T>(pc[c + k]);
    dbe[static_cast<size_t>(b) * c + k] = from_f32<T>(pc[2 * c + k]);
    a_ds += pc[3 * c + k];
    a_dt += pc[4 * c + k];
  }
  db[k] = a_db;
  ds[k] = a_ds;
  dt[k] = a_dt;
}

// the dW pass's shape: row tiles a slice and slices, fixed by (b, n, c)
struct DwSplit {
  int nb, out_tiles, per_slice, slices;
};

DwSplit dw_split(int b, int n, int c) {
  DwSplit d;
  d.nb = c % (2 * N_TILE) == 0 ? 2 : 1;
  d.out_tiles = (c / DW_M) * (c / (N_TILE * d.nb));
  const int tiles = b * cdiv(n, ROWS);
  const int want = DW_BLOCKS / d.out_tiles > 1 ? DW_BLOCKS / d.out_tiles : 1;
  d.per_slice = cdiv(tiles, want < tiles ? want : tiles);
  d.slices = cdiv(tiles, d.per_slice);
  return d;
}

// region offsets in floats: the slices' dW, the tile sums, the cloud sums,
// packed p, packed dy, packed Wᵀ, the wide path's dp, and the end. Every
// region is a multiple of 4 floats, so each starts 16-byte aligned. The
// wide path pads packed dy and dp to an even number of row tiles (the
// product's pairs); the narrow path has no dp.
enum { R_DW, R_PART, R_CLOUD, R_P, R_DY, R_WT, R_DP, R_END };

void regions(int b, int n, int c, long long (&off)[R_END + 1]) {
  const long long tiles = static_cast<long long>(b) * cdiv(n, ROWS);
  const long long packed = tiles * ROWS * c / 2;  // bf16 in floats
  const bool wide = c > MAX_C;
  const long long padded = wide ? wide_tiles(b, n) * ROWS : 0;  // dp rows
  off[R_DW] = 0;
  off[R_PART] = off[R_DW] + static_cast<long long>(dw_split(b, n, c).slices) *
                                c * c;
  off[R_CLOUD] = off[R_PART] + tiles * NQ * c;
  off[R_P] = off[R_CLOUD] + static_cast<long long>(b) * NQ * c;
  off[R_DY] = off[R_P] + packed;
  off[R_WT] = off[R_DY] + (wide ? padded * c / 2 : packed);
  off[R_DP] = off[R_WT] + static_cast<long long>(c) * c / 2;
  off[R_END] = off[R_DP] + padded * c;
}

template <typename T>
int launch(const void* dy, const void* h, const void* s, const void* t,
           const void* gamma, const void* beta, const void* w,
           const void* mean, const void* rstd, void* dh, void* dw, void* dg,
           void* dbe, void* db, void* ds, void* dt, void* workspace, int b,
           int n, int c, cudaStream_t stream) {
  long long off[R_END + 1];
  regions(b, n, c, off);
  float* base = static_cast<float*>(workspace);
  float* ws_dw = base + off[R_DW];
  float* part = base + off[R_PART];
  float* per_cloud = base + off[R_CLOUD];
  auto* p_packed = reinterpret_cast<__nv_bfloat16*>(base + off[R_P]);
  auto* dy_packed = reinterpret_cast<__nv_bfloat16*>(base + off[R_DY]);
  auto* wt_packed = reinterpret_cast<__nv_bfloat16*>(base + off[R_WT]);
  const int tiles = cdiv(n, ROWS);

  film_block_bwd_pack_wt_kernel<<<cdiv(static_cast<long long>(c) * (c / 8),
                                       RED_THREADS),
                                  RED_THREADS, 0, stream>>>(
      static_cast<const float*>(w), wt_packed, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (c > MAX_C) {
    const int werr = launch_wide_rows<T>(
        dy, h, s, t, gamma, beta, wt_packed, mean, rstd, dh, p_packed,
        dy_packed, base + off[R_DP], part, b, n, c, stream);
    if (werr != 0) return werr;
  } else {
    auto* rows_kernel = (c / N_TILE) % 2 == 0
                            ? film_block_bwd_rows_kernel<T, true>
                            : film_block_bwd_rows_kernel<T, false>;
    const size_t smem = rows_smem_bytes(c);
    err = cudaFuncSetAttribute(rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    rows_kernel<<<dim3(tiles, b), THREADS, smem, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(h),
        static_cast<const float*>(s), static_cast<const float*>(t),
        static_cast<const T*>(gamma), static_cast<const T*>(beta), wt_packed,
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<T*>(dh), p_packed, dy_packed, part, n, c);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }

  const DwSplit d = dw_split(b, n, c);
  const dim3 dw_grid(d.out_tiles, d.slices);
  if (d.nb == 2) {
    err = cudaFuncSetAttribute(film_block_bwd_dw_kernel<2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dw_smem_bytes<2>()));
    if (err != cudaSuccess) return static_cast<int>(err);
    film_block_bwd_dw_kernel<2><<<dw_grid, THREADS, dw_smem_bytes<2>(),
                                  stream>>>(dy_packed, p_packed, ws_dw,
                                            b * tiles, c, d.per_slice);
  } else {
    err = cudaFuncSetAttribute(film_block_bwd_dw_kernel<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dw_smem_bytes<1>()));
    if (err != cudaSuccess) return static_cast<int>(err);
    film_block_bwd_dw_kernel<1><<<dw_grid, THREADS, dw_smem_bytes<1>(),
                                  stream>>>(dy_packed, p_packed, ws_dw,
                                            b * tiles, c, d.per_slice);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  film_block_bwd_sum_kernel<<<
      dim3(cdiv(static_cast<long long>(c) * c, RED_THREADS), 1), RED_THREADS,
      0, stream>>>(ws_dw, static_cast<float*>(dw), d.slices, c * c, 0, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  film_block_bwd_sum_kernel<<<dim3(cdiv(NQ * c, RED_THREADS), b),
                              RED_THREADS, 0, stream>>>(
      part, per_cloud, tiles, NQ * c, static_cast<long long>(tiles) * NQ * c,
      static_cast<long long>(NQ) * c);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  film_block_bwd_finalize_kernel<T>
      <<<cdiv(c, RED_THREADS), RED_THREADS, 0, stream>>>(
          per_cloud, static_cast<T*>(dg), static_cast<T*>(dbe),
          static_cast<float*>(db), static_cast<float*>(ds),
          static_cast<float*>(dt), b, c);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int b, int n, int c) {
  return b <= 0 || n <= 0 || c <= 0 || c % N_TILE != 0 || c > WIDE_MAX_C ||
         b > 65535 || static_cast<long long>(b) * cdiv(n, ROWS) * ROWS >
                          0x7fffffffLL;
}

}  // namespace

// Floats of fp32 workspace that pcfm_film_block_bwd needs for (b, n, c);
// -1 for a shape the kernel does not take.
extern "C" long long pcfm_film_block_bwd_workspace(int b, int n, int c) {
  if (bad_shape(b, n, c)) return -1;
  long long off[R_END + 1];
  regions(b, n, c, off);
  return off[R_END];
}

// Plain C entry point (bound with ctypes). Device pointers of contiguous
// tensors: dy, h, dh (b, n, c) and gamma, beta, dgamma, dbeta (b, c) in
// bf16 when is_bf16 else fp32; s, t (c,), w (c, c) (out x in), mean, rstd
// (b, n), dw (c, c), db, ds, dt (c,) and the workspace in fp32. Launches the
// Wᵀ pack, the rows pass (C > MAX_C: the dy pack, the dp product and the
// wide rows kernel), the dW pass and three fixed-order reductions on
// `stream`, does not synchronise, returns a cudaError_t code.
extern "C" int pcfm_film_block_bwd(const void* dy, const void* h,
                                   const void* s, const void* t,
                                   const void* gamma, const void* beta,
                                   const void* w, const void* mean,
                                   const void* rstd, void* dh, void* dw,
                                   void* dgamma, void* dbeta, void* db,
                                   void* ds, void* dt, void* workspace, int b,
                                   int n, int c, int is_bf16, void* stream) {
  if (bad_shape(b, n, c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(dy, h, s, t, gamma, beta, w, mean, rstd, dh,
                                 dw, dgamma, dbeta, db, ds, dt, workspace, b,
                                 n, c, st);
  return launch<float>(dy, h, s, t, gamma, beta, w, mean, rstd, dh, dw,
                       dgamma, dbeta, db, ds, dt, workspace, b, n, c, st);
}
