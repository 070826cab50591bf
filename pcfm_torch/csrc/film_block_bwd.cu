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
// the slices' dW tiles (16 x C x C at C = 512; one above 2048), the tile
// sums B x ceil(N / 64) x 5 x C, the cloud sums B x 5 x C, packed p and
// packed dy (each B x ceil(N / 64) x 64 x C bf16: 164 MB at (8, 20000,
// 512)) and the packed Wᵀ; the same regions at every width (the wide path
// keeps dp on chip too, and pads the row tiles to an even count; above
// 2048 it adds a pair counter a row chunk).
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
// The wide path, MAX_C < C <= WIDE_MAX_C_BWD: a 64-row tile's fp32 dp (256
// KB at C = 1024) no longer fits in one SM's registers, nor the tile's bf16 dy
// beside the Wᵀ ring in its shared memory. So a thread-block cluster shares
// the rows, and dp never leaves the chip:
//   * a pack kernel writes dy as bf16 in the rows pass's byte order (the
//     dW pass's dy operand, as the narrow path's; the row tiles padded to
//     an even count) and each tile's column sums of dy (db), over the
//     tile's rows in order;
//   * the cluster kernel: the ncta = ceil(C / 256) CTAs of a cluster (3 at
//     640-768, 4 at 1024, 8 at 2048, up to 11 at 2688; above 8 a
//     non-portable cluster size, which Hopper allows up to 16)
//     take a pair of 64-row tiles; rank q owns the 128-column chunks
//     [q nch / ncta, (q + 1) nch / ncta) of the nch = C / 128, at most 2.
//     Warpgroup g computes dp = dy @ W for tile g of the pair over the
//     CTA's chunks in registers (128 fp32 a thread, as the register path
//     at C = 512), streaming 4 stages of 48 KB through an mbarrier ring:
//     the pair's two 8 KB k blocks of the packed dy (A) and the CTA's Wᵀ
//     tiles at that k, which both warpgroups read (so every 128 rows read
//     the CTA's Wᵀ columns from L2 once: 64 rows a CTA read them twice as
//     often, and were slower).
//     Then the CTA's slices of the packed dy and its columns of the pair's
//     h rows (prefetched into L2 at the start) come into the freed ring;
//     the register path's epilogue on the accumulators gives df in place
//     of dp, p = silu(f) in place of dy (one bulk store a tile, in the dW
//     pass's byte order), each tile's column sums and each row's partial
//     sums of dxhat and dxhat * xhat over the CTA's columns. Those meet in
//     distributed shared memory across a cluster barrier, every CTA adding
//     all of them in rank order (no atomics: the cluster agrees to the
//     bit, two launches are bitwise equal), and each CTA writes dh for its
//     columns from the df that stayed in its registers. fp32 inputs take
//     the register path's second pass (dy - bf16(dy) from device memory);
//     fp32 h rows fit the same ring, so both dtypes split alike;
//   * the dW pass and the reductions are the narrow path's.
// Above PORTABLE_C = 2048 the clusters have 9-11 CTAs, and a cluster must
// fit in one GPC: the H100 holds 9 / 7 clusters at once at 2176 / 2688
// (81 / 77 of its 132 SMs; cudaOccupancyMaxActiveClusters). Clusters of
// one 64-row tile x 512 columns a CTA (5-6 CTAs) would fill 110 / 102
// SMs, but each CTA then reads 1.5x the L2 bytes a flop from a ring of
// two 72 KB stages (no third fits beside the epilogue's buffers), and
// their product alone was slower than this shape's on fewer SMs
// (scripts/film_bwd_cluster_probe.py). So this path keeps the cluster
// kernel and runs the dW pass on the SMs it leaves (launch_overlapped):
// the pairs go in BWD_CHUNKS chunks, each chunk's cluster kernel on a
// side stream of the greatest priority, persistent (as many clusters as
// the card holds at once, which take the pairs in turn: while a kernel of
// a higher priority has blocks waiting, the block scheduler places none
// of a lower one, so a grid of one cluster a pair kept the dW blocks
// waiting for its tail), each chunk's dW pass on the caller's stream
// beside the next chunk's rows pass, once that has begun (a one-thread
// gate kernel; else the dW blocks took the SMs of the next clusters); the
// dy packs of the later chunks run beside the first chunk's rows pass.
// Each pass of the persistent kernel starts its
// product with wgmma_m64n128k16_first: the accumulators hold the last
// pair's df from the epilogue, and a first wgmma that read them had
// ptxas serialize every wgmma of the kernel (16 % slower). The dW pass
// takes 128 x 256 tiles at every C (the last column tile stores its 128
// columns where C % 256 != 0), one block a tile and chunk (231 at 2688),
// each adding to the chunks before. What stays outside
// the overlap: the Wᵀ pack, the first chunk's dy pack, the last chunk's
// dW and the reductions. What it leaves: the cluster kernel's own time
// (its product, loads and epilogues in series) and the L2 bandwidth the
// two passes share.
// What bounds it: the two products, 4 B N C^2 operations (0.679 ms at (8,
// 20000, 1024), 2.714 at C = 2048, 4.676 at 2688, at 989 TFLOP/s dense
// bf16). Bytes an
// element in device memory: dy read and packed (2 + 2), the packed dy read
// by the cluster kernel (2; its re-reads by the cluster's CTAs and the
// slices come from L2), h read (2), dh and p written (2 + 2), the dW
// pass's packed dy and p (2 + 2): 16 against the bound's 6. From L2 the
// product reads, for every 128 rows, each CTA's Wᵀ columns (256 x C x 2
// bytes) and the pair's packed dy (128 x C x 2) once a CTA. A CTA's
// product, loads and epilogues run in series (one CTA an SM); the
// epilogues loop over quarters of the accumulators (rotate_acc32), so that
// their code stays in the instruction cache while the other SMs' products
// load L2. Left for later: overlap across tiles. (Multicasting the pair's
// A to the cluster, each stage refilled once every CTA had released it,
// was tried and was slower: the CTAs then move in lockstep.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
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
constexpr int PORTABLE_C = 2048;    // the widest C whose cluster has at most
                                    // 8 CTAs (the portable size); wider C
                                    // overlaps dW with the rows pass
constexpr int BWD_CHUNKS = 6;       // row chunks of the overlapped path
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
// of the row tiles [tile_begin, tile_end). Grid ((C / 128) * (C / (128
// NB)), slices); writes ws_dw[slice] (C x C). kChunked (the wide path
// above PORTABLE_C, NB = 2): the grid takes ceil(C / 256) column tiles,
// and where C % 256 != 0 the last copies only its 128 columns of p (the
// second half of its product reads a stale tile and is not stored); where
// `accumulate` is set the block adds its sums to what ws_dw[slice] holds
// (a later row chunk's to the chunks before it, in chunk order).
template <int NB, bool kChunked>
__global__ void __launch_bounds__(THREADS, 1)
    film_block_bwd_dw_kernel(const __nv_bfloat16* __restrict__ dy_packed,
                             const __nv_bfloat16* __restrict__ p_packed,
                             float* __restrict__ ws_dw, int tile_begin,
                             int tile_end, int c, int tiles_per_slice,
                             int accumulate) {
  constexpr int STAGE = TILE_BYTES * (1 + NB);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DW_STAGES * STAGE);
  uint64_t* empty = full + DW_STAGES;

  const int i_tiles = kChunked ? (c + N_TILE * NB - 1) / (N_TILE * NB)
                               : c / (N_TILE * NB);
  const int o0 = (blockIdx.x / i_tiles) * DW_M;
  const int i0 = (blockIdx.x % i_tiles) * N_TILE * NB;
  // p's chunks copied and stored
  const int nb = kChunked ? min(NB, (c - i0) / N_TILE) : NB;
  const int t0 = tile_begin + blockIdx.y * tiles_per_slice;
  const int count = min(tile_end - t0, tiles_per_slice);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, tid = threadIdx.x & 127;

  // stage i: row tile t0 + i, dy's columns o0 .. o0 + 127 (two 64-column
  // regions, adjacent) and p's columns i0 .. i0 + 128 nb - 1
  auto load_stage = [&](int i) {
    const int st = i % DW_STAGES;
    const size_t base = static_cast<size_t>(t0 + i) * ROWS * c;
    mbar_arrive_expect_tx(&full[st], TILE_BYTES * (1 + nb));
    bulk_copy_g2s(ring + st * STAGE, dy_packed + base + (o0 / 64) * ROWS * 64,
                  TILE_BYTES, &full[st]);
    bulk_copy_g2s(ring + st * STAGE + TILE_BYTES,
                  p_packed + base + (i0 / 64) * ROWS * 64, nb * TILE_BYTES,
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
  for (int q = 0; q < NB; ++q) {
    if (q >= nb) break;
#pragma unroll
    for (int j = 0; j < N_TILE / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float* o = out + static_cast<size_t>(orow + 8 * hr) * c + i0 +
                   q * N_TILE + 8 * j + 2 * (lane & 3);
        float v0 = acc[q][4 * j + 2 * hr], v1 = acc[q][4 * j + 2 * hr + 1];
        if (kChunked && accumulate) {
          const float2 before = ld2(o);
          v0 = before.x + v0;
          v1 = before.y + v1;
        }
        store2(o, v0, v1);
      }
  }
}

// ------------------------------------------------------ the wide path

// the cluster kernel: a CTA takes a pair of 64-row tiles (warpgroup g: tile
// 2 pair + g) and up to CL_MAX_CHUNKS 128-column chunks; a ring stage is
// the pair's two 8 KB k blocks of the packed dy (A) and the CTA's Wᵀ tiles
// at that k, which both warpgroups read
constexpr int CL_STAGES = 4;
constexpr int CL_MAX_CHUNKS = 2;  // 128 fp32 accumulators a thread
constexpr int CL_MAXW = CL_MAX_CHUNKS * N_TILE;  // columns a CTA at most
constexpr int CL_ROWS = 2 * ROWS;                // rows a CTA
constexpr int CL_STAGE = 2 * WIDE_A_BYTES + CL_MAX_CHUNKS * TILE_BYTES;
constexpr int CL_H_LD = 8;  // pad of a row of h in shared memory (values)

// the pair's slices of the packed dy and its h rows, after the product
template <typename T>
__host__ __device__ constexpr int cl_epilogue_bytes() {
  return CL_MAXW * CL_ROWS * 2 +
         CL_ROWS * (CL_MAXW + CL_H_LD) * static_cast<int>(sizeof(T));
}

// the ring: the product's stages (192 KB), then the epilogue's inputs
// (fp32: 196 KB)
template <typename T>
__host__ __device__ constexpr int cl_ring_bytes() {
  return CL_STAGES * CL_STAGE > cl_epilogue_bytes<T>()
             ? CL_STAGES * CL_STAGE
             : cl_epilogue_bytes<T>();
}

// CTAs of a cluster at width c: ceil(c / 256), 3 at 640-768, 4 at 1024,
// 8 (the portable cluster size) at 2048, 9 / 10 / 11 at 2176 / 2432 /
// 2688 = WIDE_MAX_C_BWD (bad_shape refuses wider C before any cluster is
// sized; cluster_config allows the non-portable sizes)
int cluster_ctas(int c) { return cdiv(c / N_TILE, CL_MAX_CHUNKS); }

template <typename T>
size_t cluster_smem_bytes() {
  return 1024 +                                     // alignment slack
         cl_ring_bytes<T>() +                       // ring, then dy and h
         static_cast<size_t>(8) * 2 * CL_MAXW * 4 +  // column sums a warp
         CL_ROWS * 2 * 4 +                          // the CTA's row sums
         CL_ROWS * 2 * 4 +                          // the rows' means
         2 * CL_ROWS * 4 +                          // mean, rstd
         2 * CL_MAXW * 16 +                         // s, t, 1 + g, beta
         (2 * CL_STAGES + 1) * 8 +                  // full, empty, inputs
         8;                                         // the next pairs
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster arrives (release) / waits for
// all of them (acquire): shared-memory stores before the arrival are seen
// by the other CTAs' reads after the wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the float2 at p's shared-memory offset in CTA `rank` of the cluster
__device__ __forceinline__ float2 ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(remote)
               : "memory");
  return v;
}

// the int at p's shared-memory offset in CTA `rank` of the cluster
__device__ __forceinline__ int ld_cluster_int(const int* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n"
               : "=r"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// the cluster kernel's 128 accumulators (chunk 0's 64, then chunk 1's)
// moved 32 places to the front, the first 32 to the back: the epilogues
// loop over four quarters, each on acc[0][0 .. 31], and after four calls
// every value is back in its place (a loop, not straight-line code: its
// body stays in the instruction cache)
__device__ __forceinline__ void rotate_acc32(float (&acc)[CL_MAX_CHUNKS][64]) {
  float t[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) t[i] = acc[0][i];
#pragma unroll
  for (int i = 0; i < 96; ++i)
    acc[i / 64][i % 64] = acc[(i + 32) / 64][(i + 32) % 64];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[1][32 + i] = t[i];
}

// where lane_col_sum's sum goes in a warp's column sums of the cluster
// kernel: df (slot 0) or df * xhat (slot 1), CL_MAXW columns each
__device__ __forceinline__ int cl_col_index(int lane, int ch, int j0,
                                            int ec) {
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
  return b3 * CL_MAXW + ch * N_TILE + 8 * (j0 + b4) + ec + b2;
}

// A row tile of the wide path: tile t of the b * ceil(N / 64) (in that
// order), or the padding tile that makes their count even (no rows)
struct RowTile {
  int cloud, n_valid;
  size_t row0;  // its first row in (b * n)
  __device__ RowTile(size_t t, int bsz, int n_points) {
    const int tiles = (n_points + ROWS - 1) / ROWS;
    cloud = static_cast<int>(t / tiles);
    const int r0 = static_cast<int>(t % tiles) * ROWS;
    n_valid = cloud < bsz ? min(ROWS, n_points - r0) : 0;
    cloud = min(cloud, bsz - 1);  // the padding tile's params: any cloud's
    row0 = static_cast<size_t>(cloud) * n_points + r0;
  }
};

// dy (b, n, c) -> bf16 tiles laid out as rows_packed_index (zeros past N
// and in the padding tile), and each tile's column sums of dy over its
// rows in order (db: part's first slot), for the `items` / (c / 8) tiles
// from tile0. One thread a tile's 8 columns
template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
    film_block_bwd_wide_pack_dy_kernel(const T* __restrict__ dy,
                                       __nv_bfloat16* __restrict__ packed,
                                       float* __restrict__ part, int bsz,
                                       int n_points, int c, long long tile0,
                                       long long items) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * RED_THREADS + threadIdx.x;
  if (idx >= items) return;
  const int groups = c / 8, gi = static_cast<int>(idx % groups);
  const size_t tile = static_cast<size_t>(tile0 + idx / groups);
  const RowTile rt(tile, bsz, n_points);
  const T* src = dy + rt.row0 * c + gi * 8;
  constexpr int U = 8;  // rows' loads in flight
  float db8[8] = {};
#pragma unroll 1
  for (int r0 = 0; r0 < ROWS; r0 += U) {
    Group<T> raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r0 + u < rt.n_valid)
        raw[u].load(src + static_cast<size_t>(r0 + u) * c);
      else
        raw[u].clear();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x[8];
      raw[u].unpack(x);
#pragma unroll
      for (int e = 0; e < 8; ++e) db8[e] += x[e];
      *reinterpret_cast<uint4*>(packed +
                                wide_a_offset(tile, r0 + u, gi * 8, c)) =
          pack_bf16x8(x);
    }
  }
  float4* dst = reinterpret_cast<float4*>(part + tile * NQ * c + gi * 8);
  dst[0] = make_float4(db8[0], db8[1], db8[2], db8[3]);
  dst[1] = make_float4(db8[4], db8[5], db8[6], db8[7]);
}

// The cluster kernel's product: acc[q] (64 x 128 a warpgroup) = the rows
// of warpgroup wg's tile times the CTA's chunk q < NB, over the k stages
// of the ring (load_stage(kt) asks for stage kt). The ring's uses are
// counted from g0 (a persistent CTA's earlier pairs took g0 of them), so
// that k stage kt is use g0 + kt of slot (g0 + kt) % CL_STAGES. Returns
// with every stage released and the accumulators final. kFirst: k tile 0
// goes first, its first step through wgmma_m64n128k16_first (the
// persistent kernel's accumulators hold the last pair's df until then).
template <int NB, bool kFirst, typename LoadStage>
__device__ __forceinline__ void cluster_product(
    uint32_t ring_base, uint64_t* full, uint64_t* empty, int k_tiles, int wg,
    int g0, const LoadStage& load_stage, float (&acc)[CL_MAX_CHUNKS][64]) {
  const int tid = threadIdx.x & 127;
  auto release = [&](int i) {
    const int g = g0 + i;
    if (tid == 0) mbar_arrive(&empty[g % CL_STAGES]);
    if (threadIdx.x == 0 && i + CL_STAGES < k_tiles) {
      mbar_wait(&empty[g % CL_STAGES], (g / CL_STAGES) & 1);
      load_stage(i + CL_STAGES);
    }
  };
  int kt = 0;
  if (kFirst) {
    const int st = g0 % CL_STAGES;
    mbar_wait(&full[st], (g0 / CL_STAGES) & 1);
    wgmma_fence();
    const uint32_t sb = ring_base + st * CL_STAGE;
    const uint64_t da = desc_sw128(sb + wg * WIDE_A_BYTES);
#pragma unroll
    for (int kk = 0; kk < K_TILE / 16; ++kk)
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const uint64_t db =
            desc_sw128(sb + 2 * WIDE_A_BYTES + q * TILE_BYTES) + 2 * kk;
        if (kk == 0)
          wgmma_m64n128k16_first(acc[q], da, db);
        else
          wgmma_m64n128k16(acc[q], da + 2 * kk, db, 1);
      }
    wgmma_commit();
    kt = 1;
  }
  for (; kt < k_tiles; ++kt) {
    const int st = (g0 + kt) % CL_STAGES;
    mbar_wait(&full[st], ((g0 + kt) / CL_STAGES) & 1);
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[q][i]);
    wgmma_fence();
    const uint32_t sb = ring_base + st * CL_STAGE;
    const uint64_t da = desc_sw128(sb + wg * WIDE_A_BYTES);
#pragma unroll
    for (int kk = 0; kk < K_TILE / 16; ++kk)
#pragma unroll
      for (int q = 0; q < NB; ++q)
        wgmma_m64n128k16(acc[q], da + 2 * kk,
                         desc_sw128(sb + 2 * WIDE_A_BYTES + q * TILE_BYTES) +
                             2 * kk,
                         (kt | kk) != 0);
    wgmma_commit();
    if (kt > 0) {
      wgmma_wait<1>();  // the previous stage's products are done
      release(kt - 1);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[q][i]);
  release(k_tiles - 1);
}

// The cluster kernel: grid (ncta x tile pairs) in clusters of ncta CTAs,
// over the pairs from pair0. The CTAs of a cluster share a pair of 64-row
// tiles; rank q owns the 128-column chunks [q nch / ncta, (q + 1) nch /
// ncta) of the nch = C / 128 and keeps that slice of dp in registers
// (warpgroup g: tile 2 pair + g).
// The rows' sums of dxhat and dxhat * xhat meet in distributed shared
// memory, added in rank order. kPersistent (above PORTABLE_C): the grid
// holds only the clusters the card runs at once, and each cluster takes
// pairs pair0 + *next_pair (its rank 0 counts them out) until pair_end,
// one after the other, so that no cluster waits to be placed and the
// block scheduler gives the SMs the clusters leave to the dW pass. Each
// pair's results do not depend on which cluster took it.
template <typename T, bool kPersistent>
__global__ void __launch_bounds__(THREADS, 1)
    film_block_bwd_cluster_kernel(const T* __restrict__ dy,
                                  const T* __restrict__ h,
                                  const float* __restrict__ s,
                                  const float* __restrict__ t,
                                  const T* __restrict__ gamma,
                                  const T* __restrict__ beta,
                                  const __nv_bfloat16* __restrict__ wt_packed,
                                  const __nv_bfloat16* __restrict__ dy_packed,
                                  const float* __restrict__ mean_in,
                                  const float* __restrict__ rstd_in,
                                  T* __restrict__ dh,
                                  __nv_bfloat16* __restrict__ p_packed,
                                  float* __restrict__ part, int bsz,
                                  int n_points, int c, int ncta,
                                  int pair0, int pair_end,
                                  int* __restrict__ next_pair) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ uint8_t smem_raw[];
  // the ring on a 1024-byte boundary (the swizzle repeats every 1024 bytes)
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* colred = reinterpret_cast<float*>(ring + cl_ring_bytes<T>());
  float* xsum = colred + 8 * 2 * CL_MAXW;  // the CTA's row sums: the cluster's
  float* rmean = xsum + CL_ROWS * 2;
  float* s_mean = rmean + CL_ROWS * 2;
  float* s_rstd = s_mean + CL_ROWS;
  float4* prm = reinterpret_cast<float4*>(s_rstd + CL_ROWS);  // [tile][col]
  uint64_t* full = reinterpret_cast<uint64_t*>(prm + 2 * CL_MAXW);
  uint64_t* empty = full + CL_STAGES;
  uint64_t* in_bar = empty + CL_STAGES;
  int* s_next = reinterpret_cast<int*>(in_bar + 1);  // rank 0's next pairs

  const int rank = static_cast<int>(cluster_ctarank());
  const int nch = c / N_TILE;
  const int ch0 = rank * nch / ncta;
  const int m = (rank + 1) * nch / ncta - ch0;  // this CTA's chunks
  const int k0 = ch0 * N_TILE, cw = m * N_TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int k_tiles = c / K_TILE;
  if (threadIdx.x == 0) {
    for (int i = 0; i < CL_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_init(in_bar, 1);
    mbar_fence_init();
    if (kPersistent && rank == 0) s_next[0] = atomicAdd(next_pair, 1);
  }
  if (kPersistent) {  // rank 0's first pair, seen by the cluster
    cluster_arrive();
    cluster_wait();
  }
  // a persistent cluster's it-th pair: one of the chunk's counter
  // (*next_pair), which rank 0 takes a pair ahead, into s_next[it % 2],
  // and the cluster reads from there (the cluster barrier in the middle
  // of each pair publishes the next); the ring's uses before it, g0
  for (int it = 0;; ++it) {
    long long pair_at = static_cast<long long>(pair0) + blockIdx.x / ncta;
    if (kPersistent) {
      pair_at = pair0 + ld_cluster_int(s_next + (it & 1), 0);
      if (pair_at >= pair_end) {  // every CTA has read rank 0's before it
        cluster_arrive();         // leaves
        cluster_wait();
        break;
      }
      if (rank == 0 && threadIdx.x == 0)
        s_next[(it + 1) & 1] = atomicAdd(next_pair, 1);
    }
    const size_t pair = static_cast<size_t>(pair_at);
    const int g0 = it * k_tiles;
    const RowTile rt0(2 * pair, bsz, n_points);
    const RowTile rt1(2 * pair + 1, bsz, n_points);
    // this warpgroup's tile, by reference: the two tiles then stay in local
    // memory and no register holds them through the product (copied into
    // registers, the kernel ran slower)
    const RowTile& mine = wg ? rt1 : rt0;
    // the pair's packed dy: two adjacent tiles
    const __nv_bfloat16* a_pair = dy_packed + 2 * pair * ROWS * c;

    // stage kt holds k block kt of both tiles of A and of the CTA's m
    // chunks of Wᵀ
    auto load_stage = [&](int kt) {
      const int st = (g0 + kt) % CL_STAGES;
      uint8_t* dst = ring + st * CL_STAGE;
      mbar_arrive_expect_tx(&full[st], 2 * WIDE_A_BYTES + m * TILE_BYTES);
      for (int g = 0; g < 2; ++g)
        bulk_copy_g2s(dst + g * WIDE_A_BYTES,
                      a_pair + static_cast<size_t>(g) * ROWS * c +
                          static_cast<size_t>(kt) * ROWS * K_TILE,
                      WIDE_A_BYTES, &full[st]);
      for (int q = 0; q < m; ++q)
        bulk_copy_g2s(dst + 2 * WIDE_A_BYTES + q * TILE_BYTES,
                      wt_packed + (static_cast<size_t>(ch0 + q) * k_tiles +
                                   kt) * N_TILE * K_TILE,
                      TILE_BYTES, &full[st]);
    };
    // the epilogue's h (the CTA's columns of the pair's rows): in L2 by the
    // time the product is done
    if (warp == 1)
      for (int q = 0; q < 2; ++q) {
        const RowTile& rt = q ? rt1 : rt0;
        for (int r = lane; r < rt.n_valid; r += 32)
          prefetch_l2(h + (rt.row0 + r) * c + k0,
                      static_cast<uint32_t>(cw * sizeof(T)));
      }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 0; i < CL_STAGES && i < k_tiles; ++i) load_stage(i);
    if (threadIdx.x < CL_ROWS) {
      const RowTile& rt = threadIdx.x < ROWS ? rt0 : rt1;
      const int r = threadIdx.x % ROWS;
      s_mean[threadIdx.x] = r < rt.n_valid ? mean_in[rt.row0 + r] : 0.0f;
      s_rstd[threadIdx.x] = r < rt.n_valid ? rstd_in[rt.row0 + r] : 0.0f;
    }
    for (int i = threadIdx.x; i < 2 * cw; i += THREADS) {
      const int q = i / cw, k = i % cw;
      const size_t pk = static_cast<size_t>((q ? rt1 : rt0).cloud) * c + k0 + k;
      // f = xhat (s (1 + g)) + (t (1 + g) + beta); s kept for dgamma
      const float g1 = 1.0f + to_f32(gamma[pk]);
      prm[q * CL_MAXW + k] = make_float4(s[k0 + k] * g1,
                                         t[k0 + k] * g1 + to_f32(beta[pk]),
                                         g1, s[k0 + k]);
    }

    // ---- dp = dy @ W: warpgroup wg computes its tile's rows of the CTA's
    // chunks (the chunk count a template argument: no branch between the
    // wgmma instructions)
    float acc[CL_MAX_CHUNKS][64];
    if (m == CL_MAX_CHUNKS)
      cluster_product<CL_MAX_CHUNKS, kPersistent>(
          smem_u32(ring), full, empty, k_tiles, wg, g0, load_stage, acc);
    else
      cluster_product<1, kPersistent>(smem_u32(ring), full, empty, k_tiles,
                                      wg, g0, load_stage, acc);

    // ---- the CTA's slices of the pair's packed dy (bf16, the dW pass's
    // byte order: one contiguous block a tile) and its columns of the pair's
    // h rows (one bulk copy a row, the row stride padded) into the ring, now
    // free; rows past N are zeros, so that the epilogues need no branch on
    // them
    __syncthreads();  // both warpgroups' products have read the ring
    const uint32_t dy_bytes = static_cast<uint32_t>(cw * ROWS * 2);
    uint8_t* dys = ring;  // tile q's packed dy at q dy_bytes, then p there
    T* hd = reinterpret_cast<T*>(ring + 2 * static_cast<size_t>(dy_bytes));
    const int h_ld = cw + CL_H_LD;
    if (warp == 0) {
      const uint32_t row_bytes = static_cast<uint32_t>(cw * sizeof(T));
      if (lane == 0) {
        mbar_arrive_expect_tx(
            in_bar, (rt0.n_valid + rt1.n_valid) * row_bytes + 2 * dy_bytes);
        for (int q = 0; q < 2; ++q)
          bulk_copy_g2s(dys + q * dy_bytes,
                        a_pair + static_cast<size_t>(q) * ROWS * c +
                            static_cast<size_t>(k0) * ROWS,
                        dy_bytes, in_bar);
      }
      __syncwarp();
      for (int q = 0; q < 2; ++q) {
        const RowTile& rt = q ? rt1 : rt0;
        for (int r = lane; r < rt.n_valid; r += 32)
          bulk_copy_g2s(hd + (q * ROWS + r) * h_ld, h + (rt.row0 + r) * c + k0,
                        row_bytes, in_bar);
      }
    }
    {
      const int per_row = cw * static_cast<int>(sizeof(T)) / 16;
      for (int idx = threadIdx.x; idx < CL_ROWS * per_row; idx += THREADS) {
        const int row = idx / per_row;
        if (row % ROWS >= (row < ROWS ? rt0 : rt1).n_valid)
          reinterpret_cast<uint4*>(hd + row * h_ld)[idx % per_row] =
              make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __syncthreads();
    mbar_wait(in_bar, it & 1);

    // ---- epilogue 1: df in place of dp, p (in place of dy), the row and
    // column sums; a loop over the accumulators' quarters (rotate_acc32),
    // straight-line code within one (the shuffles need a converged warp).
    // Thread (warp, lane) holds rows lr and lr + 8 of its warpgroup's tile
    // (the CTA's rows er, er + 8), the CTA's columns 8 j + ec, +1 of each
    // of its chunks
    const int lr = (warp & 3) * 16 + (lane >> 2);
    const int er = wg * ROWS + lr;
    const int ec = 2 * (lane & 3);
    float nm[2], rs[2];  // xhat = x rs + nm
  #pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rs[hr] = s_rstd[er + 8 * hr];
      nm[hr] = -s_mean[er + 8 * hr] * rs[hr];
    }
    __nv_bfloat16* a16 =
        reinterpret_cast<__nv_bfloat16*>(dys + wg * dy_bytes);
    const float4* prm_t = prm + wg * CL_MAXW;
    float m1[2] = {0.0f, 0.0f}, m2[2] = {0.0f, 0.0f};
    float* colred_w = colred + warp * 2 * CL_MAXW;
  #pragma unroll 1
    for (int it = 0; it < 4; ++it) {  // quarter it: chunk it / 2's column
      const int ch = it >> 1, jb = 8 * (it & 1);  // groups jb .. jb + 7
      if (ch < m) {
  #pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 2) {
        hoist_barrier();
        // the sums of df and df * xhat over this thread's two rows, for
        // column groups j0 and j0 + 1: v[4 jj + 2 q + e], q 0 df, 1 df * xhat
        float v[8] = {};
  #pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = j0 + jj;
          const int k = ch * N_TILE + 8 * (jb + j) + ec;
          const float4 p0 = prm_t[k], p1 = prm_t[k + 1];
          const float ak[2] = {p0.x, p1.x}, bk[2] = {p0.y, p1.y};
  #pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = lr + 8 * hr;
            const float2 xv = ld2(hd + (er + 8 * hr) * h_ld + k);
            // dy from the packed slice: exact for bf16 inputs, rounded to
            // bf16 for fp32 ones (the fp32 pass below adds what it took)
            __nv_bfloat16* a_rk = a16 + tile_offset(r, k);
            const float2 dv = ld2(a_rk);
            const float x[2] = {xv.x, xv.y}, d[2] = {dv.x, dv.y};
            float pv[2];
  #pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float xhat = fmaf(x[e], rs[hr], nm[hr]);
              const float f = fmaf(xhat, ak[e], bk[e]);
              const float sig = __fdividef(1.0f, 1.0f + __expf(-f));
              const float pf = f * sig;
              pv[e] = r < mine.n_valid ? pf : 0.0f;  // past N: nothing
              float& a = acc[0][4 * j + 2 * hr + e];
              // sig (1 + f (1 - sig)) = sig + p (1 - sig)
              const float df = fmaf(fmaf(-pf, sig, pf) + sig, a, d[e]);
              a = df;
              const float dx = df * ak[e];
              m1[hr] += dx;
              m2[hr] += dx * xhat;
              v[4 * jj + e] += df;
              v[4 * jj + 2 + e] += df * xhat;
            }
            store2(a_rk, pv[0], pv[1]);
          }
        }
        colred_w[cl_col_index(lane, ch, jb + j0, ec)] = lane_col_sum(v, lane);
      }
      }
      rotate_acc32(acc);
    }
    // fp32 inputs: add dy - bf16(dy), from device memory, to df and to its
    // row and column sums, as the register path's second pass does
    if constexpr (!kBf16) {
  #pragma unroll 1
      for (int it = 0; it < 4; ++it) {
        const int ch = it >> 1, jb = 8 * (it & 1);
        if (ch < m) {
  #pragma unroll
        for (int j0 = 0; j0 < 8; j0 += 2) {
          float v[8] = {};
  #pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = j0 + jj;
            const int k = ch * N_TILE + 8 * (jb + j) + ec;
            const float gs[2] = {prm_t[k].x, prm_t[k + 1].x};
  #pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int r = lr + 8 * hr;
              const float2 xv = ld2(hd + (er + 8 * hr) * h_ld + k);
              const float2 dv = r < mine.n_valid
                                    ? ld2(dy + (mine.row0 + r) * c + k0 + k)
                                    : make_float2(0.0f, 0.0f);
              const float x[2] = {xv.x, xv.y}, d[2] = {dv.x, dv.y};
  #pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float xhat = fmaf(x[e], rs[hr], nm[hr]);
                const float rem =
                    d[e] - __bfloat162float(__float2bfloat16_rn(d[e]));
                acc[0][4 * j + 2 * hr + e] += rem;
                const float dx = rem * gs[e];
                m1[hr] += dx;
                m2[hr] += dx * xhat;
                v[4 * jj + e] += rem;
                v[4 * jj + 2 + e] += rem * xhat;
              }
            }
          }
          colred_w[cl_col_index(lane, ch, jb + j0, ec)] +=
              lane_col_sum(v, lane);
        }
        }
        rotate_acc32(acc);
      }
    }
    // the rows' sums over the CTA's columns
  #pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
  #pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        m1[hr] += __shfl_xor_sync(0xffffffffu, m1[hr], o);
        m2[hr] += __shfl_xor_sync(0xffffffffu, m2[hr], o);
      }
      if ((lane & 3) == 0)
        *reinterpret_cast<float2*>(xsum + (er + 8 * hr) * 2) =
            make_float2(m1[hr], m2[hr]);
    }
    fence_proxy_async();  // p in place of dy: generic stores before the store
    __syncthreads();
    if (threadIdx.x == 0)
      for (int q = 0; q < 2; ++q)
        bulk_copy_s2g(p_packed + (2 * pair + q) * ROWS * c +
                          static_cast<size_t>(k0) * ROWS,
                      dys + q * dy_bytes, dy_bytes);
    // ---- the whole rows' sums: every CTA's, in rank order (the same order
    // in every CTA of the cluster, so that they agree to the bit)
    cluster_arrive();
    cluster_wait();
    if (threadIdx.x < CL_ROWS) {
      float s1 = 0.0f, s2 = 0.0f;
      for (int q = 0; q < ncta; ++q) {
        const float2 v = ld_cluster(xsum + threadIdx.x * 2, q);
        s1 += v.x;
        s2 += v.y;
      }
      *reinterpret_cast<float2*>(rmean + threadIdx.x * 2) =
          make_float2(s1 / c, s2 / c);
    }
    // this CTA has read the others' sums; no CTA leaves before the wait at
    // the end, so that its shared memory stays while another may read it
    cluster_arrive();

    // ---- each tile's sums of the CTA's columns: its 4 warps' in order (db
    // came from the dy pack)
    for (int i = threadIdx.x; i < 2 * cw; i += THREADS) {
      const int q = i / cw, k = i % cw;
      const float* cr = colred + 4 * q * 2 * CL_MAXW + k;
      float sq[2];
  #pragma unroll
      for (int e = 0; e < 2; ++e)
        sq[e] = ((cr[e * CL_MAXW] + cr[(2 + e) * CL_MAXW]) +
                 cr[(4 + e) * CL_MAXW]) +
                cr[(6 + e) * CL_MAXW];
      const float4 pk = prm[q * CL_MAXW + k];
      const float g1 = pk.z;
      float* part_t = part + (2 * pair + q) * NQ * c + k0 + k;
      part_t[c] = pk.w * sq[1] + t[k0 + k] * sq[0];  // dgamma: df * u
      part_t[2 * c] = sq[0];                    // dbeta
      part_t[3 * c] = g1 * sq[1];               // ds: du * xhat
      part_t[4 * c] = g1 * sq[0];               // dt: du
    }
    __syncthreads();  // the rows' means

    // ---- epilogue 2: dh from the registers, in place of h in shared
    // memory, then one bulk store a row
    float rm1[2], rm2[2];
  #pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rm1[hr] = rmean[(er + 8 * hr) * 2];
      rm2[hr] = rmean[(er + 8 * hr) * 2 + 1];
    }
  #pragma unroll 1
    for (int it = 0; it < 4; ++it) {
      const int ch = it >> 1, jb = 8 * (it & 1);
      if (ch < m) {
  #pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = ch * N_TILE + 8 * (jb + j) + ec;
        const float a0 = prm_t[k].x, a1 = prm_t[k + 1].x;
  #pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          T* hp = hd + (er + 8 * hr) * h_ld + k;
          const float2 x = ld2(hp);
          const float x0 = fmaf(x.x, rs[hr], nm[hr]);
          const float x1 = fmaf(x.y, rs[hr], nm[hr]);
          const float dx0 = acc[0][4 * j + 2 * hr] * a0;
          const float dx1 = acc[0][4 * j + 2 * hr + 1] * a1;
          store2(hp, rs[hr] * (dx0 - rm1[hr] - x0 * rm2[hr]),
                 rs[hr] * (dx1 - rm1[hr] - x1 * rm2[hr]));
        }
      }
      }
      rotate_acc32(acc);
    }
    fence_proxy_async();  // dh in shared memory before the bulk stores
    __syncthreads();
    if ((warp & 3) == 0) {  // warp 0 stores tile 0's rows, warp 4 tile 1's
      for (int r = lane; r < mine.n_valid; r += 32)
        bulk_copy_s2g(dh + (mine.row0 + r) * c + k0, hd + (er - lr + r) * h_ld,
                      static_cast<uint32_t>(cw * sizeof(T)));
      // the bulk stores (p, dh) have read shared memory before it is freed
      bulk_store_wait_read();
    }
    cluster_wait();
    if (!kPersistent) break;
  }
}

// Holds its stream until *next_pair is set: the overlapped path's dW pass
// of a chunk waits behind it for the next chunk's rows pass to begin, so
// that the dW blocks, launched when the SMs of the chunk's clusters come
// free, do not take them before the next clusters are placed (a cluster
// kernel with clusters still to place goes first: its stream's priority
// is greater).
__global__ void film_block_bwd_gate_kernel(const int* next_pair) {
  while (*reinterpret_cast<const volatile int*>(next_pair) == 0)
    __nanosleep(256);
}

// the cluster kernel's launch in `clusters` clusters: its shared memory
// allowed, clusters of more than 8 CTAs allowed (C > 2048; without the
// attribute both the occupancy query and the launch refuse them), the grid
// and the cluster shape; `cfg` points into `attr`
template <typename T, bool kPersistent>
cudaError_t cluster_config(int c, long long clusters, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  auto* kernel = film_block_bwd_cluster_kernel<T, kPersistent>;
  const size_t smem = cluster_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  const int ncta = cluster_ctas(c);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(ncta * clusters));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(ncta);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// clusters of the kernel at width c that the current device holds at once
template <typename T, bool kPersistent>
cudaError_t cluster_capacity(int c, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T, kPersistent>(c, 1, nullptr, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(
      clusters, film_block_bwd_cluster_kernel<T, kPersistent>, &cfg);
}

// a call's operands, its workspace's regions and its shape
struct BwdCall {
  const void *dy, *h, *s, *t, *gamma, *beta, *mean, *rstd;
  void* dh;
  const __nv_bfloat16* wt_packed;
  __nv_bfloat16 *p_packed, *dy_packed;
  float *part, *ws_dw;
  int* next_pair;  // a pair counter a row chunk (the overlapped path)
  int b, n, c;
};

// the dy pack (with db's tile sums) of `tiles` row tiles from tile0
template <typename T>
cudaError_t launch_pack_dy(const BwdCall& a, long long tile0,
                           long long tiles, cudaStream_t stream) {
  const long long items = tiles * (a.c / 8);
  film_block_bwd_wide_pack_dy_kernel<T>
      <<<cdiv(items, RED_THREADS), RED_THREADS, 0, stream>>>(
          static_cast<const T*>(a.dy), a.dy_packed, a.part, a.b, a.n, a.c,
          tile0, items);
  return cudaGetLastError();
}

// the cluster kernel over the pairs [pair0, pair_end): one cluster a
// pair, or (kPersistent) `clusters` clusters that take them in turn
template <typename T, bool kPersistent>
cudaError_t launch_cluster(const BwdCall& a, long long pair0,
                           long long pair_end, long long clusters,
                           int* next_pair, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T, kPersistent>(
      a.c, kPersistent ? clusters : pair_end - pair0, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  auto* kernel = film_block_bwd_cluster_kernel<T, kPersistent>;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.dy), static_cast<const T*>(a.h),
      static_cast<const float*>(a.s), static_cast<const float*>(a.t),
      static_cast<const T*>(a.gamma), static_cast<const T*>(a.beta),
      a.wt_packed, static_cast<const __nv_bfloat16*>(a.dy_packed),
      static_cast<const float*>(a.mean), static_cast<const float*>(a.rstd),
      static_cast<T*>(a.dh), a.p_packed, a.part, a.b, a.n, a.c,
      cluster_ctas(a.c), static_cast<int>(pair0),
      static_cast<int>(pair_end), next_pair);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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

// The dW pass's shape, fixed by (b, n, c): p's chunks a block (nb), its
// output tiles, and its slices of the row tiles.
// Up to PORTABLE_C: 128 x 256 tiles where C % 256 == 0, else 128 x 128,
// sliced into about DW_BLOCKS blocks (per_slice row tiles a slice). Above
// PORTABLE_C the rows pass runs in `chunks` chunks of its pairs, each
// chunk's dW beside the next chunk's rows (launch_overlapped): 128 x 256
// tiles at every C (the last column tile stores 128 columns where C % 256
// != 0), one block a tile over the chunk's row tiles, adding to the
// chunks before it (one slice): beside the clusters the dW blocks run on
// the SMs those leave, where waves of DW_BLOCKS mean nothing, and 4
// slices a chunk (924 blocks at 2688, 7 whole waves when the last chunk
// runs alone) were slower than one.
struct DwSplit {
  int nb, out_tiles, per_slice, slices, chunks;
};

DwSplit dw_split(int b, int n, int c) {
  DwSplit d;
  if (c <= PORTABLE_C) {
    d.nb = c % (2 * N_TILE) == 0 ? 2 : 1;
    d.out_tiles = (c / DW_M) * (c / (N_TILE * d.nb));
    const int tiles = b * cdiv(n, ROWS);
    const int want =
        DW_BLOCKS / d.out_tiles > 1 ? DW_BLOCKS / d.out_tiles : 1;
    d.per_slice = cdiv(tiles, want < tiles ? want : tiles);
    d.slices = cdiv(tiles, d.per_slice);
    d.chunks = 1;
    return d;
  }
  d.nb = 2;
  d.out_tiles = (c / DW_M) * cdiv(c, 2 * N_TILE);
  d.per_slice = 0;  // a chunk's row tiles
  d.slices = 1;
  const long long pairs = wide_tiles(b, n) / 2;
  d.chunks = static_cast<int>(pairs < BWD_CHUNKS ? pairs : BWD_CHUNKS);
  return d;
}

// region offsets in floats: the slices' dW, the tile sums, the cloud sums,
// packed p, packed dy, packed Wᵀ, the overlapped path's flags (above
// PORTABLE_C), and the end. Every region is a multiple
// of 4 floats, so each starts 16-byte aligned. The wide path pads its row
// tiles to an even count (the cluster kernel's pairs).
enum { R_DW, R_PART, R_CLOUD, R_P, R_DY, R_WT, R_GATE, R_END };

void regions(int b, int n, int c, long long (&off)[R_END + 1]) {
  const long long tiles = c > MAX_C ? wide_tiles(b, n)
                                    : static_cast<long long>(b) * cdiv(n, ROWS);
  const long long packed = tiles * ROWS * c / 2;  // bf16 in floats
  off[R_DW] = 0;
  off[R_PART] = off[R_DW] + static_cast<long long>(dw_split(b, n, c).slices) *
                                c * c;
  off[R_CLOUD] = off[R_PART] + tiles * NQ * c;
  off[R_P] = off[R_CLOUD] + static_cast<long long>(b) * NQ * c;
  off[R_DY] = off[R_P] + packed;
  off[R_WT] = off[R_DY] + packed;
  off[R_GATE] = off[R_WT] + static_cast<long long>(c) * c / 2;
  // above PORTABLE_C: the chunks' pair counters (ints), padded to 16 bytes
  off[R_END] = off[R_GATE] + (c > PORTABLE_C ? (BWD_CHUNKS + 3) / 4 * 4 : 0);
}

// the dW pass over the row tiles [tile_begin, tile_end) in d.slices
// slices of per_slice tiles (grid (out_tiles, slices)); above PORTABLE_C
// adding to the sums in ws_dw where `accumulate` is set
template <int NB, bool kChunked>
cudaError_t launch_dw_kernel(const BwdCall& a, const DwSplit& d,
                             int tile_begin, int tile_end, int per_slice,
                             int accumulate, cudaStream_t stream) {
  auto* kernel = film_block_bwd_dw_kernel<NB, kChunked>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dw_smem_bytes<NB>()));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(d.out_tiles, d.slices), THREADS, dw_smem_bytes<NB>(),
           stream>>>(a.dy_packed, a.p_packed, a.ws_dw, tile_begin, tile_end,
                     a.c, per_slice, accumulate);
  return cudaGetLastError();
}

cudaError_t launch_dw(const BwdCall& a, const DwSplit& d, int tile_begin,
                      int tile_end, int per_slice, int accumulate,
                      cudaStream_t stream) {
  if (a.c > PORTABLE_C)
    return launch_dw_kernel<2, true>(a, d, tile_begin, tile_end, per_slice,
                                     accumulate, stream);
  if (d.nb == 2)
    return launch_dw_kernel<2, false>(a, d, tile_begin, tile_end, per_slice,
                                      0, stream);
  return launch_dw_kernel<1, false>(a, d, tile_begin, tile_end, per_slice, 0,
                                    stream);
}

// The overlapped wide path's side stream on each device, created once at
// the greatest priority for the rows pass; the events that order it and
// the caller's stream; and the clusters the card holds at once, by dtype
// and width (asked once). One call enqueues at a time.
struct Overlap {
  cudaStream_t side;
  cudaEvent_t packed[BWD_CHUNKS], rows[BWD_CHUNKS];
  int clusters[2][WIDE_MAX_C_BWD / N_TILE + 1];
};
constexpr int MAX_DEVICES = 64;

std::mutex& overlap_mutex() {
  static std::mutex mu;
  return mu;
}

cudaError_t overlap_for_device(Overlap** out) {
  static Overlap per[MAX_DEVICES];
  static bool made[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Overlap& o = per[dev];
  if (!made[dev]) {
    int least = 0, greatest = 0;
    if ((err = cudaDeviceGetStreamPriorityRange(&least, &greatest)) !=
            cudaSuccess ||
        (err = cudaStreamCreateWithPriority(&o.side, cudaStreamNonBlocking,
                                            greatest)) != cudaSuccess)
      return err;
    for (int i = 0; i < BWD_CHUNKS; ++i) {
      if ((err = cudaEventCreateWithFlags(&o.packed[i],
                                          cudaEventDisableTiming)) !=
              cudaSuccess ||
          (err = cudaEventCreateWithFlags(&o.rows[i],
                                          cudaEventDisableTiming)) !=
              cudaSuccess)
        return err;
    }
    for (auto& by_dtype : o.clusters)
      for (int& n : by_dtype) n = 0;
    made[dev] = true;
  }
  *out = &o;
  return cudaSuccess;
}

// The wide path above PORTABLE_C. The card holds only 7-9 clusters of its
// 9-11 CTAs at once, which leaves 51-62 of its 132 SMs without a cluster,
// so the pairs run in d.chunks chunks: `stream` packs each chunk's dy
// (the later packs beside the first chunk's rows pass), the side stream
// runs chunk i's rows pass once its dy is packed, as a persistent
// cluster kernel of as many clusters as the card holds at once (the
// block scheduler places no waiting block of a lower priority while one
// of a higher waits, so a cluster kernel with clusters still to place
// kept the dW pass from the SMs it left), and `stream` runs chunk i's dW
// pass once its rows are done and chunk i + 1's rows pass has begun
// (film_block_bwd_gate_kernel), beside it on the SMs the clusters leave.
// Chunk i's dW adds to chunk i - 1's (the same order in every launch, so
// two launches are bitwise equal).
// `stream` waits for the side stream's last chunk before it returns to
// the caller's work.
template <typename T>
cudaError_t launch_overlapped(const BwdCall& a, const DwSplit& d,
                              cudaStream_t stream) {
  std::lock_guard<std::mutex> lock(overlap_mutex());
  Overlap* o = nullptr;
  cudaError_t err = overlap_for_device(&o);
  if (err != cudaSuccess) return err;
  int& held = o->clusters[std::is_same<T, float>::value][a.c / N_TILE];
  if (held == 0 &&
      (err = cluster_capacity<T, true>(a.c, &held)) != cudaSuccess)
    return err;
  if (held <= 0) return cudaErrorInvalidConfiguration;
  const long long pairs = wide_tiles(a.b, a.n) / 2;
  const long long tiles = static_cast<long long>(a.b) * cdiv(a.n, ROWS);
  auto first_pair = [&](int i) { return pairs * i / d.chunks; };
  if ((err = cudaMemsetAsync(a.next_pair, 0, d.chunks * sizeof(int),
                             stream)) != cudaSuccess)
    return err;
  for (int i = 0; i < d.chunks; ++i) {
    const long long p0 = first_pair(i), p1 = first_pair(i + 1);
    if ((err = launch_pack_dy<T>(a, 2 * p0, 2 * (p1 - p0), stream)) !=
            cudaSuccess ||
        (err = cudaEventRecord(o->packed[i], stream)) != cudaSuccess)
      return err;
  }
  for (int i = 0; i < d.chunks; ++i) {
    const long long p0 = first_pair(i), p1 = first_pair(i + 1);
    const long long clusters = p1 - p0 < held ? p1 - p0 : held;
    if ((err = cudaStreamWaitEvent(o->side, o->packed[i], 0)) !=
            cudaSuccess ||
        (err = launch_cluster<T, true>(a, p0, p1, clusters, a.next_pair + i,
                                       o->side)) != cudaSuccess ||
        (err = cudaEventRecord(o->rows[i], o->side)) != cudaSuccess)
      return err;
  }
  for (int i = 0; i < d.chunks; ++i) {
    const long long t0 = 2 * first_pair(i) < tiles ? 2 * first_pair(i)
                                                   : tiles;
    const long long t1 = 2 * first_pair(i + 1) < tiles
                             ? 2 * first_pair(i + 1)
                             : tiles;
    if ((err = cudaStreamWaitEvent(stream, o->rows[i], 0)) != cudaSuccess)
      return err;
    if (i + 1 < d.chunks) {
      film_block_bwd_gate_kernel<<<1, 1, 0, stream>>>(a.next_pair + i + 1);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if ((err = launch_dw(a, d, static_cast<int>(t0), static_cast<int>(t1),
                         cdiv(t1 - t0, d.slices), i > 0, stream)) !=
        cudaSuccess)
      return err;
  }
  return cudaSuccess;
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
  float* per_cloud = base + off[R_CLOUD];
  BwdCall a{dy, h, s, t, gamma, beta, mean, rstd, dh,
            reinterpret_cast<__nv_bfloat16*>(base + off[R_WT]),
            reinterpret_cast<__nv_bfloat16*>(base + off[R_P]),
            reinterpret_cast<__nv_bfloat16*>(base + off[R_DY]),
            base + off[R_PART], base + off[R_DW],
            reinterpret_cast<int*>(base + off[R_GATE]), b, n, c};
  auto* wt_packed = reinterpret_cast<__nv_bfloat16*>(base + off[R_WT]);
  const int tiles = cdiv(n, ROWS);
  const DwSplit d = dw_split(b, n, c);

  film_block_bwd_pack_wt_kernel<<<cdiv(static_cast<long long>(c) * (c / 8),
                                       RED_THREADS),
                                  RED_THREADS, 0, stream>>>(
      static_cast<const float*>(w), wt_packed, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (c > PORTABLE_C) {
    if ((err = launch_overlapped<T>(a, d, stream)) != cudaSuccess)
      return static_cast<int>(err);
  } else {
    if (c > MAX_C) {
      // the dy pack (with db's tile sums), then the cluster kernel
      if ((err = launch_pack_dy<T>(a, 0, wide_tiles(b, n), stream)) !=
              cudaSuccess ||
          (err = launch_cluster<T, false>(a, 0, wide_tiles(b, n) / 2, 0,
                                          nullptr, stream)) != cudaSuccess)
        return static_cast<int>(err);
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
          static_cast<const T*>(gamma), static_cast<const T*>(beta),
          wt_packed, static_cast<const float*>(mean),
          static_cast<const float*>(rstd), static_cast<T*>(dh), a.p_packed,
          a.dy_packed, a.part, n, c);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
    }
    if ((err = launch_dw(a, d, 0, b * tiles, d.per_slice, 0, stream)) !=
        cudaSuccess)
      return static_cast<int>(err);
  }

  film_block_bwd_sum_kernel<<<
      dim3(cdiv(static_cast<long long>(c) * c, RED_THREADS), 1), RED_THREADS,
      0, stream>>>(a.ws_dw, static_cast<float*>(dw), d.slices, c * c, 0, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  film_block_bwd_sum_kernel<<<dim3(cdiv(NQ * c, RED_THREADS), b),
                              RED_THREADS, 0, stream>>>(
      a.part, per_cloud, tiles, NQ * c,
      static_cast<long long>(tiles) * NQ * c, static_cast<long long>(NQ) * c);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  film_block_bwd_finalize_kernel<T>
      <<<cdiv(c, RED_THREADS), RED_THREADS, 0, stream>>>(
          per_cloud, static_cast<T*>(dg), static_cast<T*>(dbe),
          static_cast<float*>(db), static_cast<float*>(ds),
          static_cast<float*>(dt), b, c);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int b, int n, int c) {
  return b <= 0 || n <= 0 || c <= 0 || c % N_TILE != 0 ||
         c > WIDE_MAX_C_BWD || b > 65535 ||
         static_cast<long long>(b) * cdiv(n, ROWS) * ROWS > 0x7fffffffLL;
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

// How pcfm_film_block_bwd runs (b, n, c), for reports and tests: out[0..5]
// = the cluster kernel's CTAs a cluster (0 on the register path), the row
// chunks, and the dW pass's p chunks a block, output tiles, slices and
// blocks (each row chunk's). Returns
// -1 for a shape the kernel does not take, else 0.
extern "C" int pcfm_film_block_bwd_plan(int b, int n, int c,
                                        long long* out) {
  if (bad_shape(b, n, c)) return -1;
  const DwSplit d = dw_split(b, n, c);
  out[0] = c > MAX_C ? cluster_ctas(c) : 0;
  out[1] = d.chunks;
  out[2] = d.nb;
  out[3] = d.out_tiles;
  out[4] = d.slices;
  out[5] = static_cast<long long>(d.out_tiles) * d.slices;
  return 0;
}

// Clusters of the wide path's cluster kernel at width c that the current
// device can hold at once (cudaOccupancyMaxActiveClusters); 0 where it
// holds none, and for c <= MAX_C (no cluster); minus a cudaError_t code on
// an error.
extern "C" int pcfm_film_block_bwd_max_clusters(int c, int is_bf16) {
  if (bad_shape(1, 1, c)) return -static_cast<int>(cudaErrorInvalidValue);
  if (c <= MAX_C) return 0;
  int clusters = 0;
  const cudaError_t err =
      is_bf16 ? cluster_capacity<__nv_bfloat16, false>(c, &clusters)
              : cluster_capacity<float, false>(c, &clusters);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// Plain C entry point (bound with ctypes). Device pointers of contiguous
// tensors: dy, h, dh (b, n, c) and gamma, beta, dgamma, dbeta (b, c) in
// bf16 when is_bf16 else fp32; s, t (c,), w (c, c) (out x in), mean, rstd
// (b, n), dw (c, c), db, ds, dt (c,) and the workspace in fp32. Launches the
// Wᵀ pack, the rows pass (C > MAX_C: the dy pack and the cluster kernel),
// the dW pass and three fixed-order reductions on `stream` (C > 2048: the
// cluster kernel's chunks on a side stream of this device, which `stream`
// waits for), does not synchronise, returns a cudaError_t code.
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
