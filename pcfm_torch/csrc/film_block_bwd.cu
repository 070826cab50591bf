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
// dgamma = sum df * u, dbeta = sum df over each cloud's N rows.
//
// Design (simple, right and deterministic first; no float atomics):
//   * rows pass: a block owns ROWS = 64 rows of ONE cloud (the forward's
//     tile). dy goes to shared memory as the bf16 A operand of dp = dy @ W
//     (wmma bf16 x bf16 -> fp32; W streamed in 32 x 128 tiles of a bf16
//     copy made once per call), the whole 64 x C fp32 dp stays in shared
//     memory (C <= 512: 204 KB), each warp turns its rows' dp into df,
//     writes dh and p = silu(f) (bf16, the dW pass's operand), then each
//     thread sums its columns over the tile's rows and writes the tile's
//     five partial sums (db, dgamma, dbeta, ds, dt) to a workspace. Masked
//     rows of the ragged last tile are never read and add nothing;
//   * dW pass: a bf16 GEMM. A block owns a 128 x 128 tile of dW and one of
//     SPLIT_K = 32 fixed slices of the B * N rows; it stages dy and p in
//     64-row steps (16-byte loads) and accumulates dy^T p with wmma, then
//     writes its slice's partial tile to the workspace. Blocks of one slice
//     are neighbours in the grid, so they share that slice's rows in L2;
//   * reductions: the SPLIT_K partial dW tiles, the per-tile partials of
//     each cloud and then the per-cloud sums are added in a fixed order by
//     small kernels. The result is bitwise reproducible.
//
// Workspace (one fp32 buffer, sized by pcfm_film_block_bwd_workspace):
// SPLIT_K * C * C for dW (32 MiB at C = 512), B * ceil(N / 64) * 5 * C for
// the tile partials (24.5 MiB at (8, 20000, 512)), B * 5 * C per cloud and
// p, B * N * C in bf16 (156 MiB at (8, 20000, 512)), and the bf16 W.
//
// What bounds it at (B, N, C) = (8, 20000, 512): it reads dy and h and
// writes dh and p in the rows pass, reads dy and p in the dW pass (~0.8 GB
// in bf16, ~0.25 ms at 3.35 TB/s) and does two C x C products over 160k
// rows, 168 GFLOP (~0.17 ms at 989 TFLOP/s dense bf16). What this design
// leaves open: wmma instead of wgmma, no TMA or cp.async pipeline, one
// rows block per SM (204 KB of shared memory), W re-read from L2 by every
// rows block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "film_common.cuh"

using namespace nvcuda;

namespace {

constexpr int ROWS = 64;            // rows (points) of one cloud per block
constexpr int THREADS = 256;        // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int NCHUNK = 128;         // dp columns per GEMM pass
constexpr int KCHUNK = 32;          // reduction depth of one staged W tile
constexpr int A_PAD = 8;            // bf16 row padding of the A operand
constexpr int B_LD = NCHUNK + 8;    // W tile, row-major [KCHUNK][B_LD]
constexpr int D_PAD = 4;            // fp32 row padding of dp / df
constexpr int MAX_C = 512;          // A operand + fp32 dp must fit
constexpr int NQ = 5;               // tile partials: db, dgamma, dbeta, ds, dt
constexpr int TILE = 128;           // dW output tile (out x in)
constexpr int KT = 64;              // rows per dW step
constexpr int T_LD = TILE + 8;      // bf16 staging of dy / p: [KT][T_LD]
constexpr int SPLIT_K = 32;         // fixed row slices of the dW sum
constexpr int RED_THREADS = 256;

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

size_t rows_smem_bytes(int c) {
  return static_cast<size_t>(ROWS) * (c + A_PAD) * sizeof(__nv_bfloat16) +
         static_cast<size_t>(KCHUNK) * B_LD * sizeof(__nv_bfloat16) +
         static_cast<size_t>(ROWS) * (c + D_PAD) * sizeof(float) +
         2 * ROWS * sizeof(float);
}

// 32 x 128 tile of the bf16 copy of W (rows k0.. = output features,
// columns n0.. = input features) into registers: 512 16-byte words, two
// per thread
__device__ __forceinline__ void load_w_tile(
    const __nv_bfloat16* __restrict__ w, int c, int k0, int n0,
    uint4 (&pre)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int k = idx >> 4, n8 = idx & 15;
    pre[i] = *reinterpret_cast<const uint4*>(
        w + static_cast<size_t>(k0 + k) * c + n0 + n8 * 8);
  }
}

__device__ __forceinline__ void store_w_tile(__nv_bfloat16* ws,
                                             const uint4 (&pre)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int k = idx >> 4, n8 = idx & 15;
    *reinterpret_cast<uint4*>(ws + k * B_LD + n8 * 8) = pre[i];
  }
}

// 8 consecutive values as 8 bf16 in one 16-byte word
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* src) {
  return *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ uint4 load8_bf16(const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
  o[0] = __floats2bfloat162_rn(a.x, a.y);
  o[1] = __floats2bfloat162_rn(a.z, a.w);
  o[2] = __floats2bfloat162_rn(b.x, b.y);
  o[3] = __floats2bfloat162_rn(b.z, b.w);
  return out;
}

// Rows pass: dh and the per-tile partial sums. Grid (ceil(N / ROWS), B).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    film_block_bwd_rows_kernel(const T* __restrict__ dy,
                               const T* __restrict__ h,
                               const float* __restrict__ s,
                               const float* __restrict__ t,
                               const T* __restrict__ gamma,
                               const T* __restrict__ beta,
                               const __nv_bfloat16* __restrict__ w,
                               const float* __restrict__ mean_in,
                               const float* __restrict__ rstd_in,
                               T* __restrict__ dh,
                               __nv_bfloat16* __restrict__ p_out,
                               float* __restrict__ part, int n_points,
                               int c) {
  // every region starts on a 128-byte boundary for c % 128 == 0
  extern __shared__ __align__(128) unsigned char smem[];
  const int a_ld = c + A_PAD, d_ld = c + D_PAD;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = as + ROWS * a_ld;
  float* dps = reinterpret_cast<float*>(ws + KCHUNK * B_LD);
  float* s_mean = dps + ROWS * d_ld;
  float* s_rstd = s_mean + ROWS;

  const int row0 = blockIdx.x * ROWS;
  const int n_valid = min(ROWS, n_points - row0);
  const size_t tile_row0 = static_cast<size_t>(blockIdx.y) * n_points + row0;
  const T* g_c = gamma + static_cast<size_t>(blockIdx.y) * c;
  const T* be_c = beta + static_cast<size_t>(blockIdx.y) * c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // for bf16 dy the A operand holds it exactly: the later passes read it
  // there instead of from device memory
  constexpr bool kDyInSmem = std::is_same<T, __nv_bfloat16>::value;

  // 1. dy -> bf16 A operand, statistics -> shared memory; masked rows 0
  for (int r = warp; r < ROWS; r += WARPS) {
    for (int k8 = lane; k8 < c / 8; k8 += 32) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < n_valid) v = load8_bf16(dy + (tile_row0 + r) * c + k8 * 8);
      *reinterpret_cast<uint4*>(as + r * a_ld + k8 * 8) = v;
    }
  }
  if (threadIdx.x < ROWS) {
    const int r = threadIdx.x;
    s_mean[r] = r < n_valid ? mean_in[tile_row0 + r] : 0.0f;
    s_rstd[r] = r < n_valid ? rstd_in[tile_row0 + r] : 0.0f;
  }
  __syncthreads();

  // 2. dp = dy @ W, 128 columns at a time; B(k, n) = W[k, n] is row-major
  const int wr = warp >> 1;  // this warp's 16-row slice of the tile
  const int wc = warp & 1;   // and its 64-column half of the chunk
  for (int n0 = 0; n0 < c; n0 += NCHUNK) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
    uint4 pre[2];
    load_w_tile(w, c, 0, n0, pre);
    for (int k0 = 0; k0 < c; k0 += KCHUNK) {
      __syncthreads();  // the previous W tile is consumed
      store_w_tile(ws, pre);
      __syncthreads();
      if (k0 + KCHUNK < c) load_w_tile(w, c, k0 + KCHUNK, n0, pre);
#pragma unroll
      for (int kk = 0; kk < KCHUNK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::load_matrix_sync(a, as + (wr * 16) * a_ld + k0 + kk, a_ld);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              bf;
          wmma::load_matrix_sync(bf, ws + kk * B_LD + wc * 64 + j * 16,
                                 B_LD);
          wmma::mma_sync(acc[j], a, bf, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(dps + (wr * 16) * d_ld + n0 + wc * 64 + j * 16,
                              acc[j], d_ld, wmma::mem_row_major);
  }
  __syncthreads();

  // 3. one warp per row: df (kept in place of dp), p, the row means, dh
  for (int r = warp; r < n_valid; r += WARPS) {
    const T* h_row = h + (tile_row0 + r) * c;
    const T* dy_row = dy + (tile_row0 + r) * c;
    const __nv_bfloat16* a_row = as + r * a_ld;
    __nv_bfloat16* p_row = p_out + (tile_row0 + r) * c;
    float* d_row = dps + r * d_ld;
    const float mean = s_mean[r], rstd = s_rstd[r];
    float m1 = 0.0f, m2 = 0.0f;
    for (int k = lane; k < c; k += 32) {
      const float xhat = (to_f32(h_row[k]) - mean) * rstd;
      const float g1 = 1.0f + to_f32(g_c[k]);
      const float f = (xhat * s[k] + t[k]) * g1 + to_f32(be_c[k]);
      const float sig = 1.0f / (1.0f + expf(-f));
      p_row[k] = __float2bfloat16(f * sig);
      const float dyk =
          kDyInSmem ? __bfloat162float(a_row[k]) : to_f32(dy_row[k]);
      const float df = dyk + sig * (1.0f + f * (1.0f - sig)) * d_row[k];
      d_row[k] = df;
      const float dxhat = df * g1 * s[k];
      m1 += dxhat;
      m2 += dxhat * xhat;
    }
    m1 = warp_sum(m1) / c;
    m2 = warp_sum(m2) / c;
    T* dh_row = dh + (tile_row0 + r) * c;
    for (int k = lane; k < c; k += 32) {
      const float xhat = (to_f32(h_row[k]) - mean) * rstd;
      const float dxhat = d_row[k] * (1.0f + to_f32(g_c[k])) * s[k];
      dh_row[k] = from_f32<T>(rstd * (dxhat - m1 - xhat * m2));
    }
  }
  __syncthreads();

  // 4. one thread per column: this tile's sums over its valid rows
  float* part_t =
      part + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                 NQ * c;
  for (int k = threadIdx.x; k < c; k += THREADS) {
    const float g1 = 1.0f + to_f32(g_c[k]), sk = s[k], tk = t[k];
    float db = 0.0f, dg = 0.0f, dbe = 0.0f, dsk = 0.0f, dtk = 0.0f;
    for (int r = 0; r < n_valid; ++r) {
      const size_t off = (tile_row0 + r) * c + k;
      const float xhat = (to_f32(h[off]) - s_mean[r]) * s_rstd[r];
      const float df = dps[r * d_ld + k];
      const float du = df * g1;
      db += kDyInSmem ? __bfloat162float(as[r * a_ld + k])
                      : to_f32(dy[off]);
      dg += df * (xhat * sk + tk);
      dbe += df;
      dsk += du * xhat;
      dtk += du;
    }
    part_t[k] = db;
    part_t[c + k] = dg;
    part_t[2 * c + k] = dbe;
    part_t[3 * c + k] = dsk;
    part_t[4 * c + k] = dtk;
  }
}

// Rows r0.. (< r_end) of a (rows x c) matrix, columns col0..col0+127,
// into a bf16 [KT][T_LD] tile; rows past r_end are zero
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int c,
                                          int col0, int r0, int r_end) {
  for (int idx = threadIdx.x; idx < KT * TILE / 8; idx += THREADS) {
    const int rr = idx / (TILE / 8), v = idx % (TILE / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + rr < r_end)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(r0 + rr) * c + col0 + v * 8);
    *reinterpret_cast<uint4*>(dst + rr * T_LD + v * 8) = val;
  }
}

__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const float* src, int c, int col0,
                                          int r0, int r_end) {
  for (int e = threadIdx.x; e < KT * TILE; e += THREADS) {
    const int rr = e / TILE, col = e % TILE;
    const float v = r0 + rr < r_end
                        ? src[static_cast<size_t>(r0 + rr) * c + col0 + col]
                        : 0.0f;
    dst[rr * T_LD + col] = __float2bfloat16(v);
  }
}

// dW pass: one 128 x 128 tile of dW = dy^T p (out x in) over one row
// slice. Grid ((C / 128)^2, SPLIT_K); writes ws_dw[slice] (C x C).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    film_block_bwd_dw_kernel(const T* __restrict__ dy,
                             const __nv_bfloat16* __restrict__ p,
                             float* __restrict__ ws_dw, int rows, int c,
                             int rows_per_slice) {
  __shared__ __align__(128) __nv_bfloat16 dyt[KT * T_LD];  // A, col-major
  __shared__ __align__(128) __nv_bfloat16 pt[KT * T_LD];   // B, row-major

  const int tiles_in = c / TILE;
  const int o0 = (blockIdx.x / tiles_in) * TILE;
  const int i0 = (blockIdx.x % tiles_in) * TILE;
  const int r_begin = blockIdx.y * rows_per_slice;
  const int r_end = min(rows, r_begin + rows_per_slice);
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;  // 32 output rows (out features)
  const int wn = warp & 1;   // 64 output columns (in features)

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int r0 = r_begin; r0 < r_end; r0 += KT) {
    __syncthreads();  // the previous step's tiles are consumed
    load_tile(dyt, dy, c, o0, r0, r_end);
    load_tile(pt, p, c, i0, r0, r_end);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      // A(m, k) = dy[row k, out m]: column-major with leading dim T_LD
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], dyt + kk * T_LD + wm * 32 + i * 16,
                               T_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bf;
        wmma::load_matrix_sync(bf, pt + kk * T_LD + wn * 64 + j * 16, T_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], bf,
                                                   acc[i][j]);
      }
    }
  }
  float* out = ws_dw + static_cast<size_t>(blockIdx.y) * c * c;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(
          out + static_cast<size_t>(o0 + wm * 32 + i * 16) * c + i0 +
              wn * 64 + j * 16,
          acc[i][j], c, wmma::mem_row_major);
}

// the bf16 copy of W that every rows block reads
__global__ void __launch_bounds__(RED_THREADS)
    film_block_bwd_w_bf16_kernel(const float* __restrict__ w,
                                 __nv_bfloat16* __restrict__ out, int n) {
  const int i = blockIdx.x * RED_THREADS + threadIdx.x;
  if (i < n) out[i] = __float2bfloat16(w[i]);
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

struct Workspace {
  float* dw_split;      // SPLIT_K x C x C
  float* part;          // B x tiles x NQ x C
  float* per_cloud;     // B x NQ x C
  __nv_bfloat16* p;     // B x N x C
  __nv_bfloat16* w;     // C x C
};

long long workspace_floats(int b, int n, int c) {
  const long long tiles = cdiv(n, ROWS);
  return static_cast<long long>(SPLIT_K) * c * c +
         static_cast<long long>(b) * tiles * NQ * c +
         static_cast<long long>(b) * NQ * c +
         static_cast<long long>(b) * n * c / 2 +  // c is even: exact
         static_cast<long long>(c) * c / 2;
}

Workspace carve(void* ws, int b, int n, int c) {
  float* base = static_cast<float*>(ws);
  Workspace out;
  out.dw_split = base;
  out.part = out.dw_split + static_cast<size_t>(SPLIT_K) * c * c;
  out.per_cloud =
      out.part + static_cast<size_t>(b) * cdiv(n, ROWS) * NQ * c;
  // 16-byte aligned: every region above is a multiple of 4 floats
  out.p = reinterpret_cast<__nv_bfloat16*>(out.per_cloud +
                                           static_cast<size_t>(b) * NQ * c);
  out.w = out.p + static_cast<size_t>(b) * n * c;
  return out;
}

template <typename T>
int launch(const void* dy, const void* h, const void* s, const void* t,
           const void* gamma, const void* beta, const void* w,
           const void* mean, const void* rstd, void* dh, void* dw, void* dg,
           void* dbe, void* db, void* ds, void* dt, void* workspace, int b,
           int n, int c, cudaStream_t stream) {
  const Workspace ws = carve(workspace, b, n, c);
  const int tiles = cdiv(n, ROWS);
  const T* dy_t = static_cast<const T*>(dy);
  const T* h_t = static_cast<const T*>(h);
  const float* s_f = static_cast<const float*>(s);
  const float* t_f = static_cast<const float*>(t);
  const T* g_t = static_cast<const T*>(gamma);
  const T* be_t = static_cast<const T*>(beta);
  const float* mean_f = static_cast<const float*>(mean);
  const float* rstd_f = static_cast<const float*>(rstd);

  film_block_bwd_w_bf16_kernel<<<cdiv(static_cast<long long>(c) * c,
                                       RED_THREADS),
                                  RED_THREADS, 0, stream>>>(
      static_cast<const float*>(w), ws.w, c * c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = rows_smem_bytes(c);
  err = cudaFuncSetAttribute(
      film_block_bwd_rows_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  film_block_bwd_rows_kernel<T><<<dim3(tiles, b), THREADS, smem, stream>>>(
      dy_t, h_t, s_f, t_f, g_t, be_t, ws.w, mean_f, rstd_f,
      static_cast<T*>(dh), ws.p, ws.part, n, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const int rows = b * n;
  const int rows_per_slice = cdiv(cdiv(rows, SPLIT_K), KT) * KT;
  const int out_tiles = (c / TILE) * (c / TILE);
  film_block_bwd_dw_kernel<T><<<dim3(out_tiles, SPLIT_K), THREADS, 0,
                                stream>>>(dy_t, ws.p, ws.dw_split, rows, c,
                                          rows_per_slice);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  film_block_bwd_sum_kernel<<<
      dim3(cdiv(static_cast<long long>(c) * c, RED_THREADS), 1), RED_THREADS,
      0, stream>>>(ws.dw_split, static_cast<float*>(dw), SPLIT_K, c * c, 0, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  film_block_bwd_sum_kernel<<<dim3(cdiv(NQ * c, RED_THREADS), b),
                              RED_THREADS, 0, stream>>>(
      ws.part, ws.per_cloud, tiles, NQ * c,
      static_cast<long long>(tiles) * NQ * c, static_cast<long long>(NQ) * c);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  film_block_bwd_finalize_kernel<T>
      <<<cdiv(c, RED_THREADS), RED_THREADS, 0, stream>>>(
          ws.per_cloud, static_cast<T*>(dg), static_cast<T*>(dbe),
          static_cast<float*>(db), static_cast<float*>(ds),
          static_cast<float*>(dt), b, c);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int b, int n, int c) {
  return b <= 0 || n <= 0 || c <= 0 || c % TILE != 0 || c > MAX_C ||
         b > 65535 || static_cast<long long>(b) * n > 0x7fffffffLL;
}

}  // namespace

// Floats of fp32 workspace that pcfm_film_block_bwd needs for (b, n, c);
// -1 for a shape the kernel does not take.
extern "C" long long pcfm_film_block_bwd_workspace(int b, int n, int c) {
  if (bad_shape(b, n, c)) return -1;
  return workspace_floats(b, n, c);
}

// Plain C entry point (bound with ctypes). Device pointers of contiguous
// tensors: dy, h, dh (b, n, c) and gamma, beta, dgamma, dbeta (b, c) in
// bf16 when is_bf16 else fp32; s, t (c,), w (c, c) (out x in), mean, rstd
// (b, n), dw (c, c), db, ds, dt (c,) and the workspace in fp32. Launches the
// rows pass, the dW pass and three fixed-order reductions on `stream`, does
// not synchronise, returns a cudaError_t code.
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
