// Fused FiLM residual block, forward, for Hopper (sm_90a).
//
// Replaces pcfm/ops/pallas/film_block.py:_fwd_kernel (the TPU kernel) and
// computes what it computes, per row n of cloud b:
//
//   mean, rstd = LayerNorm statistics of h[b, n, :] (fp32, two-pass
//                variance, eps 1e-5)
//   f          = ((h - mean) * rstd * s + t) * (1 + gamma[b]) + beta[b]
//   y          = f + silu(f) @ W^T + bias          (W: torch Linear, out x in)
//
// and writes y in h's dtype plus the per-row mean and rstd (fp32), which the
// backward kernel will reuse.
//
// Design (simple and correct first):
//   * a block owns ROWS = 64 rows of ONE cloud, so gamma/beta are per block;
//     the ragged last tile of a cloud is masked (rows >= N are never read
//     or written, their A rows are zero);
//   * each warp computes its rows' statistics in fp32 and stages silu(f) as
//     bf16 in shared memory (the whole 64 x C A operand stays on chip);
//   * the product runs on the tensor cores through nvcuda::wmma
//     (bf16 x bf16 -> fp32, the TPU kernel's DEFAULT-precision dot), over
//     128-column output chunks; W is read as fp32 in 128 x 32 tiles,
//     converted to bf16 in shared memory, the next tile prefetched into
//     registers while the current one is multiplied;
//   * the epilogue recomputes f from h and the saved statistics, adds the
//     product and the bias, and stores y.
//
// What bounds it at (B, N, C) = (8, 20000, 512): it reads h and writes y
// (2 x 164 MB in bf16) plus W and the stats, about 0.33 GB (~0.1 ms at
// 3.35 TB/s), and does 2 * 160k * 512^2 = 84 GFLOP (~0.09 ms at 989 TFLOP/s
// dense bf16). Both double at B = 16 (classifier-free guidance). Memory and
// tensor cores are about balanced, so a fast kernel has to overlap them.
//
// What this design leaves on the table (work for later kernels):
//   * wmma/mma.sync reach a fraction of the wgmma rate; no TMA, no
//     warp specialisation, no persistent schedule;
//   * every block re-reads all of W (1 MB fp32) from L2 and converts it;
//     a pre-converted bf16 W, larger row tiles or a cluster-shared W would
//     cut that traffic;
//   * h is read three times (two statistics passes and the epilogue),
//     mostly from L1/L2; scalar, not 16-byte, loads and stores;
//   * only a single W tile is in shared memory (register prefetch, no
//     multi-stage cp.async ring).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "film_common.cuh"

using namespace nvcuda;

namespace {

constexpr int ROWS = 64;            // rows (points) of one cloud per block
constexpr int THREADS = 256;        // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int NCHUNK = 128;         // output columns per GEMM pass
constexpr int KCHUNK = 32;          // reduction depth of one staged W tile
constexpr int A_PAD = 8;            // bf16 row padding of the A operand
constexpr int W_LD = KCHUNK + 8;    // W tile kept n-major: [NCHUNK][W_LD]
constexpr int E_LD = NCHUNK + 4;    // fp32 epilogue staging: [ROWS][E_LD]
constexpr int MAX_C = 1024;         // A operand (64 x C bf16) must fit

// 128 x 32 fp32 tile of W (rows n0.., columns k0..) into registers:
// 1024 float4, four per thread, 128 contiguous bytes per W row
__device__ __forceinline__ void load_w_tile(const float* __restrict__ w,
                                            int c, int n0, int k0,
                                            float4 (&pre)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int n = idx >> 3, k4 = idx & 7;
    pre[i] = *reinterpret_cast<const float4*>(
        w + static_cast<size_t>(n0 + n) * c + k0 + k4 * 4);
  }
}

__device__ __forceinline__ void store_w_tile(__nv_bfloat16* ws,
                                             const float4 (&pre)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int n = idx >> 3, k4 = idx & 7;
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(ws + n * W_LD + k4 * 4);
    dst[0] = __floats2bfloat162_rn(pre[i].x, pre[i].y);
    dst[1] = __floats2bfloat162_rn(pre[i].z, pre[i].w);
  }
}

size_t smem_bytes(int c) {
  return static_cast<size_t>(ROWS) * (c + A_PAD) * sizeof(__nv_bfloat16) +
         static_cast<size_t>(NCHUNK) * W_LD * sizeof(__nv_bfloat16) +
         static_cast<size_t>(ROWS) * E_LD * sizeof(float) +
         2 * ROWS * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    film_block_fwd_kernel(const T* __restrict__ h,
                          const float* __restrict__ s,
                          const float* __restrict__ t,
                          const T* __restrict__ gamma,
                          const T* __restrict__ beta,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          T* __restrict__ y, float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int n_points,
                          int c) {
  // every region starts on a 128-byte boundary: 64 * (c + 8) * 2 and
  // 128 * 40 * 2 and 64 * 132 * 4 are multiples of 128 for c % 128 == 0
  extern __shared__ __align__(128) unsigned char smem[];
  const int a_ld = c + A_PAD;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = as + ROWS * a_ld;
  float* es = reinterpret_cast<float*>(ws + NCHUNK * W_LD);
  float* s_mean = es + ROWS * E_LD;
  float* s_rstd = s_mean + ROWS;

  const int row0 = blockIdx.x * ROWS;
  const size_t cloud_row0 = static_cast<size_t>(blockIdx.y) * n_points;
  const T* g_c = gamma + static_cast<size_t>(blockIdx.y) * c;
  const T* be_c = beta + static_cast<size_t>(blockIdx.y) * c;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. statistics and silu(f) -> shared memory, one warp per row
  for (int r = warp; r < ROWS; r += WARPS) {
    const int n = row0 + r;
    __nv_bfloat16* a_row = as + r * a_ld;
    if (n >= n_points) {
      for (int k = lane; k < c; k += 32) a_row[k] = __float2bfloat16(0.0f);
      continue;
    }
    const T* h_row = h + (cloud_row0 + n) * c;
    float sum = 0.0f;
    for (int k = lane; k < c; k += 32) sum += to_f32(h_row[k]);
    const float mean = warp_sum(sum) / c;
    float sq = 0.0f;
    for (int k = lane; k < c; k += 32) {
      const float d = to_f32(h_row[k]) - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / c + LN_EPS);
    for (int k = lane; k < c; k += 32) {
      const float f = film_f(to_f32(h_row[k]), mean, rstd, s[k], t[k],
                             to_f32(g_c[k]), to_f32(be_c[k]));
      a_row[k] = __float2bfloat16(f / (1.0f + expf(-f)));
    }
    if (lane == 0) {
      s_mean[r] = mean;
      s_rstd[r] = rstd;
      mean_out[cloud_row0 + n] = mean;
      rstd_out[cloud_row0 + n] = rstd;
    }
  }
  __syncthreads();

  // 2. y[:, n0:n0+128] = f + silu(f) @ W^T + bias, chunk by chunk
  const int wr = warp >> 1;  // this warp's 16-row slice of the tile
  const int wc = warp & 1;   // and its 64-column half of the chunk
  for (int n0 = 0; n0 < c; n0 += NCHUNK) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
    float4 pre[4];
    load_w_tile(w, c, n0, 0, pre);
    for (int k0 = 0; k0 < c; k0 += KCHUNK) {
      __syncthreads();  // the previous W tile (and epilogue) is done
      store_w_tile(ws, pre);
      __syncthreads();
      if (k0 + KCHUNK < c) load_w_tile(w, c, n0, k0 + KCHUNK, pre);
#pragma unroll
      for (int kk = 0; kk < KCHUNK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::load_matrix_sync(a, as + (wr * 16) * a_ld + k0 + kk, a_ld);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // B(k, n) = W[n, k]: the n-major tile is B in column-major order
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major>
              bf;
          wmma::load_matrix_sync(bf, ws + (wc * 64 + j * 16) * W_LD + kk,
                                 W_LD);
          wmma::mma_sync(acc[j], a, bf, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(es + (wr * 16) * E_LD + wc * 64 + j * 16,
                              acc[j], E_LD, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < ROWS * NCHUNK; i += THREADS) {
      const int r = i / NCHUNK, col = i % NCHUNK;
      const int n = row0 + r;
      if (n >= n_points) continue;
      const int k = n0 + col;
      const size_t off = (cloud_row0 + n) * c + k;
      const float f = film_f(to_f32(h[off]), s_mean[r], s_rstd[r], s[k],
                             t[k], to_f32(g_c[k]), to_f32(be_c[k]));
      y[off] = from_f32<T>(f + es[r * E_LD + col] + bias[k]);
    }
  }
}

template <typename T>
int launch(const void* h, const void* s, const void* t, const void* gamma,
           const void* beta, const void* w, const void* bias, void* y,
           void* mean, void* rstd, int b, int n, int c,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(
      film_block_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + ROWS - 1) / ROWS, b);
  film_block_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers of
// contiguous tensors: h, y (b, n, c) and gamma, beta (b, c) in bf16 when
// is_bf16 else fp32; s, t, bias (c,), w (c, c), mean, rstd (b, n) fp32.
// Launches on `stream`, does not synchronise, returns a cudaError_t code.
extern "C" int pcfm_film_block_fwd(const void* h, const void* s,
                                   const void* t, const void* gamma,
                                   const void* beta, const void* w,
                                   const void* bias, void* y, void* mean,
                                   void* rstd, int b, int n, int c,
                                   int is_bf16, void* stream) {
  if (b <= 0 || n <= 0 || c <= 0 || c % NCHUNK != 0 || c > MAX_C ||
      b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(h, s, t, gamma, beta, w, bias, y, mean,
                                 rstd, b, n, c, st);
  return launch<float>(h, s, t, gamma, beta, w, bias, y, mean, rstd, b, n,
                       c, st);
}

extern "C" const char* pcfm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
