// Voxel gather for Hopper (sm_90a): the trilinear devoxelize of the hybrid
// backbone's PVConvs (K = 8 corners) and any K = 1 row gather.
//
// Replaces pcfm/ops/pallas/voxel_sorted.py:_gather_kernel_fused (and the
// unfused _gather_kernel) behind gather_windows, and computes what they
// compute:
//
//   out[b, n, c] = sum_k w[b, k, n] * grid[b, ids[b, k, n], c]
//
// grid (B, V, C) bf16 or fp32, ids (B, K, N) int32, w (B, K, N) fp32,
// out (B, N, C) fp32, K = 1 or 8, C % 8 == 0, ids in any order.
//
// The TPU kernel builds one-hot matrices over a window of grid rows and
// multiplies them on the MXU, because the TPU has no vector gather. Hopper
// has one, so this kernel simply loads the indexed rows:
//   * a group of `lanes` threads (a power of two <= 32) owns one point; each
//     thread loads 16 bytes of each of the point's K grid rows (8 bf16 or
//     4 fp32 channels), accumulates w * row in fp32 registers in k order,
//     and writes its 16-32 bytes of the output row; a warp serves
//     32 / lanes points, a block of 8 warps 8x that;
//   * the point's K ids and weights are read once into registers;
//   * ids outside [0, V) contribute nothing (never read out of bounds).
// Sums are taken in a fixed order: two launches give bitwise-equal output.
//
// What bounds it, at the hybrid's R = 32 stage, (B, N, C) = (8, 20000, 128)
// bf16 grid, K = 8: the least it must move is the grid (67 MB) read once,
// ids and weights (10 MB) and the fp32 output (82 MB), ~0.16 GB or
// ~0.047 ms at 3.35 TB/s; it does 2 * 8 * 160k * 128 = 0.33 GFLOP, nothing.
// It actually reads 8 rows of 256 bytes per point (328 MB of row traffic),
// most from L2, because the points arrive sorted by their R = 32 voxel and
// neighbouring points share corners. Left for later: cooperative staging
// of the shared corner rows in shared memory, bf16 output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "voxel_common.cuh"

namespace {

template <typename T, int K>
__global__ void __launch_bounds__(VOX_THREADS)
    voxel_gather_kernel(const T* __restrict__ grid,
                        const int* __restrict__ ids,
                        const float* __restrict__ w, float* __restrict__ out,
                        int n, int v, int c, int lanes) {
  constexpr int VEC = Vec<T>::N;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_warp = 32 / lanes;
  const int point = (blockIdx.x * VOX_WARPS + warp) * per_warp + lane / lanes;
  if (point >= n) return;
  const int l = lane % lanes;
  const int cvec = c / VEC;

  const size_t kn = static_cast<size_t>(K) * n;
  int id[K];
  float wt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    id[k] = ids[b * kn + static_cast<size_t>(k) * n + point];
    wt[k] = w[b * kn + static_cast<size_t>(k) * n + point];
  }
  const T* gb = grid + static_cast<size_t>(b) * v * c;
  float* orow = out + (static_cast<size_t>(b) * n + point) * c;
  for (int j = l; j < cvec; j += lanes) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (id[k] >= 0 && id[k] < v)
        fma_vec(acc, wt[k], gb + static_cast<size_t>(id[k]) * c + j * VEC);
    store_vec(orow + j * VEC, acc);
  }
}

template <typename T, int K>
int launch(const void* grid, const void* ids, const void* w, void* out,
           int b, int n, int v, int c, cudaStream_t stream) {
  const int lanes = lanes_for(c / Vec<T>::N);
  const int per_block = VOX_WARPS * (32 / lanes);
  const dim3 blocks((n + per_block - 1) / per_block, b);
  voxel_gather_kernel<T, K><<<blocks, VOX_THREADS, 0, stream>>>(
      static_cast<const T*>(grid), static_cast<const int*>(ids),
      static_cast<const float*>(w), static_cast<float*>(out), n, v, c,
      lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). Device pointers of contiguous
// tensors: grid (b, v, c) bf16 when is_bf16 else fp32, ids (b, k, n)
// int32, w (b, k, n) fp32, out (b, n, c) fp32. Launches on `stream`, does
// not synchronise, returns a cudaError_t code.
extern "C" int pcfm_voxel_gather(const void* grid, const void* ids,
                                 const void* w, void* out, int b, int n,
                                 int k, int v, int c, int is_bf16,
                                 void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || v <= 0 || c <= 0 || c % 8 != 0 ||
      (k != 1 && k != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return k == 8 ? launch<__nv_bfloat16, 8>(grid, ids, w, out, b, n, v, c, st)
                  : launch<__nv_bfloat16, 1>(grid, ids, w, out, b, n, v, c, st);
  return k == 8 ? launch<float, 8>(grid, ids, w, out, b, n, v, c, st)
                : launch<float, 1>(grid, ids, w, out, b, n, v, c, st);
}
