// Voxel scatter for Hopper (sm_90a): the scatter-mean (avg_voxelize) of the
// hybrid backbone's PVConvs (K = 1, weight 1 / count) and the K = 8
// trilinear transpose, deterministic and without float atomics.
//
// Replaces pcfm/ops/pallas/voxel_sorted.py:_scatter_kernel_fused (and the
// unfused _scatter_kernel) behind scatter_windows, and computes what they
// compute:
//
//   out[b, v, c] = sum_{n, k: ids[b, k, n] = v} w[b, k, n] * upd[b, n, c]
//
// upd (B, N, C) bf16 or fp32, w (B, K, N) fp32, out (B, V, C) fp32,
// K = 1 or 8, C % 8 == 0, ids in any order.
//
// The TPU kernel adds one-hot window products into a grid block that stays
// in VMEM across its sequential grid. On Hopper blocks run in no order, and
// float atomics would make the sums depend on the schedule (PARITY.md
// deviation 1; the port's bitwise-reproducible step). So the ids are put in
// voxel order first, outside the kernel, once per resolution (the stage
// cache): `order` (B, K*N) holds the flat entry indices k * N + n sorted
// stably by voxel id, `rowptr` (B, V + 1) the start of each voxel's run.
// Then each voxel has one owner:
//   * a group of `lanes` threads (a power of two <= 32) owns one voxel, each
//     thread 16 bytes of channels; it walks the voxel's entries in `order`
//     and accumulates w * upd[n] in fp32 registers, four loads in flight;
//   * every output row is written exactly once; an empty voxel gets 0.
// Sums are taken in a fixed order: two launches give bitwise-equal output.
//
// What bounds it, at the hybrid's R = 32 stage, (B, N, C) = (8, 20000, 128)
// bf16 updates, K = 1: the least it must move is the updates (41 MB), the
// plan and weights (~2 MB) and the fp32 grid (134 MB), ~0.18 GB or
// ~0.053 ms at 3.35 TB/s; the grid write dominates, since 20 000 points
// fill at most 20 000 of the 32 768 voxels of a cloud.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "voxel_common.cuh"

namespace {

constexpr int UNROLL = 4;          // entries loaded before they are summed

template <typename T>
__global__ void __launch_bounds__(VOX_THREADS)
    voxel_scatter_kernel(const T* __restrict__ upd,
                         const float* __restrict__ w,
                         const int* __restrict__ order,
                         const int* __restrict__ rowptr,
                         float* __restrict__ out, int n, int k, int v, int c,
                         int lanes) {
  constexpr int VEC = Vec<T>::N;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_warp = 32 / lanes;
  const int voxel = (blockIdx.x * VOX_WARPS + warp) * per_warp + lane / lanes;
  if (voxel >= v) return;
  const int l = lane % lanes;
  const int cvec = c / VEC;

  const size_t kn = static_cast<size_t>(k) * n;
  const int* ob = order + b * kn;
  const float* wb = w + b * kn;
  const T* ub = upd + static_cast<size_t>(b) * n * c;
  const int* rp = rowptr + static_cast<size_t>(b) * (v + 1);
  const int beg = rp[voxel], end = rp[voxel + 1];
  float* orow = out + (static_cast<size_t>(b) * v + voxel) * c;

  for (int j = l; j < cvec; j += lanes) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    int e = beg;
    for (; e + UNROLL <= end; e += UNROLL) {
      int pt[UNROLL];
      float wt[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int ent = ob[e + u];
        pt[u] = ent % n;
        wt[u] = wb[ent];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        fma_vec(acc, wt[u], ub + static_cast<size_t>(pt[u]) * c + j * VEC);
    }
    for (; e < end; ++e) {
      const int ent = ob[e];
      fma_vec(acc, wb[ent], ub + static_cast<size_t>(ent % n) * c + j * VEC);
    }
    store_vec(orow + j * VEC, acc);
  }
}

template <typename T>
int launch(const void* upd, const void* w, const void* order,
           const void* rowptr, void* out, int b, int n, int k, int v, int c,
           cudaStream_t stream) {
  const int lanes = lanes_for(c / Vec<T>::N);
  const int per_block = VOX_WARPS * (32 / lanes);
  const dim3 blocks((v + per_block - 1) / per_block, b);
  voxel_scatter_kernel<T><<<blocks, VOX_THREADS, 0, stream>>>(
      static_cast<const T*>(upd), static_cast<const float*>(w),
      static_cast<const int*>(order), static_cast<const int*>(rowptr),
      static_cast<float*>(out), n, k, v, c, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). Device pointers of contiguous
// tensors: upd (b, n, c) bf16 when is_bf16 else fp32, w (b, k, n) fp32,
// order (b, k * n) and rowptr (b, v + 1) int32 (a stable sort of the
// entries by voxel id and its CSR offsets), out (b, v, c) fp32. Launches on
// `stream`, does not synchronise, returns a cudaError_t code.
extern "C" int pcfm_voxel_scatter(const void* upd, const void* w,
                                  const void* order, const void* rowptr,
                                  void* out, int b, int n, int k, int v,
                                  int c, int is_bf16, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || v <= 0 || c <= 0 || c % 8 != 0 ||
      (k != 1 && k != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(upd, w, order, rowptr, out, b, n, k, v, c,
                                 st);
  return launch<float>(upd, w, order, rowptr, out, b, n, k, v, c, st);
}
