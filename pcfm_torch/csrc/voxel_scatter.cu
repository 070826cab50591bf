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
//
// A voxel's run can be long: a central voxel of a Gaussian cloud at R = 8
// holds ~10^3 entries (~10^4 at K = 8), and one owner walking it alone runs
// as long as that chain of loads on a few warps (a kernel with one owner a
// voxel took 0.58 ms at R = 8 on an H100, 4 % of its bound). So no work
// item sums more than SCATTER_CHUNK entries (ops/voxel_sorted.py:
// scatter_chunks): a run longer than that is cut into chunks, `chunkptr`
// (B, V + 1) is the prefix of the per-voxel chunk counts (0 for a short
// run) and `chunk_voxel` (B, max_chunks) each chunk's voxel. One launch
// holds two kinds of block:
//   * the first blocks of each cloud sum one chunk of a long run a group of
//     G lanes and write its fp32 partial row to `work` (B, max_chunks, C);
//     the run's last chunk to finish (an integer counter a voxel picks it:
//     it decides who adds, never the order) sums the run's partial rows in
//     chunk order, writes the output row, and sets the counter back to 0;
//   * the other blocks own one voxel a group and write the rows of the
//     short runs (summed directly) and of the empty voxels (0).
// A group's lanes each hold 16 bytes of channels and sum w * upd in fp32 in
// `order`'s order, IN_FLIGHT rows loaded before they are summed; at K = 1
// the entry is the point itself. Every output row is written exactly once
// with 16-byte stores, and every sum is taken in a fixed order: two
// launches give bitwise-equal output.
//
// Most runs are a few entries long (R = 32: under one on average), where
// the work is a chain of dependent loads per voxel that only occupancy
// hides; so both kinds of block share one lean loop (40-48 registers),
// and the long runs get their parallelism from chunks, not from more loads
// in flight.
//
// What bounds it: the least it must move is the updates read once, the
// plan and weights, and the fp32 grid written once. At R = 32, (B, N, C) =
// (8, 20000, 128) bf16 updates, K = 1, that is ~0.18 GB or ~0.053 ms at
// 3.35 TB/s, the grid write dominating; at R = 8, C = 256 it is the 82 MB of
// updates, ~0.026 ms. At K = 8 every update row is read by 8 voxels' chunks
// (from L2 after the first).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "voxel_common.cuh"

namespace {

// Chosen on an H100 among chunks of 32, 64 and 128 entries, 4, 8 or 16
// rows in flight, and two launches against one (PERF.md §6).
constexpr int SCATTER_CHUNK = 64;  // = ops/voxel_sorted.py SCATTER_CHUNK
constexpr int IN_FLIGHT = 4;       // rows loaded before they are summed

// The mask of this thread's group of G lanes (G a power of two <= 32).
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  return G == 32 ? 0xffffffffu
                 : ((1u << G) - 1u) << ((threadIdx.x & 31) / G * G);
}

// acc += sum over e in [beg, end) of w[order[e]] * upd[order[e] % n] at this
// lane's channels j * VEC .. + VEC, in that order: IN_FLIGHT entries, then
// their rows, loaded before they are summed.
template <typename T, int K>
__device__ __forceinline__ void sum_entries(float (&acc)[Vec<T>::N],
                                            const T* __restrict__ uj,
                                            const int* __restrict__ ob,
                                            const float* __restrict__ wb,
                                            int n, int c, int beg, int end) {
  int e = beg;
#pragma unroll 1  // unrolled further, ptxas spills at a low register count
  for (; e + IN_FLIGHT <= end; e += IN_FLIGHT) {
    int pt[IN_FLIGHT];
    float wt[IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int ent = ob[e + u];
      pt[u] = K == 1 ? ent : ent % n;
      wt[u] = wb[ent];
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u)
      fma_raw(acc, wt[u], load_raw(uj + static_cast<size_t>(pt[u]) * c));
  }
#pragma unroll 1
  for (; e < end; ++e) {
    const int ent = ob[e];
    fma_raw(acc, wb[ent],
            load_raw(uj + static_cast<size_t>(K == 1 ? ent : ent % n) * c));
  }
}

// Blocks [0, split_blocks) of a cloud: the chunks of long runs; the rest:
// one voxel a group (see the note at the top).
template <typename T, int K, int G>
__global__ void __launch_bounds__(VOX_THREADS)
    voxel_scatter_kernel(const T* __restrict__ upd,
                         const float* __restrict__ w,
                         const int* __restrict__ order,
                         const int* __restrict__ rowptr,
                         const int* __restrict__ chunkptr,
                         const int* __restrict__ chunk_voxel,
                         float* __restrict__ work, int* __restrict__ done,
                         float* __restrict__ out, int n, int v, int c,
                         int max_chunks, int split_blocks) {
  constexpr int VEC = Vec<T>::N;
  const int b = blockIdx.y;
  const int l = threadIdx.x % G;
  const int* rp = rowptr + static_cast<size_t>(b) * (v + 1);
  const size_t kn = static_cast<size_t>(K) * n;
  const int* ob = order + b * kn;
  const float* wb = w + b * kn;
  const T* ub = upd + static_cast<size_t>(b) * n * c;
  if (static_cast<int>(blockIdx.x) < split_blocks) {
    // a chunk of a long run
    const int chunk = blockIdx.x * (VOX_THREADS / G) + threadIdx.x / G;
    if (chunk >= max_chunks) return;
    const int voxel = chunk_voxel[static_cast<size_t>(b) * max_chunks + chunk];
    if (voxel >= v) return;  // past the cloud's last chunk
    const int* cp = chunkptr + static_cast<size_t>(b) * (v + 1);
    const int first = cp[voxel], chunks = cp[voxel + 1] - first;
    const int beg = rp[voxel] + (chunk - first) * SCATTER_CHUNK;
    const int end = min(beg + SCATTER_CHUNK, rp[voxel + 1]);
    float* wk = work + static_cast<size_t>(b) * max_chunks * c;
    for (int j = l; j < c / VEC; j += G) {
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
      sum_entries<T, K>(acc, ub + j * VEC, ob, wb, n, c, beg, end);
      store_vec(wk + static_cast<size_t>(chunk) * c + j * VEC, acc);
    }
    const unsigned mask = group_mask<G>();
    __threadfence();  // this lane's partial row, before the count
    __syncwarp(mask);
    int* count = done + static_cast<size_t>(b) * v + voxel;
    int last = 0;
    if (l == 0) last = atomicAdd(count, 1) == chunks - 1;
    if (!__shfl_sync(mask, last, 0, G)) return;
    __threadfence();  // the other chunks' partial rows, after the count
    const float* parts = wk + static_cast<size_t>(first) * c;
    float* orow = out + (static_cast<size_t>(b) * v + voxel) * c;
    for (int j = l; j < c / 4; j += G) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
      for (int i0 = 0; i0 < chunks; i0 += IN_FLIGHT) {
        float4 row[IN_FLIGHT];
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u)
          if (i0 + u < chunks)  // through L2: other SMs wrote them
            row[u] = __ldcg(reinterpret_cast<const float4*>(
                parts + static_cast<size_t>(i0 + u) * c + j * 4));
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u)
          if (i0 + u < chunks) {
            acc[0] += row[u].x;
            acc[1] += row[u].y;
            acc[2] += row[u].z;
            acc[3] += row[u].w;
          }
      }
      store_vec(orow + j * 4, acc);
    }
    if (l == 0) *count = 0;  // ready for the next launch
    return;
  }
  // a voxel: a short run summed directly, or 0
  const int voxel =
      (blockIdx.x - split_blocks) * (VOX_THREADS / G) + threadIdx.x / G;
  if (voxel >= v) return;
  const int beg = rp[voxel], end = rp[voxel + 1];
  if (end - beg > SCATTER_CHUNK) return;  // a long run, written above
  float* orow = out + (static_cast<size_t>(b) * v + voxel) * c;
  for (int j = l; j < c / VEC; j += G) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    sum_entries<T, K>(acc, ub + j * VEC, ob, wb, n, c, beg, end);
    store_vec(orow + j * VEC, acc);
  }
}

template <typename T, int K, int G>
int launch(const void* upd, const void* w, const void* order,
           const void* rowptr, const void* chunkptr, const void* chunk_voxel,
           void* out, void* work, void* done, int b, int n, int v, int c,
           int max_chunks, cudaStream_t stream) {
  constexpr int per_block = VOX_THREADS / G;
  const int split_blocks = (max_chunks + per_block - 1) / per_block;
  const int rows_blocks = (v + per_block - 1) / per_block;
  voxel_scatter_kernel<T, K, G>
      <<<dim3(split_blocks + rows_blocks, b), VOX_THREADS, 0, stream>>>(
          static_cast<const T*>(upd), static_cast<const float*>(w),
          static_cast<const int*>(order), static_cast<const int*>(rowptr),
          static_cast<const int*>(chunkptr),
          static_cast<const int*>(chunk_voxel), static_cast<float*>(work),
          static_cast<int*>(done), static_cast<float*>(out), n, v, c,
          max_chunks, split_blocks);
  return static_cast<int>(cudaGetLastError());
}

// G = the lanes that cover a row's 16-byte vectors (lanes_for), 16 or 32:
// two instantiations, and the wider rows' 16 or 32 lanes are all busy
template <typename T, int K>
int launch_k(const void* upd, const void* w, const void* order,
             const void* rowptr, const void* chunkptr,
             const void* chunk_voxel, void* out, void* work, void* done,
             int b, int n, int v, int c, int max_chunks,
             cudaStream_t stream) {
  if (lanes_for(c / Vec<T>::N) >= 32)
    return launch<T, K, 32>(upd, w, order, rowptr, chunkptr, chunk_voxel, out,
                            work, done, b, n, v, c, max_chunks, stream);
  return launch<T, K, 16>(upd, w, order, rowptr, chunkptr, chunk_voxel, out,
                          work, done, b, n, v, c, max_chunks, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). Device pointers of contiguous
// tensors: upd (b, n, c) bf16 when is_bf16 else fp32, w (b, k, n) fp32,
// order (b, k * n), rowptr and chunkptr (b, v + 1), chunk_voxel
// (b, max_chunks) int32 (ops/voxel_sorted.py:scatter_plan, runs longer
// than `chunk` entries cut into chunks), out (b, v, c) fp32, work
// (b, max_chunks, c) fp32 scratch, done (b, v) int32 counters that are 0
// before the launch and 0 after it (the plan's; one launch at a time).
// Launches on `stream`, does not synchronise, returns a cudaError_t code.
extern "C" int pcfm_voxel_scatter(const void* upd, const void* w,
                                  const void* order, const void* rowptr,
                                  const void* chunkptr,
                                  const void* chunk_voxel, void* out,
                                  void* work, void* done, int b, int n, int k,
                                  int v, int c, int max_chunks, int chunk,
                                  int is_bf16, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || v <= 0 || c <= 0 || c % 8 != 0 ||
      (k != 1 && k != 8) || max_chunks < 0 || chunk != SCATTER_CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return k == 8 ? launch_k<__nv_bfloat16, 8>(upd, w, order, rowptr,
                                               chunkptr, chunk_voxel, out,
                                               work, done, b, n, v, c,
                                               max_chunks, st)
                  : launch_k<__nv_bfloat16, 1>(upd, w, order, rowptr,
                                               chunkptr, chunk_voxel, out,
                                               work, done, b, n, v, c,
                                               max_chunks, st);
  return k == 8 ? launch_k<float, 8>(upd, w, order, rowptr, chunkptr,
                                     chunk_voxel, out, work, done, b, n, v, c,
                                     max_chunks, st)
                : launch_k<float, 1>(upd, w, order, rowptr, chunkptr,
                                     chunk_voxel, out, work, done, b, n, v, c,
                                     max_chunks, st);
}
