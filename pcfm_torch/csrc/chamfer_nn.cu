// Chamfer nearest neighbour for Hopper (sm_90a): for every query point, the
// least squared distance to a target cloud and the target's index.
//
// Replaces pcfm/ops/pallas/chamfer_v3.py:_kernel (behind _directed_v3 and
// chamfer_distance_pallas_v3), and computes what it computes, one direction
// at a time, for P (query cloud, target cloud) pairs:
//
//   dist[p, n] = min_m  sum_d (query[qi[p], n, d] - target[ti[p], m, d])^2
//   idx[p, n]  = the least m that reaches it
//
// query (Q, N, D) and target (T, M, D) fp32, D = 1..8, qi / ti (P,) int32,
// dist (P, N) fp32, idx (P, N) int32.  chamfer_distance is the pairs
// qi = ti = arange(B); cd_matrix is all pairs of two sets.
//
// The TPU kernel scores |b|^2 - 2 a.b on the MXU (inexact on near ties,
// pcfm/ops/pallas/__init__.py) and carries a running min / argmin in its
// output block over a sequential grid of 256 x 2048 tiles.  Here:
//   * a block owns THREADS queries of one pair, one query per thread, its
//     D coordinates in registers;
//   * the pair's targets pass through shared memory in chunks of TILE
//     points, stored as structure of arrays (one row per coordinate), so
//     a thread reads four targets' coordinate d with one 16-byte load that
//     every thread of the warp shares (a broadcast);
//   * the distance is taken in difference form, sum_d (a_d - b_d)^2 in
//     fp32, d in order, with fused multiply-adds;
//   * each thread scans the targets in increasing index and takes a new
//     best only when strictly less: ties go to the lowest index; a chunk's
//     padding is +inf and never wins;
//   * each output is written once, by its query's thread: no atomics, two
//     launches give bitwise-equal results.
//
// What bounds it: operations.  Per (query, target) pair, D subtractions
// and D multiply-adds (3 D - 1 = 8 FLOP at D = 3); at (8, 20000, 3) both
// ways that is 6.4e9 pairs, 51 GFLOP, ~0.76 ms at 67 TFLOP/s fp32.  Its
// bytes (the two clouds once, the outputs once) are ~2.5 MB, nothing.  The
// bound counts a multiply-add as 2 FLOP, so it allows the time of ~4
// instructions a pair; this design executes ~9 (D subtractions, D
// multiply-adds, a comparison and two selects), so it needs at least
// ~2.25x the bound.  Left for later: the dot-form score on the tensor
// cores for a candidate set, followed by an exact difference-form check.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;   // queries a block
constexpr int TILE = 1024;     // targets a shared-memory chunk
constexpr int MAX_D = 8;

template <int D>
__global__ void __launch_bounds__(THREADS)
    chamfer_nn_kernel(const float* __restrict__ query,
                      const float* __restrict__ target,
                      const int* __restrict__ qi, const int* __restrict__ ti,
                      int n, int m, float* __restrict__ dist,
                      int* __restrict__ idx) {
  __shared__ __align__(16) float tile[D][TILE];
  const int p = blockIdx.y;
  const int q = blockIdx.x * THREADS + threadIdx.x;
  const bool live = q < n;
  const float* qp = query + static_cast<size_t>(qi[p]) * n * D;
  const float* tp = target + static_cast<size_t>(ti[p]) * m * D;

  float a[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    a[d] = live ? qp[static_cast<size_t>(q) * D + d] : 0.0f;

  float best = CUDART_INF_F;
  int arg = 0;
  for (int base = 0; base < m; base += TILE) {
    const int cnt = min(TILE, m - base);
    const int padded = (cnt + 3) & ~3;
    __syncthreads();  // the previous chunk is no longer read
    // coalesced read of the chunk's cnt * D floats, transposed to SoA
    const float* src = tp + static_cast<size_t>(base) * D;
    for (int j = threadIdx.x; j < cnt * D; j += THREADS) {
      const int pt = j / D;
      tile[j - pt * D][pt] = src[j];
    }
    for (int j = cnt + threadIdx.x; j < padded; j += THREADS) {
#pragma unroll
      for (int d = 0; d < D; ++d) tile[d][j] = CUDART_INF_F;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < padded; j += 4) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float4 b = *reinterpret_cast<const float4*>(&tile[d][j]);
        const float t0 = a[d] - b.x, t1 = a[d] - b.y;
        const float t2 = a[d] - b.z, t3 = a[d] - b.w;
        s[0] = fmaf(t0, t0, s[0]);
        s[1] = fmaf(t1, t1, s[1]);
        s[2] = fmaf(t2, t2, s[2]);
        s[3] = fmaf(t3, t3, s[3]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (s[k] < best) {
          best = s[k];
          arg = base + j + k;
        }
      }
    }
  }
  if (live) {
    dist[static_cast<size_t>(p) * n + q] = best;
    idx[static_cast<size_t>(p) * n + q] = arg;
  }
}

template <int D>
int launch(const void* query, const void* target, const void* qi,
           const void* ti, int p, int n, int m, void* dist, void* idx,
           cudaStream_t stream) {
  const dim3 blocks((n + THREADS - 1) / THREADS, p);
  chamfer_nn_kernel<D><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(query), static_cast<const float*>(target),
      static_cast<const int*>(qi), static_cast<const int*>(ti), n, m,
      static_cast<float*>(dist), static_cast<int*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). Device pointers of contiguous
// tensors: query (Q, n, d) and target (T, m, d) fp32, qi / ti (p,) int32
// holding valid cloud indices, dist (p, n) fp32, idx (p, n) int32.
// Launches on `stream`, does not synchronise, returns a cudaError_t code.
extern "C" int pcfm_chamfer_nn(const void* query, const void* target,
                               const void* qi, const void* ti, int p, int n,
                               int m, int d, void* dist, void* idx,
                               void* stream) {
  if (p <= 0 || p > 65535 || n <= 0 || m <= 0 || d < 1 || d > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch<1>(query, target, qi, ti, p, n, m, dist, idx, st);
    case 2: return launch<2>(query, target, qi, ti, p, n, m, dist, idx, st);
    case 3: return launch<3>(query, target, qi, ti, p, n, m, dist, idx, st);
    case 4: return launch<4>(query, target, qi, ti, p, n, m, dist, idx, st);
    case 5: return launch<5>(query, target, qi, ti, p, n, m, dist, idx, st);
    case 6: return launch<6>(query, target, qi, ti, p, n, m, dist, idx, st);
    case 7: return launch<7>(query, target, qi, ti, p, n, m, dist, idx, st);
    default: return launch<8>(query, target, qi, ti, p, n, m, dist, idx, st);
  }
}
