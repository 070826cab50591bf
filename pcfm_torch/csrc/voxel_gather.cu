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
// has one, so this kernel loads the indexed rows:
//   * a block owns a tile of consecutive points of one cloud (64 at K = 8)
//     and first stages the tile's K ids and weights in shared memory
//     (16-byte loads, coalesced: each is a contiguous run of `ids` / `w`),
//     in place of 2K strided words that every lane loaded for its point;
//   * a group of G = 16 or 32 threads serves every (VOX_THREADS / G)-th
//     point of the tile: each thread loads 16 bytes of all K grid rows of
//     a point (8 bf16 or 4 fp32 channels) before any multiply-add, then
//     accumulates w * row in fp32 in k order and writes its slice of the
//     output row;
//   * ids outside [0, V) contribute nothing (never read out of bounds).
// Sums are taken in a fixed order: two launches give bitwise-equal output.
//
// What bounds it, at the hybrid's R = 32 stage, (B, N, C) = (8, 20000, 128)
// bf16 grid, K = 8: the least it must move is the distinct grid rows the
// ids name read once, ids and weights (10 MB) and the fp32 output (82 MB),
// ~0.032 ms at 3.35 TB/s; it does 2 * 8 * 160k * 128 = 0.33 GFLOP, nothing.
// Loading 8 corner rows a point moves 0.33 GB (R = 32; 0.66 GB at C = 256)
// between L2 and the SMs. The points arrive sorted by their R = 32 voxel,
// so the points of one tile share most of their corners, and a tile served
// at once by one block finds many of them in its SM's L1. Below that, the
// fp32 output write alone is the floor (chip_smoke.py phase 10 times it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "voxel_common.cuh"

namespace {

// Points a block, and blocks an SM at K = 8 (4: <= 64 registers a
// thread): chosen on an H100 among tiles of 16 to 128 points and one, two
// or four points a group at a time (PERF.md §6). Occupancy wins over more
// rows in flight a thread.
template <int K>
struct Tile {
  static constexpr int POINTS = K == 8 ? 64 : 32;
  static constexpr int MIN_BLOCKS = K == 8 ? 4 : 1;
};

template <typename T, int K, int G>
__global__ void __launch_bounds__(VOX_THREADS, Tile<K>::MIN_BLOCKS)
    voxel_gather_kernel(const T* __restrict__ grid,
                        const int* __restrict__ ids,
                        const float* __restrict__ w, float* __restrict__ out,
                        int n, int v, int c, int aligned) {
  constexpr int VEC = Vec<T>::N;
  constexpr int TILE = Tile<K>::POINTS;
  __shared__ __align__(16) int s_id[K * TILE];
  __shared__ __align__(16) float s_w[K * TILE];
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * TILE;
  const int tp = min(TILE, n - p0);
  const size_t kn = static_cast<size_t>(K) * n;
  const int* ib = ids + b * kn + p0;
  const float* wb = w + b * kn + p0;
  if (aligned && tp == TILE) {
    constexpr int Q = TILE / 4;
    for (int i = threadIdx.x; i < K * Q; i += VOX_THREADS) {
      const int k = i / Q, q = i % Q * 4;
      const size_t src = static_cast<size_t>(k) * n + q;
      *reinterpret_cast<int4*>(s_id + k * TILE + q) =
          __ldg(reinterpret_cast<const int4*>(ib + src));
      *reinterpret_cast<float4*>(s_w + k * TILE + q) =
          __ldg(reinterpret_cast<const float4*>(wb + src));
    }
  } else {  // the ragged last tile, or ids / weights not 16-byte aligned
    for (int i = threadIdx.x; i < K * TILE; i += VOX_THREADS) {
      const int k = i / TILE, q = i % TILE;
      const size_t src = static_cast<size_t>(k) * n + q;
      s_id[i] = q < tp ? ib[src] : -1;
      s_w[i] = q < tp ? wb[src] : 0.0f;
    }
  }
  __syncthreads();

  const int l = threadIdx.x % G;
  const T* gb = grid + static_cast<size_t>(b) * v * c;
  float* ob = out + (static_cast<size_t>(b) * n + p0) * c;
  const int cvec = c / VEC;
  for (int q = threadIdx.x / G; q < tp; q += VOX_THREADS / G) {
    for (int j = l; j < cvec; j += G) {
      const T* gj = gb + j * VEC;  // this lane's channels; v * c < 2^31
      typename Raw<T>::type row[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int id = s_id[k * TILE + q];
        if (static_cast<unsigned>(id) < static_cast<unsigned>(v))
          row[k] = load_raw(gj + id * c);
      }
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (static_cast<unsigned>(s_id[k * TILE + q]) <
            static_cast<unsigned>(v))
          fma_raw(acc, s_w[k * TILE + q], row[k]);
      store_vec(ob + static_cast<size_t>(q) * c + j * VEC, acc);
    }
  }
}

template <typename T, int K, int G>
int launch(const void* grid, const void* ids, const void* w, void* out,
           int b, int n, int v, int c, cudaStream_t stream) {
  const int aligned = n % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(ids) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 blocks((n + Tile<K>::POINTS - 1) / Tile<K>::POINTS, b);
  voxel_gather_kernel<T, K, G><<<blocks, VOX_THREADS, 0, stream>>>(
      static_cast<const T*>(grid), static_cast<const int*>(ids),
      static_cast<const float*>(w), static_cast<float*>(out), n, v, c,
      aligned);
  return static_cast<int>(cudaGetLastError());
}

// G = the lanes that cover a row's 16-byte vectors (lanes_for), 16 or 32
// (narrower rows leave lanes idle): as a constant it frees the registers
// that let bf16 fit 64 at K = 8 without a spill
template <typename T, int K>
int launch_k(const void* grid, const void* ids, const void* w, void* out,
             int b, int n, int v, int c, cudaStream_t stream) {
  if (lanes_for(c / Vec<T>::N) >= 32)
    return launch<T, K, 32>(grid, ids, w, out, b, n, v, c, stream);
  return launch<T, K, 16>(grid, ids, w, out, b, n, v, c, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). Device pointers of contiguous
// tensors: grid (b, v, c) bf16 when is_bf16 else fp32 with v * c < 2^31,
// ids (b, k, n) int32, w (b, k, n) fp32, out (b, n, c) fp32. Launches on
// `stream`, does not synchronise, returns a cudaError_t code.
extern "C" int pcfm_voxel_gather(const void* grid, const void* ids,
                                 const void* w, void* out, int b, int n,
                                 int k, int v, int c, int is_bf16,
                                 void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || v <= 0 || c <= 0 || c % 8 != 0 ||
      (k != 1 && k != 8) || static_cast<long long>(v) * c > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return k == 8
               ? launch_k<__nv_bfloat16, 8>(grid, ids, w, out, b, n, v, c, st)
               : launch_k<__nv_bfloat16, 1>(grid, ids, w, out, b, n, v, c, st);
  return k == 8 ? launch_k<float, 8>(grid, ids, w, out, b, n, v, c, st)
                : launch_k<float, 1>(grid, ids, w, out, b, n, v, c, st);
}
