// Product-only skeletons of the FiLM-block backward's cluster kernel
// (pcfm_torch/csrc/film_block_bwd.cu), for choosing its shape above
// C = 2048: the same mbarrier ring of bulk copies and the same wgmma
// instructions, with no epilogue but an optional spin of `epi_cycles`
// clock cycles a task in its place (the epilogue's time, without its
// memory traffic) and one cluster barrier a task. Built and driven by
// scripts/film_bwd_cluster_probe.py.
//
//   mode 0: the kernel's shape: a CTA takes a pair of 64-row tiles (one a
//           warpgroup) and 2 chunks of 128 columns; a stage is the pair's
//           two 8 KB k blocks of A and the CTA's two 16 KB Wᵀ tiles
//           (48 KB, 4 stages); wgmma m64n128k16 twice a k16 step.
//   mode 1: a CTA takes one 64-row tile and 4 chunks (512 columns, so
//           ceil(C / 512) CTAs a cluster); a stage is the tile's 8 KB k
//           block and four Wᵀ tiles (72 KB, 2 stages); warpgroup g
//           multiplies the shared A by chunks 2g, 2g + 1 with wgmma
//           m64n256k16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "film_common.cuh"
#include "film_wide.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_BYTES = N_TILE * K_TILE * 2;  // 16 KB

template <int MODE>
struct Shape;
template <>
struct Shape<0> {
  static constexpr int A_BLOCKS = 2, W_TILES = 2, STAGES = 4;
};
template <>
struct Shape<1> {
  static constexpr int A_BLOCKS = 1, W_TILES = 4, STAGES = 2;
};

template <int MODE>
__host__ __device__ constexpr int stage_bytes() {
  return Shape<MODE>::A_BLOCKS * WIDE_A_BYTES +
         Shape<MODE>::W_TILES * TILE_BYTES;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    probe_kernel(const __nv_bfloat16* __restrict__ a_packed,
                 const __nv_bfloat16* __restrict__ wt_packed,
                 float* __restrict__ out, int c, int ncta,
                 long long epi_cycles) {
  using S = Shape<MODE>;
  constexpr int STAGE = stage_bytes<MODE>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::STAGES * STAGE);
  uint64_t* empty = full + S::STAGES;

  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const size_t task = blockIdx.x / ncta;
  const int nch = c / N_TILE, k_tiles = c / K_TILE;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  // the task's first row tile, and this CTA's first chunk (wrapping)
  const __nv_bfloat16* a_task =
      a_packed + task * S::A_BLOCKS * WIDE_ROWS * c;
  const int ch0 = static_cast<int>(rank) * S::W_TILES;

  auto load_stage = [&](int kt) {
    const int st = kt % S::STAGES;
    uint8_t* dst = ring + st * STAGE;
    mbar_arrive_expect_tx(&full[st], STAGE);
    for (int g = 0; g < S::A_BLOCKS; ++g)
      bulk_copy_g2s(dst + g * WIDE_A_BYTES,
                    a_task + static_cast<size_t>(g) * WIDE_ROWS * c +
                        static_cast<size_t>(kt) * WIDE_ROWS * K_TILE,
                    WIDE_A_BYTES, &full[st]);
    for (int q = 0; q < S::W_TILES; ++q)
      bulk_copy_g2s(dst + S::A_BLOCKS * WIDE_A_BYTES + q * TILE_BYTES,
                    wt_packed + (static_cast<size_t>((ch0 + q) % nch) *
                                     k_tiles + kt) * N_TILE * K_TILE,
                    TILE_BYTES, &full[st]);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < S::STAGES && i < k_tiles; ++i) load_stage(i);
  auto release = [&](int i) {
    if (tid == 0) mbar_arrive(&empty[i % S::STAGES]);
    if (threadIdx.x == 0 && i + S::STAGES < k_tiles) {
      mbar_wait(&empty[i % S::STAGES], (i / S::STAGES) & 1);
      load_stage(i + S::STAGES);
    }
  };

  float acc[128];
  const uint32_t ring_base = smem_u32(ring);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int st = kt % S::STAGES;
    mbar_wait(&full[st], (kt / S::STAGES) & 1);
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
    wgmma_fence();
    const uint32_t sb = ring_base + st * STAGE;
    if constexpr (MODE == 0) {
      const uint64_t da = desc_sw128(sb + wg * WIDE_A_BYTES);
      float(&a0)[64] = *reinterpret_cast<float(*)[64]>(acc);
      float(&a1)[64] = *reinterpret_cast<float(*)[64]>(acc + 64);
#pragma unroll
      for (int kk = 0; kk < K_TILE / 16; ++kk) {
        wgmma_m64n128k16(a0, da + 2 * kk,
                         desc_sw128(sb + 2 * WIDE_A_BYTES) + 2 * kk,
                         (kt | kk) != 0);
        wgmma_m64n128k16(a1, da + 2 * kk,
                         desc_sw128(sb + 2 * WIDE_A_BYTES + TILE_BYTES) +
                             2 * kk,
                         (kt | kk) != 0);
      }
    } else {
      const uint64_t da = desc_sw128(sb);
#pragma unroll
      for (int kk = 0; kk < K_TILE / 16; ++kk)
        wgmma_m64n256k16(acc, da + 2 * kk,
                         desc_sw128(sb + WIDE_A_BYTES +
                                    wg * 2 * TILE_BYTES) + 2 * kk,
                         (kt | kk) != 0);
    }
    wgmma_commit();
    if (kt > 0) {
      wgmma_wait<1>();
      release(kt - 1);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
  release(k_tiles - 1);

  // the epilogue's place: a spin, then the cluster's barrier
  if (epi_cycles > 0) {
    const long long t0 = clock64();
    while (clock64() - t0 < epi_cycles) {
    }
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < 128; ++i) sum += acc[i];
  out[static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x] = sum;
}

template <int MODE>
cudaError_t config(int ncta, int tasks, int smem, cudaStream_t stream,
                   cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(probe_kernel<MODE>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(ncta * tasks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(ncta);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// the least dynamic shared memory the mode's ring and barriers need
extern "C" int probe_min_smem(int mode) {
  return mode == 0 ? 1024 + Shape<0>::STAGES * stage_bytes<0>() + 64
                   : 1024 + Shape<1>::STAGES * stage_bytes<1>() + 64;
}

// clusters of `ncta` CTAs with `smem` bytes each that the device holds at
// once; minus a cudaError_t code on an error
extern "C" int probe_max_clusters(int mode, int ncta, int smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  cudaError_t err;
  if (mode == 0) {
    err = config<0>(ncta, 1, smem, nullptr, cfg, attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, probe_kernel<0>, &cfg);
  } else {
    err = config<1>(ncta, 1, smem, nullptr, cfg, attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, probe_kernel<1>, &cfg);
  }
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// one launch of `tasks` tasks in clusters of `ncta` CTAs on `stream`
extern "C" int probe_launch(int mode, const void* a_packed,
                            const void* wt_packed, void* out, int c,
                            int ncta, int tasks, int smem,
                            long long epi_cycles, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err;
  const auto* a = static_cast<const __nv_bfloat16*>(a_packed);
  const auto* w = static_cast<const __nv_bfloat16*>(wt_packed);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    err = config<0>(ncta, tasks, smem, st, cfg, attr);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, probe_kernel<0>, a, w, o, c, ncta,
                               epi_cycles);
  } else {
    err = config<1>(ncta, tasks, smem, st, cfg, attr);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, probe_kernel<1>, a, w, o, c, ncta,
                               epi_cycles);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
