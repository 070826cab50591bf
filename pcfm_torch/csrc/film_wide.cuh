// The FiLM block's wide paths (forward C > 1024, backward C > 512, up to
// WIDE_MAX_C): one streamed wgmma product shared by both directions.
//
// At these widths a 64-row tile's whole bf16 operand (64 x C) or its fp32
// dp (64 x C in registers) no longer fits on an SM, so the product streams
// BOTH operands through a ring of shared-memory stages by k:
//
//   out (rows x C) = A (rows x C, bf16) @ B^T (B: C x C, bf16), fp32 sums
//
// A lies in device memory in the 64-row packed tiles of rows_packed_index
// (ops/film_block.py): tile t holds 64 rows as C / 64 regions of 64 rows x
// 128 bytes, each row's 16-byte chunks swizzled (chunk j at j ^ (r % 8)),
// so that one k stage of a tile is ONE contiguous 8 KB block, already in
// wgmma's K-major 128-byte-swizzled layout. B is packed as packed_index
// (the forward's W) or packed_t_index (the backward's Wᵀ): a 128 x 64 tile
// is one contiguous 16 KB block in the same layout.
//
// A block of two warpgroups owns a pair of row tiles (warpgroup g: tile
// 2 * pair + g; the packed A has an even number of tiles) and NB 128-column
// output chunks (NB = 2 when C % 256 == 0): 128 fp32 accumulators a thread
// at NB = 2. A stage is the pair's two 8 KB A blocks and NB 16 KB B tiles,
// one mbarrier, WIDE_STAGES deep; thread 0 keeps the ring full (as the
// narrow kernels do: no producer warp, so that 256 threads keep 255
// registers). The grid is one-dimensional, the chunk fastest, so that the
// blocks that read one pair's A run together and find it in L2.
//
// The epilogue is the caller's: the forward adds f and the bias, the
// backward stores dp in fp32. No atomics, a fixed order: bitwise
// reproducible.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "film_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int WIDE_MAX_C = 2048;
constexpr int WIDE_ROWS = 64;                          // rows of a tile
constexpr int WIDE_STAGES = 4;
constexpr int WIDE_THREADS = 256;
constexpr int WIDE_A_BYTES = WIDE_ROWS * K_TILE * 2;   // 8 KB
constexpr int WIDE_B_BYTES = N_TILE * K_TILE * 2;      // 16 KB

template <int NB>
struct Wide {
  static constexpr int STAGE = 2 * WIDE_A_BYTES + NB * WIDE_B_BYTES;
  static size_t smem_bytes() {
    return 1024 + static_cast<size_t>(WIDE_STAGES) * STAGE +
           2 * WIDE_STAGES * 8;
  }
};

// 128-column chunks a block takes at this width
inline int wide_nb(int c) { return c % (2 * N_TILE) == 0 ? 2 : 1; }

// row tiles of (b, n), rounded up to pairs
inline long long wide_tiles(int b, int n) {
  const long long t = static_cast<long long>(b) * ((n + WIDE_ROWS - 1) /
                                                   WIDE_ROWS);
  return (t + 1) / 2 * 2;
}

// offset (bf16 values) of row r < 64, column k of row tile `tile` in the
// packed A (rows_packed_index)
__device__ __forceinline__ size_t wide_a_offset(size_t tile, int r, int k,
                                                int c) {
  return tile * WIDE_ROWS * c + static_cast<size_t>(k >> 6) * (WIDE_ROWS * 64)
         + r * 64 + ((((k & 63) >> 3) ^ (r & 7)) << 3) + (k & 7);
}

// the ring of stages: dynamic shared memory on a 1024-byte boundary (the
// swizzle repeats every 1024 bytes of address)
__device__ __forceinline__ uint8_t* wide_ring() {
  extern __shared__ uint8_t smem_raw[];
  return smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
}

// The block's product: acc[q] (64 x 128 a warpgroup) = rows of tile
// 2 * pair + wg times output chunk chunk0 + q. Returns with every stage
// released and the accumulators final; the other warpgroup may still be
// reading the ring.
template <int NB>
__device__ __forceinline__ void wide_product(
    const __nv_bfloat16* __restrict__ a_packed,
    const __nv_bfloat16* __restrict__ b_packed, int c, size_t pair,
    int chunk0, float (&acc)[NB][64]) {
  constexpr int STAGE = Wide<NB>::STAGE;
  uint8_t* ring = wide_ring();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WIDE_STAGES * STAGE);
  uint64_t* empty = full + WIDE_STAGES;
  const int k_tiles = c / K_TILE;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;

  // stage i % WIDE_STAGES takes k tile i: the pair's two A blocks, then
  // the NB B tiles
  auto load_stage = [&](int i) {
    uint8_t* dst = ring + (i % WIDE_STAGES) * STAGE;
    uint64_t* bar = &full[i % WIDE_STAGES];
    mbar_arrive_expect_tx(bar, STAGE);
    for (int g = 0; g < 2; ++g)
      bulk_copy_g2s(dst + g * WIDE_A_BYTES,
                    a_packed + (2 * pair + g) * WIDE_ROWS * c +
                        static_cast<size_t>(i) * WIDE_ROWS * K_TILE,
                    WIDE_A_BYTES, bar);
    for (int q = 0; q < NB; ++q)
      bulk_copy_g2s(dst + 2 * WIDE_A_BYTES + q * WIDE_B_BYTES,
                    b_packed + (static_cast<size_t>(chunk0 + q) * k_tiles +
                                i) * N_TILE * K_TILE,
                    WIDE_B_BYTES, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < WIDE_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < WIDE_STAGES && i < k_tiles; ++i) load_stage(i);

  // this warpgroup's products of k tile i are done: release its stage
  auto release = [&](int i) {
    if (tid == 0) mbar_arrive(&empty[i % WIDE_STAGES]);
    if (threadIdx.x == 0 && i + WIDE_STAGES < k_tiles) {
      mbar_wait(&empty[i % WIDE_STAGES], (i / WIDE_STAGES) & 1);
      load_stage(i + WIDE_STAGES);
    }
  };
#pragma unroll
  for (int q = 0; q < NB; ++q)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[q][i] = 0.0f;
  const uint32_t ring_base = smem_u32(ring);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int st = kt % WIDE_STAGES;
    mbar_wait(&full[st], (kt / WIDE_STAGES) & 1);
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[q][i]);
    wgmma_fence();
    const uint32_t sb = ring_base + st * STAGE;
    const uint64_t da = desc_sw128(sb + wg * WIDE_A_BYTES);
#pragma unroll
    for (int kk = 0; kk < K_TILE / 16; ++kk)
#pragma unroll
      for (int q = 0; q < NB; ++q)
        wgmma_m64n128k16(acc[q], da + 2 * kk,
                         desc_sw128(sb + 2 * WIDE_A_BYTES +
                                    q * WIDE_B_BYTES) + 2 * kk,
                         1);
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

}  // namespace
