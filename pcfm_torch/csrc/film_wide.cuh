// The FiLM block's wide paths (forward 1024 < C <= WIDE_MAX_C_FWD_BF16 in
// bf16 and WIDE_MAX_C_FWD_F32 in fp32, backward 512 < C <= WIDE_MAX_C_BWD):
// the packed row tiles both directions stream (wide_tiles, wide_a_offset).
// The forward's persistent product (film_block.cu) and the backward's
// cluster kernel (film_block_bwd.cu) each stream them in a loop of their
// own.
//
// At these widths a 64-row tile's whole bf16 operand (64 x C) or its fp32
// dp (64 x C in registers) no longer fits on an SM, so the products stream
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
// is one contiguous 16 KB block in the same layout. Row tiles go in pairs
// (two warpgroups of 64 rows; the packed A has an even number of tiles).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "film_common.cuh"
#include "wgmma_common.cuh"

namespace {

// The widest C of each direction: the forward's are the JAX kernel's own
// (pcfm/ops/pallas/film_block.py:_fwd_kernel compiles for a v5e up to C =
// 4608 in bf16 and 4352 in fp32, W's (C, C) fp32 window filling VMEM;
// scripts/film_jax_limits.py prints them); the backward's is the JAX
// kernel's limit in both dtypes (_bwd_kernel compiles up to C = 2688), where
// its cluster kernel takes ceil(C / 256) <= 11 CTAs, a non-portable cluster
// above 2048. Neither wide_tiles nor wide_a_offset depends on C.
constexpr int WIDE_MAX_C_FWD_BF16 = 4608;
constexpr int WIDE_MAX_C_FWD_F32 = 4352;
constexpr int WIDE_MAX_C_BWD = 2688;
constexpr int WIDE_ROWS = 64;                          // rows of a tile
constexpr int WIDE_A_BYTES = WIDE_ROWS * K_TILE * 2;   // 8 KB
constexpr int WIDE_B_BYTES = N_TILE * K_TILE * 2;      // 16 KB

// row tiles of (b, n), rounded up to pairs
__host__ __device__ inline long long wide_tiles(int b, int n) {
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

}  // namespace
