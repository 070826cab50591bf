// Device helpers shared by the voxel gather and scatter kernels: row slices
// of VEC bf16 or fp32 features (16, 8, 4 or 2 bytes), accumulated in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int VOX_THREADS = 256;                 // 8 warps a block

// elements of T in one 16-byte load: the slice of a row with C % 8 == 0
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// One slice of VEC values of a row of T, loaded raw so that several loads
// can be in flight before they are summed
template <typename T, int VEC>
struct Raw;
template <>
struct Raw<float, 4> {
  using type = float4;
};
template <>
struct Raw<float, 2> {
  using type = float2;
};
template <>
struct Raw<float, 1> {
  using type = float;
};
template <>
struct Raw<__nv_bfloat16, 8> {
  using type = uint4;
};
template <>
struct Raw<__nv_bfloat16, 4> {
  using type = uint2;
};
template <>
struct Raw<__nv_bfloat16, 2> {
  using type = unsigned int;
};
template <>
struct Raw<__nv_bfloat16, 1> {
  using type = unsigned short;
};

template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load_raw(const T* p) {
  return __ldg(reinterpret_cast<const typename Raw<T, VEC>::type*>(p));
}

// acc[0..N) += w * the slice, in fp32
__device__ __forceinline__ void fma_raw(float (&acc)[4], float w,
                                        const float4& v) {
  acc[0] = fmaf(w, v.x, acc[0]);
  acc[1] = fmaf(w, v.y, acc[1]);
  acc[2] = fmaf(w, v.z, acc[2]);
  acc[3] = fmaf(w, v.w, acc[3]);
}

__device__ __forceinline__ void fma_raw(float (&acc)[2], float w,
                                        const float2& v) {
  acc[0] = fmaf(w, v.x, acc[0]);
  acc[1] = fmaf(w, v.y, acc[1]);
}

__device__ __forceinline__ void fma_raw(float (&acc)[1], float w, float v) {
  acc[0] = fmaf(w, v, acc[0]);
}

// N / 2 bf16 pairs of a raw slice
template <int N>
__device__ __forceinline__ void fma_bf16_pairs(float (&acc)[N], float w,
                                               const void* raw) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(raw);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    acc[2 * i] = fmaf(w, f.x, acc[2 * i]);
    acc[2 * i + 1] = fmaf(w, f.y, acc[2 * i + 1]);
  }
}

__device__ __forceinline__ void fma_raw(float (&acc)[8], float w,
                                        const uint4& raw) {
  fma_bf16_pairs(acc, w, &raw);
}

__device__ __forceinline__ void fma_raw(float (&acc)[4], float w,
                                        const uint2& raw) {
  fma_bf16_pairs(acc, w, &raw);
}

__device__ __forceinline__ void fma_raw(float (&acc)[2], float w,
                                        const unsigned int& raw) {
  fma_bf16_pairs(acc, w, &raw);
}

__device__ __forceinline__ void fma_raw(float (&acc)[1], float w,
                                        unsigned short raw) {
  acc[0] = fmaf(w, __uint_as_float(static_cast<uint32_t>(raw) << 16),
                acc[0]);
}

// out[0..N) = acc, fp32, aligned to N * 4 bytes (16 at most)
template <int N>
__device__ __forceinline__ void store_vec(float* out, const float (&acc)[N]) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(out + i) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(out) = make_float2(acc[0], acc[1]);
  } else {
    out[0] = acc[0];
  }
}

// Values of T in a lane's slice of a row of C channels: the widest of 16,
// 8, 4 or 2 bytes that divides both the input row (C x sizeof(T) bytes)
// and the fp32 output row (C x 4), so every slice of every row is aligned
// to its own width (the rows' bases are 16-byte aligned); every C % 8 == 0
// gets Vec<T>::N, 16-byte slices.
template <typename T>
inline int vec_for(int c) {
  int vec = Vec<T>::N;
  while (vec > 1 && c % vec != 0) vec >>= 1;
  return vec;
}

// Lanes of a warp that share one row (a point or a voxel): the smallest
// power of two >= the row's slices, at most 32; a warp then serves
// 32 / lanes rows at once.
inline int lanes_for(int cvec) {
  int lanes = 1;
  while (lanes < cvec && lanes < 32) lanes <<= 1;
  return lanes;
}

}  // namespace
