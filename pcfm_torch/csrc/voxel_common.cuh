// Device helpers shared by the voxel gather and scatter kernels: 16-byte
// row slices of bf16 or fp32 features, accumulated in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int VOX_THREADS = 256;                 // 8 warps a block

// elements of T in one 16-byte load
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// One 16-byte slice of a row of T, loaded raw so that several loads can be
// in flight before they are summed
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using type = float4;
};
template <>
struct Raw<__nv_bfloat16> {
  using type = uint4;
};

template <typename T>
__device__ __forceinline__ typename Raw<T>::type load_raw(const T* p) {
  return __ldg(reinterpret_cast<const typename Raw<T>::type*>(p));
}

// acc[0..N) += w * the slice, in fp32
__device__ __forceinline__ void fma_raw(float (&acc)[4], float w,
                                        const float4& v) {
  acc[0] = fmaf(w, v.x, acc[0]);
  acc[1] = fmaf(w, v.y, acc[1]);
  acc[2] = fmaf(w, v.z, acc[2]);
  acc[3] = fmaf(w, v.w, acc[3]);
}

__device__ __forceinline__ void fma_raw(float (&acc)[8], float w,
                                        const uint4& raw) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    acc[2 * i] = fmaf(w, f.x, acc[2 * i]);
    acc[2 * i + 1] = fmaf(w, f.y, acc[2 * i + 1]);
  }
}

// out[0..N) = acc, fp32, 16-byte aligned
template <int N>
__device__ __forceinline__ void store_vec(float* out, const float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(out + i) =
        make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
}

// Lanes of a warp that share one row (a point or a voxel): the smallest
// power of two >= the row's 16-byte vectors, at most 32; a warp then
// serves 32 / lanes rows at once.
inline int lanes_for(int cvec) {
  int lanes = 1;
  while (lanes < cvec && lanes < 32) lanes <<= 1;
  return lanes;
}

}  // namespace
