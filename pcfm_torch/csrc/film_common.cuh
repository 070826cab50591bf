// Device helpers shared by the FiLM-block forward and backward kernels.
#pragma once

#include <cuda_bf16.h>

namespace {

constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f = LN(h) * (1 + gamma) + beta, in the TPU kernel's order of operations
__device__ __forceinline__ float film_f(float x, float mean, float rstd,
                                        float s, float t, float g,
                                        float be) {
  const float u = (x - mean) * rstd * s + t;
  return u * (1.0f + g) + be;
}

}  // namespace
