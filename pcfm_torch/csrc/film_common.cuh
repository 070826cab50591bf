// Device helpers shared by the FiLM-block forward and backward kernels.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

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

// a packed W tile: N_TILE rows of W (wgmma n) x K_TILE k, one 128-byte
// swizzle row each
constexpr int N_TILE = 128;
constexpr int K_TILE = 64;

// Offset (in bf16 values) of W[n, k] in the packed buffer: the stage of
// output tile n / N_TILE and k tile k / K_TILE, in the product's order
// (output tile outer), then row n % N_TILE of that stage with its 16-byte
// chunks swizzled. pack_w_reference (ops/film_block.py) is the same formula.
__device__ __forceinline__ size_t packed_offset(int n, int k, int c) {
  const int r = n % N_TILE, j = (k % K_TILE) / 8;
  const size_t stage = static_cast<size_t>(n / N_TILE) * (c / K_TILE) +
                       k / K_TILE;
  return (stage * N_TILE + r) * K_TILE + ((j ^ (r & 7)) * 8) + (k & 7);
}

// 8 consecutive values of a row, as loaded (16 bytes of bf16, 32 of fp32)
template <typename T>
struct Group;

template <>
struct Group<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void clear() { v = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void unpack(float (&x)[8]) const {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

template <>
struct Group<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p + 4));
  }
  __device__ __forceinline__ void clear() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void unpack(float (&x)[8]) const {
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
};

// 8 consecutive values as fp32, by one or two 16-byte loads
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&x)[8]) {
  Group<T> g;
  g.load(p);
  g.unpack(x);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint4 pack_bf16x8(const float (&x)[8]) {
  return make_uint4(bf16x2_bits(x[0], x[1]), bf16x2_bits(x[2], x[3]),
                    bf16x2_bits(x[4], x[5]), bf16x2_bits(x[6], x[7]));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

}  // namespace
