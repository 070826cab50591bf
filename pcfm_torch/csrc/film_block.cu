// Fused FiLM residual block, forward, for Hopper (sm_90a).
//
// Replaces pcfm/ops/pallas/film_block.py:_fwd_kernel (the TPU kernel) and
// computes what it computes, per row n of cloud b:
//
//   mean, rstd = LayerNorm statistics of h[b, n, :] (fp32, two-pass
//                variance, eps 1e-5)
//   f          = ((h - mean) * rstd * s + t) * (1 + gamma[b]) + beta[b]
//   y          = f + silu(f) @ W^T + bias          (W: torch Linear, out x in)
//
// and writes y in h's dtype plus the per-row mean and rstd (fp32), which the
// backward kernel reuses.
//
// Design:
//   * a pack kernel turns the fp32 W (out, in) into bf16 once per call, in
//     the byte order the wgmma B descriptor reads: tiles of 128 output rows
//     x 64 k, K-major, 128-byte swizzled (wgmma_common.cuh), in the order
//     the product consumes them, so each ring stage is ONE contiguous
//     16 KB bulk copy completed on an mbarrier (no tensor map, no driver
//     API);
//   * a block owns ROWS = 128 rows of one cloud (64 for C > 512, so that
//     the A operand fits): one or two warpgroups of 64 rows. Thread 0 keeps
//     a 4-stage ring of W tiles full: it asks for the first four at the
//     block's start, so that they arrive during the statistics, and for
//     each stage again once every warpgroup has released it. There is no
//     producer warp: a block of 256 threads may use 255 registers a
//     thread, where 288 threads are held to 168;
//   * statistics with h read once from device memory: one warp per row,
//     16-byte loads, 32 bytes of h in flight a lane (2 to 8 rows a warp),
//     the two-pass mean and variance from registers; each warp writes
//     silu(f) (fast exp and divide) as bf16 straight into the swizzled
//     K-major A operand (the whole ROWS x C tile stays in shared memory);
//   * the product on wgmma m64n128k16 (bf16 x bf16 -> fp32, the TPU
//     kernel's DEFAULT-precision dot), A and B from shared memory, over
//     128-column output chunks and 64-deep k stages; a warpgroup releases
//     a stage after the wgmma.wait_group that covers it;
//   * the epilogue works on the accumulator registers: f is recomputed in
//     fp32 from h (the block's own rows, loaded before the chunk's product
//     so that the product hides the latency; the statistics pass just read
//     them, so L1 / L2 hits), the saved statistics and s, t, gamma, beta,
//     bias read through L1; y is stored as 2-element (4-byte bf16 / 8-byte
//     fp32) vectors, 16 contiguous bytes a row per warp instruction;
//   * no atomics and a fixed order: two launches are bitwise equal.
//
// What bounds it at (B, N, C) = (8, 20000, 512): it must read h and write y
// (2 x 164 MB in bf16) plus W and the stats, about 0.33 GB (~0.1 ms at
// 3.35 TB/s), and do 2 * 160k * 512^2 = 84 GFLOP (~0.085 ms at
// 989 TFLOP/s dense bf16). It takes ~0.5 ms on an H100 SXM at 700 W, where
// the product alone takes ~0.15 ms (cuBLAS): with one block per SM (A is
// 128 KB of shared memory) a tile's statistics, product and epilogue run
// one after the other, and only the W ring overlaps them. The statistics
// (FiLM and silu per value on the fp32 units) and the epilogue (f again,
// the params, stores that touch 8 rows per warp instruction) take more of
// the time than the product.
//
// What it leaves for later:
//   * overlap across tiles: a persistent block in which one warpgroup's
//     statistics and epilogue run while another's product does (two 64-row
//     A buffers), with each W stage multicast to a cluster so that W's L2
//     traffic (0.5 MB a block here) does not double;
//   * full-line y stores: staging y through shared memory cost more
//     registers than the block has, and spilled.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "film_common.cuh"
#include "film_wide.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int STAGES = 4;     // W ring depth
constexpr int STAGE_BYTES = N_TILE * K_TILE * 2;
constexpr int MAX_C = 1024;  // the one-kernel path; wider C: the wide path
constexpr int PACK_THREADS = 256;

// WG warpgroups of 64 rows; thread 0 also keeps the W ring full
template <int WG>
struct Tile {
  static constexpr int ROWS = 64 * WG;
  static constexpr int THREADS = 128 * WG;
  // 8-value groups of a row a lane holds: C / 8 <= 32 * GROUPS
  static constexpr int GROUPS = WG == 2 ? 2 : 4;
  static size_t smem_bytes(int c) {
    return 1024 +                                       // alignment slack
           static_cast<size_t>(ROWS) * c * 2 +          // A, bf16
           static_cast<size_t>(STAGES) * STAGE_BYTES +  // W ring
           2 * ROWS * 4 +                               // mean, rstd
           2 * STAGES * 8;                              // full, empty
  }
};

// two consecutive values, as loaded and as fp32
template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  __nv_bfloat162 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ __forceinline__ float2 get() const {
    return __bfloat1622float2(v);
  }
};

template <>
struct Pair<float> {
  float2 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ __forceinline__ float2 get() const { return v; }
};

template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  Pair<T> v;
  v.load(p);
  return v.get();
}

// one thread per 8 consecutive k of one W row: two 16-byte loads, one
// 16-byte store
__global__ void __launch_bounds__(PACK_THREADS)
    pack_w_kernel(const float* __restrict__ w,
                  __nv_bfloat16* __restrict__ packed, int c) {
  const int idx = blockIdx.x * PACK_THREADS + threadIdx.x;
  if (idx >= c * (c / 8)) return;
  const int n = idx / (c / 8), k = (idx % (c / 8)) * 8;
  float x[8];
  load8(w + static_cast<size_t>(n) * c + k, x);
  *reinterpret_cast<uint4*>(packed + packed_offset(n, k, c)) =
      pack_bf16x8(x);
}

template <typename T, int WG>
__global__ void __launch_bounds__(Tile<WG>::THREADS, 1)
    film_block_fwd_kernel(const T* __restrict__ h,
                          const float* __restrict__ s,
                          const float* __restrict__ t,
                          const T* __restrict__ gamma,
                          const T* __restrict__ beta,
                          const __nv_bfloat16* __restrict__ w_packed,
                          const float* __restrict__ bias,
                          T* __restrict__ y, float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int n_points,
                          int c) {
  constexpr int ROWS = Tile<WG>::ROWS;
  constexpr int GROUPS = Tile<WG>::GROUPS;
  // rows a warp has in flight in the statistics pass: 32 bytes of h a
  // lane, so that the loads of 8 warps cover the memory latency
  constexpr int ROW_BATCH = 32 / (GROUPS * static_cast<int>(sizeof(T)));

  // A and the ring on 1024-byte boundaries (the swizzle repeats every
  // 1024 bytes of address); ROWS * C * 2 and STAGE_BYTES keep that
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_tile = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = a_tile + static_cast<size_t>(ROWS) * c * 2;
  float* s_mean = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  float* s_rstd = s_mean + ROWS;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_rstd + ROWS);
  uint64_t* empty = full + STAGES;

  const int row0 = blockIdx.x * ROWS;
  const size_t cloud_row0 = static_cast<size_t>(blockIdx.y) * n_points;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WG);
    }
    mbar_fence_init();
  }
  // s, t, gamma, beta and bias are read where they are used: a few KB
  // that every block reads, so L1 / L2 hits
  const T* g_c = gamma + static_cast<size_t>(blockIdx.y) * c;
  const T* be_c = beta + static_cast<size_t>(blockIdx.y) * c;
  __syncthreads();

  // thread 0 keeps the W ring full: stage i % STAGES takes packed tile i
  // (the product's order); the first STAGES tiles are asked for now, so
  // that they arrive during the statistics, and each stage again as soon
  // as every warpgroup has released it
  const int k_tiles = c / K_TILE;
  const int total = (c / N_TILE) * k_tiles;
  auto load_stage = [&](int i) {
    const int st = i % STAGES;
    mbar_arrive_expect_tx(&full[st], STAGE_BYTES);
    bulk_copy_g2s(ring + st * STAGE_BYTES,
                  w_packed + static_cast<size_t>(i) * N_TILE * K_TILE,
                  STAGE_BYTES, &full[st]);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < STAGES && i < total; ++i) load_stage(i);

  // ---- statistics and silu(f) of this warp's 16 rows into A
  const int wg = warp >> 2;
  const int groups = c >> 3;
  for (int rb = warp * 16; rb < warp * 16 + 16; rb += ROW_BATCH) {
    Group<T> raw[ROW_BATCH][GROUPS];
#pragma unroll
    for (int rr = 0; rr < ROW_BATCH; ++rr) {
      const int n = row0 + rb + rr;
#pragma unroll
      for (int gi = 0; gi < GROUPS; ++gi) {
        const int gidx = lane + 32 * gi;
        if (n < n_points && gidx < groups)
          raw[rr][gi].load(h + (cloud_row0 + n) * c + gidx * 8);
        else
          raw[rr][gi].clear();
      }
    }
    float mean[ROW_BATCH], rstd[ROW_BATCH];
#pragma unroll
    for (int rr = 0; rr < ROW_BATCH; ++rr) {
      float sum = 0.0f;
#pragma unroll
      for (int gi = 0; gi < GROUPS; ++gi) {
        float x[8];
        raw[rr][gi].unpack(x);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += x[e];
      }
      mean[rr] = warp_sum(sum) / c;
      float sq = 0.0f;
#pragma unroll
      for (int gi = 0; gi < GROUPS; ++gi) {
        if (lane + 32 * gi >= groups) continue;  // padding, not zeros
        float x[8];
        raw[rr][gi].unpack(x);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = x[e] - mean[rr];
          sq += d * d;
        }
      }
      rstd[rr] = rsqrtf(warp_sum(sq) / c + LN_EPS);
    }
#pragma unroll
    for (int gi = 0; gi < GROUPS; ++gi) {
      const int gidx = lane + 32 * gi;
      if (gidx >= groups) continue;
      float sv[8], tv[8], gv[8], bv[8];
      load8(s + gidx * 8, sv);
      load8(t + gidx * 8, tv);
      load8(g_c + gidx * 8, gv);
      load8(be_c + gidx * 8, bv);
      const int kb = gidx >> 3, j = gidx & 7;
#pragma unroll
      for (int rr = 0; rr < ROW_BATCH; ++rr) {
        const int r = rb + rr;
        uint4 out = make_uint4(0u, 0u, 0u, 0u);  // rows past N: zeros
        if (row0 + r < n_points) {
          float x[8];
          raw[rr][gi].unpack(x);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float f =
                film_f(x[e], mean[rr], rstd[rr], sv[e], tv[e], gv[e], bv[e]);
            // silu with the fast exp and divide: their few-ulp error is
            // far below the bf16 rounding of A that follows
            x[e] = __fdividef(f, 1.0f + __expf(-f));
          }
          out = pack_bf16x8(x);
        }
        *reinterpret_cast<uint4*>(a_tile + static_cast<size_t>(kb) * ROWS * 128 +
                                  r * 128 + ((j ^ (r & 7)) << 4)) = out;
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int rr = 0; rr < ROW_BATCH; ++rr) {
        const int r = rb + rr, n = row0 + r;
        if (n >= n_points) continue;
        s_mean[r] = mean[rr];
        s_rstd[r] = rstd[rr];
        mean_out[cloud_row0 + n] = mean[rr];
        rstd_out[cloud_row0 + n] = rstd[rr];
      }
    }
  }
  // the generic-proxy stores to A (and the stats) before wgmma reads A
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);

  // ---- the product, chunk by chunk, and the epilogue from the registers
  const int tid = threadIdx.x & 127;
  // this warpgroup's products of tile i are done: release its stage
  auto release = [&](int i) {
    if (tid == 0) mbar_arrive(&empty[i % STAGES]);
    if (threadIdx.x == 0 && i + STAGES < total) {
      mbar_wait(&empty[i % STAGES], (i / STAGES) & 1);
      load_stage(i + STAGES);
    }
  };
  const uint32_t a_base = smem_u32(a_tile) + wg * 64 * 128;
  const uint32_t ring_base = smem_u32(ring);
  const int er = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // rows er, er+8
  const int ec = 2 * (lane & 3);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  int it = 0;
  for (int n0 = 0; n0 < c; n0 += N_TILE) {
    // the epilogue's h (an L2 hit: the stats pass just read it), loaded
    // now so that the product hides the latency
    Pair<T> hp[2][N_TILE / 8];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int n = row0 + er + 8 * hr;
      if (n >= n_points) continue;
      const T* h_row = h + (cloud_row0 + n) * c + n0 + ec;
#pragma unroll
      for (int j = 0; j < N_TILE / 8; ++j) hp[hr][j].load(h_row + 8 * j);
    }
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
      wgmma_fence();
      const uint64_t da = desc_sw128(a_base + kt * ROWS * 128);
      const uint64_t db = desc_sw128(ring_base + st * STAGE_BYTES);
#pragma unroll
      for (int kk = 0; kk < K_TILE / 16; ++kk)
        wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
      wgmma_commit();
      if (kt > 0) {
        wgmma_wait<1>();  // the previous stage's products are done
        release(it - 1);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
    release(it - 1);

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = er + 8 * hr, n = row0 + r;
      if (n >= n_points) continue;
      const float mu = s_mean[r], rs = s_rstd[r];
      const size_t off = (cloud_row0 + n) * c;
#pragma unroll
      for (int j = 0; j < N_TILE / 8; ++j) {
        const int k = n0 + 8 * j + ec;
        const float2 x = hp[hr][j].get();
        const float2 sv = load2(s + k), tv = load2(t + k);
        const float2 gv = load2(g_c + k), bv = load2(be_c + k);
        const float2 bb = load2(bias + k);
        const float f0 = film_f(x.x, mu, rs, sv.x, tv.x, gv.x, bv.x);
        const float f1 = film_f(x.y, mu, rs, sv.y, tv.y, gv.y, bv.y);
        store2(y + off + k, f0 + acc[4 * j + 2 * hr] + bb.x,
               f1 + acc[4 * j + 2 * hr + 1] + bb.y);
      }
    }
  }
}

// ------------------------------------------------------ the wide path
//
// For MAX_C < C <= WIDE_MAX_C_FWD_BF16 (bf16; WIDE_MAX_C_FWD_F32 for fp32,
// the JAX kernel's limits) the 64 x C bf16 silu(f) tile no longer fits in
// shared memory (256 KB at C = 2048), so the forward runs in two kernels
// (film_wide.cuh):
//   * statistics and prologue: a block owns one 64-row tile of one cloud,
//     a warp a row at a time (16-byte loads, the row in registers, the
//     two-pass mean and variance as the one-kernel path takes them); it
//     writes mean and rstd and silu(f) as bf16 into device memory, packed
//     as the product's A (rows_packed_index), zeros past N. A lane holds
//     GROUPS 8-value groups of the row, a constant of the instantiation:
//     8 up to C = 2048 (STATS_GROUPS_NARROW), and for wider C the dtype's
//     limit / 256 (18 in bf16, 17 in fp32: 136 fp32 values a lane), so
//     that the widths up to 2048 keep their registers and their code;
//   * the streamed product over A's and W's k stages, and the epilogue on
//     the accumulators: f recomputed in fp32 from h and the saved
//     statistics, y = f + acc + bias.
// What bounds it: the product, 2 B N C^2 operations (1.357 ms at (8, 20000,
// 2048) at 989 TFLOP/s dense bf16, 6.87 ms at C = 4608), against ~1.3 GB of
// h, y and the stats at C = 2048 (0.4 ms at 3.35 TB/s). What it adds to the
// one-kernel path's bytes: silu(f) written and read back (2 x B x N x C
// bf16), and A read once for each block of output chunks (from L2: the
// blocks that share a pair of tiles run together). The grid runs the chunk
// fastest, so every pair of row tiles reads all of W: at C = 4608 the
// packed bf16 W is 42.5 MB against the H100's 50 MB L2, and W's reads stay
// on chip only while it stays there. Its time beside the bound: PERF.md §6.

// 8-value groups a lane of the statistics kernel holds up to C = 2048
constexpr int STATS_GROUPS_NARROW = 2048 / 256;

// the widest C the forward takes in T: the JAX kernel's (film_wide.cuh)
template <typename T>
constexpr int fwd_max_c() {
  return sizeof(T) == 2 ? WIDE_MAX_C_FWD_BF16 : WIDE_MAX_C_FWD_F32;
}

template <typename T, int GROUPS>
__global__ void __launch_bounds__(WIDE_THREADS)
    film_block_fwd_wide_stats_kernel(const T* __restrict__ h,
                                     const float* __restrict__ s,
                                     const float* __restrict__ t,
                                     const T* __restrict__ gamma,
                                     const T* __restrict__ beta,
                                     __nv_bfloat16* __restrict__ a_packed,
                                     float* __restrict__ mean_out,
                                     float* __restrict__ rstd_out,
                                     int n_points, int c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = c >> 3;
  const size_t tile = static_cast<size_t>(blockIdx.y) * gridDim.x +
                      blockIdx.x;
  const size_t cloud_row0 = static_cast<size_t>(blockIdx.y) * n_points;
  const T* g_c = gamma + static_cast<size_t>(blockIdx.y) * c;
  const T* be_c = beta + static_cast<size_t>(blockIdx.y) * c;
  for (int r = warp; r < WIDE_ROWS; r += WIDE_THREADS / 32) {
    const int n = blockIdx.x * WIDE_ROWS + r;
    if (n >= n_points) {  // rows past N: zeros
      for (int gidx = lane; gidx < groups; gidx += 32)
        *reinterpret_cast<uint4*>(a_packed +
                                  wide_a_offset(tile, r, gidx * 8, c)) =
            make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    Group<T> raw[GROUPS];
#pragma unroll
    for (int gi = 0; gi < GROUPS; ++gi) {
      const int gidx = lane + 32 * gi;
      if (gidx < groups)
        raw[gi].load(h + (cloud_row0 + n) * c + gidx * 8);
      else
        raw[gi].clear();
    }
    float sum = 0.0f;
#pragma unroll
    for (int gi = 0; gi < GROUPS; ++gi) {
      float x[8];
      raw[gi].unpack(x);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += x[e];
    }
    const float mean = warp_sum(sum) / c;
    float sq = 0.0f;
#pragma unroll
    for (int gi = 0; gi < GROUPS; ++gi) {
      if (lane + 32 * gi >= groups) continue;  // padding, not zeros
      float x[8];
      raw[gi].unpack(x);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = x[e] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / c + LN_EPS);
    if (lane == 0) {
      mean_out[cloud_row0 + n] = mean;
      rstd_out[cloud_row0 + n] = rstd;
    }
#pragma unroll
    for (int gi = 0; gi < GROUPS; ++gi) {
      const int gidx = lane + 32 * gi;
      if (gidx >= groups) continue;
      float sv[8], tv[8], gv[8], bv[8], x[8];
      load8(s + gidx * 8, sv);
      load8(t + gidx * 8, tv);
      load8(g_c + gidx * 8, gv);
      load8(be_c + gidx * 8, bv);
      raw[gi].unpack(x);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = film_f(x[e], mean, rstd, sv[e], tv[e], gv[e], bv[e]);
        x[e] = __fdividef(f, 1.0f + __expf(-f));  // as the one-kernel path
      }
      *reinterpret_cast<uint4*>(a_packed +
                                wide_a_offset(tile, r, gidx * 8, c)) =
          pack_bf16x8(x);
    }
  }
}

// four consecutive values, as loaded and stored (8 bytes of bf16, 16 of
// fp32)
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xFFFF0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xFFFF0000u));
}
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16x2_bits(x.x, x.y), bf16x2_bits(x.z, x.w));
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// the product and the epilogue: block i takes output chunks (i % nchunk) *
// NB .. + NB - 1 of the pair of row tiles i / nchunk. The accumulators go
// through the freed ring (a row of 128 NB fp32 + 8 of padding), so that the
// epilogue walks whole rows: a warp 16 rows, a lane 4 consecutive columns
// of each 128, h read and y written 256 or 512 contiguous bytes a warp
// instruction, and few registers live beside the loads.
template <typename T, int NB>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    film_block_fwd_wide_kernel(const T* __restrict__ h,
                               const float* __restrict__ s,
                               const float* __restrict__ t,
                               const T* __restrict__ gamma,
                               const T* __restrict__ beta,
                               const __nv_bfloat16* __restrict__ a_packed,
                               const __nv_bfloat16* __restrict__ w_packed,
                               const float* __restrict__ bias,
                               T* __restrict__ y,
                               const float* __restrict__ mean,
                               const float* __restrict__ rstd, int bsz,
                               int n_points, int c) {
  constexpr int LD = N_TILE * NB + 8;
  const int nchunk = c / (N_TILE * NB);
  const int chunk0 = (blockIdx.x % nchunk) * NB;
  const size_t pair = blockIdx.x / nchunk;
  float acc[NB][64];
  wide_product<NB>(a_packed, w_packed, c, pair, chunk0, acc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  __syncthreads();  // both warpgroups' products have read the ring
  float* stage = reinterpret_cast<float*>(wide_ring()) + wg * WIDE_ROWS * LD;
  {
    const int er = (warp & 3) * 16 + (lane >> 2), ec = 2 * (lane & 3);
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int j = 0; j < N_TILE / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(stage + (er + 8 * hr) * LD +
                                     q * N_TILE + 8 * j + ec) =
              make_float2(acc[q][4 * j + 2 * hr], acc[q][4 * j + 2 * hr + 1]);
  }
  named_barrier_sync(1 + wg, 128);  // this warpgroup's rows are staged

  const size_t tile = 2 * pair + wg;
  const int tiles = (n_points + WIDE_ROWS - 1) / WIDE_ROWS;
  const size_t b = tile / tiles;
  if (b >= static_cast<size_t>(bsz)) return;  // the pairs' padding tile
  const T* g_c = gamma + b * c;
  const T* be_c = beta + b * c;
  const int n0 = static_cast<int>(tile % tiles) * WIDE_ROWS;
#pragma unroll 4
  for (int rr = 0; rr < 16; ++rr) {
    const int r = (warp & 3) * 16 + rr, n = n0 + r;
    if (n >= n_points) break;
    const size_t row = b * n_points + n;
    const float mu = mean[row], rs = rstd[row];
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int k = (chunk0 + q) * N_TILE + 4 * lane;
      const float4 x = load4(h + row * c + k);
      const float4 sv = load4(s + k), tv = load4(t + k);
      const float4 gv = load4(g_c + k), bv = load4(be_c + k);
      const float4 bb = load4(bias + k);
      const float4 a = *reinterpret_cast<const float4*>(
          stage + r * LD + q * N_TILE + 4 * lane);
      store4(y + row * c + k,
             make_float4(film_f(x.x, mu, rs, sv.x, tv.x, gv.x, bv.x) + a.x +
                             bb.x,
                         film_f(x.y, mu, rs, sv.y, tv.y, gv.y, bv.y) + a.y +
                             bb.y,
                         film_f(x.z, mu, rs, sv.z, tv.z, gv.z, bv.z) + a.z +
                             bb.z,
                         film_f(x.w, mu, rs, sv.w, tv.w, gv.w, bv.w) + a.w +
                             bb.w));
    }
  }
}

template <typename T, int NB>
int launch_wide_product(const void* h, const void* s, const void* t,
                        const void* gamma, const void* beta,
                        const __nv_bfloat16* a_packed,
                        const __nv_bfloat16* w_packed, const void* bias,
                        void* y, const void* mean, const void* rstd, int b,
                        int n, int c, cudaStream_t stream) {
  const size_t smem = Wide<NB>::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      film_block_fwd_wide_kernel<T, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = wide_tiles(b, n) / 2 * (c / (N_TILE * NB));
  film_block_fwd_wide_kernel<T, NB>
      <<<static_cast<unsigned>(blocks), WIDE_THREADS, smem, stream>>>(
          static_cast<const T*>(h), static_cast<const float*>(s),
          static_cast<const float*>(t), static_cast<const T*>(gamma),
          static_cast<const T*>(beta), a_packed, w_packed,
          static_cast<const float*>(bias), static_cast<T*>(y),
          static_cast<const float*>(mean), static_cast<const float*>(rstd),
          b, n, c);
  return static_cast<int>(cudaGetLastError());
}

// w_packed: c * c bf16 (W), then the packed A (wide_tiles x 64 x c bf16)
template <typename T>
int launch_wide(const void* h, const void* s, const void* t,
                const void* gamma, const void* beta, const void* w_packed,
                const void* bias, void* y, void* mean, void* rstd, int b,
                int n, int c, cudaStream_t stream) {
  const auto* wp = static_cast<const __nv_bfloat16*>(w_packed);
  auto* a_packed = const_cast<__nv_bfloat16*>(wp) +
                   static_cast<size_t>(c) * c;
  const dim3 grid((n + WIDE_ROWS - 1) / WIDE_ROWS, b);
  // the dtype's widest C over 256: every lane's share of the widest row
  constexpr int WIDE_GROUPS = fwd_max_c<T>() / 256;
  auto* stats = c <= 32 * 8 * STATS_GROUPS_NARROW
                    ? film_block_fwd_wide_stats_kernel<T, STATS_GROUPS_NARROW>
                    : film_block_fwd_wide_stats_kernel<T, WIDE_GROUPS>;
  stats<<<grid, WIDE_THREADS, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), a_packed, static_cast<float*>(mean),
      static_cast<float*>(rstd), n, c);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (wide_nb(c) == 2)
    return launch_wide_product<T, 2>(h, s, t, gamma, beta, a_packed, wp,
                                     bias, y, mean, rstd, b, n, c, stream);
  return launch_wide_product<T, 1>(h, s, t, gamma, beta, a_packed, wp, bias,
                                   y, mean, rstd, b, n, c, stream);
}

int launch_pack(const void* w, void* packed, int c, cudaStream_t stream) {
  const int items = c * (c / 8);
  pack_w_kernel<<<(items + PACK_THREADS - 1) / PACK_THREADS, PACK_THREADS, 0,
                  stream>>>(static_cast<const float*>(w),
                            static_cast<__nv_bfloat16*>(packed), c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int WG>
int launch(const void* h, const void* s, const void* t, const void* gamma,
           const void* beta, const void* w_packed, const void* bias, void* y,
           void* mean, void* rstd, int b, int n, int c,
           cudaStream_t stream) {
  constexpr int ROWS = Tile<WG>::ROWS;
  const size_t smem = Tile<WG>::smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(
      film_block_fwd_kernel<T, WG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + ROWS - 1) / ROWS, b);
  film_block_fwd_kernel<T, WG><<<grid, Tile<WG>::THREADS, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<const T*>(gamma),
      static_cast<const T*>(beta),
      static_cast<const __nv_bfloat16*>(w_packed),
      static_cast<const float*>(bias), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), n, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_any(const void* h, const void* s, const void* t,
               const void* gamma, const void* beta, const void* w_packed,
               const void* bias, void* y, void* mean, void* rstd, int b,
               int n, int c, cudaStream_t stream) {
  if (c > MAX_C)
    return launch_wide<T>(h, s, t, gamma, beta, w_packed, bias, y, mean,
                          rstd, b, n, c, stream);
  if (c <= 32 * 8 * Tile<2>::GROUPS)  // two warpgroups up to C = 512
    return launch<T, 2>(h, s, t, gamma, beta, w_packed, bias, y, mean, rstd,
                        b, n, c, stream);
  return launch<T, 1>(h, s, t, gamma, beta, w_packed, bias, y, mean, rstd, b,
                      n, c, stream);
}

// a width the forward does not take in bf16 (is_bf16) or fp32; W alone
// (the pack, the workspace) takes the wider of the two limits
bool bad_c(int c, bool is_bf16 = true) {
  return c <= 0 || c % N_TILE != 0 ||
         c > (is_bf16 ? WIDE_MAX_C_FWD_BF16 : WIDE_MAX_C_FWD_F32);
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers of
// contiguous tensors; each call launches on `stream`, does not synchronise
// and returns a cudaError_t code.

// w (c, c) fp32 -> w_packed (c * c bf16), the B operand's layout
extern "C" int pcfm_film_block_pack_w(const void* w, void* w_packed, int c,
                                      void* stream) {
  if (bad_c(c)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_pack(w, w_packed, c, static_cast<cudaStream_t>(stream));
}

// bf16 values of scratch that pcfm_film_block_fwd needs for (b, n, c): W
// packed (c * c), and for c > MAX_C the packed silu(f) tiles; the same in
// both dtypes, so C up to the bf16 limit; -1 for a shape the kernel does
// not take in either dtype.
extern "C" long long pcfm_film_block_fwd_workspace(int b, int n, int c) {
  if (b <= 0 || n <= 0 || bad_c(c) || b > 65535) return -1;
  const long long w = static_cast<long long>(c) * c;
  return c > MAX_C ? w + wide_tiles(b, n) * WIDE_ROWS * c : w;
}

// h, y (b, n, c) and gamma, beta (b, c) in bf16 when is_bf16 else fp32;
// s, t, bias (c,), w (c, c), mean, rstd (b, n) fp32; w_packed is scratch of
// pcfm_film_block_fwd_workspace(b, n, c) bf16: W packed by the pack kernel
// before the forward runs, then (C > MAX_C) the packed silu(f).
extern "C" int pcfm_film_block_fwd(const void* h, const void* s,
                                   const void* t, const void* gamma,
                                   const void* beta, const void* w,
                                   const void* bias, void* w_packed, void* y,
                                   void* mean, void* rstd, int b, int n,
                                   int c, int is_bf16, void* stream) {
  if (b <= 0 || n <= 0 || bad_c(c, is_bf16 != 0) || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_pack(w, w_packed, c, st);
  if (err != 0) return err;
  if (is_bf16)
    return launch_any<__nv_bfloat16>(h, s, t, gamma, beta, w_packed, bias, y,
                                     mean, rstd, b, n, c, st);
  return launch_any<float>(h, s, t, gamma, beta, w_packed, bias, y, mean,
                           rstd, b, n, c, st);
}

extern "C" const char* pcfm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
