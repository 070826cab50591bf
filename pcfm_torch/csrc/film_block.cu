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
// shared memory (256 KB at C = 2048), so the forward runs in two kernels:
//   * statistics and prologue (film_block_fwd_wide_stats_kernel): one warp
//     a row. Each row arrives in shared memory by one bulk copy into one of
//     the warp's STATS_SLOTS slots, so that the next row is on its way while
//     this one is computed, and is read there three times: the two-pass
//     mean and variance (each lane's groups and values in order, then
//     warp_sum: the one-kernel path's order and bits), then FiLM and silu,
//     written as bf16 into device memory packed as the product's A
//     (rows_packed_index), zeros past N, with mean and rstd. s, t, gamma and beta are read into shared memory as fp32 once
//     for each cloud a block meets. As many blocks as the card holds at
//     once, each a range of rows: one instantiation for every width;
//   * the product and its epilogue (film_block_fwd_wide_kernel): persistent
//     and warp-specialised. One CTA an SM walks the units (a pair of 64-row
//     tiles x a chunk of 256 columns, the last of 128 where C % 256 != 0)
//     in a grouped raster (bands of BAND_PAIRS pairs, the pair fastest, the
//     chunks walked back in odd bands), so that the units at work at once
//     share a band of W's chunks. The producer warpgroup, its registers
//     given to the consumers by setmaxnreg, keeps a ring of stages full:
//     each unit's k stages (the pair's two 8 KB A blocks and the chunk's W
//     tiles, bulk copies by one thread), then its epilogue rounds (the
//     rows of h, cp.async by every thread, and the round's s, t, bias,
//     gamma and beta), then the next unit's, so that it runs on into the
//     next unit while the consumers finish this one. The two consumer
//     warpgroups (64 rows each) run wgmma m64n256k16 on each k stage (on a
//     128-column chunk its second half reads a stale tile, and those
//     columns are never stored), then the epilogue round by round:
//     the accumulators through a buffer of their own, f recomputed in fp32
//     from the staged h and the saved statistics, y = f + acc + bias
//     written a row of 64 (bf16) or 32 (fp32) values, one 128-byte line, at
//     a time.
// Each output's arithmetic is fixed: k tiles in order, k16 steps in order
// (a wgmma's N does not change a column's sums), no split of k, and the
// epilogue's film_f + acc + bias, so two launches, and any CTA count, give
// the same bits.
// What bounds it: the product, 2 B N C^2 operations (1.357 ms at (8, 20000,
// 2048) at 989 TFLOP/s dense bf16, 6.87 ms at C = 4608), against ~1.3 GB of
// h, y and the stats at C = 2048 (0.4 ms at 3.35 TB/s); the statistics
// kernel alone by its bytes (h read, silu(f) written). Each k stage of a
// unit moves 48 KB from L2 for 4.2 MFLOP, so the product also leans on L2's
// bandwidth; the epilogue (f again, in fp32) runs while the tensor cores
// wait. Its time beside the bound: PERF.md §6.

constexpr int STATS_THREADS = 256;  // 8 warps (4 where 8 do not fit)
constexpr int STATS_SLOTS = 2;      // rows a warp holds: computed, arriving

// shared memory of the statistics kernel with `warps` warps at width c
template <typename T>
size_t stats_smem_bytes(int c, int warps) {
  return static_cast<size_t>(c) * 16 +                       // s, t, g, be
         static_cast<size_t>(warps) * STATS_SLOTS * c * sizeof(T) +
         static_cast<size_t>(warps) * STATS_SLOTS * 8;       // mbarriers
}

// 8 consecutive values of a row staged in shared memory, as fp32
__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float (&x)[8]) {
  Group<__nv_bfloat16> g;
  g.v = *reinterpret_cast<const uint4*>(p);
  g.unpack(x);
}
__device__ __forceinline__ void lds8(const float* p, float (&x)[8]) {
  Group<float> g;
  g.a = *reinterpret_cast<const float4*>(p);
  g.b = *reinterpret_cast<const float4*>(p + 4);
  g.unpack(x);
}

__device__ __forceinline__ void split8(const float (&v)[8], float4& lo,
                                       float4& hi) {
  lo = make_float4(v[0], v[1], v[2], v[3]);
  hi = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void join8(float4 lo, float4 hi, float (&v)[8]) {
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// Block i takes the padded rows [i R / G, (i + 1) R / G) of the R = B x
// tiles x 64 rows (a tile's rows past N included: they are written as
// zeros) of a grid of G blocks; warp w the rows w, w + warps, ... of that
// range. The parameters are read into shared memory once for each cloud
// the range touches (one or two).
template <typename T>
__global__ void __launch_bounds__(STATS_THREADS)
    film_block_fwd_wide_stats_kernel(const T* __restrict__ h,
                                     const float* __restrict__ s,
                                     const float* __restrict__ t,
                                     const T* __restrict__ gamma,
                                     const T* __restrict__ beta,
                                     __nv_bfloat16* __restrict__ a_packed,
                                     float* __restrict__ mean_out,
                                     float* __restrict__ rstd_out, int bsz,
                                     int n_points, int c) {
  extern __shared__ uint8_t smem_raw[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int groups = c >> 3;
  const long long cloud_rows =
      static_cast<long long>((n_points + WIDE_ROWS - 1) / WIDE_ROWS) *
      WIDE_ROWS;
  const long long rows = bsz * cloud_rows;
  const long long r0 = rows * blockIdx.x / gridDim.x;
  const long long r1 = rows * (blockIdx.x + 1) / gridDim.x;
  const uint32_t row_bytes = static_cast<uint32_t>(c * sizeof(T));
  // s, t, gamma, beta in fp32: parameter p's 8 values of group g are the
  // float4s par[2 p * groups + g] and par[(2 p + 1) * groups + g], so that
  // a warp's 16-byte reads are consecutive
  float4* par = reinterpret_cast<float4*>(smem_raw);
  uint8_t* rows_base = smem_raw + static_cast<size_t>(c) * 16;
  uint8_t* slots = rows_base + static_cast<size_t>(warp) * STATS_SLOTS *
                                   row_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
                       rows_base + static_cast<size_t>(warps) * STATS_SLOTS *
                                       row_bytes) +
                   warp * STATS_SLOTS;
  if (lane == 0) {
    for (int i = 0; i < STATS_SLOTS; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  __syncwarp();

  int it = 0;  // this warp's rows so far: slot it % STATS_SLOTS
  for (long long seg = r0; seg < r1;) {
    // a segment: the range's rows of one cloud
    const int b = static_cast<int>(seg / cloud_rows);
    const long long end = (b + 1) * cloud_rows < r1 ? (b + 1) * cloud_rows
                                                    : r1;
    // this warp's rows of the segment: seg + warp + warps i, i < count
    const int count = seg + warp < end ? static_cast<int>(
                          (end - seg - warp - 1) / warps + 1) : 0;
    // lane 0: the warp's row i into `slot` (rows past N: an arrival,
    // nothing read)
    auto issue = [&](int i, int slot) {
      const int n = static_cast<int>(seg + warp + static_cast<long long>(
                                         warps) * i - b * cloud_rows);
      if (n < n_points) {
        mbar_arrive_expect_tx(&full[slot], row_bytes);
        bulk_copy_g2s(slots + slot * row_bytes,
                      h + (static_cast<size_t>(b) * n_points + n) * c,
                      row_bytes, &full[slot]);
      } else {
        mbar_arrive(&full[slot]);
      }
    };
    if (lane == 0)
      for (int i = 0; i < STATS_SLOTS && i < count; ++i)
        issue(i, (it + i) % STATS_SLOTS);
    __syncthreads();  // the last segment's rows no longer read `par`
    const T* g_c = gamma + static_cast<size_t>(b) * c;
    const T* be_c = beta + static_cast<size_t>(b) * c;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      float v[8];
      load8(s + g * 8, v);
      split8(v, par[g], par[groups + g]);
      load8(t + g * 8, v);
      split8(v, par[2 * groups + g], par[3 * groups + g]);
      load8(g_c + g * 8, v);
      split8(v, par[4 * groups + g], par[5 * groups + g]);
      load8(be_c + g * 8, v);
      split8(v, par[6 * groups + g], par[7 * groups + g]);
    }
    __syncthreads();

    for (int i = 0; i < count; ++i, ++it) {
      const int slot = it % STATS_SLOTS;
      mbar_wait(&full[slot], (it / STATS_SLOTS) & 1);
      const long long p = seg + warp + static_cast<long long>(warps) * i;
      const int n = static_cast<int>(p - b * cloud_rows);
      const size_t tile = static_cast<size_t>(p / WIDE_ROWS);
      const int r = static_cast<int>(p % WIDE_ROWS);
      const size_t row0 = static_cast<size_t>(b) * n_points;
      if (n >= n_points) {  // rows past N: zeros
        for (int g = lane; g < groups; g += 32)
          *reinterpret_cast<uint4*>(a_packed + wide_a_offset(tile, r, g * 8,
                                                             c)) =
              make_uint4(0u, 0u, 0u, 0u);
      } else {
        const T* row = reinterpret_cast<const T*>(slots + slot * row_bytes);
        float sum = 0.0f;
        for (int g = lane; g < groups; g += 32) {
          float x[8];
          lds8(row + g * 8, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum += x[e];
        }
        const float mean = warp_sum(sum) / c;
        float sq = 0.0f;
        for (int g = lane; g < groups; g += 32) {
          float x[8];
          lds8(row + g * 8, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = x[e] - mean;
            sq += d * d;
          }
        }
        const float rstd = rsqrtf(warp_sum(sq) / c + LN_EPS);
        if (lane == 0) {
          mean_out[row0 + n] = mean;
          rstd_out[row0 + n] = rstd;
        }
        for (int g = lane; g < groups; g += 32) {
          float x[8], sv[8], tv[8], gv[8], bv[8];
          lds8(row + g * 8, x);
          join8(par[g], par[groups + g], sv);
          join8(par[2 * groups + g], par[3 * groups + g], tv);
          join8(par[4 * groups + g], par[5 * groups + g], gv);
          join8(par[6 * groups + g], par[7 * groups + g], bv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float f = film_f(x[e], mean, rstd, sv[e], tv[e], gv[e],
                                   bv[e]);
            // as the one-kernel path
            x[e] = __fdividef(f, 1.0f + __expf(-f));
          }
          *reinterpret_cast<uint4*>(a_packed +
                                    wide_a_offset(tile, r, g * 8, c)) =
              pack_bf16x8(x);
        }
      }
      __syncwarp();  // every lane has read the slot: refill it
      if (lane == 0 && i + STATS_SLOTS < count) {
        fence_proxy_async();
        issue(i + STATS_SLOTS, slot);
      }
    }
    seg = end;
  }
}

// four consecutive values stored (8 bytes of bf16, 16 of fp32)
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16x2_bits(x.x, x.y), bf16x2_bits(x.z, x.w));
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// the product: a producer warpgroup, then two consumer warpgroups of 64
// rows; setmaxnreg moves the producer's registers to the consumers (128 x
// 56 + 256 x 224 <= 65536)
constexpr int PRODUCT_THREADS = 384;
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
// the epilogue's buffer of a consumer warpgroup: its 64 rows x up to 64
// columns of accumulators, fp32
constexpr int EPI_FLOATS = WIDE_ROWS * 64;
// pairs of row tiles in a band of the raster (ops/film_block.py
// FWD_BAND_PAIRS): at (8, 20000, 4608) a wave of 132 tiles takes <= 9 of
// the 18 W chunks (21.2 MB of W's 42.5 MB) outside the last band, beside
// a band's 16 pairs of A (18.9 MB)
constexpr int BAND_PAIRS = 16;
// the ring: stages of the pair's two A blocks and up to two W tiles (a
// chunk's 256 columns)
struct Product {
  static constexpr int STAGES = 4;
  static constexpr int STAGE = 2 * WIDE_A_BYTES + 2 * WIDE_B_BYTES;
  static size_t smem_bytes() {
    return 1024 + static_cast<size_t>(STAGES) * STAGE +
           2 * EPI_FLOATS * sizeof(float) + 2 * STAGES * 8;
  }
};

// the epilogue's rounds: HC columns of the tile's 128 rows each, read from
// a ring stage that the producer fills, after the tile's k stages, with
// those columns of the rows of h (128 bytes a row: 64 bf16 or 32 fp32
// values, row 64 g + r of warpgroup g at byte 128 (64 g + r)) and their s,
// t, bias (fp32) and gamma, beta (in T, one row each for each warpgroup's
// cloud). The accumulators of a consumer warpgroup's 64 rows x HC columns
// go through a buffer of their own (EPI_FLOATS fp32).
template <typename T>
struct Epi {
  static constexpr int HC = 128 / static_cast<int>(sizeof(T));
  static constexpr int LANES = HC / 4;          // lanes a row, 4 values each
  static constexpr int AT_ONCE = 32 / LANES;    // rows a warp instruction
  static constexpr int ITERS = 16 / AT_ONCE;    // for a warp's 16 rows
  static constexpr int OFF_S = 2 * WIDE_ROWS * 128;
  static constexpr int OFF_T = OFF_S + HC * 4;
  static constexpr int OFF_BIAS = OFF_T + HC * 4;
  static constexpr int OFF_G = OFF_BIAS + HC * 4;
  static constexpr int OFF_BE = OFF_G + 2 * HC * static_cast<int>(sizeof(T));
  static constexpr int BYTES = OFF_BE + 2 * HC * static_cast<int>(sizeof(T));
};
static_assert(Epi<float>::BYTES <= Product::STAGE &&
                  Epi<__nv_bfloat16>::BYTES <= Product::STAGE,
              "an epilogue round fits in a ring stage");

// four consecutive values in shared memory, as fp32
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xFFFF0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xFFFF0000u));
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// unit u of the raster (ops/film_block.py fwd_raster): bands of `band`
// pairs, the pair fastest in a band, then the chunk, back from the last in
// odd bands (so that a wave across two bands still takes one band of W's
// chunks)
__device__ __forceinline__ void raster(long long u, long long pairs,
                                       int chunks, int band,
                                       long long& pair, int& chunk) {
  const long long b = u / (static_cast<long long>(band) * chunks);
  const long long start = b * band;
  const long long rows = pairs - start < band ? pairs - start : band;
  const long long within = u - start * chunks;
  pair = start + within % rows;
  chunk = static_cast<int>(within / rows);
  if (b & 1) chunk = chunks - 1 - chunk;
}

// The product and its epilogue, persistent: CTA i of the grid takes units
// i, i + gridDim.x, ... of the raster; a unit is a pair of row tiles x one
// chunk of nb x 128 columns (nb = 2, or 1 for the last chunk where C % 256
// != 0). The ring carries, for each unit, its k stages and then its
// epilogue rounds.
template <typename T>
__global__ void __launch_bounds__(PRODUCT_THREADS, 1)
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
  constexpr int S = Product::STAGES, STAGE = Product::STAGE;
  using E = Epi<T>;
  constexpr int HC = E::HC;
  constexpr int MAX_ROUNDS = 2 * N_TILE / HC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* epi = reinterpret_cast<float*>(ring + S * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * EPI_FLOATS);
  uint64_t* empty = full + S;

  const int k_tiles = c / K_TILE;
  // chunks of 256 columns, the last of 128 where C % 256 != 0
  const int chunks = (c + 2 * N_TILE - 1) / (2 * N_TILE);
  const bool ragged = c % (2 * N_TILE) != 0;
  const int tiles_per_cloud = (n_points + WIDE_ROWS - 1) / WIDE_ROWS;
  const long long pairs = wide_tiles(bsz, n_points) / 2;
  const long long units = pairs * chunks;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- the producer warpgroup keeps the ring full: thread 0 loads the
    // k stages (bulk copies) and every thread one row of h into each
    // epilogue round's stage (cp.async, 16 bytes at a time)
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = threadIdx.x;
    constexpr size_t B_TILE = static_cast<size_t>(N_TILE) * K_TILE;
    int st = 0;
    uint32_t phase = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      long long pair;
      int chunk;
      raster(u, pairs, chunks, BAND_PAIRS, pair, chunk);
      const int nb = ragged && chunk == chunks - 1 ? 1 : 2;  // W tiles
      // this thread's row of h for the epilogue: row pt % 64 of row tile
      // 2 pair + pt / 64 (none for the pairs' padding tile, none past N)
      const long long tile = 2 * pair + pt / WIDE_ROWS;
      const int b = static_cast<int>(tile / tiles_per_cloud);
      const int n = static_cast<int>(tile % tiles_per_cloud) * WIDE_ROWS +
                    pt % WIDE_ROWS;
      const bool mine = b < bsz && n < n_points;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(
          h + (static_cast<size_t>(b) * n_points + n) * c +
          static_cast<size_t>(chunk) * 2 * N_TILE);
      // the row into L2 while the unit's product runs
      if (mine) prefetch_l2(src, nb * N_TILE * sizeof(T));
      for (int kt = 0; kt < k_tiles; ++kt) {
        if (pt == 0) {
          mbar_wait(&empty[st], phase ^ 1u);
          uint8_t* dst = ring + st * STAGE;
          const __nv_bfloat16* a =
              a_packed + (static_cast<size_t>(2 * pair) * WIDE_ROWS * c +
                          static_cast<size_t>(kt) * WIDE_ROWS * K_TILE);
          const __nv_bfloat16* wb =
              w_packed +
              (static_cast<size_t>(chunk) * 2 * k_tiles + kt) * B_TILE;
          mbar_arrive_expect_tx(&full[st],
                                2 * WIDE_A_BYTES + nb * WIDE_B_BYTES);
          for (int g = 0; g < 2; ++g)
            bulk_copy_g2s(dst + g * WIDE_A_BYTES,
                          a + static_cast<size_t>(g) * WIDE_ROWS * c,
                          WIDE_A_BYTES, &full[st]);
          for (int q = 0; q < nb; ++q)
            bulk_copy_g2s(dst + 2 * WIDE_A_BYTES + q * WIDE_B_BYTES,
                          wb + static_cast<size_t>(q) * k_tiles * B_TILE,
                          WIDE_B_BYTES, &full[st]);
        }
        if (++st == S) {
          st = 0;
          phase ^= 1u;
        }
      }
      // the epilogue's rounds: thread 0 waits for the stage, then every
      // thread loads its row of h, then thread 0 the parameters. Only
      // thread 0 waits on `empty`: the others skip the k stages and would
      // wait two phases early, where a parity wait cannot tell the phases
      // apart; the named barrier hands them the stage.
      for (int rd = 0; rd < nb * N_TILE / HC; ++rd) {
        if (pt == 0) mbar_wait(&empty[st], phase ^ 1u);
        named_barrier_sync(3, 128);
        uint8_t* dst = ring + st * STAGE;
        if (mine)
          for (int p = 0; p < 8; ++p)
            cp_async16(dst + pt * 128 + 16 * p, src + rd * 128 + 16 * p);
        cp_async_mbar_arrive(&full[st]);
        // every thread's pending arrival is counted before thread 0's
        named_barrier_sync(3, 128);
        if (pt == 0) {
          const int k0 = chunk * 2 * N_TILE + rd * HC;
          const long long t0 = 2 * pair;
          const int b0 = static_cast<int>(t0 / tiles_per_cloud);
          const int b1 = static_cast<int>((t0 + 1) / tiles_per_cloud);
          const bool live1 = b1 < bsz;
          mbar_arrive_expect_tx(
              &full[st], 3 * HC * 4 + (live1 ? 4 : 2) * HC * sizeof(T));
          bulk_copy_g2s(dst + E::OFF_S, s + k0, HC * 4, &full[st]);
          bulk_copy_g2s(dst + E::OFF_T, t + k0, HC * 4, &full[st]);
          bulk_copy_g2s(dst + E::OFF_BIAS, bias + k0, HC * 4, &full[st]);
          for (int g = 0; g < (live1 ? 2 : 1); ++g) {
            const size_t off = static_cast<size_t>(g ? b1 : b0) * c + k0;
            bulk_copy_g2s(dst + E::OFF_G + g * HC * sizeof(T), gamma + off,
                          HC * sizeof(T), &full[st]);
            bulk_copy_g2s(dst + E::OFF_BE + g * HC * sizeof(T), beta + off,
                          HC * sizeof(T), &full[st]);
          }
        }
        if (++st == S) {
          st = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ---- the consumers: warpgroup cw takes row tile 2 * pair + cw
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = (threadIdx.x >> 7) - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const uint32_t ring_base = smem_u32(ring);
    float* ebuf = epi + cw * EPI_FLOATS;
    // the row walk: rows warp * 16 + AT_ONCE i + lane / LANES, columns
    // 4 (lane % LANES) .. + 3 of each round
    const int col = 4 * (lane % E::LANES);
    int st = 0;
    uint32_t phase = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      long long pair;
      int chunk;
      raster(u, pairs, chunks, BAND_PAIRS, pair, chunk);
      const int nb = ragged && chunk == chunks - 1 ? 1 : 2;  // W tiles
      const long long tile = 2 * pair + cw;
      // the pairs' padding tile stores nothing
      const bool live = tile < static_cast<long long>(bsz) * tiles_per_cloud;
      const size_t row0 = static_cast<size_t>(tile / tiles_per_cloud) *
                          n_points;
      const int n0 = static_cast<int>(tile % tiles_per_cloud) * WIDE_ROWS;
      // this thread's rows' statistics, read now: the product hides it
      float mu[E::ITERS], rs[E::ITERS];
#pragma unroll
      for (int i = 0; i < E::ITERS; ++i) {
        const int n = n0 + warp * 16 + E::AT_ONCE * i + lane / E::LANES;
        mu[i] = rs[i] = 0.0f;
        if (live && n < n_points) {
          mu[i] = mean[row0 + n];
          rs[i] = rstd[row0 + n];
        }
      }

      // columns 0..127 of the tile in acc[0..63], 128..255 in acc[64..127]
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      int prev = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[st], phase);
#pragma unroll
        for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
        wgmma_fence();
        const uint32_t sb = ring_base + st * STAGE;
        const uint64_t da = desc_sw128(sb + cw * WIDE_A_BYTES);
        // the stage's two W tiles lie one after the other: one operand of
        // 256 rows (on a 128-column chunk the second is a stale tile, and
        // the columns it gives are never stored)
        const uint64_t db = desc_sw128(sb + 2 * WIDE_A_BYTES);
#pragma unroll
        for (int kk = 0; kk < K_TILE / 16; ++kk)
          wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk, 1);
        wgmma_commit();
        if (kt > 0) {
          wgmma_wait<1>();  // the previous stage's products are done
          if (tid == 0) mbar_arrive(&empty[prev]);
        }
        prev = st;
        if (++st == S) {
          st = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 128; ++i) fence_operand(acc[i]);
      if (tid == 0) mbar_arrive(&empty[prev]);

      // ---- the epilogue: round rd takes columns HC rd .. + HC - 1 of the
      // tile from its ring stage, while the producer fills the next
      // unit's stages
      const int er = warp * 16 + (lane >> 2), ec = 2 * (lane & 3);
#pragma unroll
      for (int rd = 0; rd < MAX_ROUNDS; ++rd) {
        if (rd == nb * N_TILE / HC) break;
        mbar_wait(&full[st], phase);
        // the last round's reads (of its stage and of ebuf) are done
        named_barrier_sync(1 + cw, 128);
        if (rd > 0 && tid == 0) mbar_arrive(&empty[prev]);
        // rows er, er + 8, columns 8 jj + ec (+1) of this round; the
        // 32-byte chunk jj of row r at jj ^ (r % (HC / 8))
#pragma unroll
        for (int jj = 0; jj < HC / 8; ++jj)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = er + 8 * hr, j = 4 * (rd * (HC / 8) + jj);
            *reinterpret_cast<float2*>(
                ebuf + r * HC + ((jj ^ (r & (HC / 8 - 1))) << 3) + ec) =
                make_float2(acc[j + 2 * hr], acc[j + 2 * hr + 1]);
          }
        named_barrier_sync(1 + cw, 128);
        if (live) {
          const uint8_t* stg = ring + st * STAGE;
          const float4 sv = lds4(
              reinterpret_cast<const float*>(stg + E::OFF_S) + col);
          const float4 tv = lds4(
              reinterpret_cast<const float*>(stg + E::OFF_T) + col);
          const float4 bb = lds4(
              reinterpret_cast<const float*>(stg + E::OFF_BIAS) + col);
          const float4 gv = lds4(reinterpret_cast<const T*>(
                                     stg + E::OFF_G + cw * HC * sizeof(T)) +
                                 col);
          const float4 bv = lds4(reinterpret_cast<const T*>(
                                     stg + E::OFF_BE + cw * HC * sizeof(T)) +
                                 col);
          const int k = chunk * 2 * N_TILE + rd * HC + col;
#pragma unroll
          for (int i = 0; i < E::ITERS; ++i) {
            const int r = warp * 16 + E::AT_ONCE * i + lane / E::LANES;
            const int n = n0 + r;
            if (n >= n_points) continue;
            const float4 x = lds4(reinterpret_cast<const T*>(
                                      stg + (cw * WIDE_ROWS + r) * 128) +
                                  col);
            const float4 a = *reinterpret_cast<const float4*>(
                ebuf + r * HC + (((col >> 3) ^ (r & (HC / 8 - 1))) << 3) +
                (col & 7));
            const float m = mu[i], q = rs[i];
            store4(y + (row0 + n) * c + k,
                   make_float4(
                       film_f(x.x, m, q, sv.x, tv.x, gv.x, bv.x) + a.x + bb.x,
                       film_f(x.y, m, q, sv.y, tv.y, gv.y, bv.y) + a.y + bb.y,
                       film_f(x.z, m, q, sv.z, tv.z, gv.z, bv.z) + a.z + bb.z,
                       film_f(x.w, m, q, sv.w, tv.w, gv.w, bv.w) + a.w +
                           bb.w));
          }
        }
        prev = st;
        if (++st == S) {
          st = 0;
          phase ^= 1u;
        }
      }
      named_barrier_sync(1 + cw, 128);  // the last round's stage is read
      if (tid == 0) mbar_arrive(&empty[prev]);
    }
  }
}

int device_attribute(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess)
    return 0;
  return v;
}

// the product's launch at (b, n, c): its shared memory allowed, a
// persistent grid of one CTA an SM, at most one a unit of the raster
template <typename T>
cudaError_t product_config(int b, int n, int c, int& ctas, size_t& smem) {
  smem = Product::smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      film_block_fwd_wide_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long units =
      wide_tiles(b, n) / 2 * ((c + 2 * N_TILE - 1) / (2 * N_TILE));
  const long long sms = device_attribute(cudaDevAttrMultiProcessorCount);
  if (sms < 1) return cudaErrorInvalidDevice;
  ctas = static_cast<int>(units < sms ? units : sms);
  return cudaSuccess;
}

template <typename T>
int launch_wide_product(const void* h, const void* s, const void* t,
                        const void* gamma, const void* beta,
                        const __nv_bfloat16* a_packed,
                        const __nv_bfloat16* w_packed, const void* bias,
                        void* y, const void* mean, const void* rstd, int b,
                        int n, int c, cudaStream_t stream) {
  int ctas;
  size_t smem;
  const cudaError_t err = product_config<T>(b, n, c, ctas, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  film_block_fwd_wide_kernel<T><<<ctas, PRODUCT_THREADS, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), a_packed, w_packed,
      static_cast<const float*>(bias), static_cast<T*>(y),
      static_cast<const float*>(mean), static_cast<const float*>(rstd), b, n,
      c);
  return static_cast<int>(cudaGetLastError());
}

// the statistics kernel's launch at (b, n, c): 8 warps a block where their
// rows fit in shared memory beside the parameters, else 4; as many blocks
// as the card holds at once (at most one a tile), each a range of rows
template <typename T>
cudaError_t stats_config(int b, int n, int c, dim3& grid, int& threads,
                         size_t& smem) {
  auto* kernel = film_block_fwd_wide_stats_kernel<T>;
  const size_t limit = static_cast<size_t>(
      device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin));
  int warps = STATS_THREADS / 32;
  if (stats_smem_bytes<T>(c, warps) > limit) warps /= 2;
  threads = 32 * warps;
  smem = stats_smem_bytes<T>(c, warps);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>(b) * ((n + WIDE_ROWS - 1) / WIDE_ROWS);
  const long long held = static_cast<long long>(per_sm > 0 ? per_sm : 1) *
                         device_attribute(cudaDevAttrMultiProcessorCount);
  grid = dim3(static_cast<unsigned>(held < tiles ? held : tiles));
  return cudaSuccess;
}

template <typename T>
int launch_wide_stats(const void* h, const void* s, const void* t,
                      const void* gamma, const void* beta,
                      __nv_bfloat16* a_packed, void* mean, void* rstd, int b,
                      int n, int c, cudaStream_t stream) {
  dim3 grid;
  int threads;
  size_t smem;
  const cudaError_t err = stats_config<T>(b, n, c, grid, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  film_block_fwd_wide_stats_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const float*>(s),
      static_cast<const float*>(t), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), a_packed, static_cast<float*>(mean),
      static_cast<float*>(rstd), b, n, c);
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
  const int err = launch_wide_stats<T>(h, s, t, gamma, beta, a_packed, mean,
                                       rstd, b, n, c, stream);
  if (err != 0) return err;
  return launch_wide_product<T>(h, s, t, gamma, beta, a_packed, wp, bias, y,
                                mean, rstd, b, n, c, stream);
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

// The wide forward's launch at (b, n, c) for h in bf16 (is_bf16) or fp32,
// for reports: out[0..8] = the product's threads a CTA, the producer's and
// the consumers' registers a thread after setmaxnreg, ring stages, shared
// memory a CTA (bytes), CTAs launched; the statistics kernel's threads a
// block, shared memory a block (bytes), blocks launched. Returns a
// cudaError_t code (cudaErrorInvalidValue for a shape the wide path does
// not take).
extern "C" int pcfm_film_block_fwd_wide_config(int b, int n, int c,
                                               int is_bf16, long long* out) {
  if (b <= 0 || n <= 0 || bad_c(c, is_bf16 != 0) || b > 65535 || c <= MAX_C)
    return static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0, threads = 0;
  size_t product_smem = 0, stats_smem = 0;
  dim3 grid;
  cudaError_t err;
  if (is_bf16) {
    err = product_config<__nv_bfloat16>(b, n, c, ctas, product_smem);
    if (err == cudaSuccess)
      err = stats_config<__nv_bfloat16>(b, n, c, grid, threads, stats_smem);
  } else {
    err = product_config<float>(b, n, c, ctas, product_smem);
    if (err == cudaSuccess)
      err = stats_config<float>(b, n, c, grid, threads, stats_smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long got[9] = {
      PRODUCT_THREADS, PRODUCER_REGS, CONSUMER_REGS, Product::STAGES,
      static_cast<long long>(product_smem), ctas, threads,
      static_cast<long long>(stats_smem), grid.x};
  for (int i = 0; i < 9; ++i) out[i] = got[i];
  return 0;
}


extern "C" const char* pcfm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
