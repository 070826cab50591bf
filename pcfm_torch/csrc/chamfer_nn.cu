// Chamfer nearest neighbour for Hopper (sm_90a): for every query point, the
// least squared distance to a target cloud and the target's index.
//
// Replaces pcfm/ops/pallas/chamfer_v3.py:_kernel (behind _directed_v3 and
// chamfer_distance_pallas_v3), and computes what it computes, one direction
// at a time, for P (query cloud, target cloud) pairs:
//
//   dist[p, n] = min_m  sum_d (query[qi[p], n, d] - target[ti[p], m, d])^2
//   idx[p, n]  = the least m that reaches it
//
// query (Q, N, D) and target (T, M, D) fp32, D = 1..8, qi / ti (P,) int32,
// dist (P, N) fp32, idx (P, N) int32.  chamfer_distance is the pairs
// qi = ti = arange(B); cd_matrix is all pairs of two sets.  `dist` is the
// difference form, t_d = a_d - b_d, s = fma(t_d, t_d, s), d in order, of
// the chosen target; ties go to the lowest index.  No float atomics, each
// output written once: two launches give bitwise-equal results.
//
// What it costs taken plainly: the difference form costs D subtractions
// and D multiply-adds a (query, target) pair (8 FLOP at D = 3, 0.76 ms at
// (8, 20000, 3) both ways at 67 TFLOP/s fp32), and deciding the minimum
// adds a comparison and selects: ~9 instructions a pair when each pair is
// taken in that form.
// The TPU kernel scores |b|^2 - 2 a.b on the MXU, which is inexact on near
// ties.  Here a dot form is only a screen, and the difference form decides.
//
// 1. Screen, on the tensor cores.  Coordinates are taken relative to the
//    pair's centre c, its first target point, and rounded to TF32 (cvt.rna:
//    ties away, 10 mantissa bits): a~ = tf32(a - c), b~ = tf32(b - c).  One
//    mma.sync m16n8k8 (two for D >= 5) scores 16 queries against 8 targets,
//    s = |a~|^2 + |b~|^2 - 2 a~.b~ = |a~ - b~|^2 up to its error, from the
//    K-vectors A = (-2 a~, 1, 1, ahat hi, ahat lo) and B = (b~, nb hi,
//    nb lo, 1, 1): ahat = |a~|^2 and nb = |b~|^2 in fp32, each split in two
//    TF32 halves.  Every product is exact in fp32.  A warp holds 2 m-tiles
//    (32 queries) in registers for the whole scan; targets pass through
//    shared memory in double-buffered tiles of 256 (128 for D >= 5), staged
//    as B rows in fragment order.  A lane keeps, for each of its 4 queries
//    (rows g, g + 8 of each m-tile), the least s over its share of a group
//    of 32 targets (columns 2t, 2t + 1 of 4 n8 tiles): one min a pair, taken
//    three at a time by VIMNMX3 on the bits (the least of non-negative
//    floats; a negative one if any is negative, and every threshold is
//    >= 0, so no pass is missed).
// 2. Check.  A share can hold the nearest target only if its least s is at
//    most the threshold T.  T starts from the difference form of strided
//    targets (1 in 64, at most 256), tightens with every passing screen (T = smin + M, the
//    margin M refreshed every 4 tiles with smin shared in the quad).  A
//    passing share becomes its slot's pending one; the one it displaces is
//    dropped if it no longer passes T, else listed; at the end the pending
//    share joins the list if it passes the final T.  All lanes check their
//    lists together (when one fills, and at the end): every target of a
//    share in the difference form, the least (distance, index) kept per
//    (query, lane) in shared memory.  The quad merges its 4 lanes with
//    shuffles, ties to the lower index.  Padding targets screen +inf and are
//    skipped by the check.
//
// The margin.  u = 2^-24.  For a target b whose difference-form distance
// dhat <= U (so the nearest one, and every target tied with it):
//   * the exact squared distance d <= dhat (1 + 2^-20): D + 2 roundings of
//     non-negative terms, D <= 8;
//   * |a~ - (a - c)| <= W |a~| coordinate-wise, W = 2^-11 + 2^-17 >= the
//     fp32 subtraction (u) and the TF32 rounding (2^-11) together, and so
//     for b; with r = |a~ - b~|: r <= sqrt(d) + W (|a~| + |b~|) and
//     |b~| <= |a~| + r, so r <= R = (sqrt(U (1 + 2^-20)) + 2 W |a~|) / (1 - W);
//   * the screen's error: |s - r^2| <= KAPPA (|a~| + |b~|)^2.  It holds the
//     norms' fp32 sums and hi + lo splits (< 2^-21) and the tensor cores'
//     fp32 accumulation, which is not promised to round like fp32 FMAs: n
//     terms aligned to the largest and cut to 24 bits err by at most
//     n 2^-23 of their magnitudes, and those sum to <= (1 + 2^-10)
//     (|a~| + |b~|)^2; n <= 9 a k-step, so < 2^-18.6 for two.  KAPPA =
//     2^-17 (chip_smoke.py measures the screen's error against it);
//   * so s <= R^2 + KAPPA (2|a~| + R)^2 =: T(U), evaluated with |a~| from
//     above and guards of 2^-20 / 2^-18 over its own fp32 roundings.
// And from a screened s of any target b, an upper bound on its dhat:
//   r^2 <= s + KAPPA (2|a~| + r)^2 <= s + KAPPA (8 |a~|^2 + 2 r^2), so
//   r^2 <= (s + 8 KAPPA |a~|^2) / (1 - 2 KAPPA) and dhat <= (r (1 + W) +
//   2 W |a~|)^2 (1 + 2^-20) =: Ub(s).
// T and Ub grow with their arguments and T(Ub(s)) - s grows with s, so
// smin' + M(smin) >= T(Ub(smin')) for smin' <= smin: a share that fails
// the threshold of one valid bound fails the final one too, and the nearest
// target, and every target tied with it, is always checked.  A generous
// margin costs only checks.  For clouds of 20 000 N(0, 1) points it is
// ~1e-3 against a nearest distance of ~3e-3 (the error scales with the
// distance, not with |a||b|, because the screen is exact for the rounded
// points).  tests/test_torch_port_chamfer_screen.py mirrors T and Ub
// constant for constant and holds the margin on the CPU.
//
// What bounds it now: the screen's instructions, for 32 queries x 32
// targets a warp 8 mma.sync, 16 mins, 4 shared-memory loads and a vote; a
// wgmma screen (A from registers) was no faster (PERF.md).  The screen
// needs every pair and the check only a few, so the screen's least time
// is the kernel's bound: 2 K TF32 FLOP a pair (K = 8 for D <= 4) at 495
// TFLOP/s, 0.207 ms at (8, 20000, 3) both ways (chamfer_screen_bound in
// chip_smoke.py); the difference form for every pair would take 0.76.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MT = 2;                    // m16 tiles (16 queries each) a warp
constexpr int SLOTS = 2 * MT;            // queries a lane holds: rows g, g+8
constexpr int ROWS = 16 * MT * WARPS;    // queries a block
constexpr int GROUP = 4;                 // n8 tiles a group (32 targets)
constexpr int SEEDS = 256;               // strided targets that seed T, at most
constexpr int LIST = 16;                 // candidate entries a lane holds
constexpr int REFRESH = 4;               // tiles between margin refreshes
constexpr int MAX_D = 8;
constexpr unsigned FULL = 0xffffffffu;

// k-steps of 8: the coordinates, |b~|^2 and |a~|^2 each split in two TF32
// halves (hi + lo), so K = D + 4
template <int D>
constexpr int k_steps = (D + 4 + 7) / 8;
// targets a shared-memory tile: 256 (D <= 4) or 128, 8 KB a buffer
template <int D>
constexpr int tile_of = 256 / k_steps<D>;

// The margin's constants (see the note above).
constexpr float GUARD = 0x1p-20f;                // a bound's own roundings
constexpr float W_ERR = 0x1p-11f + 0x1p-17f;     // coordinate rounding
constexpr float KAPPA = 0x1p-17f;                // screen error / (|a~|+|b~|)^2
constexpr float A_UP = 1.0f + 0x1p-18f;          // 1 + 2^-20, and guards
constexpr float UB_A = 8.0f * KAPPA + 0x1p-18f;  // Ub: 8 KAPPA |a~|^2
constexpr float UB_D = 1.0f + 4.0f * KAPPA;      // Ub: >= 1 / (1 - 2 KAPPA)
constexpr float R_W = 1.0f + 2.0f * W_ERR + 0x1p-18f;  // T: >= 1 / (1 - W)

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// T(U): a share whose min screen exceeds it holds no target within U.
__device__ __forceinline__ float threshold(float u, float an) {
  const float r = (sqrtf(u * A_UP) + 2.0f * W_ERR * an) * R_W;
  const float x = r * r * A_UP;
  return x + KAPPA * A_UP * (2.0f * an + r) * (2.0f * an + r) + GUARD * x;
}

// Ub(s): the difference-form distance of a target screened at s is <= Ub.
__device__ __forceinline__ float upper(float s, float ahat, float an) {
  const float r2 = (s + ahat * UB_A) * UB_D;
  const float q = sqrtf(fmaxf(r2, 0.0f)) * (1.0f + W_ERR) + 2.0f * W_ERR * an;
  return q * q * A_UP;
}

// M such that smin' + M >= T(Ub(smin')) for every smin' <= smin: T(Ub(s))
// - s grows with s.  The guard covers the roundings of M and of smin' + M.
__device__ __forceinline__ float margin_at(float smin, float ahat, float an) {
  const float tf = threshold(upper(smin, ahat, an), an);
  return (tf - smin) + GUARD * (fabsf(smin) + tf);
}

// D[16x8] = A[16x8] B[8x8] + C in TF32 with fp32 accumulation.
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1, float c0,
                                       float c1, float c2, float c3) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c0), "f"(c1), "f"(c2), "f"(c3));
}

// min of three screens as signed integers: the least of non-negative floats,
// and a negative one if any is negative (the screen is >= 0 up to its
// error, and every threshold is >= 0, so a pass is never missed).  One DPX
// instruction on Hopper.
__device__ __forceinline__ float min3(float a, float b, float c) {
  return __int_as_float(
      __vimin3_s32(__float_as_int(a), __float_as_int(b), __float_as_int(c)));
}

// The exact difference form, as the plain version takes it.
template <int D>
__device__ __forceinline__ float exact(const float (&a)[D],
                                       const float* __restrict__ b) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float t = a[d] - b[d];
    s = fmaf(t, t, s);
  }
  return s;
}

// x = hi + lo in two TF32 values, to 2^-22 |x|.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// Element k of a query row's K-vector A = (-2 a~, 1, 1, ahat hi, ahat lo,
// 0...), from its TF32 coordinate at_k = a~_k (k < D) and ahat = |a~|^2.
template <int D>
__device__ __forceinline__ uint32_t a_entry(int k, float at_k, float ahat) {
  float hi, lo;
  split(ahat, hi, lo);
  const float v = k < D       ? -2.0f * at_k
                  : k < D + 2 ? 1.0f
                  : k == D + 2 ? hi
                  : k == D + 3 ? lo
                               : 0.0f;
  return __float_as_uint(v);
}

// A target's K-vector B = (b~, |b~|^2 hi, lo, 1, 1, 0...); a padding
// target (not live) has |b~|^2 hi = +inf, lo = 0, and screens +inf.
template <int D>
__device__ __forceinline__ void b_vector(const float (&x)[D], bool live,
                                         const float (&c)[D],
                                         float (&b)[8 * k_steps<D>]) {
#pragma unroll
  for (int k = 0; k < 8 * k_steps<D>; ++k) b[k] = 0.0f;
  if (live) {
    float nb = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      b[d] = tf32_rna(x[d] - c[d]);
      nb = fmaf(b[d], b[d], nb);
    }
    split(nb, b[D], b[D + 1]);
  } else {
    b[D] = CUDART_INF_F;
  }
  b[D + 2] = b[D + 3] = 1.0f;
}

// A tile's raw coordinates, two targets a thread (one for D > 4), loaded
// before the scan of the previous tile and staged after it.
template <int D>
struct Raw {
  float v[tile_of<D> / THREADS][D];
};

template <int D>
__device__ __forceinline__ void load_raw(Raw<D>& raw,
                                         const float* __restrict__ tp, int m,
                                         int base) {
#pragma unroll
  for (int i = 0; i < tile_of<D> / THREADS; ++i) {
    const int id = base + threadIdx.x + i * THREADS;
#pragma unroll
    for (int d = 0; d < D; ++d)
      raw.v[i][d] = id < m ? tp[static_cast<size_t>(id) * D + d] : 0.0f;
  }
}

// A staged target row holds its K-vector in B-fragment order: for each
// k-step the pairs (B[8 ks + t], B[8 ks + t + 4]), t = 0..3.
template <int D>
__device__ __forceinline__ void stage(const Raw<D>& raw, const float (&c)[D],
                                      int m, int base, float* sb) {
  constexpr int KS = k_steps<D>;
#pragma unroll
  for (int i = 0; i < tile_of<D> / THREADS; ++i) {
    const int j = threadIdx.x + i * THREADS;
    float b[8 * KS];
    b_vector<D>(raw.v[i], base + j < m, c, b);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      float* row = sb + j * 8 * KS + ks * 8;
      *reinterpret_cast<float4*>(row) =
          make_float4(b[8 * ks], b[8 * ks + 4], b[8 * ks + 1], b[8 * ks + 5]);
      *reinterpret_cast<float4*>(row + 4) =
          make_float4(b[8 * ks + 2], b[8 * ks + 6], b[8 * ks + 3],
                      b[8 * ks + 7]);
    }
  }
}

// 4 blocks an SM (<= 128 registers) for one k-step; two k-steps hold twice
// the A fragments and take 2 (<= 255) rather than spill
template <int D>
__global__ void __launch_bounds__(THREADS, k_steps<D> == 1 ? 4 : 2)
    chamfer_nn_kernel(const float* __restrict__ query,
                      const float* __restrict__ target,
                      const int* __restrict__ qi, const int* __restrict__ ti,
                      int n, int m, float* __restrict__ dist,
                      int* __restrict__ idx) {
  constexpr int KS = k_steps<D>;
  constexpr int TILE = tile_of<D>;
  __shared__ __align__(16) float s_b[2][TILE * 8 * KS];
  __shared__ float s_q[ROWS * D];     // the block's raw query coordinates
  __shared__ float s_a[ROWS];         // ahat = |a~|^2 in fp32
  // candidates to check: a lane's shares (slot mask << 24 | group), checked
  // by all lanes together when a list fills and at the end; each (row,
  // lane)'s least (distance, index) so far
  __shared__ uint32_t s_list[LIST * THREADS];
  __shared__ float s_bd[ROWS * 4];
  __shared__ int s_bi[ROWS * 4];

  const int p = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * ROWS;
  const float* qp = query + static_cast<size_t>(qi[p]) * n * D;
  const float* tp = target + static_cast<size_t>(ti[p]) * m * D;

  float c[D];   // the centre: the pair's first target point
#pragma unroll
  for (int d = 0; d < D; ++d) c[d] = tp[d];

  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    const int q = row0 + r;
    float ah = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float a = q < n ? qp[static_cast<size_t>(q) * D + d] : 0.0f;
      s_q[r * D + d] = a;
      const float at = tf32_rna(a - c[d]);
      ah = fmaf(at, at, ah);
    }
    s_a[r] = ah;
  }
  // index 0, so that a query no share passes (a NaN coordinate) still
  // gets a valid index, with +inf
  for (int j = threadIdx.x; j < ROWS * 4; j += THREADS) {
    s_bd[j] = CUDART_INF_F;
    s_bi[j] = 0;
  }
  float* s_seed = s_b[1];   // the seeds, until tile 1 is staged
  const int ns = max(1, min(SEEDS, m / 64));   // 256 at M >= 16 384
  for (int j = threadIdx.x; j < ns * D; j += THREADS) {
    const int k = j / D;
    const int id = static_cast<int>(static_cast<long long>(k) * m / ns);
    s_seed[j] = tp[static_cast<size_t>(id) * D + (j - k * D)];
  }
  Raw<D> raw;
  load_raw<D>(raw, tp, m, 0);
  stage<D>(raw, c, m, 0, s_b[0]);
  __syncthreads();

  // slot s holds row (s / 2) * 16 + g + (s % 2) * 8 of the warp's 16 MT
  auto row_of = [&](int s) {
    return warp * 16 * MT + (s >> 1) * 16 + g + (s & 1) * 8;
  };
  uint32_t af[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row_of(2 * mt + (r & 1));
        const int k = 8 * ks + t + 4 * (r >> 1);
        const float at_k = k < D ? tf32_rna(s_q[row * D + k] - c[k]) : 0.0f;
        af[mt][ks][r] = a_entry<D>(k, at_k, s_a[row]);
      }
    }
  }

  // a lane's list, checked by all lanes together, each its own entries
  int cnt = 0;
  auto flush = [&]() {
    for (int i = 0; i < cnt; ++i) {
      const uint32_t e = s_list[i * THREADS + threadIdx.x];
      const int gb = static_cast<int>(e & 0xffffffu) * (8 * GROUP);
      for (uint32_t mask = e >> 24; mask; mask &= mask - 1) {
        const int row = row_of(__ffs(mask) - 1);
        float a[D];
#pragma unroll
        for (int d = 0; d < D; ++d) a[d] = s_q[row * D + d];
        float best = s_bd[row * 4 + t];
        int arg = s_bi[row * 4 + t];
#pragma unroll
        for (int k = 0; k < GROUP; ++k) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int id = gb + 8 * k + 2 * t + e2;
            if (id < m) {
              const float s = exact<D>(a, tp + static_cast<size_t>(id) * D);
              if (s < best || (s == best && id < arg)) {
                best = s;
                arg = id;
              }
            }
          }
        }
        s_bd[row * 4 + t] = best;
        s_bi[row * 4 + t] = arg;
      }
    }
    cnt = 0;
  };

  // seeds: the difference form of ns strided targets (1 in 64, at most
  // 256) bounds the nearest; smin starts at its threshold, a valid
  // stand-in for a screen
  float gm[SLOTS], thr[SLOTS], smin[SLOTS], mg[SLOTS];
  // the pending share of a slot: its group and min screen
  float pg[SLOTS];
  uint32_t pj[SLOTS];
  unsigned live = 0;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int row = row_of(s);
    float u = CUDART_INF_F;
    if (row0 + row < n) {
      live |= 1u << s;
      float a[D];
#pragma unroll
      for (int d = 0; d < D; ++d) a[d] = s_q[row * D + d];
      for (int k = t; k < ns; k += 4)
        u = fminf(u, exact<D>(a, &s_seed[k * D]));
    }
    u = fminf(u, __shfl_xor_sync(FULL, u, 1));
    u = fminf(u, __shfl_xor_sync(FULL, u, 2));
    const float ah = s_a[row], an = sqrtf(ah * A_UP);
    pg[s] = CUDART_INF_F;
    pj[s] = 0u;
    if (live >> s & 1) {
      thr[s] = smin[s] = threshold(u, an);
      mg[s] = margin_at(smin[s], ah, an);
    } else {
      thr[s] = smin[s] = -CUDART_INF_F;
      mg[s] = 0.0f;
    }
  }
  __syncthreads();   // the seeds are read; s_b[1] takes tile 1

  const int tiles = (m + TILE - 1) / TILE;
  for (int it = 0; it < tiles; ++it) {
    const int base = it * TILE;
    const float* sb = s_b[it & 1];
    if (it + 1 < tiles) load_raw<D>(raw, tp, m, base + TILE);
    const int groups = (min(TILE, m - base) + 8 * GROUP - 1) / (8 * GROUP);
    for (int gi = 0; gi < groups; ++gi) {
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const int c8 = (gi * GROUP + k) * 8;   // the n8 tile's first target
        uint32_t b[KS][2];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const float2 bb = *reinterpret_cast<const float2*>(
              &sb[(c8 + g) * 8 * KS + ks * 8 + 2 * t]);
          b[ks][0] = __float_as_uint(bb.x);
          b[ks][1] = __float_as_uint(bb.y);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float dv[4];
          mma_k8(dv, af[mt][0], b[0][0], b[0][1], 0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int ks = 1; ks < KS; ++ks)
            mma_k8(dv, af[mt][ks], b[ks][0], b[ks][1], dv[0], dv[1], dv[2],
                   dv[3]);
          if (k == 0) {
            gm[2 * mt] = fminf(dv[0], dv[1]);
            gm[2 * mt + 1] = fminf(dv[2], dv[3]);
          } else {
            gm[2 * mt] = min3(gm[2 * mt], dv[0], dv[1]);
            gm[2 * mt + 1] = min3(gm[2 * mt + 1], dv[2], dv[3]);
          }
        }
      }
      bool pass = false;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) pass |= gm[s] <= thr[s];
      if (!__any_sync(FULL, pass)) continue;
      // a pass: tighten the thresholds (smin only moves where gm <= thr,
      // since thr >= smin); the share becomes its slot's pending one, and
      // the one it displaces goes to the list if it still passes
      const uint32_t group = static_cast<uint32_t>(base / (8 * GROUP) + gi);
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const bool ps = gm[s] <= thr[s];
        smin[s] = fminf(smin[s], gm[s]);
        thr[s] = smin[s] + mg[s];
        if (ps) {
          if (pg[s] <= thr[s]) {
            s_list[cnt * THREADS + threadIdx.x] = (1u << (24 + s)) | pj[s];
            ++cnt;
          }
          pj[s] = group;
          pg[s] = gm[s];
        }
      }
      if (__any_sync(FULL, cnt > LIST - SLOTS)) flush();
    }
    if (it + 1 < tiles) {
      stage<D>(raw, c, m, base + TILE, s_b[(it + 1) & 1]);
      if ((it + 1) % REFRESH == 0) {   // share smin in the quad, new margins
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          smin[s] = fminf(smin[s], __shfl_xor_sync(FULL, smin[s], 1));
          smin[s] = fminf(smin[s], __shfl_xor_sync(FULL, smin[s], 2));
          if (live >> s & 1) {
            const float ah = s_a[row_of(s)];
            mg[s] = margin_at(smin[s], ah, sqrtf(ah * A_UP));
            thr[s] = smin[s] + mg[s];
          }
        }
      }
    }
    __syncthreads();
  }

  // the final thresholds, from the quad's least screen; the pending shares
  // that pass them join the lists; check them all, merge the quad
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    smin[s] = fminf(smin[s], __shfl_xor_sync(FULL, smin[s], 1));
    smin[s] = fminf(smin[s], __shfl_xor_sync(FULL, smin[s], 2));
    if (live >> s & 1) {
      const float ah = s_a[row_of(s)];
      if (pg[s] <= threshold(upper(smin[s], ah, sqrtf(ah * A_UP)),
                             sqrtf(ah * A_UP))) {
        s_list[cnt * THREADS + threadIdx.x] = (1u << (24 + s)) | pj[s];
        ++cnt;
      }
    }
  }
  flush();
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int row = row_of(s);
    float best = s_bd[row * 4 + t];
    int arg = s_bi[row * 4 + t];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float ob = __shfl_xor_sync(FULL, best, o);
      const int oa = __shfl_xor_sync(FULL, arg, o);
      if (ob < best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    const int q = row0 + row;
    if (t == 0 && q < n) {
      dist[static_cast<size_t>(p) * n + q] = best;
      idx[static_cast<size_t>(p) * n + q] = arg;
    }
  }
}

// The screen alone, for one (16-query x 8-target) tile a warp: what the
// kernel compares with its thresholds, written out so that a check on the
// card can hold the tensor cores' error against KAPPA.  query (n, D) and
// target (m, D) of one pair; out (n, m).
template <int D>
__global__ void __launch_bounds__(32)
    chamfer_screen_kernel(const float* __restrict__ query,
                          const float* __restrict__ target, int n, int m,
                          float* __restrict__ out) {
  constexpr int KS = k_steps<D>;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * 16, c0 = blockIdx.y * 8;
  // the K-vectors of query row r and target j, as the kernel builds them
  float c[D];
#pragma unroll
  for (int d = 0; d < D; ++d) c[d] = target[d];
  auto a_of = [&](int r, int k) -> uint32_t {
    if (r >= n) return 0u;
    float ah = 0.0f, at_k = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float at =
          tf32_rna(query[static_cast<size_t>(r) * D + d] - c[d]);
      ah = fmaf(at, at, ah);
      if (d == k) at_k = at;
    }
    return a_entry<D>(k, at_k, ah);
  };
  auto b_of = [&](int j, int k) -> uint32_t {
    float x[D], b[8 * KS];
#pragma unroll
    for (int d = 0; d < D; ++d)
      x[d] = j < m ? target[static_cast<size_t>(j) * D + d] : 0.0f;
    b_vector<D>(x, j < m, c, b);
    uint32_t v = 0u;
#pragma unroll
    for (int i = 0; i < 8 * KS; ++i)
      if (i == k) v = __float_as_uint(b[i]);
    return v;
  };
  float dv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t a[4] = {
        a_of(r0 + g, 8 * ks + t), a_of(r0 + g + 8, 8 * ks + t),
        a_of(r0 + g, 8 * ks + t + 4), a_of(r0 + g + 8, 8 * ks + t + 4)};
    mma_k8(dv, a, b_of(c0 + g, 8 * ks + t), b_of(c0 + g, 8 * ks + t + 4),
           dv[0], dv[1], dv[2], dv[3]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g + (i >> 1) * 8, j = c0 + 2 * t + (i & 1);
    if (r < n && j < m) out[static_cast<size_t>(r) * m + j] = dv[i];
  }
}

template <int D>
int launch(const void* query, const void* target, const void* qi,
           const void* ti, int p, int n, int m, void* dist, void* idx,
           cudaStream_t stream) {
  const dim3 blocks((n + ROWS - 1) / ROWS, p);
  chamfer_nn_kernel<D><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(query), static_cast<const float*>(target),
      static_cast<const int*>(qi), static_cast<const int*>(ti), n, m,
      static_cast<float*>(dist), static_cast<int*>(idx));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_screen(const void* query, const void* target, int n, int m,
                  void* out, cudaStream_t stream) {
  const dim3 blocks((n + 15) / 16, (m + 7) / 8);
  chamfer_screen_kernel<D><<<blocks, 32, 0, stream>>>(
      static_cast<const float*>(query), static_cast<const float*>(target), n,
      m, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). Device pointers of contiguous
// tensors: query (Q, n, d) and target (T, m, d) fp32, qi / ti (p,) int32
// holding valid cloud indices, dist (p, n) fp32, idx (p, n) int32.
// Launches on `stream`, does not synchronise, returns a cudaError_t code.
extern "C" int pcfm_chamfer_nn(const void* query, const void* target,
                               const void* qi, const void* ti, int p, int n,
                               int m, int d, void* dist, void* idx,
                               void* stream) {
  if (p <= 0 || p > 65535 || n <= 0 || m <= 0 || d < 1 || d > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
#define PCFM_CASE(D) \
  case D: return launch<D>(query, target, qi, ti, p, n, m, dist, idx, st);
    PCFM_CASE(1) PCFM_CASE(2) PCFM_CASE(3) PCFM_CASE(4)
    PCFM_CASE(5) PCFM_CASE(6) PCFM_CASE(7)
    default: return launch<8>(query, target, qi, ti, p, n, m, dist, idx, st);
#undef PCFM_CASE
  }
}

// The screen of one pair, (n, d) queries against (m, d) targets, into
// out (n, m) fp32: the values the kernel above thresholds.
extern "C" int pcfm_chamfer_screen(const void* query, const void* target,
                                   int n, int m, int d, void* out,
                                   void* stream) {
  if (n <= 0 || m <= 0 || d < 1 || d > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
#define PCFM_CASE(D) case D: return launch_screen<D>(query, target, n, m, out, st);
    PCFM_CASE(1) PCFM_CASE(2) PCFM_CASE(3) PCFM_CASE(4)
    PCFM_CASE(5) PCFM_CASE(6) PCFM_CASE(7)
    default: return launch_screen<8>(query, target, n, m, out, st);
#undef PCFM_CASE
  }
}
