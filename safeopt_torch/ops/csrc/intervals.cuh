// Block body of the interval kernels K1 (fused_intervals.cu) and K2
// (fused_intervals_plan.cu): one GP's interval rows over the block's P
// grid points, with the gram entry given by a policy (common.cuh).
//
//   k[c]  = gram(xs[c], z)               difference form, c < n
//   V[r]  = sum_{c <= r} Lm[r, c] k[c]   Lm = Linv * col_mask, lower
//   mu    = sum_r w[r] V[r],  var = max(kdiag - sum_r V[r]^2, 0)
//   out   = (mu - beta sqrt(var), mu + beta sqrt(var))
//
// What bounds it: per point n(n+1)/2 FMAs of the triangular product and n
// gram entries, against 8 d bytes of grid read: the FP32 (FP64) pipe. The
// design removes the work that bound does not count and keeps the FMA
// pipe fed from shared memory:
//
// - Only the active rows. n (the GP's count, read by the kernel from
//   device memory) ends the rows and the contraction. Past n, Lm is
//   exactly zero (padding rows of Linv are identity rows, and the column
//   mask zeroes them), so the skipped terms are exact zeros.
// - The triangle at 32-row grain. The rows are cut into bands of 32; band
//   b contracts over columns [0, min(32 (b + 1), n)) only. At n = 400
//   that is 92,672 MACs per point against n(n+1)/2 = 80,200 (1.16x).
// - Each gram entry once per block. The block first computes the gram of
//   its points for the rows it keeps resident (at most kGramBytes) into
//   shared memory, one point per thread and four rows at a time; every
//   band reads it from there. Past the resident rows (f32 past cap 512,
//   f64 past 256) a warp computes the gram of each piece it needs itself.
// - One warp per band, bands handed out largest first. A band is one
//   warp's work: 32 rows by 32 points, an 8 x 4 register tile per thread.
//   Warps take (slice, band) items from a shared counter, largest band
//   first, so the triangle's unequal bands balance over the 8 warps
//   without a block barrier between them. A block holds S slices of 32
//   points: S grows as cap shrinks, so that small capacities still give
//   every warp a band.
// - The factor staged asynchronously. Each warp streams its band's rows
//   of Lm^T in pieces of kKS columns through a ring of kStages pieces in
//   shared memory with cp.async: the next piece is in flight while piece
//   q's rank-1 steps run. The wrapper pads each row of Lm^T with zeros
//   to a multiple of 32, so that every band's copies are whole 16-byte
//   vectors in bounds: a copy element by element at the edge, tried on
//   the H100, cost K1 10 % at cap 512 even where it never ran.
// - Deterministic sums. A band's per-point partials of mu and sum V^2 go
//   to their own slot; the block adds the bands in order, so which warp
//   ran which band does not change a bit. Past kRoundBands bands (1024
//   rows) the items run in rounds of that many, each added in turn, so
//   that shared memory does not grow with the capacity.
//
// On the H100 (tools_torch/tune_intervals.py, PERF.md) 64 KB of gram keeps
// two blocks of 256 threads on an SM at cap 512; 128 KB (one block), an
// 8 x 8 tile over half-warps, smaller pieces with more of them in flight
// and three blocks per SM were slower. What is left beyond the product:
// the gram, the factor streamed from L2 once per 32 points, and the last
// band of a block running alone.
//
// The product is a policy next to the gram's. Fp32Product: the products
// above are FP32 (FP64) FMAs; no TF32, no tensor cores. ThreePassProduct,
// float64 only (the float64 K1-3p and K2-3p, and the experiments B1-3p,
// B2-3p and B3-3p in float64): V = Lm k taken as Lm_hi k_hi + Lm_hi k_lo
// + Lm_lo k_hi over bf16 limbs (limbs.cuh), the TPU kernel's 3-pass
// product; the band keeps the FP32 policy's register tile and adds the
// three limb products as FP64 FMAs with lo unrounded, the JAX package's
// float64 3-pass product: a check of the bands, the gram policies and the
// limb cut against the plain version to 1e-9, not a route the card's
// float32 path takes (the float32 three-pass kernels run the wgmma
// bodies of intervals3.cuh and intervals3_tiled.cuh).
#pragma once

#include "common.cuh"
#include "limbs.cuh"

namespace safeopt {

constexpr int kWarps = kThreads / 32;
constexpr int kBand = 32;     // rows of a band: 4 row groups x kBandTM
constexpr int kBandTM = 8;    // rows per thread
constexpr int kBandTN = 4;    // points per thread
constexpr int kWP = 8 * kBandTN;  // points of a band: 8 point groups
constexpr int kKS = 16;       // columns of a piece of Lm^T
constexpr int kStages = 2;    // pieces in each warp's ring
constexpr int kMaxSlices = 8;  // slices of kWP points a block holds at most
// gram bytes a block keeps resident in shared memory: two blocks fit on
// an SM, so instances are compiled for kIvMinBlocks (at most 128
// registers a thread)
constexpr size_t kGramBytes = 64 * 1024;
constexpr int kIvMinBlocks = 2;
// bands whose partials a block holds at once; more bands are added in
// rounds, so that shared memory does not grow with the capacity
constexpr int kRoundBands = 32;
static_assert(kMaxSlices * kWP <= kThreads, "a thread per point of the block");
// shared memory a block may use, less K2's static plan
constexpr size_t kMaxDynSmem = kSmemPerBlock - sizeof(PlanSmem<double>);

// Product policies of the band's contraction (see the note above).
struct Fp32Product {
  static constexpr bool kThreePass = false;
};
struct ThreePassProduct {
  static constexpr bool kThreePass = true;
};

// Byte offsets of the block's shared memory: the resident gram (res x
// P), the warps' rings, their gram pieces past the resident rows, the
// band partials of a round (2 x nred x P), the points (d x P) and the
// work slots.
template <typename T>
struct IvLayout {
  int S, P, res, nred;
  size_t gram, ring, scratch, red, zs, slots, bytes;

  __host__ __device__ IvLayout(int cap, int d, int S_, int res_)
      : S(S_), P(S_ * kWP), res(res_),
        nred((cap + kBand - 1) / kBand < kRoundBands
                 ? (cap + kBand - 1) / kBand
                 : kRoundBands) {
    size_t o = 0;
    gram = o;
    o += sizeof(T) * (size_t)res * P;
    ring = o;
    o += sizeof(T) * (size_t)kWarps * kStages * kKS * kBand;
    scratch = o;
    if (res < cap) o += sizeof(T) * (size_t)kWarps * kKS * kWP;
    red = o;
    o += sizeof(T) * 2 * (size_t)nred * P;
    zs = o;
    o += sizeof(T) * (size_t)d * P;
    slots = o;
    o += sizeof(int) * (kWarps + 1);
    bytes = o;
  }
};

// The layout of a launch: the most slices (up to 8) whose whole gram fits
// the budget, then the most resident rows that fit.
template <typename T>
inline IvLayout<T> interval_layout(int cap, int d) {
  const int cap_pad = (cap + kKS - 1) / kKS * kKS;
  int S = kMaxSlices;
  while (S > 1 && sizeof(T) * (size_t)cap_pad * S * kWP > kGramBytes) S /= 2;
  for (;; S /= 2) {
    int res = (int)(kGramBytes / (sizeof(T) * (size_t)S * kWP)) / kKS * kKS;
    res = res < cap_pad ? res : cap_pad;
    for (; res >= 0; res -= kKS) {
      const IvLayout<T> lay(cap, d, S, res);
      if (lay.bytes <= kMaxDynSmem) return lay;
    }
    if (S == 1) return IvLayout<T>(cap, d, 1, 0);  // too large: launch fails
  }
}

// One warp stages columns [k0, k0 + kKS) of its band's rows r0..r0+31 of
// Lm^T (row stride ldl, a multiple of kBand) as at[c * kBand + r], with
// 16-byte asynchronous copies; columns at or past cend are not copied.
template <typename T>
__device__ __forceinline__ void stage_band(T* at, const T* __restrict__ lmt,
                                           int ldl, int k0, int cend, int r0,
                                           int lane) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kPerCol = kBand / V;
  for (int t = lane; t < kKS * kPerCol; t += 32) {
    const int c = t / kPerCol;
    const int r = (t - c * kPerCol) * V;
    if (k0 + c < cend)
      cp_async16(at + c * kBand + r, lmt + (size_t)(k0 + c) * ldl + r0 + r);
  }
}

// gk[c * P + p] = gram(xs[c], zs[:, p]) for rows c < rows: each thread
// keeps one point p and takes every (kThreads / P)-th row (P divides
// kThreads), four rows per gram.rows call. D is the column count when
// the caller knows it at compile time, so that the loops over columns
// unroll (0: d at run time).
template <int D, typename T, class Gram>
__device__ __forceinline__ void fill_gram(T* __restrict__ gk,
                                          const T* __restrict__ xs,
                                          const T* zs, int rows, int d, int P,
                                          const Gram& gram) {
  constexpr int R = 4;
  const int dd = D > 0 ? D : d;
  const int p = threadIdx.x % P;
  const int step = kThreads / P;
  int c = threadIdx.x / P;
  for (; c + (R - 1) * step < rows; c += R * step) {
    const T* x[R];
    T v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = xs + (size_t)(c + r * step) * dd;
    gram.rows(v, x, zs, p, dd, P);
#pragma unroll
    for (int r = 0; r < R; ++r) gk[(size_t)(c + r * step) * P + p] = v[r];
  }
  for (; c < rows; c += step)
    gk[(size_t)c * P + p] = gram(xs + (size_t)c * dd, zs, p, dd, P);
}

// acc[i][j] += a[c][ty * kBandTM + i] * b[c][tx * kBandTN + j] for the
// columns c < steps: rank-1 updates of a thread's register tile from a
// staged piece (a) and gram rows of stride ldb (b). Per step a thread
// reads 8 + 4 values from shared memory for 32 FMAs.
// ThreePass (float64 only) adds each product as a_hi b_hi + a_hi b_lo +
// a_lo b_hi of the values' limbs (split_f64).
template <bool ThreePass = false, typename T>
__device__ __forceinline__ void band_steps(T (&acc)[kBandTM][kBandTN],
                                           const T* a, const T* b, int ldb,
                                           int steps, int ty, int tx) {
  auto step = [&](int c) {
    T av[kBandTM], bv[kBandTN];
    load_vec(av, a + c * kBand + ty * kBandTM);
    load_vec(bv, b + (size_t)c * ldb + tx * kBandTN);
    if constexpr (ThreePass) {
      static_assert(std::is_same<T, double>::value,
                    "float32 three-pass bands run on the tensor cores");
      T ah[kBandTM], al[kBandTM], bh[kBandTN], bl[kBandTN];
#pragma unroll
      for (int i = 0; i < kBandTM; ++i) split_f64(av[i], ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < kBandTN; ++j) split_f64(bv[j], bh[j], bl[j]);
#pragma unroll
      for (int i = 0; i < kBandTM; ++i)
#pragma unroll
        for (int j = 0; j < kBandTN; ++j) {
          acc[i][j] += ah[i] * bh[j];
          acc[i][j] += ah[i] * bl[j];
          acc[i][j] += al[i] * bh[j];
        }
    } else {
#pragma unroll
      for (int i = 0; i < kBandTM; ++i)
#pragma unroll
        for (int j = 0; j < kBandTN; ++j) acc[i][j] += av[i] * bv[j];
    }
  };
  if (steps == kKS) {
#pragma unroll
    for (int c = 0; c < kKS; ++c) step(c);
  } else {
    for (int c = 0; c < steps; ++c) step(c);
  }
}

// out (2, N) rows of one GP for the block's points; ils scales the
// points (null for raw points); lmt is Lm transposed with row stride ldl;
// n the active rows; S and res from interval_layout. MuFromGram (the
// experiment B3, interval_experiments.cu) takes w as u = Lm^T w and mu as
// sum_c u[c] k[c]: the last band, which reads every gram column, adds it
// up and no band multiplies w into V. With the FP32 product each thread
// adds its tile's columns c = ty mod 4 and the band adds the row groups
// in order. With ThreePassProduct each band adds u[c] k[c] over its own
// columns [r0, cend), the last pieces it stages, so that the bands
// share mu's work (the longest band sets a block's time, and the last
// band, which reads every column, is the longest; PERF.md); each
// lane adds its point from the gram rows in shared memory, in
// column order (one sum a lane leaves the float64 bands' registers to
// the limbs), and the bands' partials are added in band order. Product
// is the contraction's policy (Fp32Product, ThreePassProduct).
template <typename T, class Gram, bool MuFromGram = false,
          class Product = Fp32Product>
__device__ __forceinline__ void interval_rows(
    const T* __restrict__ zt, const T* __restrict__ ils,
    const T* __restrict__ xs, const T* __restrict__ lmt, int ldl,
    const T* __restrict__ w, T kdiag, T beta, T* __restrict__ out, int N,
    int d, int cap, int n, int S, int res, const Gram& gram) {
  static_assert(!Product::kThreePass || std::is_same<T, double>::value,
                "the float32 three-pass bodies are intervals3.cuh's");
  // mu from the gram by lane = point (the three-pass bands)
  constexpr bool kMuLane = MuFromGram && Product::kThreePass;
  const IvLayout<T> lay(cap, d, S, res);
  const int P = lay.P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* gk = reinterpret_cast<T*>(smem_raw + lay.gram);     // res x P gram
  T* ring = reinterpret_cast<T*>(smem_raw + lay.ring);   // per warp
  T* scr = reinterpret_cast<T*>(smem_raw + lay.scratch);  // per warp
  T* red = reinterpret_cast<T*>(smem_raw + lay.red);     // 2 x nred x P
  T* zs = reinterpret_cast<T*>(smem_raw + lay.zs);       // d x P points
  int* slots = reinterpret_cast<int*>(smem_raw + lay.slots);

  const int i0 = blockIdx.x * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane / 8, tx = lane % 8;  // row group, point group
  const int nb = (n + kBand - 1) / kBand;

  // 1. the points, the resident gram (each entry once)
  for (int t = threadIdx.x; t < d * P; t += kThreads) {
    const int k = t / P;
    const int i = i0 + t - k * P;
    const T z = i < N ? zt[(size_t)k * N + i] : T(0);
    zs[t] = ils != nullptr ? z * ils[k] : z;
  }
  __syncthreads();
  const int rows = n < res ? n : res;
  switch (d) {
    case 1: fill_gram<1>(gk, xs, zs, rows, d, P, gram); break;
    case 2: fill_gram<2>(gk, xs, zs, rows, d, P, gram); break;
    case 3: fill_gram<3>(gk, xs, zs, rows, d, P, gram); break;
    case 4: fill_gram<4>(gk, xs, zs, rows, d, P, gram); break;
    default: fill_gram<0>(gk, xs, zs, rows, d, P, gram);
  }

  // 2. (slice, band) items, largest band first, one warp each, in rounds
  // of the bands [lo, hi); thread p keeps point p's sums over the rounds
  T* at0 = ring + (size_t)warp * kStages * kKS * kBand;
  T* bw = scr + (size_t)warp * kKS * kWP;
  T m_all = T(0), q_all = T(0);
  for (int hi = nb; hi > 0; hi -= lay.nred) {
    const int lo = hi - lay.nred > 0 ? hi - lay.nred : 0;
    if (threadIdx.x == 0) slots[kWarps] = 0;
    __syncthreads();  // the counter is reset, the last round's sums read
    for (;;) {
      if (lane == 0) slots[warp] = atomicAdd(slots + kWarps, 1);
      __syncwarp();
      const int item = slots[warp];
      __syncwarp();
      if (item >= S * (hi - lo)) break;
      const int b = hi - 1 - item / S;
      const int s = item - (item / S) * S;
      const int r0 = b * kBand;
      const int cend = r0 + kBand < n ? r0 + kBand : n;  // lower triangle
      const int pieces = (cend + kKS - 1) / kKS;

      T acc[kBandTM][kBandTN];
#pragma unroll
      for (int i = 0; i < kBandTM; ++i)
#pragma unroll
        for (int j = 0; j < kBandTN; ++j) acc[i][j] = T(0);
      // MuFromGram: this thread's columns c = ty mod 4 (kMuLane: mg[0],
      // point lane over the band's columns [r0, cend))
      T mg[kBandTN];
      if constexpr (MuFromGram) {
#pragma unroll
        for (int j = 0; j < kBandTN; ++j) mg[j] = T(0);
      }
      for (int q = 0; q < kStages - 1; ++q) {  // the ring's first pieces
        if (q < pieces)
          stage_band(at0 + q * kKS * kBand, lmt, ldl, q * kKS, cend, r0, lane);
        cp_async_commit();
      }
      for (int q = 0; q < pieces; ++q) {
        const int k0 = q * kKS;
        const int ahead = q + kStages - 1;  // into the slot piece q - 1 used
        if (ahead < pieces)
          stage_band(at0 + (ahead % kStages) * kKS * kBand, lmt, ldl,
                     ahead * kKS, cend, r0, lane);
        cp_async_commit();
        const T* bsrc;
        int ldb;
        if (k0 < res) {
          bsrc = gk + (size_t)k0 * P + s * kWP;
          ldb = P;
        } else {  // past the resident rows: this warp's piece of the gram
          static_assert(kWP == 32, "a lane per point of the band");
#pragma unroll 4
          for (int c = 0; c < kKS; ++c)
            bw[c * kWP + lane] =
                k0 + c < cend
                    ? gram(xs + (size_t)(k0 + c) * d, zs + s * kWP, lane, d, P)
                    : T(0);
          bsrc = bw;
          ldb = kWP;
        }
        cp_async_wait<kStages - 1>();  // piece q has landed, later in flight
        __syncwarp();
        const int steps = cend - k0 < kKS ? cend - k0 : kKS;
        band_steps<Product::kThreePass>(acc, at0 + (q % kStages) * kKS * kBand,
                                        bsrc, ldb, steps, ty, tx);
        if constexpr (kMuLane) {
          if (k0 >= r0) {  // the band's own columns: the bands cover [0, n)
            for (int c = 0; c < steps; ++c)
              mg[0] += w[k0 + c] * bsrc[(size_t)c * ldb + lane];
          }
        } else if constexpr (MuFromGram) {
          if (b == nb - 1) {  // the last band: every column below n
#pragma unroll
            for (int k = 0; k < kKS / 4; ++k) {
              const int c = 4 * k + ty;
              if (c < steps) {
                T bv[kBandTN];
                load_vec(bv, bsrc + (size_t)c * ldb + tx * kBandTN);
                const T uc = w[k0 + c];
#pragma unroll
                for (int j = 0; j < kBandTN; ++j) mg[j] += uc * bv[j];
              }
            }
          }
        }
        __syncwarp();  // piece q (and the gram piece) is consumed
      }
      // the band's partials; rows past n hold exact zeros
      T mu[kBandTN], ssq[kBandTN];
#pragma unroll
      for (int j = 0; j < kBandTN; ++j) mu[j] = ssq[j] = T(0);
#pragma unroll
      for (int i = 0; i < kBandTM; ++i) {
        const int r = r0 + ty * kBandTM + i;
        const T wr = r < n ? w[r] : T(0);
#pragma unroll
        for (int j = 0; j < kBandTN; ++j) {
          if constexpr (!MuFromGram) mu[j] += wr * acc[i][j];
          ssq[j] += acc[i][j] * acc[i][j];
        }
      }
      if constexpr (MuFromGram && !kMuLane) {
#pragma unroll
        for (int j = 0; j < kBandTN; ++j) mu[j] = mg[j];
      }
      T* pm = red + (size_t)(b - lo) * P + s * kWP + tx * kBandTN;
      T* ps = pm + (size_t)lay.nred * P;
      for (int g = 0; g < 4; ++g) {  // the 4 row groups in order
        if (ty == g) {
#pragma unroll
          for (int j = 0; j < kBandTN; ++j) {
            if constexpr (!kMuLane) pm[j] = g ? pm[j] + mu[j] : mu[j];
            ps[j] = g ? ps[j] + ssq[j] : ssq[j];
          }
        }
        __syncwarp();
      }
      if constexpr (kMuLane)
        red[(size_t)(b - lo) * P + s * kWP + lane] = mg[0];
    }
    __syncthreads();
    // 3. the round's bands in order, per point
    const int p = threadIdx.x;
    if (p < P) {
      T m = T(0), q = T(0);
      for (int b = lo; b < hi; ++b) {
        m += red[(size_t)(b - lo) * P + p];
        q += red[(size_t)(lay.nred + b - lo) * P + p];
      }
      m_all += m;
      q_all += q;
    }
  }

  // 4. the rows of the block's points
  const int p = threadIdx.x;
  if (p < P && i0 + p < N) {
    const T var = kdiag - q_all;
    const T spread = beta * dsqrt(var > T(0) ? var : T(0));
    out[i0 + p] = m_all - spread;
    out[N + i0 + p] = m_all + spread;
  }
}

}  // namespace safeopt
