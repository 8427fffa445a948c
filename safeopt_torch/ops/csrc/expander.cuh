// Block body of the expander kernels K3 (fused_expander.cu) and K4
// (fused_expander_plan.cu): one GP's predicate for C candidates over the
// block's kP grid points, with the gram entry given by a policy
// (common.cuh). After a virtual observation at candidate j (rank-1
// update of the posterior):
//
//   k[r]   = gram(xs[r], z)                       difference form
//   cross  = sum_r M2[j, r] k[r]                  M2 = Cm^T Lm (C x cap)
//   E      = (gram(xc[j], z) - cross) * inv_dd[j]
//   l2     = mu(z) + E gain[j] - beta sqrt(max(sigma(z)^2 - E^2, 0))
//   out[j] |= unsafe(z) && l2 >= fmin && valid[j]
//
// cross = M2 K is a register-tiled product over the block's points and a
// tile of 32 candidates (C > 32 loops over candidate tiles), contracting
// over the training rows in chunks of the transposed M2 and of the gram
// staged in shared memory; the epilogue works on the register tile.
//
// The OR over the grid is a reduction ACROSS blocks, which run in no
// order on this card: the caller zeroes the int32 output before the
// launch, each block collects its hits in shared flags, and one thread
// per hit candidate ORs it in with atomicOr. (The TPU kernels zeroed the
// output at grid step 0 and relied on in-order steps; that is not
// ported.) A block whose points are all safe cannot hit and returns at
// once after a block-wide __syncthreads_or.
#pragma once

#include "common.cuh"

namespace safeopt {

constexpr int kTMc = 2;           // candidates per thread
constexpr int kRc = kNTY * kTMc;  // candidates per candidate tile

// Dynamic shared memory of candidate_hits.
template <typename T>
inline size_t expander_smem_bytes(int d) {
  return sizeof(T) * ((size_t)kKC * kRc + (size_t)kKC * kP + (size_t)d * kP +
                      (size_t)kRc * d + 3 * (size_t)kRc) +
         sizeof(int) * (size_t)kRc;
}

// out (C,) hit flags of one GP; mu, sigma (N,) its grid posterior; cv
// (3, C) rows [inv_dd, gain, valid]; m2t is M2 transposed (cap x C); ils
// scales the points (null for raw points).
template <typename T, class Gram>
__device__ __forceinline__ void candidate_hits(
    const T* __restrict__ zt, const T* __restrict__ ils,
    const unsigned char* __restrict__ unsafe, const T* __restrict__ mu,
    const T* __restrict__ sigma, const T* __restrict__ xs,
    const T* __restrict__ xc, const T* __restrict__ m2t,
    const T* __restrict__ cv, T beta, T fmin, int* __restrict__ out, int N,
    int d, int cap, int C, const Gram& gram) {
  const int i0 = blockIdx.x * kP;
  int ty, tx;
  tile_coords(threadIdx.x, ty, tx);

  // this thread's points: unsafe flag and posterior
  bool mine[kTN];
  T mu_p[kTN], s2_p[kTN];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int i = i0 + tx * kTN + j;
    mine[j] = i < N && unsafe[i] != 0;
    mu_p[j] = mine[j] ? mu[i] : T(0);
    const T s = mine[j] ? sigma[i] : T(0);
    s2_p[j] = s * s;
    any = any || mine[j];
  }
  if (!__syncthreads_or(any)) return;  // no unsafe point in this block

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* at = reinterpret_cast<T*>(smem_raw);  // kKC x kRc chunk of M2^T
  T* kt = at + kKC * kRc;                   // kKC x kP gram chunk
  T* zs = kt + kKC * kP;                    // d x kP points
  T* xcs = zs + (size_t)d * kP;             // kRc x d candidate inputs
  T* cvs = xcs + (size_t)kRc * d;           // 3 x kRc [inv_dd, gain, valid]
  int* hits = reinterpret_cast<int*>(cvs + 3 * kRc);  // kRc flags

  stage_points(zs, zt, ils, N, d, i0);

  for (int j0 = 0; j0 < C; j0 += kRc) {
    T acc[kTMc][kTN];
#pragma unroll
    for (int i = 0; i < kTMc; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = T(0);
    for (int k0 = 0; k0 < cap; k0 += kKC) {
      __syncthreads();  // the previous chunk (and candidate tile) is done
      stage_a<T, kRc>(at, m2t, C, k0, cap, j0, C);
      stage_gram(kt, xs + (size_t)k0 * d, zs, min(kKC, cap - k0), d, gram);
      if (k0 == 0) {  // the candidate tile's own operands
        for (int t = threadIdx.x; t < kRc * d; t += kThreads)
          xcs[t] = j0 * d + t < C * d ? xc[(size_t)j0 * d + t] : T(0);
        for (int t = threadIdx.x; t < 3 * kRc; t += kThreads) {
          const int q = t / kRc, jj = t - q * kRc;
          cvs[t] = j0 + jj < C ? cv[q * C + j0 + jj] : T(0);
        }
        for (int t = threadIdx.x; t < kRc; t += kThreads) hits[t] = 0;
      }
      __syncthreads();
      mma_chunk<T, kTMc>(acc, at, kt, ty, tx);
    }

#pragma unroll
    for (int i = 0; i < kTMc; ++i) {
      const int jj = ty * kTMc + i;
      if (!(cvs[2 * kRc + jj] > T(0.5))) continue;  // padding or past C
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (!mine[j]) continue;
        const int p = tx * kTN + j;
        const T e = (gram(xcs + jj * d, zs, p, d) - acc[i][j]) * cvs[jj];
        const T v2 = s2_p[j] - e * e;
        const T l2 =
            mu_p[j] + e * cvs[kRc + jj] - beta * dsqrt(v2 > T(0) ? v2 : T(0));
        if (l2 >= fmin) hits[jj] = 1;  // benign race: every writer stores 1
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kRc; t += kThreads)
      if (hits[t]) atomicOr(out + j0 + t, 1);
  }
}

}  // namespace safeopt
