// Block body of the interval kernels K1 (fused_intervals.cu) and K2
// (fused_intervals_plan.cu): one GP's interval rows over the block's kP
// grid points, with the gram entry given by a policy (common.cuh).
//
//   k[c]  = gram(xs[c], z)               difference form, c < cap
//   V[r]  = sum_{c <= r} Lm[r, c] k[c]   Lm = Linv * col_mask, lower
//   mu    = sum_r w[r] V[r],  var = max(kdiag - sum_r V[r]^2, 0)
//   out   = (mu - beta sqrt(var), mu + beta sqrt(var))
//
// V = Lm K is a register-tiled product over the block's points. The
// block walks the rows of Lm in tiles of R = 16 TM rows; for each tile it
// contracts only over the chunks of columns at or left of the tile's last
// row (the chunks above the diagonal are never read), staging the
// transposed factor's chunk and the gram chunk in shared memory. The
// factor is streamed, so shared memory does not grow with cap. Each
// thread folds its rows of V into per-point partial sums of mu and sum
// V^2 as a row tile finishes; one pass over shared memory at the end adds
// the 16 row groups' partials. All sums are FP32 (or FP64) FMAs; no TF32,
// no tensor cores. Nothing crosses blocks.
#pragma once

#include "common.cuh"

namespace safeopt {

// Dynamic shared memory of interval_rows.
template <typename T, int TM>
inline size_t interval_smem_bytes(int d) {
  constexpr int R = kNTY * TM;
  return sizeof(T) * ((size_t)kKC * R + (size_t)kKC * kP + (size_t)d * kP +
                      2 * (size_t)kNTY * kP);
}

// out (2, N) rows of one GP for the block's points; ils scales the
// points (null for raw points); lmt is Lm transposed.
template <typename T, int TM, class Gram>
__device__ __forceinline__ void interval_rows(
    const T* __restrict__ zt, const T* __restrict__ ils,
    const T* __restrict__ xs, const T* __restrict__ lmt,
    const T* __restrict__ w, T kdiag, T beta, T* __restrict__ out, int N,
    int d, int cap, const Gram& gram) {
  constexpr int R = kNTY * TM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* at = reinterpret_cast<T*>(smem_raw);  // kKC x R chunk of Lm^T
  T* kt = at + kKC * R;                     // kKC x kP gram chunk
  T* zs = kt + kKC * kP;                    // d x kP points
  T* red = zs + (size_t)d * kP;             // 2 x kNTY x kP partials

  const int i0 = blockIdx.x * kP;
  int ty, tx;
  tile_coords(threadIdx.x, ty, tx);

  stage_points(zs, zt, ils, N, d, i0);

  T mu[kTN], ssq[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) mu[j] = ssq[j] = T(0);

  for (int r0 = 0; r0 < cap; r0 += R) {
    T acc[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = T(0);
    const int kend = min(cap, r0 + R);  // lower triangle
    for (int k0 = 0; k0 < kend; k0 += kKC) {
      __syncthreads();  // the previous chunk is consumed
      stage_a<T, R>(at, lmt, cap, k0, cap, r0, cap);
      stage_gram(kt, xs + (size_t)k0 * d, zs, min(kKC, cap - k0), d, gram);
      __syncthreads();
      mma_chunk<T, TM>(acc, at, kt, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = r0 + ty * TM + i;
      const T wr = r < cap ? w[r] : T(0);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        mu[j] += wr * acc[i][j];
        ssq[j] += acc[i][j] * acc[i][j];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    red[ty * kP + tx * kTN + j] = mu[j];
    red[(kNTY + ty) * kP + tx * kTN + j] = ssq[j];
  }
  __syncthreads();
  const int p = threadIdx.x;
  if (p < kP && i0 + p < N) {
    T m = T(0), s = T(0);
    for (int y = 0; y < kNTY; ++y) {
      m += red[y * kP + p];
      s += red[(kNTY + y) * kP + p];
    }
    const T var = kdiag - s;
    const T spread = beta * dsqrt(var > T(0) ? var : T(0));
    out[i0 + p] = m - spread;
    out[N + i0 + p] = m + spread;
  }
}

}  // namespace safeopt
