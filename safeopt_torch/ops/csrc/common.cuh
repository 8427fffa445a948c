// Shared device helpers of the safeopt_torch kernels.
//
// Both grid kernels (K1, K3) are a small matrix product A^T K per block
// of grid points followed by a per-point epilogue, where K is the block's
// gram (kernel values between the training inputs and the points). They
// share one tiling: a block of kThreads threads owns kP grid points and a
// tile of R rows (R = kNTY * TM); each thread accumulates a TM x kTN
// register tile of the product. The contraction runs over the training
// rows in chunks of kKC: per chunk the block stages A's chunk (rows of
// the transposed factor or M2) and computes the gram chunk into shared
// memory, then every thread does kKC rank-1 updates of its register tile.
// Per update a thread reads TM + kTN values from shared memory for
// TM * kTN FMAs; a warp covers 4 row groups x 8 point groups, so those
// reads are a few contiguous vectors (broadcast within the warp).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace safeopt {

// Kernel families; the numbering matches KINDS in ops/fused_posterior.py.
enum Kind { kRBF = 0, kMatern32 = 1, kMatern52 = 2, kExponential = 3 };

constexpr int kThreads = 256;       // threads per block
constexpr int kNTX = 16;            // point groups per block
constexpr int kNTY = 16;            // row groups per block
constexpr int kTN = 4;              // points per thread
constexpr int kP = kNTX * kTN;      // grid points per block
constexpr int kKC = 32;             // training rows per contraction chunk

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

// Stationary kernel value from the lengthscale-scaled squared distance,
// the same expressions as the JAX package's kernel bodies (including
// the sqrt guard of the Matern and exponential families).
template <typename T>
__device__ __forceinline__ T kfun(int kind, T r2, T variance) {
  if (kind == kRBF) return variance * dexp(T(-0.5) * r2);
  const T r = dsqrt(r2 + T(1e-36));
  if (kind == kExponential) return variance * dexp(-r);
  if (kind == kMatern52) {
    const T s5r = T(2.23606797749978969640917366873128) * r;
    return variance * (T(1) + s5r + (T(5) / T(3)) * r2) * dexp(-s5r);
  }
  const T s3r = T(1.73205080756887729352744634150587) * r;
  return variance * (T(1) + s3r) * dexp(-s3r);
}

// Thread -> (row group ty, point group tx). The 8 warps tile the 16 x 16
// groups as 4 x 2 patches of 4 row groups x 8 point groups.
__device__ __forceinline__ void tile_coords(int tid, int& ty, int& tx) {
  const int warp = tid >> 5, lane = tid & 31;
  ty = (warp >> 1) * 4 + (lane >> 3);
  tx = (warp & 1) * 8 + (lane & 7);
}

// dst = src[0:N] from shared memory; src is aligned to min(16, N *
// sizeof(T)) bytes, so the copy is one or a few vector loads.
template <typename T, int N>
__device__ __forceinline__ void load_vec(T (&dst)[N], const T* src) {
  if constexpr (std::is_same<T, float>::value && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(src)[i];
      dst[4 * i] = v.x;
      dst[4 * i + 1] = v.y;
      dst[4 * i + 2] = v.z;
      dst[4 * i + 3] = v.w;
    }
  } else if constexpr (std::is_same<T, float>::value && N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  } else if constexpr (std::is_same<T, double>::value && N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const double2 v = reinterpret_cast<const double2*>(src)[i];
      dst[2 * i] = v.x;
      dst[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

// at[c * R + r] = a[(k0 + c) * lda + r0 + r]: a chunk of kKC rows and R
// columns of the row-major A, zero past row kend or column rend.
// Neighbouring threads read neighbouring columns (coalesced).
template <typename T, int R>
__device__ __forceinline__ void stage_a(T* at, const T* __restrict__ a,
                                        int lda, int k0, int kend, int r0,
                                        int rend) {
  for (int t = threadIdx.x; t < kKC * R; t += kThreads) {
    const int c = t / R;
    const int r = t - c * R;
    at[t] = (k0 + c < kend && r0 + r < rend)
                ? a[(size_t)(k0 + c) * lda + r0 + r]
                : T(0);
  }
}

// kt[c * kP + p] = k(xs[c], zs[:, p]) for the chunk's first `rows`
// training rows (xs already offset to the chunk, scaled by the
// lengthscale), zero past them. Distances in difference form.
template <typename T>
__device__ __forceinline__ void stage_gram(T* kt, const T* __restrict__ xs,
                                           const T* zs, int rows, int d,
                                           int kind, T variance) {
  for (int t = threadIdx.x; t < kKC * kP; t += kThreads) {
    const int c = t / kP;
    const int p = t - c * kP;
    T v = T(0);
    if (c < rows) {
      T r2 = T(0);
      for (int k = 0; k < d; ++k) {
        const T diff = __ldg(xs + (size_t)c * d + k) - zs[k * kP + p];
        r2 += diff * diff;
      }
      v = kfun(kind, r2, variance);
    }
    kt[t] = v;
  }
}

// acc[i][j] += sum_c at[c][ty * TM + i] * kt[c][tx * kTN + j] over one
// staged chunk: kKC rank-1 updates of the thread's register tile.
template <typename T, int TM>
__device__ __forceinline__ void mma_chunk(T (&acc)[TM][kTN], const T* at,
                                          const T* kt, int ty, int tx) {
  constexpr int R = kNTY * TM;
#pragma unroll 8
  for (int c = 0; c < kKC; ++c) {
    T a[TM], b[kTN];
    load_vec(a, at + c * R + ty * TM);
    load_vec(b, kt + c * kP + tx * kTN);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] += a[i] * b[j];
  }
}

// Scaled grid points of the block: zs[k * kP + p] = zt[k, i0 + p] *
// ils[k], zero past N.
template <typename T>
__device__ __forceinline__ void stage_points(T* zs, const T* __restrict__ zt,
                                             const T* __restrict__ ils,
                                             int N, int d, int i0) {
  for (int t = threadIdx.x; t < d * kP; t += kThreads) {
    const int k = t / kP;
    const int i = i0 + t - k * kP;
    zs[t] = i < N ? zt[(size_t)k * N + i] * ils[k] : T(0);
  }
}

}  // namespace safeopt
