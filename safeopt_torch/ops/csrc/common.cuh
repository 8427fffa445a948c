// Shared device helpers of the safeopt_torch kernels.
//
// The grid kernels (K1-K4) are a small matrix product A^T K per block of
// grid points followed by a per-point epilogue, where K is the block's
// gram (kernel values between the training inputs and the points). How
// one gram entry is computed is a policy (StationaryGram for K1/K3,
// PlanGram for K2/K4) with one body, rows<R>, for R rows at once (the
// interval body's resident gram takes four; one entry is rows<1>). The
// interval kernels K1/K2 have their own tiling (intervals.cuh). The
// expander kernels K3/K4 share this one: a block of kThreads threads owns
// kP grid points and a tile of R rows (R = kNTY * TM); each thread
// accumulates a TM x kTN register tile of the product. The contraction
// runs over the training rows in chunks of kKC: per chunk the block
// stages A's chunk (rows of the transposed M2) and computes the gram
// chunk into shared memory, then every thread does kKC rank-1 updates of
// its register tile. Per update a thread reads TM + kTN values from
// shared memory for TM * kTN FMAs; a warp covers 4 row groups x 8 point
// groups, so those reads are a few contiguous vectors (broadcast within
// the warp).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace safeopt {

// Leaf kinds; the numbering matches LEAF_KINDS in ops/fused_posterior.py
// (K1/K3 take the first four).
enum Kind {
  kRBF = 0,
  kMatern32 = 1,
  kMatern52 = 2,
  kExponential = 3,
  kCosine = 4,
  kBias = 5
};

constexpr int kMaxLeaves = 8;  // leaves of a K2/K4 plan (MAX_LEAVES)
constexpr int kMaxDim = 64;    // grid columns (MAX_DIM)

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
// the accurate cosine (cosf, not the __cosf intrinsic)
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }

// Distance-based leaf value from the lengthscale-scaled squared
// distance, the same expressions as the JAX package's kernel bodies
// (including the sqrt guard of the Matern, exponential and cosine
// kinds).
template <typename T>
__device__ __forceinline__ T kfun(int kind, T r2, T variance) {
  if (kind == kRBF) return variance * dexp(T(-0.5) * r2);
  const T r = dsqrt(r2 + T(1e-36));
  if (kind == kCosine) return variance * dcos(r);
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

// Asynchronous copies (cp.async, sm_80 and later): 16 bytes from global
// to shared memory without passing through registers. A thread's copies
// are grouped by cp_async_commit; cp_async_wait<N> returns once at most N
// of its groups are still in flight. Other threads see the data only
// after a barrier (__syncwarp or __syncthreads) that follows the wait.
// Both pointers are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stationary family over every column: x and the points are both
// already divided by the lengthscale (K1, K3).
template <typename T>
struct StationaryGram {
  int kind;
  T variance;
  // v[r] = k(x[r], zs[:, p]) for R rows (global or shared memory) and the
  // block's staged points zs (d rows of stride ldz): the point's
  // coordinates are read once and the R evaluations are independent
  template <int R>
  __device__ __forceinline__ void rows(T (&v)[R], const T* const (&x)[R],
                                       const T* zs, int p, int d,
                                       int ldz) const {
    T r2[R];
#pragma unroll
    for (int r = 0; r < R; ++r) r2[r] = T(0);
    for (int k = 0; k < d; ++k) {
      const T z = zs[k * ldz + p];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T diff = x[r][k] - z;
        r2[r] += diff * diff;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = kfun(kind, r2[r], variance);
  }
  // k(x, zs[:, p]) for one row
  __device__ __forceinline__ T operator()(const T* x, const T* zs, int p,
                                          int d, int ldz = kP) const {
    T v[1];
    const T* const xr[1] = {x};
    rows<1>(v, xr, zs, p, d, ldz);
    return v[0];
  }
};

// A plan of a Sum/Product algebra (K2, K4; the JAX package's _part_gram):
// raw inputs, per leaf q a kind, a variance and a scale row (1 /
// lengthscale on its active columns, 0 elsewhere). A leaf reads its
// active columns only, in order, as the plain version skips a zero
// scale. Leaf values multiply within a term and terms add; last[q] marks
// the leaf that ends its term. All arrays in shared memory.
template <typename T>
struct PlanGram {
  const T* scales;   // P x d
  const T* pvar;     // P
  const int* kind;   // P
  const int* last;   // P
  const int* cols;   // P x d: row q starts with leaf q's active columns
  const int* ncols;  // P: how many
  int P;
  // v[r] = the plan at (x[r], zs[:, p]) for R rows at once: each leaf's
  // constants and the point's coordinates are read once for the R rows
  template <int R>
  __device__ __forceinline__ void rows(T (&v)[R], const T* const (&x)[R],
                                       const T* zs, int p, int d,
                                       int ldz) const {
    T prod[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = T(0);
      prod[r] = T(1);
    }
    for (int q = 0; q < P; ++q) {
      const T var = pvar[q];
      const int kd = kind[q];
      T leaf[R];
      if (kd == kBias) {
#pragma unroll
        for (int r = 0; r < R; ++r) leaf[r] = var;
      } else {
        const T* s = scales + q * d;
        const int* cq = cols + q * d;
        T r2[R];
#pragma unroll
        for (int r = 0; r < R; ++r) r2[r] = T(0);
        // bounded by d, not ncols[q], so that it unrolls where the caller
        // knows d at compile time (the resident gram)
        for (int j = 0; j < d; ++j) {
          if (j == ncols[q]) break;
          const int k = cq[j];
          const T sk = s[k];
          const T z = zs[k * ldz + p];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const T diff = (x[r][k] - z) * sk;
            r2[r] += diff * diff;
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) leaf[r] = kfun(kd, r2[r], var);
      }
      const bool end = last[q];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        prod[r] *= leaf[r];
        if (end) {
          v[r] += prod[r];
          prod[r] = T(1);
        }
      }
    }
  }
  // the plan at (x, zs[:, p]) for one row
  __device__ __forceinline__ T operator()(const T* x, const T* zs, int p,
                                          int d, int ldz = kP) const {
    T v[1];
    const T* const xr[1] = {x};
    rows<1>(v, xr, zs, p, d, ldz);
    return v[0];
  }
};

// A plan staged in shared memory once per block: plan is the int32 (2, P)
// array [kinds; term indices] and scales (P, d) as ops/fused_posterior.py
// part_plan builds them. Ends with a barrier.
template <typename T>
struct PlanSmem {
  T scales[kMaxLeaves * kMaxDim];
  T pvar[kMaxLeaves];
  int kind[kMaxLeaves];
  int last[kMaxLeaves];
  int cols[kMaxLeaves * kMaxDim];
  int ncols[kMaxLeaves];

  __device__ __forceinline__ PlanGram<T> stage(const T* __restrict__ g_scales,
                                               const T* __restrict__ g_pvar,
                                               const int* __restrict__ plan,
                                               int P, int d) {
    for (int t = threadIdx.x; t < P * d; t += kThreads) scales[t] = g_scales[t];
    const int q = threadIdx.x;
    if (q < P) {
      pvar[q] = g_pvar[q];
      kind[q] = plan[q];
      last[q] = q == P - 1 || plan[P + q + 1] != plan[P + q];
      int m = 0;
      for (int k = 0; k < d; ++k)
        if (g_scales[q * d + k] != T(0)) cols[q * d + m++] = k;
      ncols[q] = m;
    }
    __syncthreads();
    return PlanGram<T>{scales, pvar, kind, last, cols, ncols, P};
  }
};

// kt[c * kP + p] = gram(xs[c], zs[:, p]) for the chunk's first `rows`
// training rows (xs already offset to the chunk), zero past them.
template <typename T, class Gram>
__device__ __forceinline__ void stage_gram(T* kt, const T* __restrict__ xs,
                                           const T* zs, int rows, int d,
                                           const Gram& gram) {
  for (int t = threadIdx.x; t < kKC * kP; t += kThreads) {
    const int c = t / kP;
    const int p = t - c * kP;
    kt[t] = c < rows ? gram(xs + (size_t)c * d, zs, p, d) : T(0);
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

// Grid points of the block: zs[k * kP + p] = zt[k, i0 + p] * ils[k]
// (raw when ils is null), zero past N.
template <typename T>
__device__ __forceinline__ void stage_points(T* zs, const T* __restrict__ zt,
                                             const T* __restrict__ ils,
                                             int N, int d, int i0) {
  for (int t = threadIdx.x; t < d * kP; t += kThreads) {
    const int k = t / kP;
    const int i = i0 + t - k * kP;
    const T z = i < N ? zt[(size_t)k * N + i] : T(0);
    zs[t] = ils != nullptr ? z * ils[k] : z;
  }
}

}  // namespace safeopt
