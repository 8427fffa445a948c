// Shared device helpers of the safeopt_torch kernels.
//
// The grid kernels (K1-K4) are a small matrix product per block of grid
// points followed by a per-point epilogue: K1/K2 contract the factor Lm,
// K3/K4 the candidates' M2, against the block's gram (kernel values
// between the training inputs and the points). How one gram entry is
// computed is a policy (StationaryGram for K1/K3, PlanGram for K2/K4)
// with one body, rows<R>, for R rows at once (the interval body takes
// four, the expander body eight; one entry is rows<1>). The block bodies
// and their tiling are in intervals.cuh (K1/K2) and expander.cuh
// (K3/K4); both stage operands with the asynchronous copies below.
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

// leaves of a K2/K4 plan staged in static shared memory (PlanSmem,
// MAX_LEAVES); a longer plan takes the kernels' wide instances
// (stage_plan)
constexpr int kMaxLeaves = 8;
constexpr int kMaxDim = 64;    // grid columns (MAX_DIM)
// shared memory a block may opt in to on sm_90
constexpr size_t kSmemPerBlock = 227 * 1024;

constexpr int kThreads = 256;       // threads per block

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
// kinds). Cos false leaves the cosine kind out (the stationary families
// of K1/K3), and with it cosf's slow path for huge arguments, whose
// local array made the float32 K3 spill.
template <bool Cos = true, typename T>
__device__ __forceinline__ T kfun(int kind, T r2, T variance) {
  if (kind == kRBF) return variance * dexp(T(-0.5) * r2);
  const T r = dsqrt(r2 + T(1e-36));
  if (Cos && kind == kCosine) return variance * dcos(r);
  if (kind == kExponential) return variance * dexp(-r);
  if (kind == kMatern52) {
    const T s5r = T(2.23606797749978969640917366873128) * r;
    return variance * (T(1) + s5r + (T(5) / T(3)) * r2) * dexp(-s5r);
  }
  const T s3r = T(1.73205080756887729352744634150587) * r;
  return variance * (T(1) + s3r) * dexp(-s3r);
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
    for (int r = 0; r < R; ++r) v[r] = kfun<false>(kind, r2[r], variance);
  }
  // k(x, zs[:, p]) for one row
  __device__ __forceinline__ T operator()(const T* x, const T* zs, int p,
                                          int d, int ldz) const {
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
                                          int d, int ldz) const {
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

// Bytes of a plan of P leaves over d columns staged by stage_plan.
template <typename T>
__host__ __device__ inline size_t plan_bytes(int P, int d) {
  return sizeof(T) * ((size_t)P * d + P) +
         sizeof(int) * ((size_t)P * d + 3 * (size_t)P);
}

// A plan of any number of leaves (the wide instances of K2/K4, past
// kMaxLeaves), staged once per block in dynamic shared memory at smem
// (16-byte aligned, plan_bytes<T>(P, d) of it): PlanSmem's arrays with P
// rows, so the gram reads it as broadcasts as it reads PlanSmem. Kept
// apart from PlanSmem::stage so that the instances of at most kMaxLeaves
// leaves compile as they did. Ends with a barrier.
template <typename T>
__device__ __forceinline__ PlanGram<T> stage_plan(
    unsigned char* smem, const T* __restrict__ g_scales,
    const T* __restrict__ g_pvar, const int* __restrict__ plan, int P,
    int d) {
  T* scales = reinterpret_cast<T*>(smem);
  T* pvar = scales + (size_t)P * d;
  int* kind = reinterpret_cast<int*>(pvar + P);
  int* last = kind + P;
  int* ncols = last + P;
  int* cols = ncols + P;
  for (int t = threadIdx.x; t < P * d; t += kThreads) scales[t] = g_scales[t];
  for (int q = threadIdx.x; q < P; q += kThreads) {
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

}  // namespace safeopt
