// K2: fused grid posterior + confidence intervals for ONE GP whose kernel
// is a Sum/Product algebra (a plan) of RBF, Matern32, Matern52,
// Exponential, Cosine and Bias leaves, each on a subset of the columns.
//
// Replaces the TPU kernel safeopt_tpu/ops/fused_posterior.py
// ::_interval_kernel (launched by _fused_intervals_impl, wrapped by
// fused_intervals). It runs the contextual kernels of the reference,
// RBF(active_dims=[0]) * RBF(active_dims=[1]). For every grid point z:
//
//   k[c]  = sum_terms prod_leaves k_q(r2_q),  r2_q = sum_k ((x_k - z_k) s_qk)^2
//   V, mu, var, out as in K1 (intervals.cuh)
//
// What bounds it on Hopper: as K1, about cap^2 / 2 FMAs per point of
// the triangular product against cap plan evaluations (P leaves of d
// scaled differences and one transcendental each) and 8 d bytes of
// grid: the FP32 (or FP64) pipe, not device memory. Design: K1's body
// (intervals.cuh) with raw points and the PlanGram policy: the plan
// (kinds, term ends, variances, the P x d scale rows) is staged in
// shared memory once per block, so the gram chunk reads it as
// broadcasts. A Bias leaf skips the distance loop; a zero scale adds
// exactly 0, so inactive columns drop out. No TF32, no tensor cores.

#include "intervals.cuh"

namespace safeopt {

template <typename T, int TM>
__global__ void __launch_bounds__(kThreads) intervals_plan_kernel(
    const T* __restrict__ zt, const T* __restrict__ xs,
    const T* __restrict__ lmt, const T* __restrict__ w,
    const T* __restrict__ scales, const T* __restrict__ pvar,
    const int* __restrict__ plan, const T* __restrict__ scal,
    T* __restrict__ out, int N, int d, int cap, int P) {
  __shared__ PlanSmem<T> smem_plan;
  const PlanGram<T> gram = smem_plan.stage(scales, pvar, plan, P, d);
  interval_rows<T, TM>(zt, (const T*)nullptr, xs, lmt, w, scal[1], scal[2],
                       out, N, d, cap, gram);
}

template <typename T, int TM>
int launch_intervals_plan(const T* zt, const T* xs, const T* lmt, const T* w,
                          const T* scales, const T* pvar, const int* plan,
                          const T* scal, T* out, int N, int d, int cap, int P,
                          cudaStream_t stream) {
  const size_t smem = interval_smem_bytes<T, TM>(d);
  cudaError_t err = cudaFuncSetAttribute(
      intervals_plan_kernel<T, TM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kP - 1) / kP);
  intervals_plan_kernel<T, TM><<<grid, kThreads, smem, stream>>>(
      zt, xs, lmt, w, scales, pvar, plan, scal, out, N, d, cap, P);
  return (int)cudaGetLastError();
}

// Rows per thread as K1: 4 up to capacity 64, else 8.
template <typename T>
int launch_intervals_plan_any(const T* zt, const T* xs, const T* lmt,
                              const T* w, const T* scales, const T* pvar,
                              const int* plan, const T* scal, T* out, int N,
                              int d, int cap, int P, cudaStream_t stream) {
  if (P < 1 || P > kMaxLeaves || d < 1 || d > kMaxDim)
    return (int)cudaErrorInvalidValue;
  if (cap <= 4 * kNTY)
    return launch_intervals_plan<T, 4>(zt, xs, lmt, w, scales, pvar, plan,
                                       scal, out, N, d, cap, P, stream);
  return launch_intervals_plan<T, 8>(zt, xs, lmt, w, scales, pvar, plan, scal,
                                     out, N, d, cap, P, stream);
}

}  // namespace safeopt

extern "C" {

// lmt is Lm transposed: lmt[c, r] = Lm[r, c]; plan is int32 (2, P).
int safeopt_intervals_plan_f32(const void* zt, const void* xs,
                               const void* lmt, const void* w,
                               const void* scales, const void* pvar,
                               const void* plan, const void* scal, void* out,
                               int N, int d, int cap, int P, void* stream) {
  return safeopt::launch_intervals_plan_any<float>(
      (const float*)zt, (const float*)xs, (const float*)lmt, (const float*)w,
      (const float*)scales, (const float*)pvar, (const int*)plan,
      (const float*)scal, (float*)out, N, d, cap, P, (cudaStream_t)stream);
}

int safeopt_intervals_plan_f64(const void* zt, const void* xs,
                               const void* lmt, const void* w,
                               const void* scales, const void* pvar,
                               const void* plan, const void* scal, void* out,
                               int N, int d, int cap, int P, void* stream) {
  return safeopt::launch_intervals_plan_any<double>(
      (const double*)zt, (const double*)xs, (const double*)lmt,
      (const double*)w, (const double*)scales, (const double*)pvar,
      (const int*)plan, (const double*)scal, (double*)out, N, d, cap, P,
      (cudaStream_t)stream);
}

}  // extern "C"
