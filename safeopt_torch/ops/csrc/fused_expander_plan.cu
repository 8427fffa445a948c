// K4: fused expander predicate for a chunk of C candidates and ONE GP
// whose kernel is a plan (K2's Sum/Product algebra).
//
// Replaces the TPU kernel safeopt_tpu/ops/fused_expander.py
// ::_expander_kernel (launched by _fused_expander_impl, wrapped by
// fused_expander_predicate). For every candidate j and grid point z,
// after a virtual observation at candidate j:
//
//   cross  = sum_r M2[j, r] k(xs[r], z)           M2 = Cm^T Lm (C x cap)
//   E      = (k(xc[j], z) - cross) * inv_dd[j]
//   l2     = mu(z) + E gain[j] - beta sqrt(max(sigma(z)^2 - E^2, 0))
//   out[j] |= unsafe(z) && l2 >= fmin && valid[j]
//
// with both grams (the cap training rows and the C candidates) from the
// plan. The candidate-side terms come from plain PyTorch, as for K3.
// What bounds it on Hopper: per point C cap FMAs of the cross term
// against cap + C plan evaluations: the FP32 pipe and shared-memory
// bandwidth. Design: K3's body (expander.cuh: register-tiled cross term
// over 32-candidate tiles, atomicOr of per-block hit flags into an
// output the wrapper zeroes, since CUDA blocks run in no order, and a
// __syncthreads_or skip of blocks with no unsafe point), with raw points
// and the PlanGram policy, the plan staged in shared memory once per
// block.

#include "expander.cuh"

namespace safeopt {

template <typename T>
__global__ void __launch_bounds__(kThreads) expander_plan_kernel(
    const T* __restrict__ zt, const unsigned char* __restrict__ unsafe,
    const T* __restrict__ mu, const T* __restrict__ sigma,
    const T* __restrict__ xs, const T* __restrict__ xc,
    const T* __restrict__ m2t, const T* __restrict__ cvec,
    const T* __restrict__ scales, const T* __restrict__ pvar,
    const int* __restrict__ plan, const T* __restrict__ scal,
    int* __restrict__ out, int N, int d, int cap, int C, int P) {
  __shared__ PlanSmem<T> smem_plan;
  const PlanGram<T> gram = smem_plan.stage(scales, pvar, plan, P, d);
  candidate_hits<T>(zt, (const T*)nullptr, unsafe, mu, sigma, xs, xc, m2t,
                    cvec, scal[2], scal[3], out, N, d, cap, C, gram);
}

template <typename T>
int launch_expander_plan(const T* zt, const unsigned char* unsafe,
                         const T* mu, const T* sigma, const T* xs,
                         const T* xc, const T* m2t, const T* cvec,
                         const T* scales, const T* pvar, const int* plan,
                         const T* scal, int* out, int N, int d, int cap,
                         int C, int P, cudaStream_t stream) {
  if (P < 1 || P > kMaxLeaves || d < 1 || d > kMaxDim)
    return (int)cudaErrorInvalidValue;
  const size_t smem = expander_smem_bytes<T>(d);
  cudaError_t err = cudaFuncSetAttribute(
      expander_plan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kP - 1) / kP);
  expander_plan_kernel<T><<<grid, kThreads, smem, stream>>>(
      zt, unsafe, mu, sigma, xs, xc, m2t, cvec, scales, pvar, plan, scal, out,
      N, d, cap, C, P);
  return (int)cudaGetLastError();
}

}  // namespace safeopt

extern "C" {

// m2t is M2 transposed: m2t[r, j] = M2[j, r]; plan is int32 (2, P).
int safeopt_expander_plan_f32(const void* zt, const void* unsafe,
                              const void* mu, const void* sigma,
                              const void* xs, const void* xc, const void* m2t,
                              const void* cvec, const void* scales,
                              const void* pvar, const void* plan,
                              const void* scal, void* out, int N, int d,
                              int cap, int C, int P, void* stream) {
  return safeopt::launch_expander_plan<float>(
      (const float*)zt, (const unsigned char*)unsafe, (const float*)mu,
      (const float*)sigma, (const float*)xs, (const float*)xc,
      (const float*)m2t, (const float*)cvec, (const float*)scales,
      (const float*)pvar, (const int*)plan, (const float*)scal, (int*)out, N,
      d, cap, C, P, (cudaStream_t)stream);
}

int safeopt_expander_plan_f64(const void* zt, const void* unsafe,
                              const void* mu, const void* sigma,
                              const void* xs, const void* xc, const void* m2t,
                              const void* cvec, const void* scales,
                              const void* pvar, const void* plan,
                              const void* scal, void* out, int N, int d,
                              int cap, int C, int P, void* stream) {
  return safeopt::launch_expander_plan<double>(
      (const double*)zt, (const unsigned char*)unsafe, (const double*)mu,
      (const double*)sigma, (const double*)xs, (const double*)xc,
      (const double*)m2t, (const double*)cvec, (const double*)scales,
      (const double*)pvar, (const int*)plan, (const double*)scal, (int*)out,
      N, d, cap, C, P, (cudaStream_t)stream);
}

}  // extern "C"
