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
// What bounds it on Hopper: per unsafe point C n FMAs of the cross term
// against n + C plan evaluations: the FP32 (FP64) pipe. Design: K3's body
// (expander.cuh: active rows only, M2 resident in shared memory and read
// once per block, an 8 x 4 register tile, each gram entry once per block,
// atomicOr of per-block hits into an output the wrapper zeroes, since
// CUDA blocks run in no order, and tiles with no unsafe point skipped),
// with raw points and the PlanGram policy, the plan staged in shared
// memory once per block; the count comes from scal[1]. A plan of more
// than kMaxLeaves leaves runs the wide instances
// (expander_plan_wide_kernel), the plan staged in dynamic shared memory
// after the body's own (stage_plan), up to the block's 227 KB.

#include "expander.cuh"

namespace safeopt {

template <typename T, int CW>
__global__ void __launch_bounds__(kThreads, kExBlocks<T, CW>)
    expander_plan_kernel(
    const T* __restrict__ zt, const unsigned char* __restrict__ unsafe,
    const T* __restrict__ mu, const T* __restrict__ sigma,
    const T* __restrict__ xs, const T* __restrict__ xc,
    const T* __restrict__ m2, const T* __restrict__ cvec,
    const T* __restrict__ scales, const T* __restrict__ pvar,
    const int* __restrict__ plan, const T* __restrict__ scal,
    int* __restrict__ out, int N, int d, int cap, int C, int P) {
  __shared__ PlanSmem<T> smem_plan;
  const PlanGram<T> gram = smem_plan.stage(scales, pvar, plan, P, d);
  const int count = (int)scal[1];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  candidate_hits<T, CW>(zt, (const T*)nullptr, unsafe, mu, sigma, xs, xc, m2,
                        cvec, scal[2], scal[3], out, N, d, cap, C, n, 0, gram);
}

// K4 for a plan of more than kMaxLeaves leaves: the plan in dynamic shared
// memory after the layout's bytes (a multiple of 16).
template <typename T, int CW>
__global__ void __launch_bounds__(kThreads, kExBlocks<T, CW>)
    expander_plan_wide_kernel(
    const T* __restrict__ zt, const unsigned char* __restrict__ unsafe,
    const T* __restrict__ mu, const T* __restrict__ sigma,
    const T* __restrict__ xs, const T* __restrict__ xc,
    const T* __restrict__ m2, const T* __restrict__ cvec,
    const T* __restrict__ scales, const T* __restrict__ pvar,
    const int* __restrict__ plan, const T* __restrict__ scal,
    int* __restrict__ out, int N, int d, int cap, int C, int P) {
  extern __shared__ __align__(16) unsigned char smem_wide[];
  const ExLayout<T, CW> lay(cap, d);
  const PlanGram<T> gram =
      stage_plan<T>(smem_wide + lay.bytes, scales, pvar, plan, P, d);
  const int count = (int)scal[1];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  candidate_hits<T, CW>(zt, (const T*)nullptr, unsafe, mu, sigma, xs, xc, m2,
                        cvec, scal[2], scal[3], out, N, d, cap, C, n, 0, gram);
}

// K4; past kMaxLeaves leaves, its wide instances
template <typename T>
int launch_expander_plan(const T* zt, const unsigned char* unsafe,
                         const T* mu, const T* sigma, const T* xs,
                         const T* xc, const T* m2, const T* cvec,
                         const T* scales, const T* pvar, const int* plan,
                         const T* scal, int* out, int N, int d, int cap,
                         int C, int P, cudaStream_t stream) {
  if (P < 1 || d < 1 || d > kMaxDim) return (int)cudaErrorInvalidValue;
  if (N < 1 || C < 1) return 0;  // nothing to test
  return with_pass_width(C, [&](auto cw) {
    constexpr int CW = decltype(cw)::value;
    const ExLayout<T, CW> lay(cap, d);
    const bool wide = P > kMaxLeaves;
    const size_t bytes = wide ? lay.bytes + plan_bytes<T>(P, d) : lay.bytes;
    if (bytes > kSmemPerBlock) return (int)cudaErrorInvalidValue;
    auto kernel = wide ? expander_plan_wide_kernel<T, CW>
                       : expander_plan_kernel<T, CW>;
    dim3 grid;
    const int err = expander_grid(kernel, bytes, lay.TP, 1, N, grid);
    if (err) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(
        zt, unsafe, mu, sigma, xs, xc, m2, cvec, scales, pvar, plan, scal,
        out, N, d, cap, C, P);
    return (int)cudaGetLastError();
  });
}

}  // namespace safeopt

extern "C" {

// m2 is M2 row-major (C, cap); plan is int32 (2, P); scal[1] is the
// GP's count.
int safeopt_expander_plan_f32(const void* zt, const void* unsafe,
                              const void* mu, const void* sigma,
                              const void* xs, const void* xc, const void* m2,
                              const void* cvec, const void* scales,
                              const void* pvar, const void* plan,
                              const void* scal, void* out, int N, int d,
                              int cap, int C, int P, void* stream) {
  return safeopt::launch_expander_plan<float>(
      (const float*)zt, (const unsigned char*)unsafe, (const float*)mu,
      (const float*)sigma, (const float*)xs, (const float*)xc,
      (const float*)m2, (const float*)cvec, (const float*)scales,
      (const float*)pvar, (const int*)plan, (const float*)scal, (int*)out, N,
      d, cap, C, P, (cudaStream_t)stream);
}

int safeopt_expander_plan_f64(const void* zt, const void* unsafe,
                              const void* mu, const void* sigma,
                              const void* xs, const void* xc, const void* m2,
                              const void* cvec, const void* scales,
                              const void* pvar, const void* plan,
                              const void* scal, void* out, int N, int d,
                              int cap, int C, int P, void* stream) {
  return safeopt::launch_expander_plan<double>(
      (const double*)zt, (const unsigned char*)unsafe, (const double*)mu,
      (const double*)sigma, (const double*)xs, (const double*)xc,
      (const double*)m2, (const double*)cvec, (const double*)scales,
      (const double*)pvar, (const int*)plan, (const double*)scal, (int*)out,
      N, d, cap, C, P, (cudaStream_t)stream);
}

}  // extern "C"
