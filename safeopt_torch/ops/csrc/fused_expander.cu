// K3: fused expander predicate for a chunk of C candidates and G GPs.
//
// Replaces the TPU kernel safeopt_tpu/ops/fused_expander.py
// ::_expander_kernel_multi (launched by _fused_expander_multi_impl,
// wrapped by fused_expander_predicate_batched). For every GP g,
// candidate j and grid point z, after a virtual observation of GP g at
// candidate j (rank-1 update of the posterior):
//
//   k[r]   = k_g(xs[r], z * ils)                  difference form
//   cross  = sum_r M2[j, r] k[r]                  M2 = Cm^T Lm (C x cap)
//   E      = (k_g(xc[j], z * ils) - cross) * inv_dd[j]
//   l2     = mu(z) + E gain[j] - beta sqrt(max(sigma(z)^2 - E^2, 0))
//   out[g, j] |= unsafe(z) && l2 >= fmin_g && valid[j]
//
// The candidate-side terms (Cm, dd, gain, M2; O(C cap^2)) come from
// plain PyTorch outside the kernel, as the JAX package leaves them to
// XLA. What bounds it on Hopper: per point C cap FMAs of the cross term
// against cap + C kernel evaluations and a few reads of mu/sigma, so it
// is bound by the FP32 pipe and shared-memory bandwidth. Design:
// expander.cuh (cross = M2 K as a register-tiled product over tiles of
// 32 candidates, hits ORed across blocks with atomicOr into an output
// the wrapper zeroes, blocks with no unsafe point skipped), with the
// points scaled by the GP's inverse lengthscales and the StationaryGram
// policy; the GP is the grid's y axis.

#include "expander.cuh"

namespace safeopt {

template <typename T>
__global__ void __launch_bounds__(kThreads) expander_kernel(
    const T* __restrict__ zt, const unsigned char* __restrict__ unsafe,
    const T* __restrict__ mu, const T* __restrict__ sigma,
    const T* __restrict__ ils, const T* __restrict__ xs,
    const T* __restrict__ xc, const T* __restrict__ m2t,
    const T* __restrict__ cvec, const T* __restrict__ scal,
    int* __restrict__ out, int N, int d, int cap, int C, int kind) {
  const int g = blockIdx.y;
  candidate_hits<T>(zt, ils + g * d, unsafe, mu + (size_t)g * N,
                    sigma + (size_t)g * N, xs + (size_t)g * cap * d,
                    xc + (size_t)g * C * d, m2t + (size_t)g * cap * C,
                    cvec + (size_t)g * 3 * C, scal[g * 4 + 2],
                    scal[g * 4 + 3], out + (size_t)g * C, N, d, cap, C,
                    StationaryGram<T>{kind, scal[g * 4 + 0]});
}

template <typename T>
int launch_expander(const T* zt, const unsigned char* unsafe, const T* mu,
                    const T* sigma, const T* ils, const T* xs, const T* xc,
                    const T* m2t, const T* cvec, const T* scal, int* out,
                    int G, int N, int d, int cap, int C, int kind,
                    cudaStream_t stream) {
  const size_t smem = expander_smem_bytes<T>(d);
  cudaError_t err = cudaFuncSetAttribute(
      expander_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kP - 1) / kP, G);
  expander_kernel<T><<<grid, kThreads, smem, stream>>>(
      zt, unsafe, mu, sigma, ils, xs, xc, m2t, cvec, scal, out, N, d, cap, C,
      kind);
  return (int)cudaGetLastError();
}

}  // namespace safeopt

extern "C" {

// m2t is M2 transposed: m2t[g, r, j] = M2[g, j, r].
int safeopt_expander_f32(const void* zt, const void* unsafe, const void* mu,
                         const void* sigma, const void* ils, const void* xs,
                         const void* xc, const void* m2t, const void* cvec,
                         const void* scal, void* out, int G, int N, int d,
                         int cap, int C, int kind, void* stream) {
  return safeopt::launch_expander<float>(
      (const float*)zt, (const unsigned char*)unsafe, (const float*)mu,
      (const float*)sigma, (const float*)ils, (const float*)xs,
      (const float*)xc, (const float*)m2t, (const float*)cvec,
      (const float*)scal, (int*)out, G, N, d, cap, C, kind,
      (cudaStream_t)stream);
}

int safeopt_expander_f64(const void* zt, const void* unsafe, const void* mu,
                         const void* sigma, const void* ils, const void* xs,
                         const void* xc, const void* m2t, const void* cvec,
                         const void* scal, void* out, int G, int N, int d,
                         int cap, int C, int kind, void* stream) {
  return safeopt::launch_expander<double>(
      (const double*)zt, (const unsigned char*)unsafe, (const double*)mu,
      (const double*)sigma, (const double*)ils, (const double*)xs,
      (const double*)xc, (const double*)m2t, (const double*)cvec,
      (const double*)scal, (int*)out, G, N, d, cap, C, kind,
      (cudaStream_t)stream);
}

}  // extern "C"
