// K1: fused grid posterior + confidence intervals for G GPs.
//
// Replaces the TPU kernel safeopt_tpu/ops/fused_posterior.py
// ::_interval_kernel_multi (launched by _fused_intervals_multi_impl,
// wrapped by fused_intervals_batched). For every grid point z and GP g:
//
//   k[c]  = k_g(xs[c], z * ils)          difference form, c < cap
//   V[r]  = sum_{c <= r} Lm[r, c] k[c]   Lm = Linv * col_mask, lower
//   mu    = sum_r w[r] V[r],  var = max(kdiag - sum_r V[r]^2, 0)
//   out   = (mu - beta sqrt(var), mu + beta sqrt(var))
//
// What bounds it on Hopper: per point about cap^2 / 2 FMAs of the
// triangular product against cap kernel evaluations and 8 d bytes of
// grid, so it is bound by the FP32 (or FP64) pipe, not by device memory.
// Design: intervals.cuh (the register-tiled product over blocks of kP
// points, the factor streamed in chunks), with the points scaled by the
// GP's inverse lengthscales and the StationaryGram policy; the GP is the
// grid's y axis.

#include "intervals.cuh"

namespace safeopt {

template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
    intervals_kernel(const T* __restrict__ zt, const T* __restrict__ ils,
                     const T* __restrict__ xs, const T* __restrict__ lmt,
                     const T* __restrict__ w, const T* __restrict__ scal,
                     T* __restrict__ out, int N, int d, int cap, int kind) {
  const int g = blockIdx.y;
  interval_rows<T, TM>(zt, ils + g * d, xs + (size_t)g * cap * d,
                       lmt + (size_t)g * cap * cap, w + (size_t)g * cap,
                       scal[g * 4 + 1], scal[g * 4 + 2],
                       out + (size_t)g * 2 * N, N, d, cap,
                       StationaryGram<T>{kind, scal[g * 4 + 0]});
}

template <typename T, int TM>
int launch_intervals(const T* zt, const T* ils, const T* xs, const T* lmt,
                     const T* w, const T* scal, T* out, int G, int N, int d,
                     int cap, int kind, cudaStream_t stream) {
  const size_t smem = interval_smem_bytes<T, TM>(d);
  cudaError_t err = cudaFuncSetAttribute(
      intervals_kernel<T, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kP - 1) / kP, G);
  intervals_kernel<T, TM><<<grid, kThreads, smem, stream>>>(
      zt, ils, xs, lmt, w, scal, out, N, d, cap, kind);
  return (int)cudaGetLastError();
}

// Rows per thread: 4 (a 64-row tile) up to capacity 64, else 8 (128 rows,
// fewer gram chunks recomputed per row tile).
template <typename T>
int launch_intervals_any(const T* zt, const T* ils, const T* xs,
                         const T* lmt, const T* w, const T* scal, T* out,
                         int G, int N, int d, int cap, int kind,
                         cudaStream_t stream) {
  if (cap <= 4 * kNTY)
    return launch_intervals<T, 4>(zt, ils, xs, lmt, w, scal, out, G, N, d,
                                  cap, kind, stream);
  return launch_intervals<T, 8>(zt, ils, xs, lmt, w, scal, out, G, N, d, cap,
                                kind, stream);
}

}  // namespace safeopt

extern "C" {

const char* safeopt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// lmt is Lm transposed: lmt[g, c, r] = Lm[g, r, c].
int safeopt_intervals_f32(const void* zt, const void* ils, const void* xs,
                          const void* lmt, const void* w, const void* scal,
                          void* out, int G, int N, int d, int cap, int kind,
                          void* stream) {
  return safeopt::launch_intervals_any<float>(
      (const float*)zt, (const float*)ils, (const float*)xs,
      (const float*)lmt, (const float*)w, (const float*)scal, (float*)out, G,
      N, d, cap, kind, (cudaStream_t)stream);
}

int safeopt_intervals_f64(const void* zt, const void* ils, const void* xs,
                          const void* lmt, const void* w, const void* scal,
                          void* out, int G, int N, int d, int cap, int kind,
                          void* stream) {
  return safeopt::launch_intervals_any<double>(
      (const double*)zt, (const double*)ils, (const double*)xs,
      (const double*)lmt, (const double*)w, (const double*)scal,
      (double*)out, G, N, d, cap, kind, (cudaStream_t)stream);
}

}  // extern "C"
