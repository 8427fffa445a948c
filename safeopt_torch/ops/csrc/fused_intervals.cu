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
// What bounds it on Hopper: per point and GP n(n+1)/2 FMAs of the
// triangular product (n the GP's active count) against n kernel
// evaluations and 8 d bytes of grid, so it is bound by the FP32 (or FP64)
// pipe, not by device memory. Two block bodies, with the points scaled
// by the GP's inverse lengthscales and the StationaryGram policy; the GP
// is the grid's y axis, and each GP's count comes from its scal row:
//
// - intervals_kernel, intervals.cuh: active rows only, bands of 32 rows
//   balanced over the warps, the gram resident in shared memory, the
//   factor staged with cp.async; for the capacities whose rows the
//   resident gram holds (float32 up to 512, float64 up to 256);
// - intervals_tiled_kernel, intervals_tiled.cuh: a block-tiled product,
//   128 points by 128-row tiles, the gram computed once a row tile by
//   the whole block; for the capacities past them.
//
// launch_intervals picks the body from the capacity and the dtype alone.
//
// K1-3p in float64 (safeopt_intervals3_f64) is K1 with the three-pass
// product (intervals.cuh ThreePassProduct): the same TPU kernel at
// three_pass=True (_interval_kernel_multi's product at
// fused_posterior.py:513-528, through _tri_matmul(three_pass=True)), with
// the limbs as FP64 FMAs (lo unrounded), one block an SM: a check of the
// bands, the gram and the limb cut against the plain version to 1e-9, not
// a route the card's float32 path takes. The float32 K1-3p, the certified
// path's interval pass, runs on wgmma: fused_intervals3.cu.

#include "intervals.cuh"
#include "intervals_tiled.cuh"

namespace safeopt {

template <typename T>
__global__ void __launch_bounds__(kThreads, kIvMinBlocks)
    intervals_kernel(const T* __restrict__ zt, const T* __restrict__ ils,
                     const T* __restrict__ xs, const T* __restrict__ lmt,
                     const T* __restrict__ w, const T* __restrict__ scal,
                     T* __restrict__ out, int N, int d, int cap, int ldl,
                     int kind, int S, int res) {
  const int g = blockIdx.y;
  const int count = (int)scal[g * 4 + 3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  interval_rows<T>(zt, ils + g * d, xs + (size_t)g * cap * d,
                   lmt + (size_t)g * cap * ldl, ldl, w + (size_t)g * cap,
                   scal[g * 4 + 1], scal[g * 4 + 2], out + (size_t)g * 2 * N,
                   N, d, cap, n, S, res,
                   StationaryGram<T>{kind, scal[g * 4 + 0]});
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? kIvMinBlocks : 1)
    intervals3_kernel(const T* __restrict__ zt, const T* __restrict__ ils,
                      const T* __restrict__ xs, const T* __restrict__ lmt,
                      const T* __restrict__ w, const T* __restrict__ scal,
                      T* __restrict__ out, int N, int d, int cap, int ldl,
                      int kind, int S, int res) {
  const int g = blockIdx.y;
  const int count = (int)scal[g * 4 + 3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  interval_rows<T, StationaryGram<T>, false, ThreePassProduct>(
      zt, ils + g * d, xs + (size_t)g * cap * d, lmt + (size_t)g * cap * ldl,
      ldl, w + (size_t)g * cap, scal[g * 4 + 1], scal[g * 4 + 2],
      out + (size_t)g * 2 * N, N, d, cap, n, S, res,
      StationaryGram<T>{kind, scal[g * 4 + 0]});
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads,
                                  sizeof(T) == 4 ? kTiledMinBlocks : 1)
    intervals_tiled_kernel(const T* __restrict__ zt,
                           const T* __restrict__ ils,
                           const T* __restrict__ xs,
                           const T* __restrict__ lmt,
                           const T* __restrict__ w,
                           const T* __restrict__ scal, T* __restrict__ out,
                           int N, int d, int cap, int ldl, int kind) {
  const int g = blockIdx.y;
  const int count = (int)scal[g * 4 + 3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  interval_tiles<T>(zt, ils + g * d, xs + (size_t)g * cap * d,
                    lmt + (size_t)g * cap * ldl, ldl, w + (size_t)g * cap,
                    scal[g * 4 + 1], scal[g * 4 + 2], out + (size_t)g * 2 * N,
                    N, d, n, StationaryGram<T>{kind, scal[g * 4 + 0]});
}

// K1 past the resident gram: the tiled body, one block a kTileP points
// and GP
template <typename T>
int launch_intervals_tiled(const T* zt, const T* ils, const T* xs,
                           const T* lmt, const T* w, const T* scal, T* out,
                           int G, int N, int d, int cap, int kind,
                           cudaStream_t stream) {
  const TiledLayout<T> lay(d);
  cudaError_t err = cudaFuncSetAttribute(
      intervals_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const int ldl = (cap + kBand - 1) / kBand * kBand;  // Lm^T row stride
  const dim3 grid((N + kTileP - 1) / kTileP, G);
  intervals_tiled_kernel<T><<<grid, kTileThreads, lay.bytes, stream>>>(
      zt, ils, xs, lmt, w, scal, out, N, d, cap, ldl, kind);
  return (int)cudaGetLastError();
}

// K1 (three_pass 0) or, in float64, K1-3p (1); the float32 K1-3p is
// launch_intervals3 (fused_intervals3.cu). K1 takes the resident body
// where interval_layout keeps every row of the capacity resident, the
// tiled body past it (float32 past cap 512, float64 past 256).
template <typename T>
int launch_intervals(const T* zt, const T* ils, const T* xs, const T* lmt,
                     const T* w, const T* scal, T* out, int G, int N, int d,
                     int cap, int kind, int three_pass, cudaStream_t stream) {
  const IvLayout<T> lay = interval_layout<T>(cap, d);
  if (!three_pass && lay.res < cap)
    return launch_intervals_tiled<T>(zt, ils, xs, lmt, w, scal, out, G, N, d,
                                     cap, kind, stream);
  auto kernel = intervals_kernel<T>;
  if constexpr (std::is_same<T, double>::value) {
    if (three_pass) kernel = intervals3_kernel<T>;
  } else if (three_pass) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const int ldl = (cap + kBand - 1) / kBand * kBand;  // Lm^T row stride
  const dim3 grid((N + lay.P - 1) / lay.P, G);
  kernel<<<grid, kThreads, lay.bytes, stream>>>(
      zt, ils, xs, lmt, w, scal, out, N, d, cap, ldl, kind, lay.S, lay.res);
  return (int)cudaGetLastError();
}

}  // namespace safeopt

extern "C" {

const char* safeopt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// lmt is Lm transposed with rows padded to a multiple of 32: lmt[g, c, r]
// = Lm[g, r, c] for r < cap, zero past it; scal[g, 3] is GP g's count.
int safeopt_intervals_f32(const void* zt, const void* ils, const void* xs,
                          const void* lmt, const void* w, const void* scal,
                          void* out, int G, int N, int d, int cap, int kind,
                          void* stream) {
  return safeopt::launch_intervals<float>(
      (const float*)zt, (const float*)ils, (const float*)xs,
      (const float*)lmt, (const float*)w, (const float*)scal, (float*)out, G,
      N, d, cap, kind, 0, (cudaStream_t)stream);
}

int safeopt_intervals_f64(const void* zt, const void* ils, const void* xs,
                          const void* lmt, const void* w, const void* scal,
                          void* out, int G, int N, int d, int cap, int kind,
                          void* stream) {
  return safeopt::launch_intervals<double>(
      (const double*)zt, (const double*)ils, (const double*)xs,
      (const double*)lmt, (const double*)w, (const double*)scal,
      (double*)out, G, N, d, cap, kind, 0, (cudaStream_t)stream);
}

// K1-3p in float64: K1's operands and layout, the three-pass product.
int safeopt_intervals3_f64(const void* zt, const void* ils, const void* xs,
                           const void* lmt, const void* w, const void* scal,
                           void* out, int G, int N, int d, int cap, int kind,
                           void* stream) {
  return safeopt::launch_intervals<double>(
      (const double*)zt, (const double*)ils, (const double*)xs,
      (const double*)lmt, (const double*)w, (const double*)scal,
      (double*)out, G, N, d, cap, kind, 1, (cudaStream_t)stream);
}

}  // extern "C"
