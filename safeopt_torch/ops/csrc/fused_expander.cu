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
// XLA. What bounds it on Hopper: per unsafe point and GP C n FMAs of the
// cross term (n the GP's active count) against n + C kernel evaluations
// and a few bytes of grid, so it is bound by the FP32 (FP64) pipe.
// Design: expander.cuh (active rows only, M2 resident in shared memory and
// read once per block of a grid that fits the card at once, an 8 x 4
// register tile fed by 16-byte loads along the contraction, each gram
// entry once per block, hits ORed across blocks with atomicOr into an
// output the wrapper zeroes, tiles with no unsafe point skipped), with
// the points scaled by the GP's inverse lengthscales and the
// StationaryGram policy; the GP is the grid's y axis, and each GP's count
// comes from its scal row. One mask for every GP (a SafeOpt step's safe
// set) runs expander_kernel; a mask per GP (unsafe (G, N): a fleet's walk
// round, each campaign's mask repeated for its GPs, as the TPU kernel
// reads each campaign's mask under jax.vmap) runs expander_rows_kernel,
// the same body reading GP g's row.

#include "expander.cuh"

namespace safeopt {

// The body of one block: GP g = blockIdx.y against one mask `unsafe` (N,)
// or (kRows) its own row of `unsafe` (G, N).
template <typename T, int CW, bool kRows>
__device__ __forceinline__ void expander_block(
    const T* __restrict__ zt, const unsigned char* __restrict__ unsafe,
    const T* __restrict__ mu, const T* __restrict__ sigma,
    const T* __restrict__ ils, const T* __restrict__ xs,
    const T* __restrict__ xc, const T* __restrict__ m2,
    const T* __restrict__ cvec, const T* __restrict__ scal,
    int* __restrict__ out, int N, int d, int cap, int C, int kind) {
  const int g = blockIdx.y;
  const int count = (int)scal[g * 4 + 1];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  candidate_hits<T, CW, kRows>(zt, ils, unsafe, mu, sigma, xs, xc, m2, cvec,
                               scal[g * 4 + 2], scal[g * 4 + 3], out, N, d,
                               cap, C, n, g,
                               StationaryGram<T>{kind, scal[g * 4 + 0]});
}

// One mask (N,) for every GP of the launch: one SafeOpt step's safe set.
template <typename T, int CW>
__global__ void __launch_bounds__(kThreads, kExBlocks<T, CW>) expander_kernel(
    const T* __restrict__ zt, const unsigned char* __restrict__ unsafe,
    const T* __restrict__ mu, const T* __restrict__ sigma,
    const T* __restrict__ ils, const T* __restrict__ xs,
    const T* __restrict__ xc, const T* __restrict__ m2,
    const T* __restrict__ cvec, const T* __restrict__ scal,
    int* __restrict__ out, int N, int d, int cap, int C, int kind) {
  expander_block<T, CW, false>(zt, unsafe, mu, sigma, ils, xs, xc, m2, cvec,
                               scal, out, N, d, cap, C, kind);
}

// A mask per GP, `unsafe` (G, N): a fleet's walk round, each campaign's
// GPs reading its own safe set.
template <typename T, int CW>
__global__ void __launch_bounds__(kThreads, kExBlocks<T, CW>)
    expander_rows_kernel(
        const T* __restrict__ zt, const unsigned char* __restrict__ unsafe,
        const T* __restrict__ mu, const T* __restrict__ sigma,
        const T* __restrict__ ils, const T* __restrict__ xs,
        const T* __restrict__ xc, const T* __restrict__ m2,
        const T* __restrict__ cvec, const T* __restrict__ scal,
        int* __restrict__ out, int N, int d, int cap, int C, int kind) {
  expander_block<T, CW, true>(zt, unsafe, mu, sigma, ils, xs, xc, m2, cvec,
                              scal, out, N, d, cap, C, kind);
}

// rows: 0 for one mask (N,), 1 for a mask per GP (G, N).
template <typename T>
int launch_expander(const T* zt, const unsigned char* unsafe, const T* mu,
                    const T* sigma, const T* ils, const T* xs, const T* xc,
                    const T* m2, const T* cvec, const T* scal, int* out,
                    int G, int N, int d, int cap, int C, int kind, int rows,
                    cudaStream_t stream) {
  if (G < 1 || N < 1 || C < 1) return 0;  // nothing to test
  return with_pass_width(C, [&](auto cw) {
    constexpr int CW = decltype(cw)::value;
    const ExLayout<T, CW> lay(cap, d);
    dim3 grid;
    const int err =
        rows ? expander_grid(expander_rows_kernel<T, CW>, lay.bytes, lay.TP,
                             G, N, grid)
             : expander_grid(expander_kernel<T, CW>, lay.bytes, lay.TP, G,
                             N, grid);
    if (err) return err;
    if (rows)
      expander_rows_kernel<T, CW><<<grid, kThreads, lay.bytes, stream>>>(
          zt, unsafe, mu, sigma, ils, xs, xc, m2, cvec, scal, out, N, d, cap,
          C, kind);
    else
      expander_kernel<T, CW><<<grid, kThreads, lay.bytes, stream>>>(
          zt, unsafe, mu, sigma, ils, xs, xc, m2, cvec, scal, out, N, d, cap,
          C, kind);
    return (int)cudaGetLastError();
  });
}

}  // namespace safeopt

extern "C" {

// m2 is M2 row-major (G, C, cap); scal[g, 1] is GP g's count; unsafe is
// (N,) with rows == 0, (G, N) with rows == 1.
int safeopt_expander_f32(const void* zt, const void* unsafe, const void* mu,
                         const void* sigma, const void* ils, const void* xs,
                         const void* xc, const void* m2, const void* cvec,
                         const void* scal, void* out, int G, int N, int d,
                         int cap, int C, int kind, int rows, void* stream) {
  return safeopt::launch_expander<float>(
      (const float*)zt, (const unsigned char*)unsafe, (const float*)mu,
      (const float*)sigma, (const float*)ils, (const float*)xs,
      (const float*)xc, (const float*)m2, (const float*)cvec,
      (const float*)scal, (int*)out, G, N, d, cap, C, kind, rows,
      (cudaStream_t)stream);
}

int safeopt_expander_f64(const void* zt, const void* unsafe, const void* mu,
                         const void* sigma, const void* ils, const void* xs,
                         const void* xc, const void* m2, const void* cvec,
                         const void* scal, void* out, int G, int N, int d,
                         int cap, int C, int kind, int rows, void* stream) {
  return safeopt::launch_expander<double>(
      (const double*)zt, (const unsigned char*)unsafe, (const double*)mu,
      (const double*)sigma, (const double*)ils, (const double*)xs,
      (const double*)xc, (const double*)m2, (const double*)cvec,
      (const double*)scal, (int*)out, G, N, d, cap, C, kind, rows,
      (cudaStream_t)stream);
}

}  // extern "C"
