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
// Design (common.cuh): V = Lm K is a register-tiled product over a block
// of kP points. A block walks the rows of Lm in tiles of R = 16 TM rows;
// for each tile it contracts only over the chunks of columns at or left
// of the tile's last row (the chunks above the diagonal are never read),
// staging the transposed factor's chunk and the gram chunk in shared
// memory. The factor is streamed, so shared memory does not grow with
// cap. Each thread folds its rows of V into per-point partial sums of
// mu and sum V^2 as a row tile finishes; one pass over shared memory at
// the end adds the 16 row groups' partials. All sums are FP32 (or FP64)
// FMAs; no TF32, no tensor cores. Nothing crosses blocks.

#include "common.cuh"

namespace safeopt {

template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
    intervals_kernel(const T* __restrict__ zt, const T* __restrict__ ils,
                     const T* __restrict__ xs, const T* __restrict__ lmt,
                     const T* __restrict__ w, const T* __restrict__ scal,
                     T* __restrict__ out, int N, int d, int cap, int kind) {
  constexpr int R = kNTY * TM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* at = reinterpret_cast<T*>(smem_raw);  // kKC x R chunk of Lm^T
  T* kt = at + kKC * R;                     // kKC x kP gram chunk
  T* zs = kt + kKC * kP;                    // d x kP scaled points
  T* red = zs + (size_t)d * kP;             // 2 x kNTY x kP partials

  const int g = blockIdx.y;
  const int i0 = blockIdx.x * kP;
  int ty, tx;
  tile_coords(threadIdx.x, ty, tx);
  const T* xs_g = xs + (size_t)g * cap * d;
  const T* lmt_g = lmt + (size_t)g * cap * cap;
  const T* w_g = w + (size_t)g * cap;
  const T variance = scal[g * 4 + 0];

  stage_points(zs, zt, ils + g * d, N, d, i0);

  T mu[kTN], ssq[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) mu[j] = ssq[j] = T(0);

  for (int r0 = 0; r0 < cap; r0 += R) {
    T acc[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = T(0);
    const int kend = min(cap, r0 + R);  // lower triangle
    for (int k0 = 0; k0 < kend; k0 += kKC) {
      __syncthreads();  // the previous chunk is consumed
      stage_a<T, R>(at, lmt_g, cap, k0, cap, r0, cap);
      stage_gram(kt, xs_g + (size_t)k0 * d, zs, min(kKC, cap - k0), d, kind,
                 variance);
      __syncthreads();
      mma_chunk<T, TM>(acc, at, kt, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = r0 + ty * TM + i;
      const T wr = r < cap ? w_g[r] : T(0);
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        mu[j] += wr * acc[i][j];
        ssq[j] += acc[i][j] * acc[i][j];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    red[ty * kP + tx * kTN + j] = mu[j];
    red[(kNTY + ty) * kP + tx * kTN + j] = ssq[j];
  }
  __syncthreads();
  const int p = threadIdx.x;
  if (p < kP && i0 + p < N) {
    T m = T(0), s = T(0);
    for (int y = 0; y < kNTY; ++y) {
      m += red[y * kP + p];
      s += red[(kNTY + y) * kP + p];
    }
    const T kdiag = scal[g * 4 + 1];
    const T beta = scal[g * 4 + 2];
    const T var = kdiag - s;
    const T spread = beta * dsqrt(var > T(0) ? var : T(0));
    out[(size_t)g * 2 * N + i0 + p] = m - spread;
    out[(size_t)g * 2 * N + N + i0 + p] = m + spread;
  }
}

template <typename T, int TM>
int launch_intervals(const T* zt, const T* ils, const T* xs, const T* lmt,
                     const T* w, const T* scal, T* out, int G, int N, int d,
                     int cap, int kind, cudaStream_t stream) {
  constexpr int R = kNTY * TM;
  const size_t smem =
      sizeof(T) * ((size_t)kKC * R + (size_t)kKC * kP + (size_t)d * kP +
                   2 * (size_t)kNTY * kP);
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
