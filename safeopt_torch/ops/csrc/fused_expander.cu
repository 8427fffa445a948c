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
// is bound by the FP32 pipe and shared-memory bandwidth. Design
// (common.cuh): cross = M2 K is a register-tiled product over a block of
// kP points and a tile of 32 candidates (C > 32 loops over candidate
// tiles), contracting over the training rows in chunks of the transposed
// M2 and of the gram staged in shared memory; the epilogue works on the
// register tile.
//
// The OR over the grid is a reduction ACROSS blocks, which run in no
// order on this card: the wrapper zeroes the int32 (G, C) output before
// the launch, each block collects its hits in shared flags, and one
// thread per hit candidate ORs it in with atomicOr. (The TPU kernel
// zeroed the output at grid step 0 and relied on in-order steps; that
// is not ported.) A block whose points are all safe cannot hit and
// returns at once after a block-wide __syncthreads_or.

#include "common.cuh"

namespace safeopt {

constexpr int kTMc = 2;               // candidates per thread
constexpr int kRc = kNTY * kTMc;      // candidates per candidate tile

template <typename T>
__global__ void __launch_bounds__(kThreads) expander_kernel(
    const T* __restrict__ zt, const unsigned char* __restrict__ unsafe,
    const T* __restrict__ mu, const T* __restrict__ sigma,
    const T* __restrict__ ils, const T* __restrict__ xs,
    const T* __restrict__ xc, const T* __restrict__ m2t,
    const T* __restrict__ cvec, const T* __restrict__ scal,
    int* __restrict__ out, int N, int d, int cap, int C, int kind) {
  const int g = blockIdx.y;
  const int i0 = blockIdx.x * kP;
  int ty, tx;
  tile_coords(threadIdx.x, ty, tx);

  // this thread's points: unsafe flag and posterior
  bool mine[kTN];
  T mu_p[kTN], s2_p[kTN];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int i = i0 + tx * kTN + j;
    mine[j] = i < N && unsafe[i] != 0;
    mu_p[j] = mine[j] ? mu[(size_t)g * N + i] : T(0);
    const T s = mine[j] ? sigma[(size_t)g * N + i] : T(0);
    s2_p[j] = s * s;
    any = any || mine[j];
  }
  if (!__syncthreads_or(any)) return;  // no unsafe point in this block

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* at = reinterpret_cast<T*>(smem_raw);  // kKC x kRc chunk of M2^T
  T* kt = at + kKC * kRc;                   // kKC x kP gram chunk
  T* zs = kt + kKC * kP;                    // d x kP scaled points
  T* xcs = zs + (size_t)d * kP;             // kRc x d candidate inputs
  T* cv = xcs + (size_t)kRc * d;            // 3 x kRc [inv_dd, gain, valid]
  int* hits = reinterpret_cast<int*>(cv + 3 * kRc);  // kRc flags

  const T* xs_g = xs + (size_t)g * cap * d;
  const T* xc_g = xc + (size_t)g * C * d;
  const T* m2t_g = m2t + (size_t)g * cap * C;
  const T* cv_g = cvec + (size_t)g * 3 * C;
  const T variance = scal[g * 4 + 0];
  const T beta = scal[g * 4 + 2];
  const T fmin = scal[g * 4 + 3];

  stage_points(zs, zt, ils + g * d, N, d, i0);

  for (int j0 = 0; j0 < C; j0 += kRc) {
    T acc[kTMc][kTN];
#pragma unroll
    for (int i = 0; i < kTMc; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = T(0);
    for (int k0 = 0; k0 < cap; k0 += kKC) {
      __syncthreads();  // the previous chunk (and candidate tile) is done
      stage_a<T, kRc>(at, m2t_g, C, k0, cap, j0, C);
      stage_gram(kt, xs_g + (size_t)k0 * d, zs, min(kKC, cap - k0), d, kind,
                 variance);
      if (k0 == 0) {  // the candidate tile's own operands
        for (int t = threadIdx.x; t < kRc * d; t += kThreads)
          xcs[t] = j0 * d + t < C * d ? xc_g[(size_t)j0 * d + t] : T(0);
        for (int t = threadIdx.x; t < 3 * kRc; t += kThreads) {
          const int q = t / kRc, jj = t - q * kRc;
          cv[t] = j0 + jj < C ? cv_g[q * C + j0 + jj] : T(0);
        }
        for (int t = threadIdx.x; t < kRc; t += kThreads) hits[t] = 0;
      }
      __syncthreads();
      mma_chunk<T, kTMc>(acc, at, kt, ty, tx);
    }

#pragma unroll
    for (int i = 0; i < kTMc; ++i) {
      const int jj = ty * kTMc + i;
      if (!(cv[2 * kRc + jj] > T(0.5))) continue;  // padding or past C
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (!mine[j]) continue;
        const int p = tx * kTN + j;
        T r2 = T(0);
        for (int k = 0; k < d; ++k) {
          const T diff = xcs[jj * d + k] - zs[k * kP + p];
          r2 += diff * diff;
        }
        const T e = (kfun(kind, r2, variance) - acc[i][j]) * cv[jj];
        const T v2 = s2_p[j] - e * e;
        const T l2 =
            mu_p[j] + e * cv[kRc + jj] - beta * dsqrt(v2 > T(0) ? v2 : T(0));
        if (l2 >= fmin) hits[jj] = 1;  // benign race: every writer stores 1
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kRc; t += kThreads)
      if (hits[t]) atomicOr(out + (size_t)g * C + j0 + t, 1);
  }
}

template <typename T>
int launch_expander(const T* zt, const unsigned char* unsafe, const T* mu,
                    const T* sigma, const T* ils, const T* xs, const T* xc,
                    const T* m2t, const T* cvec, const T* scal, int* out,
                    int G, int N, int d, int cap, int C, int kind,
                    cudaStream_t stream) {
  const size_t smem =
      sizeof(T) * ((size_t)kKC * kRc + (size_t)kKC * kP + (size_t)d * kP +
                   (size_t)kRc * d + 3 * (size_t)kRc) +
      sizeof(int) * (size_t)kRc;
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
