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
// What bounds it on Hopper: as K1, n(n+1)/2 FMAs per point of the
// triangular product against n plan evaluations (P leaves of d scaled
// differences and one transcendental each) and 8 d bytes of grid: the
// FP32 (or FP64) pipe, not device memory. Design: K1's body
// (intervals.cuh) with raw points and the PlanGram policy: the plan
// (kinds, term ends, variances, the P x d scale rows) is staged in
// shared memory once per block, so the gram reads it as broadcasts, and
// the body evaluates each plan entry once per block while the gram is
// resident. A Bias leaf skips the distance loop, and a leaf reads only
// its active columns (nonzero scale). No TF32, no tensor cores.
//
// K2-3p in float64 (safeopt_intervals_plan3_f64) is K2 with the
// three-pass product (intervals.cuh ThreePassProduct): _interval_kernel at
// three_pass=True (its product at fused_posterior.py:313, through
// _tri_matmul(three_pass=True)), the limbs as FP64 FMAs, one block an SM:
// a check, as K1-3p's float64 instance is (fused_intervals.cu). The
// float32 K2-3p, the contextual certified path's interval pass, runs on
// wgmma: fused_intervals3.cu.
//
// A plan of more than kMaxLeaves leaves (any Sum/Product tree the JAX
// kernel takes) runs the wide instances (intervals_plan_wide_kernel):
// the same body with the whole plan staged once per block in dynamic
// shared memory after the body's own (stage_plan), up to the block's
// 227 KB; a plan past that makes the launch fail.
//
// Past the rows the resident gram holds (float32 past cap 512, float64
// past 256) K2 runs K1's tiled body (intervals_tiled.cuh) with the
// PlanGram policy: intervals_plan_tiled_kernel, and for a wide plan
// intervals_plan_wide_tiled_kernel, the plan at wide_plan_at(the tiled
// layout's bytes). The resident body there had each warp compute its
// own 32-row piece of the gram, about 35k plan entries a point at
// n = 2000 against the tiled body's 9.2k, and ran 5.7 times slower; the
// plan's entries (the contextual product: two leaves, two exponentials)
// still take about a fifth of the tiled launch, K1's a twentieth
// (PERF.md). The launcher's rule is K1's: capacity and dtype alone, so
// the count stays on the device.

#include "intervals.cuh"
#include "intervals_tiled.cuh"

namespace safeopt {

template <typename T>
__global__ void __launch_bounds__(kThreads, kIvMinBlocks)
    intervals_plan_kernel(
    const T* __restrict__ zt, const T* __restrict__ xs,
    const T* __restrict__ lmt, const T* __restrict__ w,
    const T* __restrict__ scales, const T* __restrict__ pvar,
    const int* __restrict__ plan, const T* __restrict__ scal,
    T* __restrict__ out, int N, int d, int cap, int ldl, int P, int S,
    int res) {
  __shared__ PlanSmem<T> smem_plan;
  const PlanGram<T> gram = smem_plan.stage(scales, pvar, plan, P, d);
  const int count = (int)scal[3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  interval_rows<T>(zt, (const T*)nullptr, xs, lmt, ldl, w, scal[1], scal[2],
                   out, N, d, cap, n, S, res, gram);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? kIvMinBlocks : 1)
    intervals_plan3_kernel(
    const T* __restrict__ zt, const T* __restrict__ xs,
    const T* __restrict__ lmt, const T* __restrict__ w,
    const T* __restrict__ scales, const T* __restrict__ pvar,
    const int* __restrict__ plan, const T* __restrict__ scal,
    T* __restrict__ out, int N, int d, int cap, int ldl, int P, int S,
    int res) {
  __shared__ PlanSmem<T> smem_plan;
  const PlanGram<T> gram = smem_plan.stage(scales, pvar, plan, P, d);
  const int count = (int)scal[3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  interval_rows<T, PlanGram<T>, false, ThreePassProduct>(
      zt, (const T*)nullptr, xs, lmt, ldl, w, scal[1], scal[2], out, N, d,
      cap, n, S, res, gram);
}

// offset of a wide plan in the dynamic shared memory of a launch whose
// body takes body bytes
__host__ __device__ inline size_t wide_plan_at(size_t body) {
  return (body + 15) / 16 * 16;
}

// K2 and K2-3p for a plan of more than kMaxLeaves leaves: the plan in
// dynamic shared memory at wide_plan_at(the layout's bytes).
template <typename T, class Product>
__global__ void __launch_bounds__(
    kThreads, Product::kThreePass && sizeof(T) == 8 ? 1 : kIvMinBlocks)
    intervals_plan_wide_kernel(
    const T* __restrict__ zt, const T* __restrict__ xs,
    const T* __restrict__ lmt, const T* __restrict__ w,
    const T* __restrict__ scales, const T* __restrict__ pvar,
    const int* __restrict__ plan, const T* __restrict__ scal,
    T* __restrict__ out, int N, int d, int cap, int ldl, int P, int S,
    int res) {
  extern __shared__ __align__(16) unsigned char smem_wide[];
  const IvLayout<T> lay(cap, d, S, res);
  const PlanGram<T> gram = stage_plan<T>(smem_wide + wide_plan_at(lay.bytes),
                                         scales, pvar, plan, P, d);
  const int count = (int)scal[3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  interval_rows<T, PlanGram<T>, false, Product>(
      zt, (const T*)nullptr, xs, lmt, ldl, w, scal[1], scal[2], out, N, d,
      cap, n, S, res, gram);
}

// PlanSmem::stage and stage_plan hand the plan out over kThreads threads
static_assert(kTileThreads == kThreads, "the tiled block stages the plan");

// K2 past the resident gram: K1's tiled body with the plan gram, one
// block a kTileP points; the same launch bounds as intervals_tiled_kernel
template <typename T>
__global__ void __launch_bounds__(kTileThreads,
                                  sizeof(T) == 4 ? kTiledMinBlocks : 1)
    intervals_plan_tiled_kernel(
    const T* __restrict__ zt, const T* __restrict__ xs,
    const T* __restrict__ lmt, const T* __restrict__ w,
    const T* __restrict__ scales, const T* __restrict__ pvar,
    const int* __restrict__ plan, const T* __restrict__ scal,
    T* __restrict__ out, int N, int d, int cap, int ldl, int P) {
  __shared__ PlanSmem<T> smem_plan;
  const PlanGram<T> gram = smem_plan.stage(scales, pvar, plan, P, d);
  const int count = (int)scal[3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  interval_tiles<T>(zt, (const T*)nullptr, xs, lmt, ldl, w, scal[1],
                    scal[2], out, N, d, n, gram);
}

// the same for a plan of more than kMaxLeaves leaves: the plan in dynamic
// shared memory at wide_plan_at(the tiled layout's bytes)
template <typename T>
__global__ void __launch_bounds__(kTileThreads,
                                  sizeof(T) == 4 ? kTiledMinBlocks : 1)
    intervals_plan_wide_tiled_kernel(
    const T* __restrict__ zt, const T* __restrict__ xs,
    const T* __restrict__ lmt, const T* __restrict__ w,
    const T* __restrict__ scales, const T* __restrict__ pvar,
    const int* __restrict__ plan, const T* __restrict__ scal,
    T* __restrict__ out, int N, int d, int cap, int ldl, int P) {
  extern __shared__ __align__(16) unsigned char smem_wide[];
  const PlanGram<T> gram =
      stage_plan<T>(smem_wide + wide_plan_at(TiledLayout<T>(d).bytes),
                    scales, pvar, plan, P, d);
  const int count = (int)scal[3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  interval_tiles<T>(zt, (const T*)nullptr, xs, lmt, ldl, w, scal[1],
                    scal[2], out, N, d, n, gram);
}

// K2 past the resident gram, static or wide plan: one block a kTileP
// points
template <typename T>
int launch_intervals_plan_tiled(const T* zt, const T* xs, const T* lmt,
                                const T* w, const T* scales, const T* pvar,
                                const int* plan, const T* scal, T* out, int N,
                                int d, int cap, int P, cudaStream_t stream) {
  const TiledLayout<T> lay(d);
  const bool wide = P > kMaxLeaves;
  const size_t bytes =
      wide ? wide_plan_at(lay.bytes) + plan_bytes<T>(P, d) : lay.bytes;
  if (bytes > kSmemPerBlock) return (int)cudaErrorInvalidValue;
  auto kernel = wide ? intervals_plan_wide_tiled_kernel<T>
                     : intervals_plan_tiled_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int ldl = (cap + kBand - 1) / kBand * kBand;  // Lm^T row stride
  const dim3 grid((N + kTileP - 1) / kTileP);
  kernel<<<grid, kTileThreads, bytes, stream>>>(
      zt, xs, lmt, w, scales, pvar, plan, scal, out, N, d, cap, ldl, P);
  return (int)cudaGetLastError();
}

// K2 (three_pass 0) or, in float64, K2-3p (1); past kMaxLeaves leaves,
// their wide instances. The float32 K2-3p is launch_intervals_plan3
// (fused_intervals3.cu). K2 takes the resident body where
// interval_layout keeps every row of the capacity resident, the tiled
// body past it (float32 past cap 512, float64 past 256), as K1 does;
// K2-3p keeps the resident body.
template <typename T>
int launch_intervals_plan(const T* zt, const T* xs, const T* lmt, const T* w,
                          const T* scales, const T* pvar, const int* plan,
                          const T* scal, T* out, int N, int d, int cap, int P,
                          int three_pass, cudaStream_t stream) {
  if (P < 1 || d < 1 || d > kMaxDim) return (int)cudaErrorInvalidValue;
  const IvLayout<T> lay = interval_layout<T>(cap, d);
  if (!three_pass && lay.res < cap)
    return launch_intervals_plan_tiled<T>(zt, xs, lmt, w, scales, pvar, plan,
                                          scal, out, N, d, cap, P, stream);
  const bool wide = P > kMaxLeaves;
  const size_t bytes =
      wide ? wide_plan_at(lay.bytes) + plan_bytes<T>(P, d) : lay.bytes;
  if (bytes > kSmemPerBlock) return (int)cudaErrorInvalidValue;
  auto kernel = wide ? intervals_plan_wide_kernel<T, Fp32Product>
                     : intervals_plan_kernel<T>;
  if constexpr (std::is_same<T, double>::value) {
    if (three_pass)
      kernel = wide ? intervals_plan_wide_kernel<T, ThreePassProduct>
                    : intervals_plan3_kernel<T>;
  } else if (three_pass) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int ldl = (cap + kBand - 1) / kBand * kBand;  // Lm^T row stride
  const dim3 grid((N + lay.P - 1) / lay.P);
  kernel<<<grid, kThreads, bytes, stream>>>(
      zt, xs, lmt, w, scales, pvar, plan, scal, out, N, d, cap, ldl, P, lay.S,
      lay.res);
  return (int)cudaGetLastError();
}

}  // namespace safeopt

extern "C" {

// lmt is Lm transposed with rows padded to a multiple of 32: lmt[c, r] =
// Lm[r, c] for r < cap, zero past it; plan is int32 (2, P); scal[3] is the
// GP's count.
int safeopt_intervals_plan_f32(const void* zt, const void* xs,
                               const void* lmt, const void* w,
                               const void* scales, const void* pvar,
                               const void* plan, const void* scal, void* out,
                               int N, int d, int cap, int P, void* stream) {
  return safeopt::launch_intervals_plan<float>(
      (const float*)zt, (const float*)xs, (const float*)lmt, (const float*)w,
      (const float*)scales, (const float*)pvar, (const int*)plan,
      (const float*)scal, (float*)out, N, d, cap, P, 0, (cudaStream_t)stream);
}

int safeopt_intervals_plan_f64(const void* zt, const void* xs,
                               const void* lmt, const void* w,
                               const void* scales, const void* pvar,
                               const void* plan, const void* scal, void* out,
                               int N, int d, int cap, int P, void* stream) {
  return safeopt::launch_intervals_plan<double>(
      (const double*)zt, (const double*)xs, (const double*)lmt,
      (const double*)w, (const double*)scales, (const double*)pvar,
      (const int*)plan, (const double*)scal, (double*)out, N, d, cap, P, 0,
      (cudaStream_t)stream);
}

// K2-3p in float64: K2's operands and layout, the three-pass product.
int safeopt_intervals_plan3_f64(const void* zt, const void* xs,
                                const void* lmt, const void* w,
                                const void* scales, const void* pvar,
                                const void* plan, const void* scal, void* out,
                                int N, int d, int cap, int P, void* stream) {
  return safeopt::launch_intervals_plan<double>(
      (const double*)zt, (const double*)xs, (const double*)lmt,
      (const double*)w, (const double*)scales, (const double*)pvar,
      (const int*)plan, (const double*)scal, (double*)out, N, d, cap, P, 1,
      (cudaStream_t)stream);
}

}  // extern "C"
