// B1-B5: the interval stage's experiment kernels, K1's TPU experiment
// harnesses ported to the H100. None of them is on a SafeOpt path: they
// answer what K1's time is made of and what precision a tensor-core
// product of the factor gives (tools_torch/bench_interval_experiments.py,
// tools_torch/probe_interval_precision.py).
//
// B1 (benchmarks/bench_interval_mosaic.py::_variant_impl): K1's block body
//    (intervals.cuh interval_rows) launched with the caller's slices per
//    block S, resident gram rows res and shared-memory carveout: the
//    H100's counterparts of the TPU kernel's block size and VMEM limit.
//    The TPU's dimension_semantics and CostEstimate have none (CUDA blocks
//    run in no order and take no scheduling hint). Each point's sums are
//    added in band order whatever S and res are, so every launch gives
//    K1's bits.
// B2, B5 (bench_interval_mosaic3.py kern_gram_only / kern_solve_only,
//    bench_interval_ablation.py::_kernel): ablations of K1, one kernel
//    with a mode. kGramSums: per GP the sums of k[c] and k[c]^2 over the
//    n active rows. kSolveRank1: K1's body with the rank-1 gram xs[c, 0]
//    z[0] (raw points), one multiply an entry. kNoProduct: V := k, then
//    K1's epilogue. kEpilogue: V[r] := 0.01 z[0] (raw), then the epilogue.
//    kGramSums, kNoProduct and kEpilogue replace the TPU kernels
//    kern_gram_only and _kernel's no_mxu and epilogue variants with one
//    body designed for the H100 (gram_rows.cuh gram_rows_kernel): the
//    GP's active rows (and w) staged in shared memory in double-buffered
//    cp.async chunks, several points a thread with their coordinates in
//    registers (an RBF gram of d = 1, 2 or 10 at compile time; any other
//    kind or d up to kMaxDim at run time, one point a thread in shared
//    memory), each row read once by a broadcast vector load for all of a
//    thread's points. The rows of a point are added in ascending order,
//    one accumulator a sum, with StationaryGram's entry: the bits of the
//    one-point-a-thread body it replaced, and for RBF of an in-order
//    float32 sum of kernel_gram's entries.
// B3 (bench_interval_mosaic4.py::kern_mxu_emit): K1 with mu = sum_c u[c]
//    k[c], u = Lm^T w precomputed by the wrapper (interval_rows
//    MuFromGram): no band multiplies w into V.
// B1-3p, B2-3p, B3-3p in float64: B1, B2's rank-1 solve and B3 at the
//    harnesses' three_pass=True (bench_interval_mosaic.py:76,
//    mosaic3.py:114, mosaic4.py:107): the same bodies with the float64
//    K1-3p's product (intervals.cuh ThreePassProduct, V = Lm_hi k_hi +
//    Lm_hi k_lo + Lm_lo k_hi over bf16 limbs as FP64 FMAs, lo unrounded)
//    at one block an SM (its limbs and register tile take 254
//    registers): checks of the gram policies and the limb cut against
//    the plain versions to 1e-9, not routes. The float64 B1-3p is the
//    float64 K1-3p's body and gives its bits at every layout; B3-3p reads
//    mu from the gram rows by lane = point, each band over its own 32
//    columns. In float32 all three, and B4, run K1-3p's wgmma bodies
//    (interval_experiments3.cu).
//
// What bounds them: B1-B3 and B2/B5's rank-1 solve as K1 (the FP32/FP64
// pipe: n(n+1)/2 FMAs a point; in float64 their three-pass forms too).
// B2's sums and B5's no-product mode: n gram entries a point against 8 d
// bytes read. At d = 2 an RBF entry is about eleven FP32 instructions
// around one MUFU.EX2, so the FP32 issue rate binds; the MUFU (16 results
// a clock an SM, 4.18e12 a second) binds only where an entry takes two
// transcendentals. MUFU operations of one float32 entry, read from the
// SASS of one entry of each kind on the H100 (tools_torch/
// tune_gram_rows.py --mufu): RBF 1 (MUFU.EX2), Exponential, Matern32 and
// Matern52 2 (the square root's MUFU.RSQ and MUFU.EX2; a second RSQ in
// the square root's slow path for special inputs is not counted), Cosine
// 1 (the square root; cosf's polynomial runs on the FP32 pipe), Bias 0. What the design does: the rows' coordinates come
// from shared memory once per R rows for P points, not from global
// memory for every entry; d and (for RBF) the kind are compile-time, so
// no column loop, pointer arithmetic or kind branch is left an entry;
// P R independent entries a thread keep the FP32 and MUFU pipes fed. The
// epilogue mode has no gram: two FMAs an entry, w from shared memory.
#include "gram_rows.cuh"
#include "intervals.cuh"
#include "limbs.cuh"

namespace safeopt {

// -- B1: K1's body at the caller's layout -------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, kIvMinBlocks)
    intervals_launch_kernel(const T* __restrict__ zt, const T* __restrict__ ils,
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
                   N, d, cap, n, S, res, StationaryGram<T>{kind, scal[g * 4]});
}

// B1-3p in float64: the float64 K1-3p's body at the caller's layout
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? kIvMinBlocks : 1)
    intervals3_launch_kernel(const T* __restrict__ zt,
                             const T* __restrict__ ils,
                             const T* __restrict__ xs,
                             const T* __restrict__ lmt,
                             const T* __restrict__ w,
                             const T* __restrict__ scal, T* __restrict__ out,
                             int N, int d, int cap, int ldl, int kind, int S,
                             int res) {
  const int g = blockIdx.y;
  const int count = (int)scal[g * 4 + 3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  interval_rows<T, StationaryGram<T>, false, ThreePassProduct>(
      zt, ils + g * d, xs + (size_t)g * cap * d, lmt + (size_t)g * cap * ldl,
      ldl, w + (size_t)g * cap, scal[g * 4 + 1], scal[g * 4 + 2],
      out + (size_t)g * 2 * N, N, d, cap, n, S, res,
      StationaryGram<T>{kind, scal[g * 4]});
}

// A layout the caller chose, or an error: S a power of two up to
// kMaxSlices, res a multiple of kKS up to cap rounded to kKS, and the
// block's shared memory within the card's.
template <typename T>
inline cudaError_t caller_layout(int cap, int d, int S, int res,
                                 IvLayout<T>* lay) {
  const int cap_pad = (cap + kKS - 1) / kKS * kKS;
  if (S < 1 || S > kMaxSlices || (S & (S - 1)) || res < 0 ||
      res > cap_pad || res % kKS)
    return cudaErrorInvalidValue;
  *lay = IvLayout<T>(cap, d, S, res);
  return lay->bytes <= kMaxDynSmem ? cudaSuccess : cudaErrorInvalidValue;
}

// B1 (ThreePass false) or the float64 B1-3p (true)
template <typename T, bool ThreePass>
int launch_intervals_at(const T* zt, const T* ils, const T* xs, const T* lmt,
                        const T* w, const T* scal, T* out, int G, int N, int d,
                        int cap, int kind, int S, int res, int carveout,
                        cudaStream_t stream) {
  static_assert(!ThreePass || sizeof(T) == 8,
                "the float32 B1-3p is interval_experiments3.cu's");
  IvLayout<T> lay = interval_layout<T>(cap, d);
  if (S > 0) {
    const cudaError_t err = caller_layout<T>(cap, d, S, res, &lay);
    if (err != cudaSuccess) return (int)err;
  }
  auto kernel = intervals_launch_kernel<T>;
  if constexpr (ThreePass) kernel = intervals3_launch_kernel<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  static int initial = -2;  // this launcher has an instance per kernel
  const int cerr = set_carveout(kernel, carveout, &initial);
  if (cerr) return cerr;
  const int ldl = (cap + kBand - 1) / kBand * kBand;
  const dim3 grid((N + lay.P - 1) / lay.P, G);
  kernel<<<grid, kThreads, lay.bytes, stream>>>(
      zt, ils, xs, lmt, w, scal, out, N, d, cap, ldl, kind, lay.S, lay.res);
  return (int)cudaGetLastError();
}

// -- B2 / B5: ablations -------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, kIvMinBlocks)
    rank1_solve_kernel(const T* __restrict__ zt, const T* __restrict__ xs,
                       const T* __restrict__ lmt, const T* __restrict__ w,
                       const T* __restrict__ scal, T* __restrict__ out, int N,
                       int d, int cap, int ldl, int S, int res) {
  const int g = blockIdx.y;
  const int count = (int)scal[g * 4 + 3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  interval_rows<T>(zt, nullptr, xs + (size_t)g * cap * d,
                   lmt + (size_t)g * cap * ldl, ldl, w + (size_t)g * cap,
                   scal[g * 4 + 1], scal[g * 4 + 2], out + (size_t)g * 2 * N,
                   N, d, cap, n, S, res, RankOneGram<T>{});
}

// B2-3p in float64: the rank-1 solve with the float64 K1-3p's product
// (the float32 B2-3p is interval_experiments3.cu's)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    rank1_solve3_kernel(const T* __restrict__ zt, const T* __restrict__ xs,
                        const T* __restrict__ lmt, const T* __restrict__ w,
                        const T* __restrict__ scal, T* __restrict__ out,
                        int N, int d, int cap, int ldl, int S, int res) {
  const int g = blockIdx.y;
  const int count = (int)scal[g * 4 + 3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  interval_rows<T, RankOneGram<T>, false, ThreePassProduct>(
      zt, nullptr, xs + (size_t)g * cap * d, lmt + (size_t)g * cap * ldl, ldl,
      w + (size_t)g * cap, scal[g * 4 + 1], scal[g * 4 + 2],
      out + (size_t)g * 2 * N, N, d, cap, n, S, res, RankOneGram<T>{});
}

// three_pass: the rank-1 solve's three-pass form (B2-3p), in float64 only
// (the float32 B2-3p is interval_experiments3.cu's); the other modes have
// no product and refuse it
template <typename T>
int launch_ablation(const T* zt, const T* ils, const T* xs, const T* lmt,
                    const T* w, const T* scal, T* out, int G, int N, int d,
                    int cap, int kind, int mode, int three_pass,
                    cudaStream_t stream) {
  if (three_pass && (mode != kSolveRank1 || sizeof(T) != 8))
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kGramSums:
      return launch_gram_rows<T, kGramSums>(zt, ils, xs, w, scal, out, G, N,
                                            d, cap, kind, stream);
    case kNoProduct:
      return launch_gram_rows<T, kNoProduct>(zt, ils, xs, w, scal, out, G, N,
                                             d, cap, kind, stream);
    case kEpilogue:
      return launch_gram_rows<T, kEpilogue>(zt, ils, xs, w, scal, out, G, N,
                                            d, cap, kind, stream);
    case kSolveRank1: {
      const IvLayout<T> lay = interval_layout<T>(cap, d);
      auto kernel = rank1_solve_kernel<T>;
      if constexpr (sizeof(T) == 8) {
        if (three_pass) kernel = rank1_solve3_kernel<T>;
      }
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
      if (err != cudaSuccess) return (int)err;
      const int ldl = (cap + kBand - 1) / kBand * kBand;
      const dim3 grid((N + lay.P - 1) / lay.P, G);
      kernel<<<grid, kThreads, lay.bytes, stream>>>(
          zt, xs, lmt, w, scal, out, N, d, cap, ldl, lay.S, lay.res);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// -- B3: mu from the gram -----------------------------------------------------

// float64 at one block per SM (K1's float64 blocks at capacities 64 and
// 512 already take more than half an SM's shared memory): at two, the
// four more sums spill
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? kIvMinBlocks : 1)
    mu_from_gram_kernel(const T* __restrict__ zt, const T* __restrict__ ils,
                        const T* __restrict__ xs, const T* __restrict__ lmt,
                        const T* __restrict__ u, const T* __restrict__ scal,
                        T* __restrict__ out, int N, int d, int cap, int ldl,
                        int kind, int S, int res) {
  const int g = blockIdx.y;
  const int count = (int)scal[g * 4 + 3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  interval_rows<T, StationaryGram<T>, true>(
      zt, ils + g * d, xs + (size_t)g * cap * d, lmt + (size_t)g * cap * ldl,
      ldl, u + (size_t)g * cap, scal[g * 4 + 1], scal[g * 4 + 2],
      out + (size_t)g * 2 * N, N, d, cap, n, S, res,
      StationaryGram<T>{kind, scal[g * 4]});
}

// B3-3p in float64: mu from the gram beside the float64 K1-3p's product
// (the float32 B3-3p is interval_experiments3.cu's)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mu_from_gram3_kernel(const T* __restrict__ zt, const T* __restrict__ ils,
                         const T* __restrict__ xs, const T* __restrict__ lmt,
                         const T* __restrict__ u, const T* __restrict__ scal,
                         T* __restrict__ out, int N, int d, int cap, int ldl,
                         int kind, int S, int res) {
  const int g = blockIdx.y;
  const int count = (int)scal[g * 4 + 3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  interval_rows<T, StationaryGram<T>, true, ThreePassProduct>(
      zt, ils + g * d, xs + (size_t)g * cap * d, lmt + (size_t)g * cap * ldl,
      ldl, u + (size_t)g * cap, scal[g * 4 + 1], scal[g * 4 + 2],
      out + (size_t)g * 2 * N, N, d, cap, n, S, res,
      StationaryGram<T>{kind, scal[g * 4]});
}

// B3 (three_pass 0) or, in float64, B3-3p (1)
template <typename T>
int launch_mu_from_gram(const T* zt, const T* ils, const T* xs, const T* lmt,
                        const T* u, const T* scal, T* out, int G, int N, int d,
                        int cap, int kind, int three_pass,
                        cudaStream_t stream) {
  const IvLayout<T> lay = interval_layout<T>(cap, d);
  auto kernel = mu_from_gram_kernel<T>;
  if constexpr (sizeof(T) == 8) {
    if (three_pass) kernel = mu_from_gram3_kernel<T>;
  } else if (three_pass) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const int ldl = (cap + kBand - 1) / kBand * kBand;
  const dim3 grid((N + lay.P - 1) / lay.P, G);
  kernel<<<grid, kThreads, lay.bytes, stream>>>(
      zt, ils, xs, lmt, u, scal, out, N, d, cap, ldl, kind, lay.S, lay.res);
  return (int)cudaGetLastError();
}

}  // namespace safeopt

extern "C" {

// B1: K1 (safeopt_intervals_*) at slices per block S and resident gram
// rows res (S = 0: K1's own layout) and a shared-memory carveout (-1:
// CUDA's default; else a percentage); three_pass 1: K1-3p (B1-3p), in
// float64 only (the float32 B1-3p is safeopt_intervals3_launch_f32).
int safeopt_intervals_launch_f32(const void* zt, const void* ils,
                                 const void* xs, const void* lmt,
                                 const void* w, const void* scal, void* out,
                                 int G, int N, int d, int cap, int kind,
                                 int S, int res, int carveout, int three_pass,
                                 void* stream) {
  if (three_pass) return (int)cudaErrorInvalidValue;
  return safeopt::launch_intervals_at<float, false>((const float*)zt, (const float*)ils, (const float*)xs,
                (const float*)lmt, (const float*)w, (const float*)scal,
                (float*)out, G, N, d, cap, kind, S, res, carveout,
                (cudaStream_t)stream);
}

int safeopt_intervals_launch_f64(const void* zt, const void* ils,
                                 const void* xs, const void* lmt,
                                 const void* w, const void* scal, void* out,
                                 int G, int N, int d, int cap, int kind,
                                 int S, int res, int carveout, int three_pass,
                                 void* stream) {
  auto launch = three_pass ? safeopt::launch_intervals_at<double, true>
                           : safeopt::launch_intervals_at<double, false>;
  return launch((const double*)zt, (const double*)ils, (const double*)xs,
                (const double*)lmt, (const double*)w, (const double*)scal,
                (double*)out, G, N, d, cap, kind, S, res, carveout,
                (cudaStream_t)stream);
}

// B2/B5: K1's operands, mode 0 gram sums, 1 rank-1 solve, 2 no product,
// 3 epilogue only; three_pass 1: the rank-1 solve's three-pass form
// (B2-3p), in float64 only (the float32 B2-3p is
// safeopt_rank1_solve3_f32; any other mode refuses it); out (G, 2, N).
int safeopt_interval_ablation_f32(const void* zt, const void* ils,
                                  const void* xs, const void* lmt,
                                  const void* w, const void* scal, void* out,
                                  int G, int N, int d, int cap, int kind,
                                  int mode, int three_pass, void* stream) {
  return safeopt::launch_ablation<float>(
      (const float*)zt, (const float*)ils, (const float*)xs,
      (const float*)lmt, (const float*)w, (const float*)scal, (float*)out, G,
      N, d, cap, kind, mode, three_pass, (cudaStream_t)stream);
}

int safeopt_interval_ablation_f64(const void* zt, const void* ils,
                                  const void* xs, const void* lmt,
                                  const void* w, const void* scal, void* out,
                                  int G, int N, int d, int cap, int kind,
                                  int mode, int three_pass, void* stream) {
  return safeopt::launch_ablation<double>(
      (const double*)zt, (const double*)ils, (const double*)xs,
      (const double*)lmt, (const double*)w, (const double*)scal,
      (double*)out, G, N, d, cap, kind, mode, three_pass,
      (cudaStream_t)stream);
}

// B3: K1's operands with u = Lm^T w in place of w; three_pass 1: B3-3p,
// in float64 only (the float32 B3-3p is safeopt_mu_from_gram3_f32).
int safeopt_intervals_mu_from_gram_f32(const void* zt, const void* ils,
                                       const void* xs, const void* lmt,
                                       const void* u, const void* scal,
                                       void* out, int G, int N, int d,
                                       int cap, int kind, int three_pass,
                                       void* stream) {
  return safeopt::launch_mu_from_gram<float>(
      (const float*)zt, (const float*)ils, (const float*)xs,
      (const float*)lmt, (const float*)u, (const float*)scal, (float*)out, G,
      N, d, cap, kind, three_pass, (cudaStream_t)stream);
}

int safeopt_intervals_mu_from_gram_f64(const void* zt, const void* ils,
                                       const void* xs, const void* lmt,
                                       const void* u, const void* scal,
                                       void* out, int G, int N, int d,
                                       int cap, int kind, int three_pass,
                                       void* stream) {
  return safeopt::launch_mu_from_gram<double>(
      (const double*)zt, (const double*)ils, (const double*)xs,
      (const double*)lmt, (const double*)u, (const double*)scal,
      (double*)out, G, N, d, cap, kind, three_pass, (cudaStream_t)stream);
}

}  // extern "C"
