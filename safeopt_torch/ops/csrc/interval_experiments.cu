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
// B3 (bench_interval_mosaic4.py::kern_mxu_emit): K1 with mu = sum_c u[c]
//    k[c], u = Lm^T w precomputed by the wrapper (interval_rows
//    MuFromGram): no band multiplies w into V.
// B1-3p, B2-3p, B3-3p: B1, B2's rank-1 solve and B3 at the harnesses'
//    three_pass=True (bench_interval_mosaic.py:76, mosaic3.py:114,
//    mosaic4.py:107): the same bodies with K1-3p's product (intervals.cuh
//    ThreePassProduct, V = Lm_hi k_hi + Lm_hi k_lo + Lm_lo k_hi over bf16
//    limbs, mma.sync in float32, FP64 FMAs of the limbs in float64) and
//    K1-3p's launch bounds (float64 at one block an SM: its limbs and
//    register tile take 254 registers). B1-3p gives K1-3p's bits at every
//    layout; B3-3p reads mu from the gram rows by lane = point, each band
//    over its own 32 columns.
// B4 (bench_interval_variants.py::_kernel, the TPU's _dot3 3-pass
//    product): one GP's intervals with V = Lm k as Lm_hi k_hi + Lm_hi k_lo
//    + Lm_lo k_hi on tensor cores (mma.sync m16n8k16 bf16 or m16n8k8 tf32,
//    f32 accumulation), the three passes into one fragment (the TPU
//    harness's "stacked" form), tiles above the diagonal skipped at the
//    mma tile's grain. hi = round(x) to the limb format, lo = round(x -
//    hi); tf32 rounds to nearest, ties away (cvt.rna: the tensor core
//    itself would truncate). Lm's limbs are split in the kernel
//    (inkernel) or read pre-split (hoisted): the same bits.
//
// What bounds them: B1-B3 and B2/B5's rank-1 solve as K1 (the FP32/FP64
// pipe: n(n+1)/2 FMAs a point); their three-pass forms as K1-3p (the
// bf16 tensor cores, 3 n(n+1) flops a point, beside the gram, the limb
// cuts and the epilogue on the FP32 pipe); B2's sums and B5's no-product and
// epilogue modes n gram entries (or none) a point against 8 d bytes read,
// still the FP32 pipe at n = 400; B4 the tensor cores (3 n(n+1) flop a
// point, 495 TFLOP/s tf32, 989 bf16), with its factor fragments read from
// L2 by every block of 32 points.
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

// B1-3p: K1-3p's body at the caller's layout
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

// B1 (ThreePass false) or B1-3p (true)
template <typename T, bool ThreePass>
int launch_intervals_at(const T* zt, const T* ils, const T* xs, const T* lmt,
                        const T* w, const T* scal, T* out, int G, int N, int d,
                        int cap, int kind, int S, int res, int carveout,
                        cudaStream_t stream) {
  IvLayout<T> lay = interval_layout<T>(cap, d);
  if (S > 0) {
    const cudaError_t err = caller_layout<T>(cap, d, S, res, &lay);
    if (err != cudaSuccess) return (int)err;
  }
  auto kernel =
      ThreePass ? intervals3_launch_kernel<T> : intervals_launch_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  // the attribute outlives the launch, so it is set on every call: -1
  // restores the value the kernel had before any call set it (one value
  // per kernel: this launcher has an instance per kernel)
  static int initial_carveout = -2;
  if (initial_carveout == -2) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    initial_carveout = attr.preferredShmemCarveout;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             carveout < 0 ? initial_carveout : carveout);
  if (err != cudaSuccess) return (int)err;
  const int ldl = (cap + kBand - 1) / kBand * kBand;
  const dim3 grid((N + lay.P - 1) / lay.P, G);
  kernel<<<grid, kThreads, lay.bytes, stream>>>(
      zt, ils, xs, lmt, w, scal, out, N, d, cap, ldl, kind, lay.S, lay.res);
  return (int)cudaGetLastError();
}

// -- B2 / B5: ablations -------------------------------------------------------

enum AblationMode { kGramSums = 0, kSolveRank1 = 1, kNoProduct = 2,
                    kEpilogue = 3 };

// The rank-1 stand-in gram of B2's solve: xs[c, 0] * z[0], one multiply
// (the block stages raw points: K1's body gets no inverse lengthscales).
template <typename T>
struct RankOneGram {
  template <int R>
  __device__ __forceinline__ void rows(T (&v)[R], const T* const (&x)[R],
                                       const T* zs, int p, int d,
                                       int ldz) const {
    const T z = zs[p];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = x[r][0] * z;
  }
  __device__ __forceinline__ T operator()(const T* x, const T* zs, int p,
                                          int d, int ldz) const {
    return x[0] * zs[p];
  }
};

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

// B2-3p: the rank-1 solve with K1-3p's product
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? kIvMinBlocks : 1)
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

// One thread per point, the rows in order: the gram's sums (kGramSums), or
// K1's epilogue on V := k (kNoProduct) or V := 0.01 z[0] (kEpilogue).
template <typename T, int Mode>
__global__ void __launch_bounds__(kThreads)
    rowwise_kernel(const T* __restrict__ zt, const T* __restrict__ ils,
                   const T* __restrict__ xs, const T* __restrict__ w,
                   const T* __restrict__ scal, T* __restrict__ out, int N,
                   int d, int cap, int kind) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* zs = reinterpret_cast<T*>(smem_raw);  // d x kThreads scaled points
  const int g = blockIdx.y;
  const int count = (int)scal[g * 4 + 3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  const int p = threadIdx.x;
  const int i = blockIdx.x * kThreads + p;
  const T* il = ils + g * d;
  for (int k = 0; k < d; ++k)
    zs[k * kThreads + p] = i < N ? zt[(size_t)k * N + i] * il[k] : T(0);
  if (i >= N) return;
  const T* x = xs + (size_t)g * cap * d;
  const T* wg = w + (size_t)g * cap;
  const StationaryGram<T> gram{kind, scal[g * 4]};
  T s1 = T(0), s2 = T(0);  // sum k and sum k^2, or mu and sum V^2
  auto add = [&](int c, T v) {
    s1 += Mode == kGramSums ? v : wg[c] * v;
    s2 += v * v;
  };
  if constexpr (Mode == kEpilogue) {
    const T v = T(0.01) * zt[i];
    for (int c = 0; c < n; ++c) add(c, v);
  } else {
    constexpr int R = 4;
    int c = 0;
    for (; c + R <= n; c += R) {
      const T* xr[R];
      T v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) xr[r] = x + (size_t)(c + r) * d;
      gram.rows(v, xr, zs, p, d, kThreads);
#pragma unroll
      for (int r = 0; r < R; ++r) add(c + r, v[r]);
    }
    for (; c < n; ++c) add(c, gram(x + (size_t)c * d, zs, p, d, kThreads));
  }
  T* o = out + (size_t)g * 2 * N;
  if constexpr (Mode == kGramSums) {
    o[i] = s1;
    o[N + i] = s2;
  } else {
    const T var = scal[g * 4 + 1] - s2;
    const T spread = scal[g * 4 + 2] * dsqrt(var > T(0) ? var : T(0));
    o[i] = s1 - spread;
    o[N + i] = s1 + spread;
  }
}

template <typename T, int Mode>
int launch_rowwise(const T* zt, const T* ils, const T* xs, const T* w,
                   const T* scal, T* out, int G, int N, int d, int cap,
                   int kind, cudaStream_t stream) {
  const size_t bytes = sizeof(T) * (size_t)d * kThreads;
  const cudaError_t err = cudaFuncSetAttribute(
      rowwise_kernel<T, Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kThreads - 1) / kThreads, G);
  rowwise_kernel<T, Mode><<<grid, kThreads, bytes, stream>>>(
      zt, ils, xs, w, scal, out, N, d, cap, kind);
  return (int)cudaGetLastError();
}

// three_pass: the rank-1 solve's three-pass form (B2-3p); the other
// modes have no product and refuse it
template <typename T>
int launch_ablation(const T* zt, const T* ils, const T* xs, const T* lmt,
                    const T* w, const T* scal, T* out, int G, int N, int d,
                    int cap, int kind, int mode, int three_pass,
                    cudaStream_t stream) {
  if (three_pass && mode != kSolveRank1) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kGramSums:
      return launch_rowwise<T, kGramSums>(zt, ils, xs, w, scal, out, G, N, d,
                                          cap, kind, stream);
    case kNoProduct:
      return launch_rowwise<T, kNoProduct>(zt, ils, xs, w, scal, out, G, N,
                                           d, cap, kind, stream);
    case kEpilogue:
      return launch_rowwise<T, kEpilogue>(zt, ils, xs, w, scal, out, G, N, d,
                                          cap, kind, stream);
    case kSolveRank1: {
      const IvLayout<T> lay = interval_layout<T>(cap, d);
      auto kernel = three_pass ? rank1_solve3_kernel<T> : rank1_solve_kernel<T>;
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

// B3-3p: mu from the gram beside K1-3p's product
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? kIvMinBlocks : 1)
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

// B3 (three_pass 0) or B3-3p (1)
template <typename T>
int launch_mu_from_gram(const T* zt, const T* ils, const T* xs, const T* lmt,
                        const T* u, const T* scal, T* out, int G, int N, int d,
                        int cap, int kind, int three_pass,
                        cudaStream_t stream) {
  const IvLayout<T> lay = interval_layout<T>(cap, d);
  auto kernel =
      three_pass ? mu_from_gram3_kernel<T> : mu_from_gram_kernel<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const int ldl = (cap + kBand - 1) / kBand * kBand;
  const dim3 grid((N + lay.P - 1) / lay.P, G);
  kernel<<<grid, kThreads, lay.bytes, stream>>>(
      zt, ils, xs, lmt, u, scal, out, N, d, cap, ldl, kind, lay.S, lay.res);
  return (int)cudaGetLastError();
}

// -- B4: the split-limb tensor-core product -----------------------------------
//
// A block takes kSP = 32 points of one GP. It computes their gram for the
// rows c < n16 (n rounded up to 16; zero past n) once, splits each entry
// into limbs and keeps both in shared memory as [point][row] (row stride
// ldc, padded so that a B fragment's 32 lanes hit 32 banks). Warps take
// bands of 32 rows of V (two m16 tiles) by the block's 32 points (four n8
// tiles), largest first from a shared counter; band b contracts over
// columns [0, min(32 (b + 1), n16)), skipping an (m16, k) tile whose first
// column lies past its last row. A fragments (Lm's limbs) come straight
// from global memory (L2); the factor is padded to ldl = cap rounded up
// to 32 in both dimensions, with zeros, so that every band is in bounds.
// Each band's per-point sums of w V and V^2 are reduced over the lanes
// that share a column and stored to the band's slot; the block adds the
// bands in order.

// Shared memory of a block: both gram limbs (kSP x ldc each), the bands'
// partials (2 x nbmax x kSP floats), the points (d x kSP) and the counter.
template <class Limb>
struct SplitLayout {
  int n16, ldc, nbmax;
  size_t ghi, glo, red, zs, slot, bytes;
  __host__ __device__ SplitLayout(int cap, int d) {
    const int ldl = (cap + kBand - 1) / kBand * kBand;
    n16 = (cap + kSK - 1) / kSK * kSK;
    ldc = n16 + Limb::kLdcPad;
    nbmax = ldl / kBand;
    const size_t g = sizeof(typename Limb::Stored) * (size_t)kSP * ldc;
    ghi = 0;
    glo = g;
    red = 2 * g;
    zs = red + sizeof(float) * 2 * (size_t)nbmax * kSP;
    slot = zs + sizeof(float) * (size_t)d * kSP;
    bytes = slot + sizeof(int);
  }
};

template <class Limb, bool Hoisted>
__global__ void __launch_bounds__(kThreads, 2)
    split_kernel(const float* __restrict__ zt, const float* __restrict__ ils,
                 const float* __restrict__ xs, const float* __restrict__ lm,
                 const typename Limb::Stored* __restrict__ lm_hi,
                 const typename Limb::Stored* __restrict__ lm_lo,
                 const float* __restrict__ w, const float* __restrict__ scal,
                 float* __restrict__ out, int N, int d, int cap, int kind) {
  using Stored = typename Limb::Stored;
  const SplitLayout<Limb> lay(cap, d);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stored* ghi = reinterpret_cast<Stored*>(smem_raw + lay.ghi);
  Stored* glo = reinterpret_cast<Stored*>(smem_raw + lay.glo);
  float* red = reinterpret_cast<float*>(smem_raw + lay.red);
  float* zs = reinterpret_cast<float*>(smem_raw + lay.zs);
  int* slot = reinterpret_cast<int*>(smem_raw + lay.slot);
  const int ldl = (cap + kBand - 1) / kBand * kBand;
  const int count = (int)scal[3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  const int n16 = (n + kSK - 1) / kSK * kSK;
  const int nb = (n + kBand - 1) / kBand;
  const int i0 = blockIdx.x * kSP;

  // 1. the points, the gram's limbs (zero past n) and the counter
  for (int t = threadIdx.x; t < d * kSP; t += kThreads) {
    const int k = t / kSP;
    const int i = i0 + t - k * kSP;
    zs[t] = i < N ? zt[(size_t)k * N + i] * ils[k] : 0.0f;
  }
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  const StationaryGram<float> gram{kind, scal[0]};
  for (int t = threadIdx.x; t < n16 * kSP; t += kThreads) {
    const int p = t / n16;
    const int c = t - p * n16;  // consecutive threads, consecutive rows
    const float v = c < n ? gram(xs + (size_t)c * d, zs, p, d, kSP) : 0.0f;
    split<Limb>(v, ghi[p * lay.ldc + c], glo[p * lay.ldc + c]);
  }
  __syncthreads();

  // 2. bands, largest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(slot, 1);
    item = __shfl_sync(0xffffffffu, item, 0);
    if (item >= nb) break;
    const int b = nb - 1 - item;
    const int r0 = b * kBand;
    const int kend = r0 + kBand < n16 ? r0 + kBand : n16;
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    for (int c0 = 0; c0 < kend; c0 += kSK) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (c0 <= r0 + 16 * mt + 15)  // else every column is past the rows
          split_step<Limb, Hoisted>(acc[mt], lm, lm_hi, lm_lo, ldl,
                                    r0 + 16 * mt, ghi, glo, lay.ldc, c0, gid,
                                    tig);
    }
    // the band's sums of w V and V^2 for points 8 nt + 2 tig + j
    float m[4][2], q[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mm = 0.0f, qq = 0.0f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 16 * mt + gid + 8 * h;
            const float v = acc[mt][nt][2 * h + j];
            mm += (r < n ? w[r] : 0.0f) * v;
            qq += v * v;
          }
#pragma unroll
        for (int s = 4; s < 32; s <<= 1) {  // over gid: same bits per lane
          mm += __shfl_xor_sync(0xffffffffu, mm, s);
          qq += __shfl_xor_sync(0xffffffffu, qq, s);
        }
        m[nt][j] = mm;
        q[nt][j] = qq;
      }
    if (gid == 0) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = 8 * nt + 2 * tig + j;
          red[b * kSP + p] = m[nt][j];
          red[(lay.nbmax + b) * kSP + p] = q[nt][j];
        }
    }
  }
  __syncthreads();

  // 3. the bands in order, per point
  const int p = threadIdx.x;
  if (p < kSP && i0 + p < N) {
    float mu = 0.0f, ssq = 0.0f;
    for (int b = 0; b < nb; ++b) {
      mu += red[b * kSP + p];
      ssq += red[(lay.nbmax + b) * kSP + p];
    }
    const float var = scal[1] - ssq;
    const float spread = scal[2] * sqrtf(var > 0.0f ? var : 0.0f);
    out[i0 + p] = mu - spread;
    out[N + i0 + p] = mu + spread;
  }
}

template <class Limb>
int launch_split(const float* zt, const float* ils, const float* xs,
                 const void* a, const void* b, const float* w,
                 const float* scal, float* out, int N, int d, int cap,
                 int kind, int hoisted, cudaStream_t stream) {
  using Stored = typename Limb::Stored;
  const SplitLayout<Limb> lay(cap, d);
  if (lay.bytes > kMaxDynSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kSP - 1) / kSP);
  const float* lm = hoisted ? nullptr : (const float*)a;
  const Stored* hi = hoisted ? (const Stored*)a : nullptr;
  const Stored* lo = hoisted ? (const Stored*)b : nullptr;
  auto run = [&](auto kernel) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, lay.bytes, stream>>>(zt, ils, xs, lm, hi, lo, w,
                                                  scal, out, N, d, cap, kind);
    return (int)cudaGetLastError();
  };
  return hoisted ? run(split_kernel<Limb, true>)
                 : run(split_kernel<Limb, false>);
}

}  // namespace safeopt

extern "C" {

// B1: K1 (safeopt_intervals_*) at slices per block S and resident gram
// rows res (S = 0: K1's own layout) and a shared-memory carveout (-1:
// CUDA's default; else a percentage); three_pass 1: K1-3p (B1-3p).
int safeopt_intervals_launch_f32(const void* zt, const void* ils,
                                 const void* xs, const void* lmt,
                                 const void* w, const void* scal, void* out,
                                 int G, int N, int d, int cap, int kind,
                                 int S, int res, int carveout, int three_pass,
                                 void* stream) {
  auto launch = three_pass ? safeopt::launch_intervals_at<float, true>
                           : safeopt::launch_intervals_at<float, false>;
  return launch((const float*)zt, (const float*)ils, (const float*)xs,
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
// (B2-3p; any other mode refuses it); out (G, 2, N).
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

// B3: K1's operands with u = Lm^T w in place of w; three_pass 1: B3-3p.
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

// B4: one GP, float32. a is Lm (ldl x ldl, ldl = cap rounded up to 32,
// zero padded) when hoisted is 0, else its hi limbs, b its lo limbs, in
// the limb format (bfloat16, or float32 holding tf32 values); zt (d, N),
// ils (d), xs (cap, d) scaled, w (cap), scal (4) = [variance, kdiag,
// beta, count]; out (2, N).
int safeopt_intervals_split_bf16(const void* zt, const void* ils,
                                 const void* xs, const void* a, const void* b,
                                 const void* w, const void* scal, void* out,
                                 int N, int d, int cap, int kind, int hoisted,
                                 void* stream) {
  return safeopt::launch_split<safeopt::Bf16Limb>(
      (const float*)zt, (const float*)ils, (const float*)xs, a, b,
      (const float*)w, (const float*)scal, (float*)out, N, d, cap, kind,
      hoisted, (cudaStream_t)stream);
}

int safeopt_intervals_split_tf32(const void* zt, const void* ils,
                                 const void* xs, const void* a, const void* b,
                                 const void* w, const void* scal, void* out,
                                 int N, int d, int cap, int kind, int hoisted,
                                 void* stream) {
  return safeopt::launch_split<safeopt::Tf32Limb>(
      (const float*)zt, (const float*)ils, (const float*)xs, a, b,
      (const float*)w, (const float*)scal, (float*)out, N, d, cap, kind,
      hoisted, (cudaStream_t)stream);
}

}  // extern "C"
