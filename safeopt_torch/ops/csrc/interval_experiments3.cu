// B1-3p, B2-3p, B3-3p (float32) and B4: the experiment kernels of the
// three-pass product on K1-3p's Hopper bodies (intervals3.cuh, resident,
// to capacity kResidentCap3; intervals3_tiled.cuh, tiled, past it, the
// same rule as K1-3p's, three_pass_tiled).
//
// B1-3p (benchmarks/bench_interval_mosaic.py:63 impl at three_pass=True,
//    call :73): K1-3p's function and operands at the caller's launch
//    layout, the H100's counterpart of the TPU kernel's block size and
//    VMEM limit: consumer warpgroups a block (1 or kGroups3, resident body
//    only), ring stages (chunks in flight per warpgroup), resident gram
//    rows (resident body only) and the shared-memory carveout; 0 (-1 for
//    the carveout) is K1-3p's own choice. The ring, the resident rows and
//    the carveout leave each point's sums in K1-3p's order (its bits); the
//    consumer warpgroups decide which warp adds which row tile, and the
//    order changes with them.
// B2-3p (bench_interval_mosaic3.py:104 kern_solve_only at
//    three_pass=True, product :114): K1-3p's function and operands on the
//    rank-1 stand-in gram xs[c, 0] z[0] of raw points (common.cuh
//    RankOneGram), one multiply an entry in place of the exponential.
// B3-3p (bench_interval_mosaic4.py:95 kern_mxu_emit at three_pass=True,
//    product :107): K1-3p's with mu = sum_c u[c] k[c], u = Lm^T w from
//    the wrapper, taken from the float32 gram entries before their limb
//    cut in the registers of the gram tasks (the bodies' Mu); V feeds
//    sum V^2 alone. res: the resident body's gram rows, as B1-3p's (0:
//    the most that fit, every row up to kResidentCap3), so that the
//    chunks past them, and who adds their u k, can be held.
// B4 (benchmarks/bench_interval_variants.py:92 _kernel via run_kernel
//    :121, the TPU's 3-pass _dot3 product): one GP's intervals with V =
//    Lm_hi k_hi + Lm_hi k_lo + Lm_lo k_hi in bf16 (m64nNk16) or tf32
//    (m64nNk8) limbs (Limbs3), the factor's limbs cut by the wrapper
//    (hoisted: split_factor's chunks, in bf16 K1-3p's own) or in the
//    kernel from float32 chunks as each lands (cut_chunk): the same bits.
//    hi = round(x) to the limb format, lo = round(x - hi); tf32 rounds to
//    nearest, ties away (cvt.rna: the tensor core itself would truncate).
//
// What bounds them on the H100: the limb products, 3 n(n+1) flops a
// point on the tensor cores (989 TFLOP/s bf16, 495 tf32), with the gram,
// its limb cut and the epilogue on the FP32 pipe beside them (K1-3p's
// notes in intervals3.cuh and intervals3_tiled.cuh); B2-3p's gram is a
// multiply an entry, B3-3p's adds one FMA an entry. What the design does
// about it is K1-3p's; tf32 takes chunks of 16 columns (two k8 steps), so
// that a stage, a step's gram and a block take the bytes they take in
// bf16 and the same rings fit; its gram rows take twice the bytes, so the
// resident body keeps fewer of them (240 of capacity 512's, beside its
// rings) and computes the rest a chunk at a time.
#include "intervals3.cuh"
#include "intervals3_tiled.cuh"

namespace safeopt {

// bytes of a GP's chunks as L lands them
template <class L>
__host__ __device__ __forceinline__ size_t gp_chunk_bytes(int cap) {
  const size_t cap_pad = (cap + kTM3 - 1) / kTM3 * kTM3;
  return cap_pad * cap_pad / (kTM3 * L::kKC) * L::kLanded;
}

// G GPs of K1's operands on the resident body, items G x nbx of 64 points,
// GP-major; C consumer warpgroups, stages chunks in flight per ring
template <class L, int C>
__global__ void __launch_bounds__(threads3<C>(), min_blocks3<C>())
    wg3_kernel(const float* __restrict__ zt, const float* __restrict__ ils,
               const float* __restrict__ xs,
               const unsigned char* __restrict__ tiles,
               const float* __restrict__ w, const float* __restrict__ scal,
               float* __restrict__ out, int G, int N, int d, int cap,
               int kind, int res, int stages) {
  extern __shared__ __align__(1024) unsigned char smem3[];
  const int nbx = (N + kP3 - 1) / kP3;
  const size_t gp_bytes = gp_chunk_bytes<L>(cap);
  auto item = [&](int it) {
    const int g = it / nbx;
    const float* sg = scal + g * 4;
    return Item3<StationaryGram<float>>{
        ils + g * d, xs + (size_t)g * cap * d, tiles + g * gp_bytes,
        w + (size_t)g * cap, sg[1], sg[2], out + (size_t)g * 2 * N,
        active_rows(sg, cap), (it - g * nbx) * kP3,
        StationaryGram<float>{kind, sg[0]}};
  };
  interval3_rows<C, L, 0>(zt, N, d, cap, res, G * nbx, item, smem3, stages);
}

// the same on the tiled body, items of kP3t points
template <class L>
__global__ void __launch_bounds__(kThreads3t, 1)
    tiled3_kernel(const float* __restrict__ zt, const float* __restrict__ ils,
                  const float* __restrict__ xs,
                  const unsigned char* __restrict__ tiles,
                  const float* __restrict__ w, const float* __restrict__ scal,
                  float* __restrict__ out, int G, int N, int d, int cap,
                  int kind, int stages) {
  extern __shared__ __align__(1024) unsigned char smem3[];
  const int nbx = (N + kP3t - 1) / kP3t;
  const size_t gp_bytes = gp_chunk_bytes<L>(cap);
  auto item = [&](int it) {
    const int g = it / nbx;
    const float* sg = scal + g * 4;
    return Item3<StationaryGram<float>>{
        ils + g * d, xs + (size_t)g * cap * d, tiles + g * gp_bytes,
        w + (size_t)g * cap, sg[1], sg[2], out + (size_t)g * 2 * N,
        active_rows(sg, cap), (it - g * nbx) * kP3t,
        StationaryGram<float>{kind, sg[0]}};
  };
  interval3_tiled_rows<L>(zt, N, d, cap, stages, G * nbx, item, smem3);
}

// The items of B2-3p (Mu false: the rank-1 gram of raw points; ils and
// kind unused) and B3-3p (Mu true: K1's gram, w holding u) over G GPs, nbx
// items of P points each, GP-major
template <bool Mu, int P>
struct ExpItems3 {
  const float *ils, *xs;
  const unsigned char* tiles;
  const float *w, *scal;
  float* out;
  int N, d, cap, kind, nbx;

  __device__ __forceinline__ auto operator()(int it) const {
    const int g = it / nbx;
    const float* sg = scal + g * 4;
    const size_t gp_bytes = gp_chunk_bytes<Bf16Limbs3>(cap);
    const int n = active_rows(sg, cap), i0 = (it - g * nbx) * P;
    if constexpr (Mu)
      return Item3<StationaryGram<float>>{
          ils + g * d, xs + (size_t)g * cap * d, tiles + g * gp_bytes,
          w + (size_t)g * cap, sg[1], sg[2], out + (size_t)g * 2 * N, n, i0,
          StationaryGram<float>{kind, sg[0]}};
    else
      return Item3<RankOneGram<float>>{
          nullptr, xs + (size_t)g * cap * d, tiles + g * gp_bytes,
          w + (size_t)g * cap, sg[1], sg[2], out + (size_t)g * 2 * N, n, i0,
          RankOneGram<float>{}};
  }
};

// B2-3p on the resident body, C consumer warpgroups
template <int C>
__global__ void __launch_bounds__(threads3<C>(), min_blocks3<C>())
    rank1_wg3_kernel(const float* __restrict__ zt,
                     const float* __restrict__ ils,
                     const float* __restrict__ xs,
                     const unsigned char* __restrict__ tiles,
                     const float* __restrict__ w,
                     const float* __restrict__ scal, float* __restrict__ out,
                     int G, int N, int d, int cap, int kind, int res) {
  extern __shared__ __align__(1024) unsigned char smem3[];
  const int nbx = (N + kP3 - 1) / kP3;
  const ExpItems3<false, kP3> item{ils, xs, tiles, w, scal, out,
                                   N,   d,  cap,   kind, nbx};
  interval3_rows<C>(zt, N, d, cap, res, G * nbx, item, smem3);
}

// B3-3p on the resident body, C consumer warpgroups
template <int C>
__global__ void __launch_bounds__(threads3<C>(), min_blocks3<C>())
    mu_wg3_kernel(const float* __restrict__ zt, const float* __restrict__ ils,
                  const float* __restrict__ xs,
                  const unsigned char* __restrict__ tiles,
                  const float* __restrict__ u, const float* __restrict__ scal,
                  float* __restrict__ out, int G, int N, int d, int cap,
                  int kind, int res) {
  extern __shared__ __align__(1024) unsigned char smem3[];
  const int nbx = (N + kP3 - 1) / kP3;
  const ExpItems3<true, kP3> item{ils, xs, tiles, u, scal, out,
                                  N,   d,  cap,   kind, nbx};
  interval3_rows<C, Bf16Limbs3, kStages3, true>(zt, N, d, cap, res,
                                                G * nbx, item, smem3);
}

// B2-3p on the tiled body
__global__ void __launch_bounds__(kThreads3t, 1)
    rank1_tiled3_kernel(const float* __restrict__ zt,
                        const float* __restrict__ ils,
                        const float* __restrict__ xs,
                        const unsigned char* __restrict__ tiles,
                        const float* __restrict__ w,
                        const float* __restrict__ scal,
                        float* __restrict__ out, int G, int N, int d,
                        int cap, int kind, int stages) {
  extern __shared__ __align__(1024) unsigned char smem3[];
  const int nbx = (N + kP3t - 1) / kP3t;
  const ExpItems3<false, kP3t> item{ils, xs, tiles, w, scal, out,
                                    N,   d,  cap,   kind, nbx};
  interval3_tiled_rows(zt, N, d, cap, stages, G * nbx, item, smem3);
}

// B3-3p on the tiled body
__global__ void __launch_bounds__(kThreads3t, 1)
    mu_tiled3_kernel(const float* __restrict__ zt,
                     const float* __restrict__ ils,
                     const float* __restrict__ xs,
                     const unsigned char* __restrict__ tiles,
                     const float* __restrict__ u,
                     const float* __restrict__ scal, float* __restrict__ out,
                     int G, int N, int d, int cap, int kind, int stages) {
  extern __shared__ __align__(1024) unsigned char smem3[];
  const int nbx = (N + kP3t - 1) / kP3t;
  const ExpItems3<true, kP3t> item{ils, xs, tiles, u, scal, out,
                                   N,   d,  cap,   kind, nbx};
  interval3_tiled_rows<Bf16Limbs3, true>(zt, N, d, cap, stages, G * nbx,
                                         item, smem3);
}

// The resident body with C consumer warpgroups: res resident gram rows (a
// multiple of L::kKC up to the capacity rounded to 64; 0: the most that
// fit, interval3_layout), stages chunks in flight per ring
template <class L, int C>
int launch_wg3(const float* zt, const float* ils, const float* xs,
               const unsigned char* tiles, const float* w, const float* scal,
               float* out, int G, int N, int d, int cap, int kind, int res,
               int stages, int carveout, cudaStream_t stream) {
  auto kernel = wg3_kernel<L, C>;
  const int cap_pad = (cap + kTM3 - 1) / kTM3 * kTM3;
  if (res < 0 || res > cap_pad || res % L::kKC)
    return (int)cudaErrorInvalidValue;
  const size_t avail = dynamic_smem(kernel, 0);
  const Iv3Layout<C, L> lay =
      res > 0 ? Iv3Layout<C, L>(cap, d, res, stages)
              : interval3_layout<C, L>(cap, d, avail, stages);
  if (lay.bytes > avail) return (int)cudaErrorInvalidValue;
  static int initial = -2;
  int err = set_smem(kernel, lay.bytes);
  if (!err) err = set_carveout(kernel, carveout, &initial);
  if (err) return err;
  const int items = G * ((N + kP3 - 1) / kP3);
  kernel<<<persistent_blocks(kernel, threads3<C>(), lay.bytes, items),
           threads3<C>(), lay.bytes, stream>>>(zt, ils, xs, tiles, w, scal,
                                               out, G, N, d, cap, kind,
                                               lay.res, stages);
  return (int)cudaGetLastError();
}

// The tiled body: stages chunks in flight per ring (0: the most that fit,
// interval3_tiled_layout)
template <class L>
int launch_tiled3(const float* zt, const float* ils, const float* xs,
                  const unsigned char* tiles, const float* w,
                  const float* scal, float* out, int G, int N, int d, int cap,
                  int kind, int stages, int carveout, cudaStream_t stream) {
  auto kernel = tiled3_kernel<L>;
  const size_t avail = dynamic_smem(kernel, 0);
  const Iv3TiledLayout lay =
      stages > 0 ? Iv3TiledLayout(d, stages) : interval3_tiled_layout(d, avail);
  if (lay.bytes > avail) return (int)cudaErrorInvalidValue;
  static int initial = -2;
  int err = set_smem(kernel, lay.bytes);
  if (!err) err = set_carveout(kernel, carveout, &initial);
  if (err) return err;
  const int items = G * ((N + kP3t - 1) / kP3t);
  kernel<<<persistent_blocks(kernel, kThreads3t, lay.bytes, items),
           kThreads3t, lay.bytes, stream>>>(zt, ils, xs, tiles, w, scal, out,
                                            G, N, d, cap, kind, lay.stages);
  return (int)cudaGetLastError();
}

// B1-3p: groups consumer warpgroups (0: K1-3p's, one at and below
// kSmallCap3, kGroups3 past it), stages (0: kStages3 in the resident body,
// the most that fit in the tiled one; else 2 to 4), res resident rows
// (0: the most that fit) and carveout; the tiled body takes no groups and
// no resident rows
int launch_b1_3p(const float* zt, const float* ils, const float* xs,
                 const unsigned char* tiles, const float* w,
                 const float* scal, float* out, int G, int N, int d, int cap,
                 int kind, int groups, int stages, int res, int carveout,
                 cudaStream_t stream) {
  using L = Bf16Limbs3;
  if (d < 1 || d > kMaxDim || (stages != 0 && (stages < 2 || stages > 4)) ||
      carveout < -1 || carveout > 100)
    return (int)cudaErrorInvalidValue;
  if (three_pass_tiled(cap)) {
    if (groups != 0 || res != 0) return (int)cudaErrorInvalidValue;
    return launch_tiled3<L>(zt, ils, xs, tiles, w, scal, out, G, N, d, cap,
                            kind, stages, carveout, stream);
  }
  const int C = groups != 0 ? groups : (cap <= kSmallCap3 ? 1 : kGroups3);
  const int S = stages != 0 ? stages : kStages3;
  if (C == 1)
    return launch_wg3<L, 1>(zt, ils, xs, tiles, w, scal, out, G, N, d, cap,
                            kind, res, S, carveout, stream);
  if (C == kGroups3)
    return launch_wg3<L, kGroups3>(zt, ils, xs, tiles, w, scal, out, G, N,
                                   d, cap, kind, res, S, carveout, stream);
  return (int)cudaErrorInvalidValue;
}

// B2-3p (Mu false) and B3-3p (true) at K1-3p's body and layout for the
// capacity; res the resident body's gram rows (0: the most that fit; the
// tiled body takes none)
template <bool Mu>
int launch_exp3(const float* zt, const float* ils, const float* xs,
                const unsigned char* tiles, const float* w, const float* scal,
                float* out, int G, int N, int d, int cap, int kind, int res,
                cudaStream_t stream) {
  using L = Bf16Limbs3;
  const int cap_pad = (cap + kTM3 - 1) / kTM3 * kTM3;
  if (d < 1 || d > kMaxDim || res < 0 || res > cap_pad || res % L::kKC)
    return (int)cudaErrorInvalidValue;
  if (three_pass_tiled(cap)) {
    if (res != 0) return (int)cudaErrorInvalidValue;
    auto kernel = Mu ? mu_tiled3_kernel : rank1_tiled3_kernel;
    const size_t avail = dynamic_smem(kernel, 0);
    const Iv3TiledLayout lay = interval3_tiled_layout(d, avail);
    if (lay.bytes > avail) return (int)cudaErrorInvalidValue;
    const int err = set_smem(kernel, lay.bytes);
    if (err) return err;
    const int items = G * ((N + kP3t - 1) / kP3t);
    kernel<<<persistent_blocks(kernel, kThreads3t, lay.bytes, items),
             kThreads3t, lay.bytes, stream>>>(zt, ils, xs, tiles, w, scal,
                                              out, G, N, d, cap, kind,
                                              lay.stages);
    return (int)cudaGetLastError();
  }
  auto resident = [&](auto groups) {
    constexpr int C = decltype(groups)::value;
    auto kernel = Mu ? mu_wg3_kernel<C> : rank1_wg3_kernel<C>;
    const size_t avail = dynamic_smem(kernel, 0);
    const Iv3Layout<C> lay = res > 0 ? Iv3Layout<C>(cap, d, res)
                                     : interval3_layout<C>(cap, d, avail);
    if (lay.bytes > avail) return (int)cudaErrorInvalidValue;
    const int err = set_smem(kernel, lay.bytes);
    if (err) return err;
    const int items = G * ((N + kP3 - 1) / kP3);
    kernel<<<persistent_blocks(kernel, threads3<C>(), lay.bytes, items),
             threads3<C>(), lay.bytes, stream>>>(zt, ils, xs, tiles, w, scal,
                                                 out, G, N, d, cap, kind,
                                                 lay.res);
    return (int)cudaGetLastError();
  };
  return cap <= kSmallCap3
             ? resident(std::integral_constant<int, 1>{})
             : resident(std::integral_constant<int, kGroups3>{});
}

// B4: one GP in limb format Tf32, its chunks hoisted (the limbs) or not
// (float32, cut in the kernel); K1-3p's body and layout for the capacity
template <bool Tf32>
int launch_split3(const float* zt, const float* ils, const float* xs,
                  const unsigned char* chunks, const float* w,
                  const float* scal, float* out, int N, int d, int cap,
                  int kind, int hoisted, cudaStream_t stream) {
  if (d < 1 || d > kMaxDim) return (int)cudaErrorInvalidValue;
  auto run = [&](auto limbs) {
    using L = decltype(limbs);
    if (three_pass_tiled(cap))
      return launch_tiled3<L>(zt, ils, xs, chunks, w, scal, out, 1, N, d,
                              cap, kind, 0, -1, stream);
    return cap <= kSmallCap3
               ? launch_wg3<L, 1>(zt, ils, xs, chunks, w, scal, out, 1, N, d,
                                  cap, kind, 0, kStages3, -1, stream)
               : launch_wg3<L, kGroups3>(zt, ils, xs, chunks, w, scal, out,
                                         1, N, d, cap, kind, 0, kStages3, -1,
                                         stream);
  };
  return hoisted ? run(Limbs3<Tf32, false>{}) : run(Limbs3<Tf32, true>{});
}

}  // namespace safeopt

extern "C" {

// B1-3p, float32: K1-3p's operands (the factor as factor_chunks) at
// groups consumer warpgroups, stages ring stages, res resident gram rows
// (0 each: K1-3p's layout) and a shared-memory carveout (-1: the
// kernel's default; else a percentage).
int safeopt_intervals3_launch_f32(const void* zt, const void* ils,
                                  const void* xs, const void* tiles,
                                  const void* w, const void* scal, void* out,
                                  int G, int N, int d, int cap, int kind,
                                  int groups, int stages, int res,
                                  int carveout, void* stream) {
  return safeopt::launch_b1_3p(
      (const float*)zt, (const float*)ils, (const float*)xs,
      (const unsigned char*)tiles, (const float*)w, (const float*)scal,
      (float*)out, G, N, d, cap, kind, groups, stages, res, carveout,
      (cudaStream_t)stream);
}

// B2-3p, float32: K1-3p's operands but ils and kind (the rank-1 gram
// takes raw points), the factor as factor_chunks; out (G, 2, N).
int safeopt_rank1_solve3_f32(const void* zt, const void* xs,
                             const void* tiles, const void* w,
                             const void* scal, void* out, int G, int N, int d,
                             int cap, void* stream) {
  return safeopt::launch_exp3<false>(
      (const float*)zt, nullptr, (const float*)xs,
      (const unsigned char*)tiles, (const float*)w, (const float*)scal,
      (float*)out, G, N, d, cap, 0, 0, (cudaStream_t)stream);
}

// B3-3p, float32: K1-3p's operands with u = Lm^T w in place of w, the
// factor as factor_chunks, res resident gram rows (0: K1-3p's layout);
// out (G, 2, N).
int safeopt_mu_from_gram3_f32(const void* zt, const void* ils,
                              const void* xs, const void* tiles,
                              const void* u, const void* scal, void* out,
                              int G, int N, int d, int cap, int kind, int res,
                              void* stream) {
  return safeopt::launch_exp3<true>(
      (const float*)zt, (const float*)ils, (const float*)xs,
      (const unsigned char*)tiles, (const float*)u, (const float*)scal,
      (float*)out, G, N, d, cap, kind, res, (cudaStream_t)stream);
}

// B4: one GP, float32. chunks are Lm's limbs in chunk order when hoisted
// is 1 (split_factor: bfloat16, or float32 holding tf32 values), else Lm
// in float32 chunks as the kernel cuts them (factor_landing); zt (d, N),
// ils (d), xs (cap, d) scaled, w (cap), scal (4) = [variance, kdiag,
// beta, count]; out (2, N).
int safeopt_intervals_split_bf16(const void* zt, const void* ils,
                                 const void* xs, const void* chunks,
                                 const void* w, const void* scal, void* out,
                                 int N, int d, int cap, int kind, int hoisted,
                                 void* stream) {
  return safeopt::launch_split3<false>(
      (const float*)zt, (const float*)ils, (const float*)xs,
      (const unsigned char*)chunks, (const float*)w, (const float*)scal,
      (float*)out, N, d, cap, kind, hoisted, (cudaStream_t)stream);
}

int safeopt_intervals_split_tf32(const void* zt, const void* ils,
                                 const void* xs, const void* chunks,
                                 const void* w, const void* scal, void* out,
                                 int N, int d, int cap, int kind, int hoisted,
                                 void* stream) {
  return safeopt::launch_split3<true>(
      (const float*)zt, (const float*)ils, (const float*)xs,
      (const unsigned char*)chunks, (const float*)w, (const float*)scal,
      (float*)out, N, d, cap, kind, hoisted, (cudaStream_t)stream);
}

}  // extern "C"
