// K1-3p and K2-3p in float32: the certified path's interval pass
// (interval_precision='high') on Hopper's warpgroup tensor-core product.
//
// K1-3p (safeopt_intervals3_f32) replaces the TPU kernel
// safeopt_tpu/ops/fused_posterior.py::_interval_kernel_multi (:454) at
// three_pass=True (its product :513-528, through
// _tri_matmul(three_pass=True), :112-144): G GPs of one stationary
// family, the points scaled by each GP's inverse lengthscales, the GP the
// grid's y axis. K2-3p (safeopt_intervals_plan3_f32) replaces
// ::_interval_kernel (:294) at three_pass=True (its product :313): one
// GP whose kernel is a Sum/Product plan (PlanGram), the plan staged in
// shared memory once per block, statically up to kMaxLeaves leaves and
// in dynamic shared memory past that (stage_plan).
//
// What bounds them on the H100, and the design: two block bodies, picked
// by the capacity alone (the count lives on the device):
//
// - intervals3.cuh, the resident body (intervals3_wg_kernel,
//   intervals_plan3_wg_kernel): limbs cut once, m64n64k16 wgmma over
//   64-row tiles of the factor's limbs and the block's gram limbs, the
//   factor's chunks streamed by cp.async.bulk on mbarriers and shared by
//   the block's 64 points, the gram limbs resident; up to capacity
//   kResidentCap3 (576), where every gram row stays resident;
// - intervals3_tiled.cuh, the tiled body (intervals3_tiled_kernel,
//   intervals_plan3_tiled_kernel): items of 128 points (m64n128k16),
//   four warpgroups on bands of 256 rows, each step's gram computed once
//   a band beside the products; past kResidentCap3.
//
// The float64
// instances of K1-3p and K2-3p, a check of the bands against the plain
// version rather than a route the card's float32 path takes, stay in
// fused_intervals.cu and fused_intervals_plan.cu (intervals.cuh,
// ThreePassProduct).
//
// The factor comes as chunks of its bf16 limbs (ops/fused_posterior.py
// factor_chunks): per GP (cap_pad / 64) x (cap_pad / 32) chunks of 8 KB,
// cap_pad the capacity rounded up to 64.

#include "intervals3.cuh"
#include "intervals3_tiled.cuh"

namespace safeopt {

// items = G x nbx work items of 64 points, GP-major; C consumer
// warpgroups.
template <int C>
__global__ void __launch_bounds__(threads3<C>(), min_blocks3<C>())
    intervals3_wg_kernel(const float* __restrict__ zt,
                         const float* __restrict__ ils,
                         const float* __restrict__ xs,
                         const unsigned char* __restrict__ tiles,
                         const float* __restrict__ w,
                         const float* __restrict__ scal,
                         float* __restrict__ out, int G, int N, int d,
                         int cap, int kind, int res) {
  extern __shared__ __align__(1024) unsigned char smem3[];
  const int nbx = (N + kP3 - 1) / kP3;
  const size_t cap_pad = (cap + kTM3 - 1) / kTM3 * kTM3;
  auto item = [&](int it) {
    const int g = it / nbx;
    const float* sg = scal + g * 4;
    return Item3<StationaryGram<float>>{
        ils + g * d, xs + (size_t)g * cap * d,
        tiles + (size_t)g * cap_pad * cap_pad * 4, w + (size_t)g * cap,
        sg[1], sg[2], out + (size_t)g * 2 * N, active_rows(sg, cap),
        (it - g * nbx) * kP3, StationaryGram<float>{kind, sg[0]}};
  };
  interval3_rows<C>(zt, N, d, cap, res, G * nbx, item, smem3);
}

// Wide: a plan of more than kMaxLeaves leaves, staged in dynamic shared
// memory at plan_at; C consumer warpgroups.
template <int C, bool Wide>
__global__ void __launch_bounds__(threads3<C>(), min_blocks3<C>())
    intervals_plan3_wg_kernel(const float* __restrict__ zt,
                              const float* __restrict__ xs,
                              const unsigned char* __restrict__ tiles,
                              const float* __restrict__ w,
                              const float* __restrict__ scales,
                              const float* __restrict__ pvar,
                              const int* __restrict__ plan,
                              const float* __restrict__ scal,
                              float* __restrict__ out, int N, int d, int cap,
                              int P, int res, int plan_at) {
  extern __shared__ __align__(1024) unsigned char smem3[];
  PlanGram<float> gram;
  if constexpr (Wide) {
    gram = stage_plan<float>(smem3 + plan_at, scales, pvar, plan, P, d);
  } else {
    __shared__ PlanSmem<float> smem_plan;
    gram = smem_plan.stage(scales, pvar, plan, P, d);
  }
  const int n = active_rows(scal, cap);
  auto item = [&](int it) {
    return Item3<PlanGram<float>>{nullptr, xs, tiles, w, scal[1], scal[2],
                                  out, n, it * kP3, gram};
  };
  interval3_rows<C>(zt, N, d, cap, res, (N + kP3 - 1) / kP3, item, smem3);
}

// The tiled body (intervals3_tiled.cuh) of K1-3p: items = G x nbx work
// items of kP3t points, GP-major; stages as interval3_tiled_layout's.
__global__ void __launch_bounds__(kThreads3t, 1)
    intervals3_tiled_kernel(const float* __restrict__ zt,
                            const float* __restrict__ ils,
                            const float* __restrict__ xs,
                            const unsigned char* __restrict__ tiles,
                            const float* __restrict__ w,
                            const float* __restrict__ scal,
                            float* __restrict__ out, int G, int N, int d,
                            int cap, int kind, int stages) {
  extern __shared__ __align__(1024) unsigned char smem3[];
  const int nbx = (N + kP3t - 1) / kP3t;
  const size_t cap_pad = (cap + kTM3 - 1) / kTM3 * kTM3;
  auto item = [&](int it) {
    const int g = it / nbx;
    const float* sg = scal + g * 4;
    return Item3<StationaryGram<float>>{
        ils + g * d, xs + (size_t)g * cap * d,
        tiles + (size_t)g * cap_pad * cap_pad * 4, w + (size_t)g * cap,
        sg[1], sg[2], out + (size_t)g * 2 * N, active_rows(sg, cap),
        (it - g * nbx) * kP3t, StationaryGram<float>{kind, sg[0]}};
  };
  interval3_tiled_rows(zt, N, d, cap, stages, G * nbx, item, smem3);
}

// The tiled body of K2-3p; Wide as intervals_plan3_wg_kernel's.
template <bool Wide>
__global__ void __launch_bounds__(kThreads3t, 1)
    intervals_plan3_tiled_kernel(const float* __restrict__ zt,
                                 const float* __restrict__ xs,
                                 const unsigned char* __restrict__ tiles,
                                 const float* __restrict__ w,
                                 const float* __restrict__ scales,
                                 const float* __restrict__ pvar,
                                 const int* __restrict__ plan,
                                 const float* __restrict__ scal,
                                 float* __restrict__ out, int N, int d,
                                 int cap, int P, int stages, int plan_at) {
  extern __shared__ __align__(1024) unsigned char smem3[];
  PlanGram<float> gram;
  if constexpr (Wide) {
    gram = stage_plan<float>(smem3 + plan_at, scales, pvar, plan, P, d);
  } else {
    __shared__ PlanSmem<float> smem_plan;
    gram = smem_plan.stage(scales, pvar, plan, P, d);
  }
  const int n = active_rows(scal, cap);
  auto item = [&](int it) {
    return Item3<PlanGram<float>>{nullptr, xs, tiles, w, scal[1], scal[2],
                                  out, n, it * kP3t, gram};
  };
  interval3_tiled_rows(zt, N, d, cap, stages, (N + kP3t - 1) / kP3t, item,
                       smem3);
}

// K1-3p with C consumer warpgroups a block
template <int C>
int launch_intervals3_c(const float* zt, const float* ils, const float* xs,
                        const unsigned char* tiles, const float* w,
                        const float* scal, float* out, int G, int N, int d,
                        int cap, int kind, cudaStream_t stream) {
  auto kernel = intervals3_wg_kernel<C>;
  const size_t avail = dynamic_smem(kernel, 0);
  const Iv3Layout<C> lay = interval3_layout<C>(cap, d, avail);
  if (lay.bytes > avail) return (int)cudaErrorInvalidValue;
  int err = set_smem(kernel, lay.bytes);
  if (err) return err;
  const int items = G * ((N + kP3 - 1) / kP3);
  kernel<<<persistent_blocks(kernel, threads3<C>(), lay.bytes, items),
           threads3<C>(), lay.bytes, stream>>>(zt, ils, xs, tiles, w, scal,
                                               out, G, N, d, cap, kind,
                                               lay.res);
  return (int)cudaGetLastError();
}

// K1-3p past the resident body's capacity: the tiled body
int launch_intervals3_tiled(const float* zt, const float* ils,
                            const float* xs, const unsigned char* tiles,
                            const float* w, const float* scal, float* out,
                            int G, int N, int d, int cap, int kind,
                            cudaStream_t stream) {
  auto kernel = intervals3_tiled_kernel;
  const size_t avail = dynamic_smem(kernel, 0);
  const Iv3TiledLayout lay = interval3_tiled_layout(d, avail);
  if (lay.bytes > avail) return (int)cudaErrorInvalidValue;
  int err = set_smem(kernel, lay.bytes);
  if (err) return err;
  const int items = G * ((N + kP3t - 1) / kP3t);
  kernel<<<persistent_blocks(kernel, kThreads3t, lay.bytes, items),
           kThreads3t, lay.bytes, stream>>>(
      zt, ils, xs, tiles, w, scal, out, G, N, d, cap, kind, lay.stages);
  return (int)cudaGetLastError();
}

int launch_intervals3(const float* zt, const float* ils, const float* xs,
                      const unsigned char* tiles, const float* w,
                      const float* scal, float* out, int G, int N, int d,
                      int cap, int kind, cudaStream_t stream) {
  if (d < 1 || d > kMaxDim) return (int)cudaErrorInvalidValue;
  if (three_pass_tiled(cap))
    return launch_intervals3_tiled(zt, ils, xs, tiles, w, scal, out, G, N, d,
                                   cap, kind, stream);
  return cap <= kSmallCap3
             ? launch_intervals3_c<1>(zt, ils, xs, tiles, w, scal, out, G, N,
                                      d, cap, kind, stream)
             : launch_intervals3_c<kGroups3>(zt, ils, xs, tiles, w, scal,
                                             out, G, N, d, cap, kind, stream);
}

// K2-3p with C consumer warpgroups a block
template <int C>
int launch_intervals_plan3_c(const float* zt, const float* xs,
                             const unsigned char* tiles, const float* w,
                             const float* scales, const float* pvar,
                             const int* plan, const float* scal, float* out,
                             int N, int d, int cap, int P,
                             cudaStream_t stream) {
  const bool wide = P > kMaxLeaves;
  auto kernel = wide ? intervals_plan3_wg_kernel<C, true>
                     : intervals_plan3_wg_kernel<C, false>;
  // a wide plan follows the body's bytes at a 16-byte boundary
  const size_t avail =
      dynamic_smem(kernel, wide ? plan_bytes<float>(P, d) + 16 : 0);
  const Iv3Layout<C> lay = interval3_layout<C>(cap, d, avail);
  if (lay.bytes > avail) return (int)cudaErrorInvalidValue;
  const size_t at = (lay.bytes + 15) / 16 * 16;
  const size_t bytes = wide ? at + plan_bytes<float>(P, d) : lay.bytes;
  int err = set_smem(kernel, bytes);
  if (err) return err;
  const int items = (N + kP3 - 1) / kP3;
  kernel<<<persistent_blocks(kernel, threads3<C>(), bytes, items),
           threads3<C>(), bytes, stream>>>(zt, xs, tiles, w, scales, pvar,
                                           plan, scal, out, N, d, cap, P,
                                           lay.res, (int)at);
  return (int)cudaGetLastError();
}

// K2-3p past the resident body's capacity: the tiled body
int launch_intervals_plan3_tiled(const float* zt, const float* xs,
                                 const unsigned char* tiles, const float* w,
                                 const float* scales, const float* pvar,
                                 const int* plan, const float* scal,
                                 float* out, int N, int d, int cap, int P,
                                 cudaStream_t stream) {
  const bool wide = P > kMaxLeaves;
  auto kernel = wide ? intervals_plan3_tiled_kernel<true>
                     : intervals_plan3_tiled_kernel<false>;
  // a wide plan follows the body's bytes at a 16-byte boundary
  const size_t avail =
      dynamic_smem(kernel, wide ? plan_bytes<float>(P, d) + 16 : 0);
  const Iv3TiledLayout lay = interval3_tiled_layout(d, avail);
  if (lay.bytes > avail) return (int)cudaErrorInvalidValue;
  const size_t at = (lay.bytes + 15) / 16 * 16;
  const size_t bytes = wide ? at + plan_bytes<float>(P, d) : lay.bytes;
  int err = set_smem(kernel, bytes);
  if (err) return err;
  const int items = (N + kP3t - 1) / kP3t;
  kernel<<<persistent_blocks(kernel, kThreads3t, bytes, items), kThreads3t,
           bytes, stream>>>(zt, xs, tiles, w, scales, pvar, plan, scal, out,
                            N, d, cap, P, lay.stages, (int)at);
  return (int)cudaGetLastError();
}

int launch_intervals_plan3(const float* zt, const float* xs,
                           const unsigned char* tiles, const float* w,
                           const float* scales, const float* pvar,
                           const int* plan, const float* scal, float* out,
                           int N, int d, int cap, int P,
                           cudaStream_t stream) {
  if (P < 1 || d < 1 || d > kMaxDim) return (int)cudaErrorInvalidValue;
  if (three_pass_tiled(cap))
    return launch_intervals_plan3_tiled(zt, xs, tiles, w, scales, pvar, plan,
                                        scal, out, N, d, cap, P, stream);
  return cap <= kSmallCap3
             ? launch_intervals_plan3_c<1>(zt, xs, tiles, w, scales, pvar,
                                           plan, scal, out, N, d, cap, P,
                                           stream)
             : launch_intervals_plan3_c<kGroups3>(zt, xs, tiles, w, scales,
                                                  pvar, plan, scal, out, N,
                                                  d, cap, P, stream);
}

}  // namespace safeopt

extern "C" {

// K1-3p, float32: K1's operands with the factor as its limb chunks
// (tiles, per GP (cap_pad / 64) x (cap_pad / 32) chunks of 8 KB);
// scal[g, 3] is GP g's count.
int safeopt_intervals3_f32(const void* zt, const void* ils, const void* xs,
                           const void* tiles, const void* w, const void* scal,
                           void* out, int G, int N, int d, int cap, int kind,
                           void* stream) {
  return safeopt::launch_intervals3(
      (const float*)zt, (const float*)ils, (const float*)xs,
      (const unsigned char*)tiles, (const float*)w, (const float*)scal,
      (float*)out, G, N, d, cap, kind, (cudaStream_t)stream);
}

// K2-3p, float32: K2's operands with the factor as its limb chunks; plan
// is int32 (2, P), scal[3] the GP's count.
int safeopt_intervals_plan3_f32(const void* zt, const void* xs,
                                const void* tiles, const void* w,
                                const void* scales, const void* pvar,
                                const void* plan, const void* scal, void* out,
                                int N, int d, int cap, int P, void* stream) {
  return safeopt::launch_intervals_plan3(
      (const float*)zt, (const float*)xs, (const unsigned char*)tiles,
      (const float*)w, (const float*)scales, (const float*)pvar,
      (const int*)plan, (const float*)scal, (float*)out, N, d, cap, P,
      (cudaStream_t)stream);
}

}  // extern "C"
