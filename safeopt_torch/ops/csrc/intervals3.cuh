// Block body of the float32 three-pass interval kernels K1-3p
// (fused_intervals3.cu, intervals3_wg_kernel) and K2-3p
// (intervals_plan3_wg_kernel): one GP's interval rows over work items of
// 64 grid points, with V = Lm k taken as Lm_hi k_hi + Lm_hi k_lo + Lm_lo
// k_hi over bf16 limbs on Hopper's warpgroup tensor-core product (wgmma).
//
// Replaces, as intervals.cuh's ThreePassProduct did before it, the TPU
// kernels safeopt_tpu/ops/fused_posterior.py::_interval_kernel_multi
// (:454) and ::_interval_kernel (:294) at three_pass=True: their product
// (:513-528 and :313, through _tri_matmul(three_pass=True), :112-144).
//
//   k[c]  = gram(xs[c], z)               difference form, c < n
//   V[r]  = sum_{c <= r} Lm[r, c] k[c]   three bf16 limb products
//   mu    = sum_r w[r] V[r],  var = max(kdiag - sum_r V[r]^2, 0)
//   out   = (mu - beta sqrt(var), mu + beta sqrt(var))
//
// What bounds it on the H100: the operations, 3 n(n+1) flops a point
// and GP of the limb products on the bf16 tensor cores, with the gram
// and its limb cut on the FP32 pipe beside them; not device memory. What
// the design does about it:
//
// - Limbs cut once. The factor's limbs are cut once per call by the
//   wrapper (split_limbs, bit for bit the plain version's) and laid out
//   in the order the kernel reads them: chunks of 64 rows by kKC3
//   columns, hi then lo, each in wgmma's no-swizzle core-matrix order (8
//   rows of 16 bytes). One cp.async.bulk lands a chunk ready to use. The
//   gram's limbs are cut once per block, as the gram is filled, into the
//   same order (hi and lo bf16 take the 4 bytes an entry that a float32
//   gram takes).
// - The product on wgmma. m64n64k16 with A the factor's limbs (64 rows)
//   and B the gram's (the block's 64 points), both from shared memory,
//   three instructions per k16 step in the order above, float32
//   accumulators in registers. Only the active rows: row tile m
//   contracts over columns [0, min(64 (m + 1), n)), n read from the
//   device; past n, Lm is exactly zero.
// - The factor shared by 64 points. A producer warp per consumer
//   warpgroup keeps kStages3 chunks in flight on mbarriers; the consumer
//   warpgroups (three a block past capacity kSmallCap3) take the row
//   tiles, largest first, each to the one with less work so far (a
//   function of n alone). Every item of 64 points reads the executed
//   triangle once: 4 bytes an entry.
// - Persistent blocks. The blocks that fit the card at once walk over
//   the work items, and the rings keep streaming from one item into the
//   next. Past kSmallCap3 a block takes a multiprocessor's shared memory;
//   at and below it (at most two row tiles, where two of three
//   warpgroups would idle) a block has one consumer warpgroup and three
//   share a multiprocessor, so that one's gram overlaps another's
//   products.
// - The gram resident. A block keeps the gram limbs of its item's points
//   for the first `res` rows (every row at the certified path's
//   capacities, 512 and 256); past them a warpgroup computes each
//   chunk's gram itself, as it comes to it (larger capacities run,
//   slower).
// - Deterministic sums. Each thread adds its two rows' w V and V^2 per
//   point, a butterfly adds a warp's 16 rows, each warp adds its tiles in
//   its fixed order, and the block adds the warps in order: the same bits
//   whatever the scheduling (the certified path compares runs).
//
// On the H100 (tools_torch/tune_three_pass.py, PERF.md): three consumer
// warpgroups with three chunks in flight each were faster than two with
// four or four with two; the factor's loads cost about 2 % (a copy
// without them); each limb product beyond the first runs near 75 % of
// the tensor cores' peak (m64n64k16, both operands in shared memory;
// the factor's limbs from registers spilled at this register budget and
// were slower); the gram, computed before each item's products, is about
// a quarter of the time: computed between the products (by the
// consumer warpgroups, or by a warpgroup of its own) it took issue slots
// the tensor cores wait on, and the kernel was slower.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "limbs.cuh"

namespace safeopt {

constexpr int kTM3 = 64;       // rows of a factor tile: wgmma's M
constexpr int kP3 = 64;        // points of a work item: wgmma's N
constexpr int kKC3 = 32;       // columns of a factor chunk (a ring stage)
constexpr int kStages3 = 3;    // chunks in flight per ring
// Consumer warpgroups of a block (C below), a ring and a producer warp
// each: kGroups3 past capacity kSmallCap3, one at and below it, where a
// GP has at most two row tiles and several blocks share a multiprocessor
constexpr int kGroups3 = 3;
constexpr int kSmallCap3 = 128;
template <int C>
constexpr int threads3() {
  return (128 + 32) * C;
}
// bytes of one limb of a chunk, of a chunk (hi, lo), of a gram k8 group
// of one limb (8 rows of the 64 points)
constexpr int kLimbBytes3 = kTM3 * kKC3 * 2;
constexpr int kChunkBytes3 = 2 * kLimbBytes3;
constexpr int kGroupBytes3 = 8 * kP3 * 2;
static_assert(kKC3 % 16 == 0 && kTM3 % kKC3 == 0, "k16 steps in a chunk");
// named barriers (bar.sync ids): the consumer warps', a consumer
// warpgroup's (+ its index)
constexpr int kBarConsumers3 = 1;
constexpr int kBarGroup3 = 2;

// Byte offsets of the block's dynamic shared memory: the rings, the
// resident gram limbs (res rows), the warpgroups' gram chunks past them,
// the points (d x 64), the warps' partial sums per point and the rings'
// full and empty barriers.
template <int C>
struct Iv3Layout {
  int res;
  size_t ring, ghi, glo, scratch, zs, red, bars, bytes;

  __host__ __device__ Iv3Layout(int cap, int d, int res_) : res(res_) {
    const int cap_pad = (cap + kTM3 - 1) / kTM3 * kTM3;
    size_t o = 0;
    ring = o;
    o += (size_t)C * kStages3 * kChunkBytes3;
    ghi = o;
    o += (size_t)res * kP3 * 2;
    glo = o;
    o += (size_t)res * kP3 * 2;
    scratch = o;
    if (res < cap_pad) o += (size_t)C * kKC3 * kP3 * 4;
    zs = o;
    o += sizeof(float) * (size_t)d * kP3;
    red = o;
    o += sizeof(float) * 2 * 4 * C * kP3;
    bars = o;
    o += sizeof(uint64_t) * 2 * C * kStages3;
    bytes = o;
  }
};

// The layout of a launch with avail bytes of dynamic shared memory: the
// most resident rows, a multiple of kKC3, that fit.
template <int C>
inline Iv3Layout<C> interval3_layout(int cap, int d, size_t avail) {
  const int cap_pad = (cap + kTM3 - 1) / kTM3 * kTM3;
  for (int res = cap_pad; res > 0; res -= kKC3) {
    const Iv3Layout<C> lay(cap, d, res);
    if (lay.bytes <= avail) return lay;
  }
  return Iv3Layout<C>(cap, d, 0);  // too large for the card: the launch fails
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers (PTX ISA: mbarrier): a barrier's phase completes when its
// arrivals (and, for the full barriers, the bytes of the bulk copy it
// expects) are in; a wait on parity ph returns once the phase of that
// parity has completed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the copy engine; their arrival completes on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// shared-memory stores of this thread made visible to the async proxy
// (the tensor cores' operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A wgmma shared-memory matrix descriptor, no swizzle: core matrices of 8
// rows by 16 bytes, stored as 128 contiguous bytes; lbo is the byte
// distance between core matrices adjacent along k, sbo along m (n).
__device__ __forceinline__ uint64_t wg_desc(const void* smem, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d += A B: A 64 x 16 and B 16 x 64 bf16 (descriptors a, b, both k
// contiguous), d the warpgroup's float32 accumulator fragment: d[4 j + 2
// h + e] is row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e.
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// Gram limbs for the block's 64 points: task t = 64 j + p of [t0, t1) is
// point p's rows 8 (g0 + j) .. 8 (g0 + j) + 7, cut to limbs and stored as
// one 16-byte vector per limb at hi/lo + j kGroupBytes3 + (p / 8) 128 +
// (p % 8) 16 (the core-matrix order, k contiguous). Rows at or past n
// are zeros. Tasks are spread over the threads tid = 0 .. threads - 1. D
// as fill_gram's (intervals.cuh).
template <int D, class Gram>
__device__ __forceinline__ void fill_gram3(unsigned char* hi, unsigned char* lo,
                                           const float* __restrict__ xs,
                                           const float* zs, int g0, int t0,
                                           int t1, int n, int d,
                                           const Gram& gram, int tid,
                                           int threads) {
  const int dd = D > 0 ? D : d;
  for (int t = t0 + tid; t < t1; t += threads) {
    const int j = t / kP3, p = t - j * kP3;
    const int r0 = 8 * (g0 + j);
    float v[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* x[4];
      float u[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r0 + 4 * h + r;
        x[r] = xs + (size_t)(row < n ? row : 0) * dd;
      }
      gram.template rows<4>(u, x, zs, p, dd, kP3);
#pragma unroll
      for (int r = 0; r < 4; ++r) v[4 * h + r] = r0 + 4 * h + r < n ? u[r] : 0.0f;
    }
    uint32_t h4[4], l4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_pack_bf16(v[2 * e], v[2 * e + 1], h4[e], l4[e]);
    const size_t o = (size_t)j * kGroupBytes3 + (p >> 3) * 128 + (p & 7) * 16;
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h4[0], h4[1], h4[2], h4[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(l4[0], l4[1], l4[2], l4[3]);
  }
}

template <class Gram>
__device__ __forceinline__ void fill_gram3_d(unsigned char* hi,
                                             unsigned char* lo,
                                             const float* __restrict__ xs,
                                             const float* zs, int g0, int t0,
                                             int t1, int n, int d,
                                             const Gram& gram, int tid,
                                             int threads) {
  switch (d) {
    case 1: fill_gram3<1>(hi, lo, xs, zs, g0, t0, t1, n, d, gram, tid, threads); break;
    case 2: fill_gram3<2>(hi, lo, xs, zs, g0, t0, t1, n, d, gram, tid, threads); break;
    case 3: fill_gram3<3>(hi, lo, xs, zs, g0, t0, t1, n, d, gram, tid, threads); break;
    case 4: fill_gram3<4>(hi, lo, xs, zs, g0, t0, t1, n, d, gram, tid, threads); break;
    default: fill_gram3<0>(hi, lo, xs, zs, g0, t0, t1, n, d, gram, tid, threads);
  }
}

// The row tiles of warpgroup r at count n, in the order it runs them:
// tiles largest first (the last, whose columns end at n, may be shorter
// than the one before it), each to the warpgroup with less work so far
// (in k16 steps; ties to warpgroup 0). f(m) for each of r's tiles.
template <int C, class F>
__device__ __forceinline__ void for_my_tiles(int n, int r, F&& f) {
  const int mt = (n + kTM3 - 1) / kTM3;
  int load[C] = {};
  for (int m = mt - 1; m >= 0; --m) {
    const int kend = kTM3 * (m + 1) < n ? kTM3 * (m + 1) : n;
    int o = 0, least = load[0];
#pragma unroll
    for (int q = 1; q < C; ++q)
      if (load[q] < least) {
        o = q;
        least = load[q];
      }
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (q == o) load[q] += (kend + 15) / 16;
    if (o == r) f(m, kend);
  }
}

// One work item: the 64 points from i0 of one GP.
template <class Gram>
struct Item3 {
  const float* ils;                  // the GP's point scales (null: raw)
  const float* xs;                   // (cap, d) inputs
  const unsigned char* tiles;        // the factor's limb chunks
  const float* w;                    // (cap) weights
  float kdiag, beta;
  float* out;                        // the GP's (2, N) rows
  int n, i0;
  Gram gram;
};

// Interval rows of `items` work items (item(i) gives item i), each block
// taking items blockIdx.x, blockIdx.x + gridDim.x, ...: the rings keep
// streaming across a block's items. zt (d, N) is the grid; tiles hold
// per GP (cap_pad / 64) x (cap_pad / kKC3) chunks of kChunkBytes3, row
// tile major; res the resident gram rows of interval3_layout.
//
// Each item's resident gram is computed by all consumer threads before
// its first product (see the note at the top).
template <int C, class ItemF>
__device__ __forceinline__ void interval3_rows(const float* __restrict__ zt,
                                               int N, int d, int cap, int res,
                                               int items, ItemF item,
                                               unsigned char* smem) {
  constexpr int kCons = 128 * C, kWarps = 4 * C;  // consumer threads, warps
  const Iv3Layout<C> lay(cap, d, res);
  unsigned char* ring = smem + lay.ring;
  unsigned char* ghi = smem + lay.ghi;
  unsigned char* glo = smem + lay.glo;
  float* zs = reinterpret_cast<float*>(smem + lay.zs);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + C * kStages3;
  const int nq = (cap + kTM3 - 1) / kTM3 * kTM3 / kKC3;  // chunks a tile row

  if (threadIdx.x == 0) {
    for (int s = 0; s < C * kStages3; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);  // a consumer warpgroup's four warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kCons) {
    // producer warp r: ring r's chunks, in the order warpgroup r runs them
    const int r = (threadIdx.x - kCons) >> 5;
    if ((threadIdx.x & 31) != 0) return;
    uint64_t* f = full + r * kStages3;
    uint64_t* e = empty + r * kStages3;
    unsigned char* buf = ring + (size_t)r * kStages3 * kChunkBytes3;
    int s = 0;
    uint32_t ph = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const unsigned char* tiles = item(it).tiles;
      for_my_tiles<C>(item(it).n, r, [&](int m, int kend) {
        const unsigned char* src = tiles + (size_t)m * nq * kChunkBytes3;
        for (int k0 = 0; k0 < kend; k0 += kKC3) {
          mbar_wait(e + s, ph ^ 1);
          mbar_expect_tx(f + s, kChunkBytes3);
          bulk_load(buf + (size_t)s * kChunkBytes3,
                    src + (size_t)(k0 / kKC3) * kChunkBytes3, kChunkBytes3,
                    f + s);
          if (++s == kStages3) {
            s = 0;
            ph ^= 1;
          }
        }
      });
    }
    return;
  }

  // consumers: thread ct of warpgroup wg
  const int ct = threadIdx.x;
  const int wg = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wq = ct >> 5;                 // warp of the block
  uint64_t* f = full + wg * kStages3;
  uint64_t* e = empty + wg * kStages3;
  unsigned char* buf = ring + (size_t)wg * kStages3 * kChunkBytes3;
  const uint64_t a0 = wg_desc(buf, kGroupBytes3, 128);  // stage 0's hi limb
  unsigned char* shi = smem + lay.scratch + (size_t)wg * kKC3 * kP3 * 4;
  unsigned char* slo = shi + kKC3 * kP3 * 2;
  float* red_m = red + wq * kP3;          // this warp's sums per point
  float* red_q = red + (kWarps + wq) * kP3;
  int s = 0;
  uint32_t ph = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const auto I = item(it);
    const int n = I.n;
    const int nk = (n + 15) / 16 * 16;
    const int rows = nk < res ? nk : res;   // resident gram rows to compute

    // 1. the points and the resident gram limbs (rows past n zero up to
    // the last k16 step); the barrier first: the last item's products are
    // done
    named_sync(kBarConsumers3, kCons);
    for (int t = ct; t < d * kP3; t += kCons) {
      const int k = t / kP3;
      const int i = I.i0 + t - k * kP3;
      const float z = i < N ? zt[(size_t)k * N + i] : 0.0f;
      zs[t] = I.ils != nullptr ? z * I.ils[k] : z;
    }
    for (int p = lane; p < kP3; p += 32) red_m[p] = red_q[p] = 0.0f;
    named_sync(kBarConsumers3, kCons);
    fill_gram3_d(ghi, glo, I.xs, zs, 0, 0, rows / 8 * kP3, n, d, I.gram, ct,
                 kCons);
    fence_proxy_async();
    named_sync(kBarConsumers3, kCons);

    // 2. this warpgroup's row tiles: V of 64 rows x 64 points on wgmma
    for_my_tiles<C>(n, wg, [&](int m, int kend) {
      // this thread's rows r0, r0 + 8 of the tile
      const int r0 = kTM3 * m + 16 * warp + gid;
      const float w0 = r0 < n ? I.w[r0] : 0.0f;
      const float w1 = r0 + 8 < n ? I.w[r0 + 8] : 0.0f;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      fence_acc(acc);
      int prev = -1;
      for (int k0 = 0; k0 < kend; k0 += kKC3) {
        const unsigned char *bh, *bl;
        if (k0 < res) {
          bh = ghi + (size_t)(k0 / 8) * kGroupBytes3;
          bl = glo + (size_t)(k0 / 8) * kGroupBytes3;
        } else {  // past the resident rows: this chunk's gram, here
          wg_wait<0>();
          fence_acc(acc);
          if (prev >= 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(e + prev);
            prev = -1;
          }
          named_sync(kBarGroup3 + wg, 128);  // the last chunk's reads are done
          fill_gram3_d(shi, slo, I.xs, zs, k0 / 8, 0, kKC3 / 8 * kP3, n, d,
                       I.gram, ct & 127, 128);
          fence_proxy_async();
          named_sync(kBarGroup3 + wg, 128);
          bh = shi;
          bl = slo;
        }
        const int steps = (kend - k0 + 15) / 16 < kKC3 / 16
                              ? (kend - k0 + 15) / 16 : kKC3 / 16;
        mbar_wait(f + s, ph);
        wg_fence();
        // descriptors of the stage's limbs and the gram's, advanced in
        // the start address field (16-byte units) by a k16 step, two k8
        // groups
        const uint64_t ahi = a0 + (uint64_t)(s * kChunkBytes3 >> 4);
        const uint64_t alo = ahi + (kLimbBytes3 >> 4);
        const uint64_t bhi = wg_desc(bh, kGroupBytes3, 128);
        const uint64_t blo = wg_desc(bl, kGroupBytes3, 128);
#pragma unroll
        for (int jj = 0; jj < kKC3 / 16; ++jj)
          if (jj < steps) {
            const uint64_t o = (uint64_t)jj * (2 * kGroupBytes3 >> 4);
            wgmma_64x64(acc, ahi + o, bhi + o);
            wgmma_64x64(acc, ahi + o, blo + o);
            wgmma_64x64(acc, alo + o, bhi + o);
          }
        wg_commit();
        if (prev >= 0) {  // the chunk before this one is read: release it
          wg_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(e + prev);
        }
        prev = s;
        if (++s == kStages3) {
          s = 0;
          ph ^= 1;
        }
      }
      wg_wait<0>();
      fence_acc(acc);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(e + prev);
      }
      // w V and V^2 of the two rows, added over the warp's 16 rows; the
      // warp's sums per point gather its tiles in its fixed order
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v0 = acc[4 * jn + c], v1 = acc[4 * jn + 2 + c];
          float mm = w0 * v0 + w1 * v1;
          float qq = v0 * v0 + v1 * v1;
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            mm += __shfl_xor_sync(0xffffffffu, mm, o);
            qq += __shfl_xor_sync(0xffffffffu, qq, o);
          }
          if (gid == 0) {
            const int p = 8 * jn + 2 * tig + c;
            red_m[p] += mm;
            red_q[p] += qq;
          }
        }
    });

    // 3. the warps' sums per point, added in warp order
    named_sync(kBarConsumers3, kCons);
    if (ct < kP3 && I.i0 + ct < N) {
      float mu = 0.0f, q = 0.0f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        mu += red[v * kP3 + ct];
        q += red[(kWarps + v) * kP3 + ct];
      }
      const float var = I.kdiag - q;
      const float spread = I.beta * sqrtf(var > 0.0f ? var : 0.0f);
      I.out[I.i0 + ct] = mu - spread;
      I.out[N + I.i0 + ct] = mu + spread;
    }
  }
}

}  // namespace safeopt
