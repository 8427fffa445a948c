// Block body of the float32 three-pass interval kernels past the resident
// gram (fused_intervals3.cu, intervals3_tiled_kernel and
// intervals_plan3_tiled_kernel): one GP's interval rows over work items
// of 128 grid points, for the capacities whose gram limbs intervals3.cuh
// cannot keep resident (past kResidentCap3). It stands for the same TPU
// kernels, safeopt_tpu/ops/fused_posterior.py::_interval_kernel_multi
// (:454) and ::_interval_kernel (:294) at three_pass=True (their product
// :513-528 and :313, through _tri_matmul(three_pass=True), :112-144), and
// computes the same function as the resident body:
//
//   k[c]  = gram(xs[c], z)               difference form, c < n
//   V[r]  = sum_{c <= r} Lm[r, c] k[c]   three bf16 limb products
//   mu    = sum_r w[r] V[r],  var = max(kdiag - sum_r V[r]^2, 0)
//   out   = (mu - beta sqrt(var), mu + beta sqrt(var))
//
// What bounds it on the H100: the limb products' 3 n(n+1) flops a point
// on the bf16 tensor cores (12.1 ms for 1e6 points at n = 2000). Two
// costs stand beside them past the resident rows, and the resident body
// paid both in full: the gram, which each of its warpgroups computed per
// 32-column chunk of every row tile, between its own products (about
// 20,400 entries a point at n = 2000), and the factor, which every item
// of 64 points streamed from L2 at 4 bytes an entry (about 135 GB a
// launch at n = 2000). A gram entry costs about 0.4 multiprocessor
// cycles (an exponential and the limb cut, tools_torch/tune_three_pass.py
// no_product), and more warps hide more of it. What this body does:
//
// - Bands of rows, aligned to the triangle's end. A block takes an item
//   of kP3t = 128 points (wgmma's N; 64 accumulators a thread) and walks
//   the triangle in bands of kGroups3t = 4 row tiles (256 rows), one
//   64-row tile per warpgroup; the short band, if any, is the first,
//   whose columns are fewest. A band's columns come in steps of kStep3t
//   = 96, three factor chunks.
// - The gram once a band, by every thread. A step's gram limbs (96
//   columns x 128 points) are computed once for the band, three tasks of
//   8 rows a thread, into a double buffer that every warpgroup's products
//   read: about 9,200 entries a point at n = 2000, 1,100 at n = 600.
// - The gram beside the products. A warpgroup issues a chunk's products
//   (wgmma is asynchronous), computes a task of the next step's gram
//   while they run, issues the next chunk's, and so on; one barrier a
//   step. The limbs of two entries are cut by one packed conversion.
// - Four warpgroups and no producer warps: a warpgroup's first thread
//   loads its own ring (cp.async.bulk on mbarriers), the next chunk into
//   a stage as soon as the products that read it are done. Sixteen warps
//   a block (128 registers a thread) hide the gram's latency that twelve
//   did not. At that budget the K2-3p instances spill 36-48 bytes (the
//   plan gram's leaf loop); two rows a plan call, or the cursor below in
//   shared memory, spilled less and ran slower.
// - Half the factor bytes a point: each chunk serves 128 points, not 64.
// - Kept from the resident body: the factor's limb chunks
//   (ops/fused_posterior.py factor_chunks), persistent blocks, and sums
//   in a fixed order (each warp adds its bands' tiles in band order, the
//   block adds the warps in order).
//
// The body takes the limb format as the resident one does (Limbs3 in
// intervals3.cuh): the experiment B4 runs it in tf32 (m64n128k8, chunks
// of 16 columns and steps of 48, the same bytes a stage, a step's gram
// and a block as in bf16, so the same ring stages fit) and with the
// factor's limbs cut in the kernel (interval_experiments3.cu).
#pragma once

#include "intervals3.cuh"
#include "intervals_tiled.cuh"

namespace safeopt {

constexpr int kP3t = 128;                  // points of a work item: wgmma's N
// warpgroups of a block, and row tiles of a band (one each)
constexpr int kGroups3t = 4;
constexpr int kThreads3t = 128 * kGroups3t;
// factor chunks a step; its gram columns are kStep3t<L> (96 in bf16, 48
// in tf32)
constexpr int kChunksStep3t = 3;
template <class L>
constexpr int kStep3t = kChunksStep3t * L::kKC;
// bytes of a core-matrix column of one gram limb (16 bytes of each of the
// 128 points: 8 rows in bf16, 4 in tf32), of one limb of a step's gram
// (the same in either format)
constexpr int kGroupBytes3t = 16 * kP3t;
constexpr int kStepBytes3t = kStep3t<Bf16Limbs3> / 8 * kGroupBytes3t;
// gram tasks (a core-matrix row of a point) of a step per thread, and the
// slots of a step: a chunk's products issued, then a task computed
constexpr int kTasks3t = kStepBytes3t / kGroupBytes3t * kP3t / kThreads3t;
static_assert(kTasks3t * kThreads3t == kStepBytes3t / kGroupBytes3t * kP3t,
              "whole gram tasks a thread");
static_assert(kStep3t<Limbs3<true, false>> / 4 * kGroupBytes3t ==
                  kStepBytes3t,
              "a step's gram limbs take the same bytes in tf32");
constexpr int kSlots3t =
    kTasks3t > kChunksStep3t ? kTasks3t : kChunksStep3t;
// The largest capacity whose gram rows intervals3.cuh keeps resident in
// full (interval3_layout with three consumer warpgroups: 576 rows x 256
// bytes beside its rings); the launchers take this body past it.
constexpr int kResidentCap3 = 576;

// Byte offsets of the block's dynamic shared memory: a ring of `stages`
// chunks per warpgroup, two steps of gram limbs (hi, lo), the points (d
// x 128), the warps' partial sums per point and the rings' barriers.
struct Iv3TiledLayout {
  int stages;
  size_t ring, gram, zs, red, bars, bytes;

  __host__ __device__ Iv3TiledLayout(int d, int stages_) : stages(stages_) {
    size_t o = 0;
    ring = o;
    o += (size_t)kGroups3t * stages * kChunkBytes3;
    gram = o;
    o += 2 * 2 * (size_t)kStepBytes3t;
    zs = o;
    o += sizeof(float) * (size_t)d * kP3t;
    red = o;
    o += sizeof(float) * 2 * 4 * kGroups3t * kP3t;
    bars = o;
    o += sizeof(uint64_t) * kGroups3t * stages;
    bytes = o;
  }
};

// The most chunks in flight per ring that fit, from a step's three and
// the next step's first down to 2 (the same in either limb format).
inline Iv3TiledLayout interval3_tiled_layout(int d, size_t avail) {
  for (int stages = kChunksStep3t + 1; stages > 2; --stages) {
    const Iv3TiledLayout lay(d, stages);
    if (lay.bytes <= avail) return lay;
  }
  return Iv3TiledLayout(d, 2);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B: A 64 x 16 and B 16 x 128 bf16 (descriptors a, b, both k
// contiguous), d the warpgroup's float32 fragment: d[4 j + 2 h + e] is
// row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e.
__device__ __forceinline__ void wgmma_64x128(float (&d)[64], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}
// The same product in tf32 (m64n128k8, both operands k contiguous)
__device__ __forceinline__ void wgmma_64x128_tf32(float (&d)[64], uint64_t a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}
template <class L>
__device__ __forceinline__ void wg_mma(float (&d)[64], uint64_t a,
                                       uint64_t b) {
  if constexpr (L::kTf32)
    wgmma_64x128_tf32(d, a, b);
  else
    wgmma_64x128(d, a, b);
}

// mbar_wait with the spin inside one asm statement: the caller's control
// flow stays warp-uniform to the compiler, which otherwise serializes the
// wgmma issued after a divergent C++ loop.
__device__ __forceinline__ void mbar_wait_uniform(uint64_t* bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// waits until at most `pending` (0 or 1) of the warpgroup's committed
// product groups are still running
__device__ __forceinline__ void wg_wait_pending(int pending) {
  if (pending > 0)
    wg_wait<1>();
  else
    wg_wait<0>();
}

// Gram task of a step whose first column is k0 for point p: the
// core-matrix column j, rows k0 + kCoreK j .. k0 + kCoreK (j + 1) - 1 (8
// in bf16, 4 in tf32), cut to limbs and stored as one 16-byte vector per
// limb at hi/lo + j kGroupBytes3t + (p / 8) 128 + (p % 8) 16 (fill_gram3's
// core-matrix order). Rows at or past lim are zeros (a group wholly past
// it is not computed); a group wholly below it takes its rows from one
// base, with no per-row clamp. Each row's entry goes to mu.add (NoMuSum3
// or MuSum3, intervals3.cuh). D as tile_gram's (intervals_tiled.cuh): a
// plan takes PlanGram::rows_d, the same bits as the resident body's rows.
template <int D, class L, class Gram, class Mu>
__device__ __forceinline__ void gram_task3t(unsigned char* hi,
                                            unsigned char* lo,
                                            const float* __restrict__ xs,
                                            const float* zs, int k0, int j,
                                            int p, int lim, int d,
                                            const Gram& gram, Mu&& mu) {
  const int dd = D > 0 ? D : d;
  const int r0 = k0 + L::kCoreK * j;
  float v[L::kCoreK];
#pragma unroll
  for (int h = 0; h < L::kCoreK / 4; ++h) {
    const float* x[4];
    float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r0 + L::kCoreK <= lim) {
#pragma unroll
      for (int r = 0; r < 4; ++r) x[r] = xs + (size_t)(r0 + 4 * h + r) * dd;
      tile_rows<D>(gram, u, x, zs, p, dd, kP3t);
    } else if (r0 < lim) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r0 + 4 * h + r;
        x[r] = xs + (size_t)(row < lim ? row : 0) * dd;
      }
      tile_rows<D>(gram, u, x, zs, p, dd, kP3t);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r0 + 4 * h + r >= lim) u[r] = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      v[4 * h + r] = u[r];
      mu.add(r0 + 4 * h + r, u[r]);
    }
  }
  uint4 h4, l4;
  if constexpr (L::kTf32) {
    split_tf32x4(v, h4, l4);
  } else {
    split_pack_bf16x2(v[0], v[1], h4.x, l4.x);
    split_pack_bf16x2(v[2], v[3], h4.y, l4.y);
    split_pack_bf16x2(v[4], v[5], h4.z, l4.z);
    split_pack_bf16x2(v[6], v[7], h4.w, l4.w);
  }
  const size_t o = (size_t)j * kGroupBytes3t + (p >> 3) * 128 + (p & 7) * 16;
  *reinterpret_cast<uint4*>(hi + o) = h4;
  *reinterpret_cast<uint4*>(lo + o) = l4;
}

template <class L, class Gram, class Mu>
__device__ __forceinline__ void gram_task3t_d(unsigned char* hi,
                                              unsigned char* lo,
                                              const float* __restrict__ xs,
                                              const float* zs, int k0, int j,
                                              int p, int lim, int d,
                                              const Gram& gram, Mu&& mu) {
  switch (d) {
    case 1: gram_task3t<1, L>(hi, lo, xs, zs, k0, j, p, lim, d, gram, mu); break;
    case 2: gram_task3t<2, L>(hi, lo, xs, zs, k0, j, p, lim, d, gram, mu); break;
    case 3: gram_task3t<3, L>(hi, lo, xs, zs, k0, j, p, lim, d, gram, mu); break;
    case 4: gram_task3t<4, L>(hi, lo, xs, zs, k0, j, p, lim, d, gram, mu); break;
    default: gram_task3t<0, L>(hi, lo, xs, zs, k0, j, p, lim, d, gram, mu);
  }
}

// The bands of a count n (mt row tiles, nb bands of kGroups3t tiles,
// one a warpgroup) are aligned to the triangle's end: band nb - 1 holds
// the last tiles, band 0 the first tiles that are left (a count whose
// tiles are no multiple of a band leaves band 0 short, where the columns
// are fewest). band_tile gives warpgroup w's tile of band b (negative:
// none), band_end the end of the band's columns (its last tile's).
__device__ __forceinline__ int band_tile(int mt, int nb, int b, int w) {
  return mt - kGroups3t * (nb - b) + w;
}
__device__ __forceinline__ int band_end(int n, int mt, int nb, int b) {
  const int end = kTM3 * (mt - kGroups3t * (nb - b - 1));
  return end < n ? end : n;
}

// The factor chunk a warpgroup loads next, in the order it runs them: its
// tile of each band of its block's items, columns in order (invalid past
// the last).
template <class L, class ItemF>
struct ChunkCursor3 {
  const ItemF& item;
  int items, w, nq;
  int it, n, mt, nb, b, m, q, chunks;
  const unsigned char* tiles;

  __device__ __forceinline__ ChunkCursor3(const ItemF& item_, int items_,
                                          int w_, int nq_)
      : item(item_), items(items_), w(w_), nq(nq_), it(blockIdx.x), b(0) {
    first();
  }
  // the first chunk from band b of item it on
  __device__ __forceinline__ void first() {
    for (; it < items; it += gridDim.x, b = 0) {
      if (b == 0) {
        const auto I = item(it);
        n = I.n;
        tiles = I.tiles;
        mt = (n + kTM3 - 1) / kTM3;
        nb = (mt + kGroups3t - 1) / kGroups3t;
      }
      for (; b < nb; ++b) {
        m = band_tile(mt, nb, b, w);
        if (m >= 0) {
          const int kend = kTM3 * (m + 1) < n ? kTM3 * (m + 1) : n;
          chunks = (kend + L::kKC - 1) / L::kKC;
          q = 0;
          return;
        }
      }
    }
  }
  __device__ __forceinline__ bool valid() const { return it < items; }
  __device__ __forceinline__ const unsigned char* src() const {
    return tiles + ((size_t)m * nq + q) * L::kLanded;
  }
  __device__ __forceinline__ void advance() {
    if (++q == chunks) {
      ++b;
      first();
    }
  }
};

// w V (not with Mu) and V^2 of the thread's two rows r0, r0 + 8 of a
// finished tile, added over the warp's 16 rows into the warp's sums per
// point
template <bool Mu = false>
__device__ __forceinline__ void tile_sums3t(const float (&acc)[64],
                                            const float* __restrict__ w,
                                            int r0, int n, int gid, int tig,
                                            float* red_m, float* red_q) {
  const float w0 = r0 < n ? w[r0] : 0.0f;
  const float w1 = r0 + 8 < n ? w[r0 + 8] : 0.0f;
#pragma unroll
  for (int jn = 0; jn < kP3t / 8; ++jn)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float v0 = acc[4 * jn + c], v1 = acc[4 * jn + 2 + c];
      float mm = w0 * v0 + w1 * v1;
      float qq = v0 * v0 + v1 * v1;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        if constexpr (!Mu) mm += __shfl_xor_sync(0xffffffffu, mm, o);
        qq += __shfl_xor_sync(0xffffffffu, qq, o);
      }
      if (gid == 0) {
        const int p = 8 * jn + 2 * tig + c;
        if constexpr (!Mu) red_m[p] += mm;
        red_q[p] += qq;
      }
    }
}

// one chunk's three limb products into acc: the stage's factor limbs at
// descriptor ahi (lo 4 KB on) against the gram chunk's limbs at g0, ks
// k-steps
template <class L>
__device__ __forceinline__ void chunk_products3t(float (&acc)[64],
                                                 uint64_t ahi,
                                                 const unsigned char* g0,
                                                 int ks) {
  const uint64_t alo = ahi + (kLimbBytes3 >> 4);
  const uint64_t bhi = wg_desc(g0, kGroupBytes3t, 128);
  const uint64_t blo = wg_desc(g0 + kStepBytes3t, kGroupBytes3t, 128);
#pragma unroll
  for (int jj = 0; jj < L::kKC / L::kK; ++jj)
    if (jj < ks) {
      const uint64_t oa = (uint64_t)jj * (2 * kGroupBytes3 >> 4);
      const uint64_t ob = (uint64_t)jj * (2 * kGroupBytes3t >> 4);
      wg_mma<L>(acc, ahi + oa, bhi + ob);
      wg_mma<L>(acc, ahi + oa, blo + ob);
      wg_mma<L>(acc, alo + oa, bhi + ob);
    }
}

// Interval rows of `items` work items of kP3t points (item(i) gives item
// i, its i0 a multiple of kP3t), each block taking items blockIdx.x,
// blockIdx.x + gridDim.x, ...; zt (d, N) is the grid; tiles hold per GP
// (cap_pad / 64) x (cap_pad / L::kKC) chunks of L::kLanded bytes, row
// tile major; stages the chunks in flight per ring
// (interval3_tiled_layout).
//
// Mu (the experiment B3-3p): the item's w holds u = Lm^T w and mu is
// sum_c u[c] k[c], added from each gram entry before its limb cut, and
// no warp multiplies w into V. Every band computes its steps' gram anew;
// only the last band's steps, whose columns end at n and so cover every
// active column once, add u k. Thread ct serves point ct % 128 in every
// task and adds its entries in one register; the block adds the four
// registers of a point in thread order: the same bits on every launch.
template <class L = Bf16Limbs3, bool Mu = false, class ItemF>
__device__ __forceinline__ void interval3_tiled_rows(
    const float* __restrict__ zt, int N, int d, int cap, int stages,
    int items, ItemF item, unsigned char* smem) {
  constexpr int C = kGroups3t;
  constexpr int kWarps = 4 * C;
  const Iv3TiledLayout lay(d, stages);
  unsigned char* ring = smem + lay.ring;
  unsigned char* gram = smem + lay.gram;
  float* zs = reinterpret_cast<float*>(smem + lay.zs);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  // chunks a tile row
  const int nq = (cap + kTM3 - 1) / kTM3 * kTM3 / L::kKC;
  constexpr int kStep = kStep3t<L>;       // gram columns of a step

  if (threadIdx.x == 0) {
    for (int s = 0; s < C * stages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread ct of warpgroup wg (broadcast from lane 0, so that the
  // compiler sees it, and every value that follows from it, warp-uniform)
  const int ct = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, ct >> 7, 0);
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wq = ct >> 5;                 // warp of the block
  uint64_t* f = full + wg * stages;
  unsigned char* buf = ring + (size_t)wg * stages * kChunkBytes3;
  const uint64_t a0 = wg_desc(buf, kGroupBytes3, 128);  // stage 0's hi limb
  float* red_m = red + wq * kP3t;         // this warp's sums per point
  float* red_q = red + (kWarps + wq) * kP3t;
  // the warpgroup's first thread loads its ring: the next chunk into a
  // stage as soon as the products that read the stage are done
  const bool loader = (ct & 127) == 0;
  ChunkCursor3<L, ItemF> cursor(item, items, wg, nq);
  auto load = [&](int st) {
    if (loader && cursor.valid()) {
      mbar_expect_tx(f + st, L::kLanded);
      bulk_load(buf + (size_t)st * kChunkBytes3, cursor.src(), L::kLanded,
                f + st);
      cursor.advance();
    }
  };
  for (int st = 0; st < stages; ++st) load(st);
  int s = 0;
  uint32_t ph = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const auto I = item(it);
    const int n = __shfl_sync(0xffffffffu, I.n, 0);
    const int mt = (n + kTM3 - 1) / kTM3;        // row tiles
    const int nb = (mt + kGroups3t - 1) / kGroups3t;  // bands
    std::conditional_t<Mu, MuSum3, NoMuSum3> usum(I.w, n);
    // task i of the step from column k0 of band `band` (whose columns end
    // at bend), into gram buffer b: the k8 group wg + C i of the thread's
    // point
    auto task = [&](int b, int k0, int i, int bend, int band) {
      unsigned char* h = gram + (size_t)b * 2 * kStepBytes3t;
      gram_task3t_d<L>(h, h + kStepBytes3t, I.xs, zs, k0, wg + C * i,
                       ct & (kP3t - 1), bend, d, I.gram,
                       usum.only(band == nb - 1));
    };

    // 1. the points and the first step's gram; the barrier first: the
    // last item's sums are read
    named_sync(kBarConsumers3, kThreads3t);
    for (int t = ct; t < d * kP3t; t += kThreads3t) {
      const int k = t / kP3t;
      const int i = I.i0 + t - k * kP3t;
      const float z = i < N ? zt[(size_t)k * N + i] : 0.0f;
      zs[t] = I.ils != nullptr ? z * I.ils[k] : z;
    }
    for (int p = lane; p < kP3t; p += 32) red_m[p] = red_q[p] = 0.0f;
    named_sync(kBarConsumers3, kThreads3t);
    if (nb > 0)
      for (int i = 0; i < kTasks3t; ++i)
        task(0, 0, i, band_end(n, mt, nb, 0), 0);
    fence_proxy_async();
    named_sync(kBarConsumers3, kThreads3t);

    // 2. the bands: this warpgroup's tile of each, step by step
    int gb = 0;                           // the gram buffer of this step
    for (int b = 0; b < nb; ++b) {
      const int m = band_tile(mt, nb, b, wg);
      const int kend = m < 0 ? 0 : (kTM3 * (m + 1) < n ? kTM3 * (m + 1) : n);
      const int chunks = (kend + L::kKC - 1) / L::kKC;
      const int bend = band_end(n, mt, nb, b);
      const int steps = (bend + kStep - 1) / kStep;
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      fence_acc(acc);
      for (int j = 0; j < steps; ++j) {
        const int left = chunks - kChunksStep3t * j;
        const int nc = left < 0 ? 0 : (left < kChunksStep3t ? left : kChunksStep3t);
        const unsigned char* gh = gram + (size_t)gb * 2 * kStepBytes3t;
        // the next step's gram (the band's next columns, or the next
        // band's first) goes to the other buffer while the products run:
        // slot c issues chunk c's products, computes gram task c, then
        // waits for chunk c - 1's products and loads its stage anew
        const bool more = j + 1 < steps || b + 1 < nb;
        const int nk0 = j + 1 < steps ? kStep * (j + 1) : 0;
        const int nbend = j + 1 < steps ? bend : band_end(n, mt, nb, b + 1);
        const int s0 = s;
        int released = 0;
        auto release = [&](int upto, int issued) {
          for (; released < upto; ++released) {
            wg_wait_pending(issued - released - 1);
            load(s0 + released < stages ? s0 + released
                                        : s0 + released - stages);
          }
        };
        for (int c = 0; c < kSlots3t; ++c) {
          if (c < nc) {
            const int k0 = L::kKC * (kChunksStep3t * j + c);
            const int ks = (kend - k0 + L::kK - 1) / L::kK < L::kKC / L::kK
                               ? (kend - k0 + L::kK - 1) / L::kK
                               : L::kKC / L::kK;
            mbar_wait_uniform(f + s, ph);
            if constexpr (L::kCut) {  // the stage's float32 values to limbs
              cut_chunk<L>(buf + (size_t)s * kChunkBytes3, ct & 127);
              fence_proxy_async();
              named_sync(kBarGroup3 + wg, 128);
            }
            wg_fence();
            // the stage's limbs and the chunk's gram, descriptors'
            // start address fields in 16-byte units
            chunk_products3t<L>(
                acc, a0 + (uint64_t)(s * kChunkBytes3 >> 4),
                gh + (size_t)c * (L::kKC / L::kCoreK) * kGroupBytes3t, ks);
            wg_commit();
            if (++s == stages) {
              s = 0;
              ph ^= 1;
            }
          }
          if (more && c < kTasks3t)
            task(gb ^ 1, nk0, c, nbend, j + 1 < steps ? b : b + 1);
          release(c < nc ? c : nc, c + 1 < nc ? c + 1 : nc);
        }
        release(nc, nc);
        wg_wait<0>();
        fence_acc(acc);
        // the band's tile is done: its sums per point (the warp's sums
        // gather its tiles band by band)
        if (j == steps - 1 && m >= 0)
          tile_sums3t<Mu>(acc, I.w, kTM3 * m + 16 * warp + gid, n, gid, tig,
                          red_m, red_q);
        // the next step's gram is written and this step's is read
        fence_proxy_async();
        named_sync(kBarConsumers3, kThreads3t);
        gb ^= 1;
      }
    }

    // 3. the warps' sums per point, added in warp order (with Mu, the
    // threads' sums of u k in thread order, in the rows of w V's sums)
    if constexpr (Mu) {
      red[ct] = usum.acc;
      named_sync(kBarConsumers3, kThreads3t);
    }
    if (ct < kP3t && I.i0 + ct < N) {
      float mu = 0.0f, q = 0.0f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        if (!Mu || v < kThreads3t / kP3t) mu += red[v * kP3t + ct];
        q += red[(kWarps + v) * kP3t + ct];
      }
      const float var = I.kdiag - q;
      const float spread = I.beta * sqrtf(var > 0.0f ? var : 0.0f);
      I.out[I.i0 + ct] = mu - spread;
      I.out[N + I.i0 + ct] = mu + spread;
    }
  }
}

// -- launch helpers of the wgmma bodies (fused_intervals3.cu and the
// experiment kernels of interval_experiments3.cu) --

// The count of GP g's scal row, clamped to [0, cap].
__device__ __forceinline__ int active_rows(const float* scal, int cap) {
  const int count = (int)scal[3];
  return count < 0 ? 0 : (count < cap ? count : cap);
}

// Blocks of C consumer warpgroups a multiprocessor holds: one of kGroups3
// (its shared memory is the multiprocessor's), several of one.
template <int C>
constexpr int min_blocks3() {
  return C == 1 ? 3 : 1;
}

// The body of the float32 K1-3p/K2-3p at capacity cap: the tiled one
// past the resident body's capacity.
inline bool three_pass_tiled(int cap) {
  return (cap + kTM3 - 1) / kTM3 * kTM3 > kResidentCap3;
}

// Blocks of a persistent launch of `items` work items: as many as fit
// the card at once (bytes of dynamic shared memory each), fewer for a
// short launch.
template <class Kernel>
int persistent_blocks(Kernel kernel, int threads, size_t bytes, int items) {
  int dev = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                bytes);
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  return items < blocks ? (items > 0 ? items : 1) : blocks;
}

// Dynamic shared memory a launch of kernel may take beside its static
// shared memory (the static plan of K2-3p), less `extra` bytes.
template <class Kernel>
size_t dynamic_smem(Kernel kernel, size_t extra) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return 0;
  const size_t taken = attr.sharedSizeBytes + extra;
  return taken < kSmemPerBlock ? kSmemPerBlock - taken : 0;
}

template <class Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace safeopt
