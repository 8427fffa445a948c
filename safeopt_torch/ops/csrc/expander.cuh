// Block body of the expander kernels K3 (fused_expander.cu) and K4
// (fused_expander_plan.cu): one GP's predicate for C candidates over the
// grid, with the gram entry given by a policy (common.cuh). After a
// virtual observation at candidate j (rank-1 update of the posterior):
//
//   k[r]   = gram(xs[r], z)                       difference form, r < n
//   cross  = sum_r M2[j, r] k[r]                  M2 = Cm^T Lm (C x cap)
//   E      = (gram(xc[j], z) - cross) * inv_dd[j]
//   l2     = mu(z) + E gain[j] - beta sqrt(max(sigma(z)^2 - E^2, 0))
//   out[j] |= unsafe(z) && l2 >= fmin && valid[j]
//
// What bounds it: per unsafe point C n FMAs of the cross term against
// n + C gram entries and a few bytes of grid: the FP32 (FP64) pipe. The
// design removes the work that bound does not count and keeps the FMA
// pipe fed from shared memory:
//
// - Only the active rows. n (the GP's count, read by the kernel from
//   device memory) ends the contraction and the gram. Past n, M2 is
//   exactly zero (Lm = Linv * col_mask zeroes those columns), so the
//   skipped terms are exact zeros. The last piece runs to n rounded up to
//   one 16-byte vector: at C = 32 and n = 400 a point costs C n = 12,800
//   MACs.
// - M2 read once per block. A block stages its pass's rows of M2 into
//   shared memory once, with cp.async from M2's own (C, cap) layout (no
//   transpose, in the kernel or the wrapper), then loops over point
//   tiles: the grid is as many blocks as fit on the card at once. Past
//   kExM2Bytes (f32 past 512 rows at CW = 32, f64 past 272) the rest of
//   each tile's contraction streams through a ring of pieces that the
//   block shares, the next piece in flight while one is used.
// - A register tile fed with 16-byte loads along the contraction. A
//   thread holds kExTM = 8 candidates x kExTN = 4 points; a round of V =
//   16 / sizeof(T) contraction steps loads one vector of M2 per candidate
//   and one of gram per point (f32: 12 loads for 128 FMAs, K1's ratio).
//   Row strides are odd multiples of 16 bytes, so that a quarter warp's
//   loads hit distinct banks or one broadcast address.
// - Each gram entry once per block, whatever C is. A warp owns a slice of
//   points and every candidate of the pass: CG candidate groups x PG
//   point groups (CG PG = 32), CW = kExTM CG candidates, a compile-time
//   parameter (the launcher picks the power of two from 32 to 256 that
//   covers C; passes of 256 past it): 32 points a warp at C <= 32, 16 at
//   64. The warp computes its slice's gram piece by piece into its own
//   shared scratch, kExRows rows a gram.rows call, and contracts it at
//   once. While M2 is all resident the warps share nothing and skip on
//   their own, so they drift apart and one's gram (exp-bound, long
//   dependency chains) overlaps another's products. The epilogue's
//   candidate gram is one evaluation per (candidate, point).
// - Hits ORed across blocks. Blocks run in no order on this card: the
//   caller zeroes the int32 output before the launch; a thread keeps its
//   candidates' hits as bits over every tile, the warp ORs them with
//   shuffles, the block in shared flags, and one atomicOr per hit
//   candidate and block goes to the output. (The TPU kernels zeroed the
//   output at grid step 0 and relied on in-order steps; that is not
//   ported.) A warp's slice with no unsafe point is skipped after
//   __any_sync (a tile after __syncthreads_or where M2 streams).
//
// On the H100 (tools_torch/tune_intervals.py, PERF.md) no instance may
// spill: float32 passes of 32 run two blocks of 256 threads on an SM (at
// most 128 registers), wider passes and float64 one; the GP's rows of
// the operands are indexed where they are read rather than held as
// pointers, and the stationary gram leaves out the cosine kind. At
// capacity 512 a 4 x 4 tile, all of M2 streamed, one or three blocks per
// SM, 8- or 32-row pieces and four gram rows a call were 5-24 % slower
// (at capacity 64 all within 4 %, three blocks and two epilogue rows
// slower). What is left beyond the product: the gram (a fifth of the
// time at capacity 512, half of K4's) and the epilogue and loads around
// it.
//
// All products are FP32 (FP64) FMAs; no TF32, no tensor cores.
#pragma once

#include "common.cuh"

namespace safeopt {

constexpr int kExTM = 8;       // candidates per thread
constexpr int kExTN = 4;       // points per thread
constexpr int kExKS = 16;      // training rows of a piece
constexpr int kExStages = 2;   // pieces in the ring of streamed M2
constexpr int kExWarps = kThreads / 32;
// bytes of M2 a block keeps resident in shared memory
constexpr size_t kExM2Bytes = 80 * 1024;
constexpr int kExMinBlocks = 2;
constexpr int kExRows = 8;  // training rows per gram.rows call
constexpr int kExEpi = 4;   // candidates per gram.rows call of the epilogue
static_assert(kExTM % kExEpi == 0, "whole epilogue gram calls");

template <typename T>
constexpr int kExVec = 16 / (int)sizeof(T);  // values in a 16-byte vector
// row stride of a piece (ring, gram scratch): an odd multiple of 16 bytes
template <typename T>
constexpr int kExLd = kExKS + kExVec<T>;
// blocks per SM an instance is compiled for: kExMinBlocks for float32
// passes of 32 candidates (the main path), else one (at most 255
// registers, so that no instance spills)
template <typename T, int CW>
constexpr int kExBlocks = sizeof(T) == 4 && CW == 32 ? kExMinBlocks : 1;

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// offset of a region of b bytes at o, o moved past it (16-byte aligned)
__host__ __device__ inline size_t take_bytes(size_t& o, size_t b) {
  const size_t at = o;
  o += (b + 15) / 16 * 16;
  return at;
}

// Candidates of a pass: the power of two from 32 to kExTM * 32 that
// covers C (passes of kExTM * 32 past it).
__host__ __device__ inline int pass_width(int C) {
  int cw = 32;
  while (cw < C && cw < kExTM * 32) cw *= 2;
  return cw;
}

// f(std::integral_constant<int, CW>()) for the pass width of C: the
// shape of a pass is a compile-time constant of the kernel.
template <class F>
inline int with_pass_width(int C, F&& f) {
  const int cw = pass_width(C);
  if (cw == 32) return f(std::integral_constant<int, 32>());
  if constexpr (kExTM * 32 >= 64)
    if (cw == 64) return f(std::integral_constant<int, 64>());
  if constexpr (kExTM * 32 >= 128)
    if (cw == 128) return f(std::integral_constant<int, 128>());
  if constexpr (kExTM * 32 >= 256)
    if (cw == 256) return f(std::integral_constant<int, 256>());
  return (int)cudaErrorInvalidValue;
}

// Shape and byte offsets of a launch's shared memory for passes of CW
// candidates: the warps' gram pieces (PTS x kExLd each), [inv_dd; gain;
// valid] (3 x CW) and hit flags (CW) first, at offsets known at compile
// time; then M2's resident pieces (res / kExKS pieces of CW x kExLd:
// piece q holds columns [q kExKS, (q + 1) kExKS) of every candidate, the
// layout of a ring slot), the ring (kExStages pieces, only if M2 is not
// all resident), the warps' points (d x PTS each) and the pass's
// candidates (CW x d).
template <typename T, int CW>
struct ExLayout {
  static constexpr int CG = CW / kExTM;      // candidate groups of a warp
  static constexpr int PG = 32 / CG;         // point groups of a warp
  static constexpr int PTS = PG * kExTN;     // points of a warp's slice
  static constexpr int TP = kExWarps * PTS;  // points of a tile
  static constexpr int kSlot = CW * kExLd<T>;  // values of a piece
  int res;
  size_t m2, ring, gram, zs, xc, cv, hits, bytes;

  __host__ __device__ ExLayout(int cap, int d) {
    const int cap_pad = round_up(cap, kExKS);
    const size_t piece = sizeof(T) * (size_t)kSlot;
    const int fit = (int)(kExM2Bytes / piece) * kExKS;
    res = cap_pad < fit ? cap_pad : fit;
    size_t o = 0;
    gram = take_bytes(o, sizeof(T) * kExWarps * (size_t)PTS * kExLd<T>);
    cv = take_bytes(o, sizeof(T) * 3 * (size_t)CW);
    hits = take_bytes(o, sizeof(int) * (size_t)CW);
    m2 = take_bytes(o, piece * (res / kExKS));
    ring = take_bytes(o, res < cap_pad ? piece * kExStages : 0);
    zs = take_bytes(o, sizeof(T) * kExWarps * (size_t)d * PTS);
    xc = take_bytes(o, sizeof(T) * (size_t)CW * d);
    bytes = o;
  }
};

// Piece q of the pass's M2 into dst: dst[j kExLd + c] = M2[j0 + j, q
// kExKS + c], zero past C or cap; M2's rows (stride cap) start at row
// r0 of m2. Rows that are 16-byte aligned go by cp.async (the caller
// commits and waits), others element by element.
template <typename T, int CW>
__device__ __forceinline__ void stage_piece(T* dst, const T* __restrict__ m2,
                                            int r0, int cap, int C, int j0,
                                            int q, bool aligned) {
  constexpr int V = kExVec<T>;
  constexpr int nv = kExKS / V;  // vectors of a candidate's piece
#pragma unroll
  for (int t0 = 0; t0 < CW * nv; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    if (CW * nv % kThreads != 0 && t >= CW * nv) break;
    const int j = t / nv;
    const int e0 = (t - j * nv) * V;
    const int c = q * kExKS + e0;
    T* s = dst + j * kExLd<T> + e0;
    const T* g = m2 + (size_t)(r0 + j0 + j) * cap + c;
    if (aligned && j0 + j < C && c + V <= cap) {
      cp_async16(s, g);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        s[e] = j0 + j < C && c + e < cap ? g[e] : T(0);
    }
  }
}

// gk[p * kExLd + c] = gram(xs[r0 + k0 + c], zs[:, p]) for the piece's kExKS
// rows, zero at and past n: lane takes point p = lane % PTS and every
// (32 / PTS)-th row, kExRows rows per gram.rows call. D is the column
// count when the caller knows it at compile time (0: d at run time).
template <int D, int PTS, typename T, class Gram>
__device__ __forceinline__ void gram_piece(T* __restrict__ gk,
                                           const T* __restrict__ xs, int r0,
                                           const T* zs, int k0, int n, int d,
                                           int lane, const Gram& gram) {
  constexpr int R = kExRows;
  constexpr int step = 32 / PTS;
  const int dd = D > 0 ? D : d;
  const int p = lane % PTS;
  T* row = gk + p * kExLd<T>;
  int c = lane / PTS;
  for (; c + (R - 1) * step < kExKS && k0 + c + (R - 1) * step < n;
       c += R * step) {
    // one base pointer: with D known the rows are immediate offsets
    const T* xr = xs + (size_t)(r0 + k0 + c) * dd;
    const T* x[R];
    T v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = xr + r * step * dd;
    gram.rows(v, x, zs, p, dd, PTS);
#pragma unroll
    for (int r = 0; r < R; ++r) row[c + r * step] = v[r];
  }
  for (; c < kExKS; c += step)
    row[c] = k0 + c < n
                 ? gram(xs + (size_t)(r0 + k0 + c) * dd, zs, p, dd, PTS)
                 : T(0);
}

// acc[i][jj] += sum_c a[i * kExLd + c] * b[(PG jj) * kExLd + c] over the
// piece's first `steps` columns (a multiple of the vector); a is the
// thread's first candidate row of an M2 piece, b its first point row of
// the gram piece. Per round of V columns a thread loads kExTN + kExTM
// vectors for kExTM kExTN V FMAs.
template <int PG, typename T>
__device__ __forceinline__ void piece_steps(T (&acc)[kExTM][kExTN],
                                            const T* a, const T* b,
                                            int steps) {
  constexpr int V = kExVec<T>;
  auto round = [&](int c) {
    T bv[kExTN][V];
#pragma unroll
    for (int jj = 0; jj < kExTN; ++jj)
      load_vec(bv[jj], b + PG * jj * kExLd<T> + c);
#pragma unroll
    for (int i = 0; i < kExTM; ++i) {
      T av[V];
      load_vec(av, a + i * kExLd<T> + c);
#pragma unroll
      for (int jj = 0; jj < kExTN; ++jj)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[i][jj] += av[v] * bv[jj][v];
    }
  };
  if (steps == kExKS) {
#pragma unroll
    for (int c = 0; c < kExKS; c += V) round(c);
  } else {
    for (int c = 0; c < steps; c += V) round(c);
  }
}

// The unsafe flag of point i for GP g: one mask (N,) for every GP, or
// (kRows) a mask per GP (G, N), whose row is indexed as mu's and sigma's
// are (a row index or pointer held across the loops made the float32
// CW=32 instance spill).
template <bool kRows>
__device__ __forceinline__ bool unsafe_at(
    const unsigned char* __restrict__ unsafe, int g, int N, int i) {
  if constexpr (kRows)
    return unsafe[(size_t)g * N + i] != 0;
  else
    return unsafe[i] != 0;
}

// Hit flags out[g] (C,) of GP g of the launch's operands (as K3 lays them
// out: GP g's rows of mu, sigma (G, N), ils (G, d), xs (G, cap, d), xc (G,
// C, d), M2 (G, C, cap), cv (G, 3, C) with rows [inv_dd, gain, valid]); ils
// scales the points (null for raw points); n the GP's active rows; passes
// of CW candidates. The GP's rows are indexed where they are read, not
// held as pointers: eight 64-bit pointers live across the loops made the
// float32 instance spill.
template <typename T, int CW, bool kRows = false, class Gram>
__device__ __forceinline__ void candidate_hits(
    const T* __restrict__ zt, const T* __restrict__ ils,
    const unsigned char* __restrict__ unsafe, const T* __restrict__ mu,
    const T* __restrict__ sigma, const T* __restrict__ xs,
    const T* __restrict__ xc, const T* __restrict__ m2,
    const T* __restrict__ cv, T beta, T fmin, int* __restrict__ out, int N,
    int d, int cap, int C, int n, int g, const Gram& gram) {
  using Lay = ExLayout<T, CW>;
  constexpr int V = kExVec<T>, PG = Lay::PG, PTS = Lay::PTS;
  constexpr int slot = Lay::kSlot;
  const Lay lay(cap, d);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* m2s = reinterpret_cast<T*>(smem_raw + lay.m2);     // resident pieces
  T* ring = reinterpret_cast<T*>(smem_raw + lay.ring);  // streamed pieces
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* gk = reinterpret_cast<T*>(smem_raw + lay.gram) + warp * PTS * kExLd<T>;
  T* zs = reinterpret_cast<T*>(smem_raw + lay.zs) + (size_t)warp * d * PTS;
  T* xcs = reinterpret_cast<T*>(smem_raw + lay.xc);     // CW x d
  T* cvs = reinterpret_cast<T*>(smem_raw + lay.cv);     // 3 x CW
  int* hits = reinterpret_cast<int*>(smem_raw + lay.hits);
  // candidates cg kExTM + i (i < kExTM), points pg + PG jj (jj < kExTN)
  const int cg = lane / PG, pg = lane % PG;

  const int pieces = (n + kExKS - 1) / kExKS;
  const int qres = pieces < lay.res / kExKS ? pieces : lay.res / kExKS;
  const int np = round_up(n, V);  // columns the contraction runs over
  // rows of M2 16-byte aligned: copied with cp.async
  const bool aligned =
      cap * sizeof(T) % 16 == 0 && reinterpret_cast<size_t>(m2) % 16 == 0;
  const int tiles = (N + Lay::TP - 1) / Lay::TP;

  for (int j0 = 0; j0 < C; j0 += CW) {
    __syncthreads();  // the previous pass is done with shared memory
    for (int q = 0; q < qres; ++q)
      stage_piece<T, CW>(m2s + q * slot, m2, g * C, cap, C, j0, q, aligned);
    cp_async_commit();
    for (int t = threadIdx.x; t < CW * d; t += kThreads)
      xcs[t] = j0 * d + t < C * d ? xc[(size_t)(g * C + j0) * d + t] : T(0);
    for (int t = threadIdx.x; t < 3 * CW; t += kThreads) {
      const int q = t / CW, jj = t - q * CW;
      cvs[t] = j0 + jj < C ? cv[(size_t)(3 * g + q) * C + j0 + jj] : T(0);
    }
    for (int t = threadIdx.x; t < CW; t += kThreads) hits[t] = 0;
    cp_async_wait<0>();
    __syncthreads();

    unsigned bits = 0;  // bit i: candidate cg kExTM + i hit
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int i0 = tile * Lay::TP + warp * PTS;
      bool any = false;  // an unsafe point among this thread's
#pragma unroll
      for (int jj = 0; jj < kExTN; ++jj) {
        const int i = i0 + pg + PG * jj;
        any = any || (i < N && unsafe_at<kRows>(unsafe, g, N, i));
      }
      const bool work = __any_sync(0xffffffffu, any);
      // no unsafe point in the warp's slice: while M2 is all resident the
      // warps share nothing and drift apart (one's gram overlaps
      // another's products); a streamed piece needs the whole block
      if (qres == pieces ? !work : !__syncthreads_or(work)) continue;
      if (work) {
        for (int t = lane; t < d * PTS; t += 32) {
          const int k = t / PTS;
          const int i = i0 + t - k * PTS;
          const T z = i < N ? zt[(size_t)k * N + i] : T(0);
          zs[t] = ils != nullptr ? z * ils[g * d + k] : z;
        }
      }
      __syncwarp();

      T acc[kExTM][kExTN];
#pragma unroll
      for (int i = 0; i < kExTM; ++i)
#pragma unroll
        for (int jj = 0; jj < kExTN; ++jj) acc[i][jj] = T(0);
      // the ring's first streamed pieces (none while M2 is resident)
      for (int s = 0; s < kExStages - 1; ++s) {
        if (qres + s < pieces)
          stage_piece<T, CW>(ring + s * slot, m2, g * C, cap, C, j0,
                             qres + s, aligned);
        cp_async_commit();
      }
      for (int q = 0; q < pieces; ++q) {
        const int k0 = q * kExKS;
        const bool streamed = q >= qres;  // the same in every thread
        if (streamed) {
          const int ahead = q + kExStages - 1;  // into the slot q - 1 used
          if (ahead < pieces)
            stage_piece<T, CW>(ring + ((ahead - qres) % kExStages) * slot,
                               m2, g * C, cap, C, j0, ahead, aligned);
          cp_async_commit();
        }
        if (work) {  // d known at compile time unrolls the column loops
          const int xr0 = g * cap;  // the GP's first training row
          switch (d) {
            case 1:
              gram_piece<1, PTS>(gk, xs, xr0, zs, k0, n, d, lane, gram);
              break;
            case 2:
              gram_piece<2, PTS>(gk, xs, xr0, zs, k0, n, d, lane, gram);
              break;
            case 3:
              gram_piece<3, PTS>(gk, xs, xr0, zs, k0, n, d, lane, gram);
              break;
            case 4:
              gram_piece<4, PTS>(gk, xs, xr0, zs, k0, n, d, lane, gram);
              break;
            default:
              gram_piece<0, PTS>(gk, xs, xr0, zs, k0, n, d, lane, gram);
          }
        }
        if (streamed) {
          cp_async_wait<kExStages - 1>();  // piece q has landed
          __syncthreads();
        } else {
          __syncwarp();
        }
        if (work) {
          const T* a = streamed ? ring + ((q - qres) % kExStages) * slot
                                : m2s + q * slot;
          piece_steps<PG>(acc, a + cg * kExTM * kExLd<T>,
                          gk + pg * kExLd<T>,
                          np - k0 < kExKS ? np - k0 : kExKS);
        }
        if (streamed)
          __syncthreads();  // the ring slot and the gram piece are consumed
        else
          __syncwarp();
      }

      if (work) {
#pragma unroll
        for (int jj = 0; jj < kExTN; ++jj) {
          const int p = pg + PG * jj;
          const int i = i0 + p;
          if (i >= N || !unsafe_at<kRows>(unsafe, g, N, i)) continue;
          const T mu_p = mu[(size_t)g * N + i], sg = sigma[(size_t)g * N + i];
          const T s2 = sg * sg;
#pragma unroll
          for (int i4 = 0; i4 < kExTM; i4 += kExEpi) {
            const T* x[kExEpi];
            T kc[kExEpi];
#pragma unroll
            for (int r = 0; r < kExEpi; ++r)
              x[r] = xcs + (size_t)(cg * kExTM + i4 + r) * d;
            gram.rows(kc, x, zs, p, d, PTS);
#pragma unroll
            for (int r = 0; r < kExEpi; ++r) {
              const int j = cg * kExTM + i4 + r;
              const T e = (kc[r] - acc[i4 + r][jj]) * cvs[j];
              const T v2 = s2 - e * e;
              const T l2 = mu_p + e * cvs[CW + j] -
                           beta * dsqrt(v2 > T(0) ? v2 : T(0));
              if (cvs[2 * CW + j] > T(0.5) && l2 >= fmin)
                bits |= 1u << (i4 + r);
            }
          }
        }
      }
    }

    // the pass's hits: over the warp's point groups, the block, the grid
#pragma unroll
    for (int o = 1; o < PG; o <<= 1)
      bits |= __shfl_xor_sync(0xffffffffu, bits, o);
    if (pg == 0) {
#pragma unroll
      for (int i = 0; i < kExTM; ++i)
        if (bits >> i & 1u) atomicOr(hits + cg * kExTM + i, 1);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < CW; t += kThreads)
      if (hits[t] && j0 + t < C) atomicOr(out + (size_t)g * C + j0 + t, 1);
  }
}

// Launch geometry: as many blocks of each GP as fit on the card at once
// (at most one per tile of TP points), a kernel with `bytes` of dynamic
// shared memory. Returns a CUDA error code.
template <class Kernel>
inline int expander_grid(Kernel kernel, size_t bytes, int TP, int G, int N,
                         dim3& grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + TP - 1) / TP;
  int gx = per_sm * sms / G;
  gx = gx < 1 ? 1 : gx;
  grid = dim3(gx < tiles ? gx : tiles, G);
  return 0;
}

}  // namespace safeopt
