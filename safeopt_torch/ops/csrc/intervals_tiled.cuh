// Block body of K1 and K2 past the resident gram (fused_intervals.cu
// intervals_tiled_kernel; fused_intervals_plan.cu
// intervals_plan_tiled_kernel and its wide instance): one GP's interval
// rows over the block's kTileP grid points, for the capacities whose
// active rows the resident body (intervals.cuh) cannot keep in shared
// memory (float32 past cap 512, float64 past 256). It stands for the
// same TPU kernels, safeopt_tpu/ops/fused_posterior.py::
// _interval_kernel_multi (K1) and ::_interval_kernel (K2) at
// three_pass=False, and computes the same function:
//
//   k[c]  = gram(xs[c], z)               difference form, c < n
//   V[r]  = sum_{c <= r} Lm[r, c] k[c]   Lm = Linv * col_mask, lower
//   mu    = sum_r w[r] V[r],  var = max(kdiag - sum_r V[r]^2, 0)
//   out   = (mu - beta sqrt(var), mu + beta sqrt(var))
//
// What bounds it on the H100: per point n(n+1)/2 FMAs of the triangular
// product, 2.0e6 at n = 2000, so the FP32 (FP64) pipe: 60 ms for 1e6
// points at 67 TFLOP/s. The gram (n entries a point, an exp each) and
// the factor (8 MB in float32 at cap 2048, read from L2) stay small
// beside it only if each is taken few times. The resident body past its
// resident rows took both many times: 32 points a block, each block
// streaming the triangle, and each 32-row band computing its own piece
// of the gram in its warp (about 35k entries a point at n = 2000), so
// it ran slower than a chunked cuBLAS product of the whole square. This
// body is a tiled product in the manner of an SGEMM instead:
//
// - A block owns kTileP = 64 points and walks the triangle's row tiles
//   of kTileR = 256 rows in order; row tile t contracts over the columns
//   [0, min(256 (t + 1), n)) in steps of kTileK = 16.
// - The gram of a step (16 columns x 64 points) is computed once per
//   row tile by the whole block, four entries a thread through the
//   StationaryGram policy, into a double buffer in shared memory: the
//   next step's gram is computed while this step's product runs. About
//   9.2k entries a point at n = 2000; the taller the row tile, the fewer
//   (128-row tiles, with 128 points a block, took 17k and were slower).
// - The factor's step (16 columns x 256 rows of Lm^T) is staged with
//   cp.async through a ring of kTileStages steps; rows past the stride
//   and columns past the row tile's end land as zeros.
// - Each thread holds an 8 x 8 register tile (rows 32 wr + 4 ty + {0..3,
//   16..19}, points 4 tx + {0..3, 32..35}; warp wr of the 8 row warps,
//   lane = 8 ty + tx) and reads it from shared memory as four 16-byte
//   vectors a column, without bank conflicts: 64 FMAs for 4 loads. A
//   warp's 32 rows skip the steps past them (the triangle) and past n,
//   so a point takes as many FMAs as the resident body's 32-row bands.
//   Two blocks share an SM (128 registers a thread), so that one's gram
//   and barriers overlap the other's product.
// - Deterministic sums. After a row tile each thread adds its rows to
//   per-point partials of mu and sum V^2, a butterfly adds the 4 lanes
//   of a point, the row warps' partials land in shared memory and one
//   thread a point adds them in order to its running sum: the same bits
//   on every launch, no atomics, no workspace, no second pass.
//
// Full FP32 (FP64) FMAs on the CUDA cores: no TF32, no tensor cores.
// The launchers of fused_intervals.cu and fused_intervals_plan.cu take
// this body wherever interval_layout's resident rows are fewer than the
// capacity. K2's plan gram (PlanGram::rows_d) is about four times K1's
// share of the launch (tools_torch/tune_tiled.py `no_gram`), which
// times the variants and ablations.
#pragma once

#include "common.cuh"

namespace safeopt {

constexpr int kTileR = 256;      // rows of a row tile
constexpr int kTileK = 16;       // columns of a step
constexpr int kTileStages = 3;   // steps of Lm^T in the ring
constexpr int kTileThreads = 256;  // threads of a block
// warps over a row tile's 32-row groups, and over the points: a warp
// multiplies 32 rows by 64 points
constexpr int kRowWarps = kTileR / 32;
constexpr int kPointWarps = kTileThreads / 32 / kRowWarps;
constexpr int kTileP = 64 * kPointWarps;   // points of a block
static_assert(kRowWarps * kPointWarps * 32 == kTileThreads, "whole warps");
// float32 instances keep two blocks on an SM (at most 128 registers a
// thread); the float64 ones one
constexpr int kTiledMinBlocks = 2;

// Byte offsets of the block's shared memory: the ring of factor steps
// (kTileStages x kTileK x kTileR), the gram's double buffer (2 x kTileK
// x kTileP), the row warps' partials (2 x kRowWarps x kTileP) and the
// points (d x kTileP).
template <typename T>
struct TiledLayout {
  size_t a, b, red, zs, bytes;

  __host__ __device__ explicit TiledLayout(int d) {
    size_t o = 0;
    a = o;
    o += sizeof(T) * (size_t)kTileStages * kTileK * kTileR;
    b = o;
    o += sizeof(T) * 2 * (size_t)kTileK * kTileP;
    red = o;
    o += sizeof(T) * 2 * kRowWarps * (size_t)kTileP;
    zs = o;
    o += sizeof(T) * (size_t)d * kTileP;
    bytes = o;
  }
};

// The block stages columns [k0, k0 + kTileK) of rows [r0, r0 + kTileR) of
// Lm^T (row stride ldl, a multiple of 32) as a[c * kTileR + r], with
// 16-byte asynchronous copies; columns at or past kend and rows at or
// past ldl land as zeros.
template <typename T>
__device__ __forceinline__ void stage_tile(T* a, const T* __restrict__ lmt,
                                           int ldl, int k0, int kend,
                                           int r0) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kPerCol = kTileR / V;
  static_assert(kTileK * kPerCol % kTileThreads == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < kTileK * kPerCol / kTileThreads; ++it) {
    const int t = threadIdx.x + it * kTileThreads;
    const int c = t / kPerCol;
    const int r = (t - c * kPerCol) * V;
    const bool in = k0 + c < kend && r0 + r < ldl;
    cp_async16_zfill(a + c * kTileR + r,
                     in ? lmt + (size_t)(k0 + c) * ldl + r0 + r : lmt, in);
  }
}

// gram.rows for R rows at once; a plan whose column count D is known at
// compile time takes PlanGram::rows_d (the same bits, its loads issued
// before the leaves)
template <int D, int R, typename T, class Gram>
__device__ __forceinline__ void tile_rows(const Gram& gram, T (&v)[R],
                                          const T* const (&x)[R],
                                          const T* zs, int p, int d,
                                          int ldz) {
  gram.rows(v, x, zs, p, d, ldz);
}
template <int D, int R, typename T>
__device__ __forceinline__ void tile_rows(const PlanGram<T>& gram,
                                          T (&v)[R], const T* const (&x)[R],
                                          const T* zs, int p, int d,
                                          int ldz) {
  if constexpr (D > 0)
    gram.template rows_d<D>(v, x, zs, p, ldz);
  else
    gram.rows(v, x, zs, p, d, ldz);
}

// b[c * kTileP + p] = gram(xs[k0 + c], zs[:, p]) for the step's columns,
// 0 at or past kend: thread t takes point t % kTileP and the kCols
// columns from (t / kTileP) kCols, at most four per gram.rows call. D is
// the column count when known at compile time (0: d at run time).
template <int D, typename T, class Gram>
__device__ __forceinline__ void tile_gram(T* __restrict__ b,
                                          const T* __restrict__ xs,
                                          const T* zs, int k0, int kend,
                                          int d, const Gram& gram) {
  constexpr int kCols = kTileK * kTileP / kTileThreads;
  constexpr int R = kCols < 4 ? kCols : 4;
  const int dd = D > 0 ? D : d;
  const int p = threadIdx.x % kTileP;
  const int c0 = threadIdx.x / kTileP * kCols;
#pragma unroll
  for (int h = 0; h < kCols; h += R) {
    const int c = k0 + c0 + h;  // the first column, the same in a warp
    T v[R];
    if (c + R <= kend) {
      const T* x[R];
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = xs + (size_t)(c + r) * dd;
      tile_rows<D>(gram, v, x, zs, p, dd, kTileP);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = c + r < kend ? gram(xs + (size_t)(c + r) * dd, zs, p, dd,
                                   kTileP)
                            : T(0);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) b[(c0 + h + r) * kTileP + p] = v[r];
  }
}

template <typename T, class Gram>
__device__ __forceinline__ void tile_gram_d(T* b, const T* xs, const T* zs,
                                            int k0, int kend, int d,
                                            const Gram& gram) {
  switch (d) {
    case 1: tile_gram<1>(b, xs, zs, k0, kend, d, gram); break;
    case 2: tile_gram<2>(b, xs, zs, k0, kend, d, gram); break;
    case 3: tile_gram<3>(b, xs, zs, k0, kend, d, gram); break;
    case 4: tile_gram<4>(b, xs, zs, k0, kend, d, gram); break;
    default: tile_gram<0>(b, xs, zs, k0, kend, d, gram);
  }
}

// acc[i][j] += a[c][rows i] * b[c][points j] over the step's columns:
// the thread's rows 4 ty + {0..3} and 16 + 4 ty + {0..3} of a (already
// offset to its warp's 32 rows), its points 4 tx + {0..3} and 32 + 4 tx
// + {0..3} of b (offset to its warp's 64 points).
template <typename T>
__device__ __forceinline__ void tile_steps(T (&acc)[8][8], const T* a,
                                           const T* b, int ty, int tx) {
#pragma unroll
  for (int c = 0; c < kTileK; ++c) {
    T a0[4], a1[4], b0[4], b1[4];
    load_vec(a0, a + c * kTileR + 4 * ty);
    load_vec(a1, a + c * kTileR + 16 + 4 * ty);
    load_vec(b0, b + c * kTileP + 4 * tx);
    load_vec(b1, b + c * kTileP + 32 + 4 * tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const T ai = i < 4 ? a0[i & 3] : a1[i & 3];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] += ai * (j < 4 ? b0[j & 3] : b1[j & 3]);
    }
  }
}

// out (2, N) rows of one GP for the block's kTileP points; ils scales the
// points (null for raw points); lmt is Lm transposed with row stride ldl
// (a multiple of 32); n the active rows.
template <typename T, class Gram>
__device__ __forceinline__ void interval_tiles(
    const T* __restrict__ zt, const T* __restrict__ ils,
    const T* __restrict__ xs, const T* __restrict__ lmt, int ldl,
    const T* __restrict__ w, T kdiag, T beta, T* __restrict__ out, int N,
    int d, int n, const Gram& gram) {
  const TiledLayout<T> lay(d);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw + lay.a);      // the factor's ring
  T* bs = reinterpret_cast<T*>(smem_raw + lay.b);      // the gram, 2 steps
  T* red = reinterpret_cast<T*>(smem_raw + lay.red);   // row warps' sums
  T* zs = reinterpret_cast<T*>(smem_raw + lay.zs);     // d x kTileP points
  constexpr int kA = kTileK * kTileR, kB = kTileK * kTileP;

  const int i0 = blockIdx.x * kTileP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / kPointWarps, wc = warp % kPointWarps;
  const int ty = lane >> 3, tx = lane & 7;

  for (int t = threadIdx.x; t < d * kTileP; t += kTileThreads) {
    const int k = t / kTileP;
    const int i = i0 + t - k * kTileP;
    const T z = i < N ? zt[(size_t)k * N + i] : T(0);
    zs[t] = ils != nullptr ? z * ils[k] : z;
  }
  __syncthreads();

  // thread t < kTileP: mu of point t; kTileP <= t < 2 kTileP: sum V^2
  // of point t - kTileP, added over the row tiles in order
  T run = T(0);
  for (int r0 = 0; r0 < n; r0 += kTileR) {
    const int kend = r0 + kTileR < n ? r0 + kTileR : n;
    const int steps = (kend + kTileK - 1) / kTileK;
    // the warp's rows [wrow, wrow + 32) need the columns [0, wend)
    const int wrow = r0 + 32 * wr;
    const int wend = wrow >= n ? 0 : (wrow + 32 < n ? wrow + 32 : n);

    T acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
#pragma unroll
    for (int s = 0; s < kTileStages - 1; ++s) {  // the ring's first steps
      if (s < steps) stage_tile(as + s * kA, lmt, ldl, s * kTileK, kend, r0);
      cp_async_commit();
    }
    tile_gram_d(bs, xs, zs, 0, kend, d, gram);
    for (int q = 0; q < steps; ++q) {
      // step q's factor has landed and its gram is written; every warp
      // is done with step q - 1, whose ring slot and gram buffer refill
      cp_async_wait<kTileStages - 2>();
      __syncthreads();
      const int ahead = q + kTileStages - 1;
      if (ahead < steps)
        stage_tile(as + (ahead % kTileStages) * kA, lmt, ldl,
                   ahead * kTileK, kend, r0);
      cp_async_commit();
      if (q + 1 < steps)
        tile_gram_d(bs + ((q + 1) & 1) * kB, xs, zs, (q + 1) * kTileK, kend,
                    d, gram);
      if (q * kTileK < wend)
        tile_steps(acc, as + (q % kTileStages) * kA + 32 * wr,
                   bs + (q & 1) * kB + 64 * wc, ty, tx);
    }

    // the row tile's partials per point; rows past n hold exact zeros
    T m[8], s2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = s2[j] = T(0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = wrow + (i < 4 ? 4 * ty + i : 16 + 4 * ty + (i - 4));
      const T wi = r < n ? w[r] : T(0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m[j] += wi * acc[i][j];
        s2[j] += acc[i][j] * acc[i][j];
      }
    }
#pragma unroll
    for (int o = 8; o < 32; o <<= 1)  // the 4 lanes of a point (ty)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m[j] += __shfl_xor_sync(0xffffffffu, m[j], o);
        s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], o);
      }
    if (ty == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 64 * wc + (j < 4 ? 4 * tx + j : 32 + 4 * tx + (j - 4));
        red[wr * kTileP + p] = m[j];
        red[(kRowWarps + wr) * kTileP + p] = s2[j];
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * kTileP) {  // the row warps in order
      const T* rr = red + (threadIdx.x / kTileP) * kRowWarps * kTileP +
                    threadIdx.x % kTileP;
      T sum = rr[0];
#pragma unroll
      for (int g = 1; g < kRowWarps; ++g) sum += rr[g * kTileP];
      run += sum;
    }
  }

  // the rows of the block's points
  __syncthreads();  // every thread has read the last row tile's partials
  if (threadIdx.x >= kTileP && threadIdx.x < 2 * kTileP)
    red[threadIdx.x - kTileP] = run;
  __syncthreads();
  const int p = threadIdx.x;
  if (p < kTileP && i0 + p < N) {
    const T var = kdiag - red[p];
    const T spread = beta * dsqrt(var > T(0) ? var : T(0));
    out[i0 + p] = run - spread;
    out[N + i0 + p] = run + spread;
  }
}

}  // namespace safeopt
