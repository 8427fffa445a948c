// The gram-only experiment body: B2's gram sums and B5's no-product and
// epilogue modes (interval_experiments.cu launch_ablation). Per GP g and
// grid point i, over the GP's n active rows c in ascending order, one
// accumulator for each sum:
//
//   kGramSums   s1 += k[c],           s2 = fma(k[c], k[c], s2)
//   kNoProduct  s1 = fma(w[c], k, s1), s2 = fma(k, k, s2), then K1's
//               epilogue mu -+ beta sqrt(max(kdiag - s2, 0))
//   kEpilogue   the same with V[c] := 0.01 z[0] (raw) in place of k; V is
//               the same every row, and nvcc squares it once (s2 += V^2)
//
// k[c] is StationaryGram's entry (kfun<false> of the lengthscale-scaled
// squared distance, added column by column), so the sums have the bits
// of the one-point-a-thread body this replaces (on the card:
// compare_trees.py run --experiments compares their digests).
//
// What bounds it: at d = 2 one entry is about eleven FP32 instructions
// (two differences, two FMAs, expf's reduction around its MUFU.EX2, the
// variance multiply, the two sums), so the FP32 issue rate binds; the
// MUFU (16 results a clock an SM against 128 FP32 lanes) binds only for
// a kind with two transcendentals an entry (the Materns and the
// exponential: a square root and an exponential). The rows are read by
// every point, from shared memory.
//
// The design: a block of kGrThreads threads, each with P points whose
// scaled coordinates sit in registers (d a template parameter: 1, 2 and
// 10, the widths of the port's states; the kind RBF, theirs, at compile
// time, so no branch an entry). The GP's active rows (the prescaled x,
// and w for the modes that read it) are staged in chunks of shared
// memory by cp.async, double-buffered so that the next chunk lands while
// this one is summed; one broadcast vector load reads R rows (R d
// values, 16 bytes where d allows) and serves P R entries. Any other
// width up to kMaxDim, and every other kind, runs a runtime-d instance
// with one point a thread, its coordinates in shared memory, and
// StationaryGram::rows<4> on the staged rows: the parent body's entry,
// whose contractions around the square root an instance with d and the
// kind at compile time did not keep (its float32 sums of the Materns
// and the exponential differed in the last bits, on the card).
#pragma once

#include "common.cuh"

namespace safeopt {

// the modes of B2/B5's C entry (interval_experiments.cu launch_ablation);
// kSolveRank1 runs K1's body, the others this one
enum AblationMode { kGramSums = 0, kSolveRank1 = 1, kNoProduct = 2,
                    kEpilogue = 3 };

// Chosen on the H100 with tools_torch/tune_gram_rows.py: 64 or 256
// threads, 2 or 8 points a thread were slower at every state timed, 2 or
// 8 KB chunks within 1 %.
constexpr int kGrThreads = 128;     // threads of a block
constexpr int kGrPoints = 4;        // points a thread at d <= 4
constexpr int kGrChunkBytes = 4096; // bytes of a staged chunk, at least
constexpr int kGrMinRows = 16;      // rows of a chunk, at least

// points a thread (Dim 0: the runtime-d instance, one)
template <int Dim>
__host__ __device__ constexpr int gr_points() {
  return Dim == 0 ? 1 : Dim > 4 ? (kGrPoints + 1) / 2 : kGrPoints;
}

// rows a group reads with one vector load: the fewest (a power of two up
// to 4) whose V values take a multiple of 16 bytes
template <typename T, int V>
__host__ __device__ constexpr int gr_group() {
  int r = 1;
  while (r < 4 && (r * V * (int)sizeof(T)) % 16) r *= 2;
  return r;
}

// one element from global to shared memory by cp.async (4 or 8 bytes:
// any row start is aligned to it); grouped and waited for as cp_async16
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* smem, const T* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(gmem));
}

// StationaryGram's RBF entry of a row x and a point z held in registers:
// the same differences and fused squares in the same column order, then
// kfun<false>
template <int D, typename T>
__device__ __forceinline__ T rbf_entry(const T* x, const T (&z)[D],
                                       T variance) {
  T r2 = T(0);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const T diff = x[k] - z[k];
    r2 += diff * diff;
  }
  return kfun<false>(kRBF, r2, variance);
}

// Rows of a chunk staged for one GP: ch of them, each Dim (or d) values
// of x (none under kEpilogue), then ch values of w (none under
// kGramSums). Dim > 0: an RBF gram of Dim columns; Dim 0: any
// stationary kind and d at run time, the points in shared memory.
template <typename T, int Mode, int Dim>
__global__ void __launch_bounds__(kGrThreads)
    gram_rows_kernel(const T* __restrict__ zt, const T* __restrict__ ils,
                     const T* __restrict__ xs, const T* __restrict__ w,
                     const T* __restrict__ scal, T* __restrict__ out, int N,
                     int d, int cap, int kind, int ch) {
  constexpr bool kX = Mode != kEpilogue;
  constexpr bool kW = Mode != kGramSums;
  constexpr int P = gr_points<Dim>();
  constexpr int DR = Dim > 0 ? Dim : 1;
  static_assert(Dim > 0 || Mode != kEpilogue, "the epilogue reads no rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = Dim > 0 ? Dim : d;
  T* zs = reinterpret_cast<T*>(smem_raw);  // Dim 0: d x kGrThreads points
  T* bufs = zs + (Dim == 0 ? D * kGrThreads : 0);
  const int xlen = kX ? ch * D : 0;
  const int stride = xlen + (kW ? ch : 0);
  const int g = blockIdx.y;
  const int count = (int)scal[g * 4 + 3];
  const int n = count < 0 ? 0 : (count < cap ? count : cap);
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * (kGrThreads * P) + t;
  const T* il = ils + g * d;
  const T variance = scal[g * 4];
  T z[P][DR];   // the points' scaled coordinates, or (kEpilogue) 0.01 z[0]
  T s1[P], s2[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = i0 + j * kGrThreads;
    s1[j] = s2[j] = T(0);
    if constexpr (Mode == kEpilogue) {
      z[j][0] = i < N ? T(0.01) * zt[i] : T(0);
    } else if constexpr (Dim > 0) {
#pragma unroll
      for (int k = 0; k < Dim; ++k)
        z[j][k] = i < N ? zt[(size_t)k * N + i] * il[k] : T(0);
    }
  }
  if constexpr (Dim == 0) {
    for (int k = 0; k < D; ++k)
      zs[k * kGrThreads + t] = i0 < N ? zt[(size_t)k * N + i0] * il[k] : T(0);
  }
  const T* x = xs + (size_t)g * cap * d;
  const T* wg = w + (size_t)g * cap;
  auto stage = [&](int c0, T* buf) {
    const int rows = n - c0 < ch ? n - c0 : ch;
    if constexpr (kX)
      for (int e = t; e < rows * D; e += kGrThreads)
        cp_async_elem(buf + e, x + (size_t)c0 * D + e);
    if constexpr (kW)
      for (int e = t; e < rows; e += kGrThreads)
        cp_async_elem(buf + xlen + e, wg + c0 + e);
    cp_async_commit();
  };
  // one row's entries added to the P points' sums, in row order
  auto add = [&](int j, T wc, T v) {
    if constexpr (Mode == kGramSums)
      s1[j] += v;
    else
      s1[j] += wc * v;
    s2[j] += v * v;
  };
  if (n > 0) stage(0, bufs);
  for (int c0 = 0, b = 0; c0 < n; c0 += ch, b ^= 1) {
    if (c0 + ch < n) {
      stage(c0 + ch, bufs + (b ^ 1) * stride);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* xb = bufs + b * stride;
    const T* wb = xb + xlen;
    const int rows = n - c0 < ch ? n - c0 : ch;
    int c = 0;
    if constexpr (Dim == 0) {
      const StationaryGram<T> gram{kind, variance};
      for (; c + 4 <= rows; c += 4) {
        const T* xr[4];
        T v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) xr[r] = xb + (c + r) * D;
        gram.rows(v, xr, zs, t, D, kGrThreads);
#pragma unroll
        for (int r = 0; r < 4; ++r) add(0, kW ? wb[c + r] : T(0), v[r]);
      }
      for (; c < rows; ++c)
        add(0, kW ? wb[c] : T(0), gram(xb + c * D, zs, t, D, kGrThreads));
    } else {
      constexpr int R = gr_group<T, kX ? Dim : 1>();
      for (; c + R <= rows; c += R) {
        T xr[kX ? R * Dim : 1], wr[R];
        if constexpr (kX) load_vec(xr, xb + c * Dim);
        if constexpr (kW) load_vec(wr, wb + c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int j = 0; j < P; ++j) {
            if constexpr (kX)
              add(j, kW ? wr[r] : T(0),
                  rbf_entry(xr + r * Dim, z[j], variance));
            else
              add(j, wr[r], z[j][0]);
          }
        }
      }
      for (; c < rows; ++c) {
        const T wc = kW ? wb[c] : T(0);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          if constexpr (kX)
            add(j, wc, rbf_entry(xb + c * Dim, z[j], variance));
          else
            add(j, wc, z[j][0]);
        }
      }
    }
    __syncthreads();
  }
  T* o = out + (size_t)g * 2 * N;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = i0 + j * kGrThreads;
    if (i >= N) continue;
    if constexpr (Mode == kGramSums) {
      o[i] = s1[j];
      o[N + i] = s2[j];
    } else {
      const T var = scal[g * 4 + 1] - s2[j];
      const T spread = scal[g * 4 + 2] * dsqrt(var > T(0) ? var : T(0));
      o[i] = s1[j] - spread;
      o[N + i] = s1[j] + spread;
    }
  }
}

// Rows of a chunk: kGrChunkBytes of staged values (at least kGrMinRows
// rows), a multiple of 16 rows, so that every group's vector load and
// the w block stay 16-byte aligned.
template <typename T, int Mode>
inline int gr_chunk_rows(int d) {
  const int per_row = (Mode != kEpilogue ? d : 0) + (Mode != kGramSums);
  const int rows = kGrChunkBytes / (int)sizeof(T) / per_row / 16 * 16;
  return rows > kGrMinRows ? rows : kGrMinRows;
}

template <typename T, int Mode, int Dim>
int launch_gram_rows_at(const T* zt, const T* ils, const T* xs, const T* w,
                        const T* scal, T* out, int G, int N, int d, int cap,
                        int kind, cudaStream_t stream) {
  const int ch = gr_chunk_rows<T, Mode>(d);
  const int per_row = (Mode != kEpilogue ? d : 0) + (Mode != kGramSums);
  const size_t bytes =
      sizeof(T) * ((Dim == 0 ? (size_t)d * kGrThreads : 0) +
                   2 * (size_t)ch * per_row);
  auto kernel = gram_rows_kernel<T, Mode, Dim>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int per_block = kGrThreads * gr_points<Dim>();
  const dim3 grid((N + per_block - 1) / per_block, G);
  kernel<<<grid, kGrThreads, bytes, stream>>>(zt, ils, xs, w, scal, out, N, d,
                                              cap, kind, ch);
  return (int)cudaGetLastError();
}

// the instance for width d and kind: an RBF gram of 1, 2 or 10 columns in
// registers, any other kind or width up to kMaxDim at run time; the
// epilogue reads no rows
template <typename T, int Mode>
int launch_gram_rows(const T* zt, const T* ils, const T* xs, const T* w,
                     const T* scal, T* out, int G, int N, int d, int cap,
                     int kind, cudaStream_t stream) {
  if (d < 1 || d > kMaxDim || kind < kRBF || kind > kExponential)
    return (int)cudaErrorInvalidValue;
#define SAFEOPT_GR_AT(DIM)                                                  \
  launch_gram_rows_at<T, Mode, DIM>(zt, ils, xs, w, scal, out, G, N, d, cap, \
                                    kind, stream)
  if constexpr (Mode == kEpilogue) {
    return SAFEOPT_GR_AT(1);
  } else {
    if (kind == kRBF && d == 1) return SAFEOPT_GR_AT(1);
    if (kind == kRBF && d == 2) return SAFEOPT_GR_AT(2);
    if (kind == kRBF && d == 10) return SAFEOPT_GR_AT(10);
    return SAFEOPT_GR_AT(0);
  }
#undef SAFEOPT_GR_AT
}

}  // namespace safeopt
