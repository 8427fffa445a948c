// Split limbs and warp-level tensor-core products (mma.sync), shared by
// the interval kernels' three-pass product (intervals.cuh ThreePass, K1-3p
// and K2-3p) and the experiment B4 (interval_experiments.cu).
//
// A float32 x is cut into two limbs of a narrower format, hi = round(x)
// and lo = round(x - hi); the product of two such numbers is taken as
// hi hi + hi lo + lo hi (lo lo, about 2^-18 of it in bf16, is dropped),
// three single-pass tensor-core products accumulated in float32: the
// TPU's 3-pass emulation of a float32 matrix product (safeopt_tpu
// ops/fused_posterior.py _dot3 / _tri_matmul(three_pass=True)).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace safeopt {

// B4's block: kSP points, contraction steps of kSK columns
constexpr int kSP = 32;        // points of a block (four n8 tiles)
constexpr int kSK = 16;        // columns of a contraction step (k16)

struct Bf16Limb {
  using Stored = __nv_bfloat16;
  static constexpr int kLdcPad = 8;  // elements: 4 words
  __device__ static __forceinline__ Stored round(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ static __forceinline__ float value(Stored x) {
    return __bfloat162float(x);
  }
};

struct Tf32Limb {
  using Stored = float;
  static constexpr int kLdcPad = 4;
  __device__ static __forceinline__ Stored round(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return __uint_as_float(r);
  }
  __device__ static __forceinline__ float value(Stored x) { return x; }
};

// hi and lo limbs of x
template <class Limb>
__device__ __forceinline__ void split(float x, typename Limb::Stored& hi,
                                      typename Limb::Stored& lo) {
  hi = Limb::round(x);
  lo = Limb::round(x - Limb::value(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo_col,
                                              __nv_bfloat16 hi_col) {
  return (uint32_t)__bfloat16_as_ushort(lo_col) |
         ((uint32_t)__bfloat16_as_ushort(hi_col) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k16 step of a band for m tile mt: V[mt][nt] += Lm_hi k_hi + Lm_hi
// k_lo + Lm_lo k_hi over columns [c0, c0 + 16). Fragment layouts (PTX ISA,
// mma.m16n8k16 .bf16 and mma.m16n8k8 .tf32), lane = 4 gid + tig:
//   bf16 A: regs {row gid, gid + 8} x {cols 2 tig, 2 tig + 8}, two
//           consecutive columns a register (the lower in the low half);
//        B: regs {k = 2 tig, 2 tig + 8} (two consecutive k), n = gid;
//   tf32 A: a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4),
//           a3 (gid + 8, tig + 4);  B: b0 (k = tig, gid), b1 (tig + 4, gid);
//   D: d0, d1 (row gid, cols 2 tig, 2 tig + 1), d2, d3 (row gid + 8).
template <class Limb, bool Hoisted>
__device__ __forceinline__ void split_step(
    float (&acc)[4][4], const float* __restrict__ lm,
    const typename Limb::Stored* __restrict__ lm_hi,
    const typename Limb::Stored* __restrict__ lm_lo, int ldl, int r,
    const typename Limb::Stored* ghi, const typename Limb::Stored* glo,
    int ldc, int c0, int gid, int tig) {
  const int ra = r + gid, rb = ra + 8;
  if constexpr (std::is_same<Limb, Bf16Limb>::value) {
    uint32_t ahi[4], alo[4];
    const int ca = c0 + 2 * tig;
    const size_t off[4] = {(size_t)ra * ldl + ca, (size_t)rb * ldl + ca,
                           (size_t)ra * ldl + ca + 8, (size_t)rb * ldl + ca + 8};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (Hoisted) {
        ahi[q] = *reinterpret_cast<const uint32_t*>(lm_hi + off[q]);
        alo[q] = *reinterpret_cast<const uint32_t*>(lm_lo + off[q]);
      } else {
        const float2 x = *reinterpret_cast<const float2*>(lm + off[q]);
        __nv_bfloat16 h0, l0, h1, l1;
        split<Limb>(x.x, h0, l0);
        split<Limb>(x.y, h1, l1);
        ahi[q] = pack_bf16(h0, h1);
        alo[q] = pack_bf16(l0, l1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kSP / 8; ++nt) {
      const size_t pb = (size_t)(8 * nt + gid) * ldc + ca;
      const uint32_t bhi[2] = {*reinterpret_cast<const uint32_t*>(ghi + pb),
                               *reinterpret_cast<const uint32_t*>(ghi + pb + 8)};
      const uint32_t blo[2] = {*reinterpret_cast<const uint32_t*>(glo + pb),
                               *reinterpret_cast<const uint32_t*>(glo + pb + 8)};
      mma_bf16(acc[nt], ahi, bhi);
      mma_bf16(acc[nt], ahi, blo);
      mma_bf16(acc[nt], alo, bhi);
    }
  } else {
#pragma unroll
    for (int h = 0; h < kSK; h += 8) {  // two k8 steps
      uint32_t ahi[4], alo[4];
      const int ca = c0 + h + tig;
      const size_t off[4] = {(size_t)ra * ldl + ca, (size_t)rb * ldl + ca,
                             (size_t)ra * ldl + ca + 4,
                             (size_t)rb * ldl + ca + 4};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float hi, lo;
        if constexpr (Hoisted) {
          hi = lm_hi[off[q]];
          lo = lm_lo[off[q]];
        } else {
          split<Limb>(lm[off[q]], hi, lo);
        }
        ahi[q] = __float_as_uint(hi);
        alo[q] = __float_as_uint(lo);
      }
#pragma unroll
      for (int nt = 0; nt < kSP / 8; ++nt) {
        const size_t pb = (size_t)(8 * nt + gid) * ldc + ca;
        const uint32_t bhi[2] = {__float_as_uint(ghi[pb]),
                                 __float_as_uint(ghi[pb + 4])};
        const uint32_t blo[2] = {__float_as_uint(glo[pb]),
                                 __float_as_uint(glo[pb + 4])};
        mma_tf32(acc[nt], ahi, bhi);
        mma_tf32(acc[nt], ahi, blo);
        mma_tf32(acc[nt], alo, bhi);
      }
    }
  }
}

// hi and lo bf16 limbs of the pair (x0, x1), packed as an mma operand
// register holds them (x0 in the low half): the A and B fragments of
// mma.m16n8k16 .bf16 hold two consecutive k a register
__device__ __forceinline__ void split_pack_bf16(float x0, float x1,
                                                uint32_t& hi, uint32_t& lo) {
  __nv_bfloat16 h0, l0, h1, l1;
  split<Bf16Limb>(x0, h0, l0);
  split<Bf16Limb>(x1, h1, l1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(l0, l1);
}

// c += a_hi b_hi + a_hi b_lo + a_lo b_hi: the three-pass product of one
// m16n8k16 tile, in the order the TPU kernel adds its passes
__device__ __forceinline__ void mma3_bf16(float (&c)[4],
                                          const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4],
                                          const uint32_t (&bhi)[2],
                                          const uint32_t (&blo)[2]) {
  mma_bf16(c, ahi, bhi);
  mma_bf16(c, ahi, blo);
  mma_bf16(c, alo, bhi);
}

// The float64 limbs of x as the three-pass product of a float64 matrix
// takes them (the JAX package's _tri_matmul in an x64 session): hi = x
// rounded to bf16 through float32, lo = x - hi exactly (unrounded)
__device__ __forceinline__ void split_f64(double x, double& hi, double& lo) {
  hi = (double)__bfloat162float(__float2bfloat16_rn((float)x));
  lo = x - hi;
}

}  // namespace safeopt
