// Split limbs, shared by the interval kernels' three-pass products:
// intervals.cuh's ThreePassProduct (float64: K1-3p and K2-3p, the
// experiments B1-3p, B2-3p and B3-3p) and the wgmma bodies of
// intervals3.cuh and intervals3_tiled.cuh (float32: K1-3p and K2-3p, the
// experiments B1-3p, B2-3p, B3-3p and B4).
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

// hi and lo tf32 limbs of x, as 32-bit tf32 values: to nearest, ties away
// from zero (cvt.rna; the tensor core itself would truncate)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo_col,
                                              __nv_bfloat16 hi_col) {
  return (uint32_t)__bfloat16_as_ushort(lo_col) |
         ((uint32_t)__bfloat16_as_ushort(hi_col) << 16);
}

// hi and lo bf16 limbs of x, to nearest even
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16& hi,
                                           __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// hi and lo bf16 limbs of the pair (x0, x1), packed two to a 32-bit
// word (x0 in the low half), as a k-contiguous tensor-core operand holds
// two consecutive k
__device__ __forceinline__ void split_pack_bf16(float x0, float x1,
                                                uint32_t& hi, uint32_t& lo) {
  __nv_bfloat16 h0, l0, h1, l1;
  split_bf16(x0, h0, l0);
  split_bf16(x1, h1, l1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(l0, l1);
}

// The float64 limbs of x as the three-pass product of a float64 matrix
// takes them (the JAX package's _tri_matmul in an x64 session): hi = x
// rounded to bf16 through float32, lo = x - hi exactly (unrounded)
__device__ __forceinline__ void split_f64(double x, double& hi, double& lo) {
  hi = (double)__bfloat162float(__float2bfloat16_rn((float)x));
  lo = x - hi;
}

}  // namespace safeopt
