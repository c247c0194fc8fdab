// The float32 operand split of the 3xTF32 kernels (flash_attention.cu,
// swiglu.cu): each float32 x becomes two TF32 parts hi + lo, and a product
// a b is taken on the tensor cores as lo_a hi_b + hi_a lo_b + hi_a hi_b
// (lo_a lo_b, about 2^-22 of the product, dropped), which keeps float32
// accuracy where one TF32 product keeps about three decimal digits.

#pragma once

#include <stdint.h>

namespace aec_tc {

// x as TF32 parts, x = hi + lo to about 2^-22 |x|: hi is x rounded to
// nearest at 11 significant bits by Veltkamp's split (c = 8193 x, hi = c -
// (c - x), each step rounded on its own), which TF32 holds exactly; lo = x -
// hi is exact and is cut to TF32 by masking its low 13 bits. Four FP32
// operations and one logic operation, where cvt.rna.tf32.f32 costs four for
// each part; NaN stays NaN. Finite x below 2^114 in magnitude.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float c = __fmul_rn(x, 8193.f);
  const float h = __fadd_rn(c, __fsub_rn(x, c));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h)) & 0xffffe000u;
}

}  // namespace aec_tc
