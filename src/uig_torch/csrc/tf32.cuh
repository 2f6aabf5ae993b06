// The three-term TF32 split that lets the fp32 kernels multiply on the
// tensor cores with fp32's order of error: csrc/attention.cu (K5f, K5b on
// mma.sync) and csrc/conv3_in_tf32.cu (K3's fp32 conv on wgmma).
//
// Each fp32 operand x becomes hi = rna_tf32(x) and lo = rna_tf32(x - hi);
// a product a b is summed as lo_a hi_b + hi_a lo_b + hi_a hi_b into fp32.
// hi + lo carries 22 of x's 24 significand bits and the dropped lo_a lo_b
// term is 2^-22 of the product; plain single-pass TF32 (2^-11) would not
// keep fp32's order of error.
#pragma once

#include <stdint.h>

namespace {

// x as the TF32 pair the products take. hi: x rounded to the nearest TF32
// value, ties away from zero, as cvt.rna.tf32.f32 rounds a finite x: half of
// the 13 dropped bits' weight added to the magnitude bits, which are then
// cleared (2 integer ops; cvt.rna.tf32.f32 compiles to a longer sequence on
// sm_90a, with a test for inf and NaN that finite operands do not need). lo:
// x - hi (exact) with the same half added; the tensor core reads only a
// TF32 operand's upper 19 bits, so it takes lo rounded to nearest.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

}  // namespace
