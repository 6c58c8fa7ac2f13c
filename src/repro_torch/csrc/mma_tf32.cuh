// 3xTF32 on mma.sync m16n8k8: an f32 product from three TF32 tensor-core
// products, which flash attention's f32 forward (csrc/flash_attention.cu)
// and backward (csrc/flash_attention_bwd.cu) share.  x = hi + lo with hi =
// tf32(x) and lo = x - hi, and a b = lo_a hi_b + hi_a lo_b + hi_a hi_b:
// the lo lo term left out is ~2^-22 of the product, and each tf32 product
// is exact in the f32 accumulator (CUTLASS's OpMultiplyAddFastF32 order).
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8) a0 = (g,
// t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4); B (8 x 8, k x
// n) b0 = (t, g), b1 = (t + 4, g); C (16 x 8) c0 = (g, 2 t), c1 = (g, 2 t
// + 1), c2 = (g + 8, 2 t), c3 = (g + 8, 2 t + 1).
#pragma once

#include <cstdint>

namespace rt {

// x = hi + lo: hi = tf32(x), rounded to nearest with ties away from zero
// (cvt.rna.tf32.f32, which ptxas expands to four instructions with a NaN
// check; an integer add and mask give the same bits for every finite x),
// and lo = x - hi, exact in f32, which the tensor core reads as a tf32 by
// ignoring its low 13 bits (rounding it toward zero)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// x = hi + lo with hi = x's top 19 bits (tf32 rounded toward zero: one
// logic operation where split takes two integer ones) and lo = x - hi,
// exact: |lo| < 2^-10 |x| where split's is at most 2^-11 |x|, so a 3xTF32
// product keeps about 20 of x's bits instead of 21, and leans toward zero
// by about 2^-21 of itself (the f32 backward's split; PERF.md has its
// time and error beside split's)
__device__ __forceinline__ void split_rz(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// d (16 x 8) += a (16 x 8) b (8 x 8), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b in 3xTF32: lo hi, hi lo, then hi hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

}  // namespace rt
