// Tensor-core products at about f32's precision on Hopper (sm_90a):
// mma.sync m16n8k8 in TF32 with f32 sums, each f32 operand split into two
// TF32 parts, x = hi + lo (cvt.rna), and a b taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi. The dropped a_lo b_lo is 2^-22 of the
// product, so the sums keep about f32's precision; TF32 alone (2^-11) does
// not. A value widened from bf16 is a TF32 number as it stands (its low 16
// bits are 0), so its low part is 0 and its products need no split.
//
// TF32 here is explicit, in the PTX: PyTorch's switches
// (torch.backends.cuda.matmul.allow_tf32, set_float32_matmul_precision)
// govern its own matmuls, not these kernels.
//
// Fragments of m16n8k8 (row.col), lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A [16 x 8]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B [8 x 8]:  b0 (k t, n g), b1 (k t + 4, n g)
//   C [16 x 8]: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
//
// Included by rwkv6_scan.cu (SplitA, mma3) and flash_attention.cu
// (SplitFast, mma3_fast, mma2_fast).
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an m16 x k8 operand in two TF32 parts, x = hi + lo
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit SplitA(const float (&x)[4]) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      hi[n] = tf32(x[n]);
      lo[n] = tf32(x[n] - __uint_as_float(hi[n]));
    }
  }
};

// c += a b to about f32's precision: a_lo b_hi + a_hi b_lo + a_hi b_hi
// (a_lo b_lo, 2^-22 of the product, dropped); with `b_exact` b is a TF32
// number (widened from bf16) and its low part is 0
template <bool b_exact>
__device__ __forceinline__ void mma3(float (&c)[4], const SplitA& a, float b0,
                                     float b1) {
  const uint32_t h0 = b_exact ? __float_as_uint(b0) : tf32(b0);
  const uint32_t h1 = b_exact ? __float_as_uint(b1) : tf32(b1);
  mma_tf32(c, a.lo, h0, h1);
  if (!b_exact)
    mma_tf32(c, a.hi, tf32(b0 - __uint_as_float(h0)),
             tf32(b1 - __uint_as_float(h1)));
  mma_tf32(c, a.hi, h0, h1);
}

// The same split in three instructions a value (an add and a mask on the
// bits, a subtraction), where two cvt.rna.tf32.f32 and a subtraction take
// nine (each cvt compiles to a finiteness check, an add, a select and a
// mask): hi is x rounded to TF32 by integer ops (cvt.rna's rounding for
// finite x), and lo = x - hi, exact in f32, is passed whole, since the
// tensor cores read only the top 19 bits of a TF32 operand (CUTLASS's
// round_half_ulp_truncate rests on the same): lo is truncated to TF32
// there. Its error, under 2^-21 of x, is of the order of the dropped
// a_lo b_lo.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct SplitFast {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit SplitFast(const float (&x)[4]) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      hi[n] = tf32_round(x[n]);
      lo[n] = __float_as_uint(x[n] - __uint_as_float(hi[n]));
    }
  }
};

// c += a b, both split as SplitFast: a_lo b_hi + a_hi b_lo + a_hi b_hi
__device__ __forceinline__ void mma3_fast(float (&c)[4], const SplitFast& a,
                                          float b0, float b1) {
  const uint32_t h0 = tf32_round(b0), h1 = tf32_round(b1);
  mma_tf32(c, a.lo, h0, h1);
  mma_tf32(c, a.hi, __float_as_uint(b0 - __uint_as_float(h0)),
           __float_as_uint(b1 - __uint_as_float(h1)));
  mma_tf32(c, a.hi, h0, h1);
}

// c += a b with b a TF32 number (widened from bf16): a_lo b + a_hi b
__device__ __forceinline__ void mma2_fast(float (&c)[4], const SplitFast& a,
                                          float b0, float b1) {
  mma_tf32(c, a.lo, __float_as_uint(b0), __float_as_uint(b1));
  mma_tf32(c, a.hi, __float_as_uint(b0), __float_as_uint(b1));
}

}  // namespace
