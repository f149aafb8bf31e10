// The 3xTF32 arithmetic shared by K1 (distance_topk.cu) and the float32
// paths of K3 (flash_attention.cu) and K3-bwd (flash_attention_bwd.cu, on
// wgmma): float32-grade products on the tensor cores.
//
// mma.sync m16n8k8 and wgmma m64nNk8 take tf32 operands, which keep 10 of
// float32's 23 mantissa bits.  Each operand a is split into hi = tf32(a) and
// lo = tf32(a - hi), and a product accumulates a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi in float32, small terms first; the lo.lo term is below
// float32's rounding.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// cvt.rna.tf32.f32 for finite a, as two full-rate integer operations (the
// conversion instruction issues at a fraction of their rate): add half of
// the 13 dropped bits to the magnitude, then clear them, which rounds to
// nearest with ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(uint32_t a) { return (a + 0x1000u) & 0xffffe000u; }

// a = hi + lo: hi = tf32(a), lo = tf32(a - hi)
__device__ __forceinline__ void split_tf32(uint32_t a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(__float_as_uint(__uint_as_float(a) - __uint_as_float(hi)));
}

// c += a (16 x 8, row) . b (8 x 8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tf32
