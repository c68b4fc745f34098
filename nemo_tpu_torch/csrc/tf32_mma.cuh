// The tensor-core primitives the port's kernels share (csrc/skin_common.cuh
// for K2 and K3b, csrc/mlp.cu for K6): products on mma.sync m16n8k8 TF32
// with a 3xTF32 split, and the cp.async copies that stage their operands.
//
// The 3xTF32 split: x = big + small, big = tf32(x), small = tf32(x - big)
// (rounded to nearest, ties away, by masking the low 13 mantissa bits), and
// a.b = (a_s.b_b + a_b.b_s) + a_b.b_b accumulated in f32. The dropped
// a_s.b_s term is below 2^-22 of each product, so a contraction keeps
// f32-level accuracy; this is the kernels' arithmetic, not an option, and
// TF32 stays off everywhere else.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// the 3xTF32 split
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  // round to the nearest TF32 (10 mantissa bits), ties away from zero
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32 with both operands split: lo += a_s . b_b + a_b . b_s,
// hi += a_b . b_b (lo and hi may be the same accumulator).
__device__ __forceinline__ void mma_3xtf32(float lo[4], float hi[4],
                                           const uint32_t ab[4],
                                           const uint32_t as[4],
                                           const uint32_t bb[2],
                                           const uint32_t bs[2]) {
  mma_tf32(lo, as, bb);
  mma_tf32(lo, ab, bs);
  mma_tf32(hi, ab, bb);
}

// The same with a split here and b already split.
__device__ __forceinline__ void mma_3xtf32(float lo[4], float hi[4],
                                           const float a[4],
                                           const uint32_t bb[2],
                                           const uint32_t bs[2]) {
  uint32_t ab[4], as[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
  mma_3xtf32(lo, hi, ab, as, bb, bs);
}

// ---------------------------------------------------------------------------
// cp.async staging
// ---------------------------------------------------------------------------

// Copy CW floats (CW = 1, 2 or 4) from global to shared memory; only the
// first n of them are read (n <= 0: none), the rest are zero-filled.
template <int CW>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = n > 0 ? 4 * (n < CW ? n : CW) : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(d), "l"(src), "n"(4 * CW), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace
