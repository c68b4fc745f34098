// The bf16 tensor-core primitives the port's kernels share
// (csrc/skin_common.cuh for the bf16 skinning tables, csrc/mlp.cu for K6 at
// "high" and "bf16"): mma.sync m16n8k16 with bf16 operands and f32
// accumulation, the packing of two bf16 values into one of its operand
// registers, and the bf16x3 split of nemo_tpu/ops/mlp_pallas.py _kdot.
//
// m16n8k16 holds two k-neighbours a register: A (16 x 16, row-major)
// register r of lane (gid = lane / 4, tig = lane % 4) packs row gid + 8 (r
// & 1), columns 2 tig + 8 (r >> 1) and the next; B (16 x 8) register r
// packs rows 2 tig + 8 r and the next of column gid. The lower index sits
// in the low half. C is m16n8k8's: row gid + 8 (c >> 1), column 2 tig +
// (c & 1).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

// two f32 rounded to bf16 (nearest even) in one register, lo in the low
// half (the lower index, as mma.sync's fragments take them)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The bf16x3 split of two neighbours x0, x1 (x0 the lower index): hi packs
// bf16(x), lo packs bf16(x - bf16(x)), each rounded to nearest even, as
// _kdot's a_hi = a.astype(bf16), a_lo = (a - a_hi).astype(bf16).
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

// d += a . b on mma.sync m16n8k16, bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
