"""The tensor-core kernels' arithmetic, emulated on the CPU (tests only).

The one-pass skinning kernels (K2, K3b; ``lbs``) and the MotionNet GEMM
routine (K6; ``mlp``) run their products on ``mma.sync`` TF32 in 3xTF32
(csrc/tf32_mma.cuh) and sum per-block partials in a fixed order. These
helpers repeat that arithmetic so the CPU tests can hold it against the
JAX kernels and the plain versions before a card runs it.
"""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to the nearest TF32, ties away from zero, by masking the
    low 13 mantissa bits (csrc/tf32_mma.cuh:tf32_bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products accumulated in f32: small . big, then
    big . small, then big . big."""
    ab, bb = tf32(a), tf32(b)
    a_s, b_s = tf32(a - ab), tf32(b - bb)
    return (a_s @ bb + ab @ b_s) + ab @ bb


def in_order(parts):
    """The sum of the partials in index order, as a kernel's fixed-order
    reduction takes it."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc
