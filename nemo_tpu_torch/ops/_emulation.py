"""Kernels' arithmetic, emulated on the CPU (tests only).

The one-pass skinning kernels (K2, K3b; ``lbs``) and the MotionNet GEMM
routine (K6; ``mlp``) run their products on ``mma.sync`` TF32 in 3xTF32
(csrc/tf32_mma.cuh) and sum per-block partials in a fixed order. These
helpers repeat that arithmetic so the CPU tests can hold it against the
JAX kernels and the plain versions before a card runs it. The GroupNorm +
ReLU kernel (K7, ``groupnorm``) sums its groups by shuffles and its
dgamma and dbeta by partials in a fixed order; ``gn_relu_fwd_emulation``
and ``gn_relu_bwd_emulation`` repeat it.
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


# ---------------------------------------------------------------------------
# K7 (csrc/groupnorm.cu): GroupNorm + ReLU, step for step
# ---------------------------------------------------------------------------

def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) on f32 tensors: the product is exact in f64, and the
    sum is rounded to f64 and then to f32 (one rounding, but for the rare
    double-rounding case)."""
    return (a.double() * b.double() + c.double()).float()


def _lanes(t: torch.Tensor) -> torch.Tensor:
    """(R, C) -> (R, C / 128, 32, 4): lane l's float4 k holds the columns
    4 (l + 32 k) .. 4 (l + 32 k) + 3."""
    return t.reshape(t.shape[0], t.shape[1] // 128, 32, 4)


def _sum4(v: torch.Tensor) -> torch.Tensor:
    return ((v[..., 0] + v[..., 1]) + v[..., 2]) + v[..., 3]


def _dot4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fma(a[..., 3], b[..., 3], fma(a[..., 2], b[..., 2], fma(
        a[..., 1], b[..., 1], a[..., 0] * b[..., 0])))


def gn_group_sums(p: torch.Tensor, q: int) -> torch.Tensor:
    """group_sums on (R, C / 128, 32) lane partials, q = S / 4 lanes a
    group: a butterfly over min(q, 32) lanes, then, where a group spans
    q / 32 float4s, their sums in order."""
    lanes = torch.arange(32)
    off = min(q, 32) // 2
    while off:
        p = p + p[..., lanes ^ off]
        off //= 2
    if q > 32:
        kq = q // 32
        R, NV = p.shape[:2]
        g = p.reshape(R, NV // kq, kq, 32)
        run = g[:, :, 0]
        for j in range(1, kq):
            run = run + g[:, :, j]
        p = run[:, :, None].expand(R, NV // kq, kq, 32).reshape(R, NV, 32)
    return p


def gn_relu_fwd_emulation(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, groups: int, eps: float = 1e-5):
    """humor_gn_fwd_kernel on f32 CPU tensors: (y (R, C), mean (R, G), rstd
    (R, G))."""
    R, C = x.shape
    S = C // groups
    q = S // 4
    v = _lanes(x)
    m = gn_group_sums(_sum4(v), q) / S
    d = v - m[..., None]
    r = 1.0 / torch.sqrt(gn_group_sums(_dot4(d, d), q) / S + eps)
    z = fma(d * r[..., None], gamma.reshape(-1, 32, 4),
            beta.reshape(-1, 32, 4))
    y = torch.where(z < 0, torch.zeros_like(z), z)
    return (y.reshape(R, C), m.reshape(R, C // 4)[:, ::q].contiguous(),
            r.reshape(R, C // 4)[:, ::q].contiguous())


def gn_relu_bwd_emulation(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, mean: torch.Tensor,
                          rstd: torch.Tensor, gy: torch.Tensor, groups: int,
                          wgrad: bool = False):
    """humor_gn_bwd_kernel (wgrad False: dx alone) or
    humor_gn_bwd_wgrad_kernel and its reduction on f32 CPU tensors: (dx,
    dgamma, dbeta), the last two None without wgrad."""
    from .groupnorm import KWARPS, wgrad_blocks
    R, C = x.shape
    S = C // groups
    q = S // 4
    grp = torch.arange(C // 4).reshape(C // 128, 32) // q
    m, r = mean[:, grp][..., None], rstd[:, grp][..., None]
    ga, be = gamma.reshape(-1, 32, 4), beta.reshape(-1, 32, 4)
    xh = (_lanes(x) - m) * r
    g = _lanes(gy)
    gz = torch.where(fma(xh, ga, be) > 0, g, torch.zeros_like(g))
    gg = gz * ga
    m1 = gn_group_sums(_sum4(gg), q)[..., None] / S
    m2 = gn_group_sums(_dot4(gg, xh), q)[..., None] / S
    dx = (r * fma(-xh, m2, gg - m1)).reshape(R, C)
    if not wgrad:
        return dx, None, None
    gz, xh = gz.reshape(R, C), xh.reshape(R, C)
    nb = wgrad_blocks(R)
    rpb = -(-R // nb)
    first = torch.arange(nb)[:, None] * rpb + torch.arange(KWARPS)[None]
    end = torch.clamp(torch.arange(1, nb + 1) * rpb, max=R)[:, None]
    acc_g = torch.zeros((nb, KWARPS, C))
    acc_b = torch.zeros((nb, KWARPS, C))
    for i in range(-(-rpb // KWARPS)):
        rows = first + KWARPS * i
        ok = (rows < end)[..., None]
        rr = rows.clamp(max=R - 1)
        acc_g = torch.where(ok, fma(gz[rr], xh[rr], acc_g), acc_g)
        acc_b = torch.where(ok, acc_b + gz[rr], acc_b)
    dgamma = in_order(in_order(acc_g.unbind(1)).unbind(0))
    dbeta = in_order(in_order(acc_b.unbind(1)).unbind(0))
    return dx, dgamma, dbeta
