"""One-way nearest-neighbour chamfer: kernel K4 and its autograd op.

Replaces nemo_tpu/ops/chamfer.py's ``_nn_one_way_pallas``
(``_chamfer_kernel``) behind the same public ops: ``nn_one_way`` (min
squared distance and argmin from each point of ``a`` to the set ``b``),
``chamfer_distance`` (both directions, with the CUDA extension's backward)
and ``chamfer_loss``.

The port takes a leading frame axis where the JAX package vmaps: ``a (T, N,
3)`` and ``b (T, M, 3)``, one kernel launch for all T frames; 2-D inputs are
one frame. On a CUDA tensor ``nn_one_way`` launches ``csrc/chamfer.cu``, an
operations-bound kernel (9 f32 operations per pair, one thread per query
point; the source note has the details). On a CPU tensor it runs
``nn_one_way_plain``, chunked over M as ``_nn_one_way_xla`` is, which
evaluates every sum in the kernel's order (no matmul, whose K=3 summation
order is unspecified), so the two agree bit for bit on the card. The
backward is plain PyTorch, as the JAX backward is plain XLA.

``chamfer_distance`` returns each matched pair's squared distance computed
directly, |x - y|^2, as the reference's CUDA extension does and as its
backward differentiates it; the search's expansion (|x|^2 + |y|^2 - 2 x.y)
loses up to a few ulp of |x|^2 to cancellation and goes negative for a
point sub-millimetre from its match a few metres from the origin, where
the JAX package's value (and its points3d loss, through sqrt) is NaN.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

LAUNCHES = {"chamfer_nn": 0}


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """(x0 x0 + x1 x1) + x2 x2 over the last axis, in the kernel's order."""
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + \
        x[..., 2] * x[..., 2]


def nn_one_way_plain(a: torch.Tensor, b: torch.Tensor, chunk: int = 1024
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min squared distance (T, N), argmin (T, N) int64) from each
    a[t, n] to the set b[t]; the plain version of K4. A running minimum
    over chunks of M under a strict <, the first minimum within a chunk:
    the lowest index wins a tie. Memory is (T, N, chunk) at a time."""
    T, N, _ = a.shape
    M = b.shape[1]
    a_sq = _sq_norm(a)[..., None]                        # (T, N, 1)
    a0, a1, a2 = (a[..., k:k + 1] for k in range(3))
    best = torch.full((T, N), float("inf"), dtype=a.dtype, device=a.device)
    best_idx = torch.zeros((T, N), dtype=torch.int64, device=a.device)
    for m0 in range(0, M, chunk):
        bc = b[:, m0:m0 + chunk]
        b0, b1, b2 = (bc[..., k][:, None] for k in range(3))
        dot = (a0 * b0 + a1 * b1) + a2 * b2              # (T, N, c)
        d = (a_sq + _sq_norm(bc)[:, None]) - 2.0 * dot
        idx = d.argmin(-1)
        val = d.gather(-1, idx[..., None])[..., 0]
        take = val < best
        best = torch.where(take, val, best)
        best_idx = torch.where(take, idx + m0, best_idx)
    return best, best_idx


def nn_one_way_cuda(a: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 (CUDA tensors only): a (T, N, 3), b (T, M, 3)."""
    T, N = a.shape[:2]
    dev = a.device
    _build.check_input("a", a, (T, N, 3), dev)
    _build.check_input("b", b, (T, None, 3), dev)
    M = b.shape[1]
    if min(T, N, M) < 1 or T > 65535:
        raise ValueError(f"nn_one_way: T={T}, N={N}, M={M} (need each >= 1 "
                         "and T <= 65535)")
    lib = _build.library()
    dist = torch.empty((T, N), dtype=torch.float32, device=dev)
    idx = torch.empty((T, N), dtype=torch.int64, device=dev)
    err = lib.nemo_chamfer_nn(a.data_ptr(), b.data_ptr(), T, N, M,
                              dist.data_ptr(), idx.data_ptr(),
                              _build.stream_handle(dev))
    _build.check(err, "nemo_chamfer_nn")
    LAUNCHES["chamfer_nn"] += 1
    return dist, idx


def nn_one_way(a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min squared distances, argmin indices) from each point of a to the
    set b: a (T, N, 3) and b (T, M, 3) frame by frame, or one frame (N, 3)
    and (M, 3). The kernel on CUDA tensors, the plain version on CPU ones."""
    if a.dim() == 2:
        d, i = nn_one_way(a[None], b[None])
        return d[0], i[0]
    if _build.route(a, b) == "cpu":
        return nn_one_way_plain(a, b)
    return nn_one_way_cuda(a, b)


def _matched_sq_dist(x: torch.Tensor, y: torch.Tensor, i: torch.Tensor
                     ) -> torch.Tensor:
    """|x[t, n] - y[t, i[t, n]]|^2 (T, N), never negative."""
    d = x - torch.gather(y, 1, i[..., None].expand(*i.shape, 3))
    return _sq_norm(d)


def _flat_index(i: torch.Tensor, size: int) -> torch.Tensor:
    """(T, K) per-frame indices into a (T, size) axis -> (T*K,) flat."""
    off = torch.arange(i.shape[0], device=i.device)[:, None] * size
    return (i + off).reshape(-1)


def _chamfer_bwd(x1, x2, i1, i2, g1: Optional[torch.Tensor],
                 g2: Optional[torch.Tensor]):
    """The CUDA extension's backward (nemo_tpu ``_chamfer_bwd``), per frame:
    d1[n] = |x1[n] - x2[i1[n]]|^2 gives 2 (x1[n] - x2[i1[n]]) to x1[n] and
    its negative to x2[i1[n]]; d2 mirrors it. The scatter is index_add_ over
    the flattened (T*M) indices (atomics on CUDA: sums onto a vertex are
    order-nondeterministic at the ulp level)."""
    T, N, _ = x1.shape
    M = x2.shape[1]
    g1 = torch.zeros((T, N), dtype=x1.dtype, device=x1.device) \
        if g1 is None else g1
    g2 = torch.zeros((T, M), dtype=x1.dtype, device=x1.device) \
        if g2 is None else g2
    x2_nn = torch.gather(x2, 1, i1[..., None].expand(T, N, 3))
    x1_nn = torch.gather(x1, 1, i2[..., None].expand(T, M, 3))
    grad1 = g1[..., None] * (2.0 * (x1 - x2_nn))        # (T, N, 3)
    grad2 = g2[..., None] * (2.0 * (x2 - x1_nn))        # (T, M, 3)
    gx1 = grad1.reshape(T * N, 3).index_add(0, _flat_index(i2, N),
                                            -grad2.reshape(T * M, 3))
    gx2 = grad2.reshape(T * M, 3).index_add(0, _flat_index(i1, M),
                                            -grad1.reshape(T * N, 3))
    return gx1.reshape(T, N, 3), gx2.reshape(T, M, 3)


class ChamferDistance(torch.autograd.Function):
    """Forward: K4 both ways (the plain version on the CPU) for the
    matches, then the matched pairs' squared distances; backward:
    ``_chamfer_bwd``."""

    @staticmethod
    def forward(ctx, xyz1, xyz2):
        x1, x2 = xyz1.contiguous(), xyz2.contiguous()
        _, i1 = nn_one_way(x1, x2)
        _, i2 = nn_one_way(x2, x1)
        ctx.save_for_backward(x1, x2, i1, i2)
        return _matched_sq_dist(x1, x2, i1), _matched_sq_dist(x2, x1, i2)

    @staticmethod
    def backward(ctx, g1, g2):
        return _chamfer_bwd(*ctx.saved_tensors, g1, g2)


def chamfer_distance(xyz1: torch.Tensor, xyz2: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional squared chamfer distances: xyz1 (T, N, 3), xyz2 (T, M,
    3) -> (dist1 (T, N), dist2 (T, M)), each point's squared distance to its
    nearest neighbour in the other set; 2-D inputs are one frame."""
    if xyz1.dim() == 2:
        d1, d2 = ChamferDistance.apply(xyz1[None], xyz2[None])
        return d1[0], d2[0]
    return ChamferDistance.apply(xyz1, xyz2)


def chamfer_loss(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Scalar symmetric chamfer loss (mean of both directions)."""
    d1, d2 = chamfer_distance(xyz1, xyz2)
    return d1.mean() + d2.mean()
