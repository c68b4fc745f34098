"""Kinematic-chain composition: kernel K1 (forward and backward).

Replaces nemo_tpu/ops/fk_pallas.py: ``_fk_fwd_pallas`` (``_fk_fwd_kernel``)
and ``_fk_bwd_pallas`` (``_fk_bwd_kernel``), behind the same public op
``fk_compose(R_l (B,J,3,3), t_l (B,J,3), parents) -> (R_g, t_g)``.

On a CUDA tensor the forward and backward launch the hand-written kernels of
``csrc/fk.cu``. On the H100 they are launch- and latency-bound (the fit's
batch of 512 is four warps of threads): the design is one thread per batch
element walking the whole tree, so one launch per direction replaces the
plain chain's ~50 small kernels. The source note there has the details.
On a CPU tensor they run the plain versions below, which mirror ``_fk_xla``
and ``_bwd_xla``: the plain backward is the explicit reverse accumulation,
not autograd.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build

LAUNCHES = {"fk_fwd": 0, "fk_bwd": 0}


def topo_order(parents: Sequence[int]) -> Tuple[int, ...]:
    """Joints other than the root, parents before children (stable by
    depth), as nemo_tpu's ``_topo_order``."""
    parents = np.asarray(parents)
    depth = np.zeros(len(parents), np.int64)
    for i in range(1, len(parents)):
        depth[i] = depth[parents[i]] + 1
    return tuple(int(i) for i in np.argsort(depth, kind="stable") if i != 0)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def fk_fwd_plain(R_l: torch.Tensor, t_l: torch.Tensor, parents
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    Rs = {0: R_l[:, 0]}
    ts = {0: t_l[:, 0]}
    for j in topo_order(parents):
        p = int(parents[j])
        Rs[j] = torch.matmul(Rs[p], R_l[:, j])
        ts[j] = torch.einsum('bik,bk->bi', Rs[p], t_l[:, j]) + ts[p]
    J = R_l.shape[1]
    return (torch.stack([Rs[j] for j in range(J)], dim=1),
            torch.stack([ts[j] for j in range(J)], dim=1))


def fk_bwd_plain(R_l, t_l, R_g, gR_g, gt_g, parents
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    J = R_l.shape[1]
    accR = [gR_g[:, j] for j in range(J)]
    acct = [gt_g[:, j] for j in range(J)]
    gRl = [None] * J
    gtl = [None] * J
    for j in reversed(topo_order(parents)):
        p = int(parents[j])
        Rp = R_g[:, p]
        accR[p] = accR[p] + torch.matmul(accR[j], R_l[:, j].transpose(-1, -2)) \
            + torch.einsum('bi,bk->bik', acct[j], t_l[:, j])
        gRl[j] = torch.matmul(Rp.transpose(-1, -2), accR[j])
        gtl[j] = torch.einsum('bki,bk->bi', Rp, acct[j])
        acct[p] = acct[p] + acct[j]
    gRl[0] = accR[0]
    gtl[0] = acct[0]
    return torch.stack(gRl, dim=1), torch.stack(gtl, dim=1)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/fk.cu)
# ---------------------------------------------------------------------------

def _tree_args(parents):
    J = len(parents)
    par = (ctypes.c_int * J)(*[int(p) for p in parents])
    order = (ctypes.c_int * max(J - 1, 1))(*topo_order(parents))
    return par, order


def fk_fwd_cuda(R_l: torch.Tensor, t_l: torch.Tensor, parents
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the K1 forward kernel (CUDA tensors only)."""
    B, J = R_l.shape[:2]
    dev = R_l.device
    _build.check_input("R_l", R_l, (B, J, 3, 3), dev)
    _build.check_input("t_l", t_l, (B, J, 3), dev)
    if len(parents) != J:
        raise ValueError(f"parents has {len(parents)} entries for J={J}")
    lib = _build.library()
    R_g = torch.empty_like(R_l)
    t_g = torch.empty_like(t_l)
    par, order = _tree_args(parents)
    err = lib.nemo_fk_fwd(R_l.data_ptr(), t_l.data_ptr(), ctypes.addressof(par),
                          ctypes.addressof(order), B, J, R_g.data_ptr(),
                          t_g.data_ptr(), _build.stream_handle(dev))
    _build.check(err, "nemo_fk_fwd")
    LAUNCHES["fk_fwd"] += 1
    return R_g, t_g


def fk_bwd_cuda(R_l, t_l, R_g, gR_g, gt_g, parents
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the K1 backward kernel (CUDA tensors only)."""
    B, J = R_l.shape[:2]
    dev = R_l.device
    for name, t, shape in (("R_l", R_l, (B, J, 3, 3)), ("t_l", t_l, (B, J, 3)),
                           ("R_g", R_g, (B, J, 3, 3)),
                           ("gR_g", gR_g, (B, J, 3, 3)),
                           ("gt_g", gt_g, (B, J, 3))):
        _build.check_input(name, t, shape, dev)
    if len(parents) != J:
        raise ValueError(f"parents has {len(parents)} entries for J={J}")
    lib = _build.library()
    acc = torch.empty((J * 12, B), dtype=torch.float32, device=dev)
    gR_l = torch.empty_like(R_l)
    gt_l = torch.empty_like(t_l)
    par, order = _tree_args(parents)
    err = lib.nemo_fk_bwd(R_l.data_ptr(), t_l.data_ptr(), R_g.data_ptr(),
                          gR_g.data_ptr(), gt_g.data_ptr(),
                          ctypes.addressof(par), ctypes.addressof(order), B, J,
                          acc.data_ptr(), gR_l.data_ptr(), gt_l.data_ptr(),
                          _build.stream_handle(dev))
    _build.check(err, "nemo_fk_bwd")
    LAUNCHES["fk_bwd"] += 1
    return gR_l, gt_l


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

class FKCompose(torch.autograd.Function):
    """Forward = K1 forward kernel, backward = K1 backward kernel (plain
    versions for CPU tensors). A transposed or offset CUDA view is copied
    once, contiguous, before the kernel; the cotangents likewise."""

    @staticmethod
    def forward(ctx, R_l, t_l, parents):
        if _build.route(R_l, t_l) == "cpu":
            R_g, t_g = fk_fwd_plain(R_l, t_l, parents)
        else:
            R_l, t_l = (_build.kernel_operand(t) for t in (R_l, t_l))
            R_g, t_g = fk_fwd_cuda(R_l, t_l, parents)
        ctx.parents = parents
        ctx.save_for_backward(R_l, t_l, R_g)
        return R_g, t_g

    @staticmethod
    def backward(ctx, gR_g, gt_g):
        R_l, t_l, R_g = ctx.saved_tensors
        gR_g = torch.zeros_like(R_g) if gR_g is None else gR_g.contiguous()
        gt_g = torch.zeros_like(t_l) if gt_g is None else gt_g.contiguous()
        if _build.route(R_l, gR_g, gt_g) == "cpu":
            gR_l, gt_l = fk_bwd_plain(R_l, t_l, R_g, gR_g, gt_g, ctx.parents)
        else:
            gR_l, gt_l = fk_bwd_cuda(R_l, t_l, R_g, gR_g, gt_g, ctx.parents)
        return gR_l, gt_l, None


def fk_compose(R_l: torch.Tensor, t_l: torch.Tensor, parents
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose local (R, t) transforms over a static kinematic tree.

    R_l: (B, J, 3, 3) local rotations; t_l: (B, J, 3) local offsets;
    parents: J ints, parents[0] ignored for the root.
    Returns (R_global (B, J, 3, 3), t_global (B, J, 3)).
    """
    return FKCompose.apply(R_l, t_l, tuple(int(p) for p in parents))
