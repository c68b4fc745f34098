"""Kinematic-chain composition: kernel K1 (forward and backward).

Replaces nemo_tpu/ops/fk_pallas.py: ``_fk_fwd_pallas`` (``_fk_fwd_kernel``)
and ``_fk_bwd_pallas`` (``_fk_bwd_kernel``), behind the same public op
``fk_compose(R_l (B,J,3,3), t_l (B,J,3), parents) -> (R_g, t_g)``.

On a CUDA tensor the forward and backward launch the hand-written kernels of
``csrc/fk.cu``. They are bound by the launch and by the tree's dependent
chain, not by their bytes: a block takes a tile of batch elements in shared
memory and walks the tree level by level (:func:`kinematic_tree`, built once
per tree), the backward with its accumulators on-chip. The source note
there has the details; :func:`fk_fwd_emulation` and :func:`fk_bwd_emulation`
repeat the kernels' arithmetic on the CPU. On a CPU tensor the op runs the
plain versions below, which mirror ``_fk_xla`` and ``_bwd_xla``: the plain
backward is the explicit reverse accumulation, not autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from . import _build
from ._emulation import fma as _fma
from ..utils.trace import launch

LAUNCHES = {"fk_fwd": 0, "fk_bwd": 0}


class KinematicTree(NamedTuple):
    """A tree's joints grouped for the kernels (see :func:`kinematic_tree`)."""
    parents: Tuple[int, ...]
    levels: Tuple[Tuple[int, ...], ...]    # joints by depth, root alone first
    children: Tuple[Tuple[int, ...], ...]  # per joint, reverse topological
    packed: ctypes.Array                   # what csrc/fk.cu's make_tree reads
    address: int                           # of packed, passed to the kernels

    @property
    def order(self) -> Tuple[int, ...]:
        """Every joint, parents before children: the levels in turn."""
        return tuple(j for level in self.levels for j in level)


@functools.lru_cache(maxsize=None)
def kinematic_tree(parents: Tuple[int, ...]) -> KinematicTree:
    """The levels and child lists of the tree ``parents`` (parents[0], the
    root's, is ignored; every other joint's parent comes before it), built
    once per tree. Level d holds the joints at depth d in index order, so
    the levels in turn are nemo_tpu's ``_topo_order`` after the root; a
    joint's children are listed in reverse topological order, the order in
    which ``fk_bwd_plain`` folds them into it."""
    J = len(parents)
    if J < 1:
        raise ValueError("a kinematic tree needs at least the root")
    depth = [0] * J
    for j in range(1, J):
        p = int(parents[j])
        if not 0 <= p < j:
            raise ValueError(f"joint {j} has parent {p}: each joint's parent "
                             "must come before it")
        depth[j] = depth[p] + 1
    levels = tuple(tuple(j for j in range(J) if depth[j] == d)
                   for d in range(max(depth) + 1))
    order = [j for level in levels for j in level]
    children = tuple(tuple(j for j in reversed(order[1:])
                           if int(parents[j]) == p) for p in range(J))
    par = (0,) + tuple(int(p) for p in parents[1:])
    level_start = [0]
    for level in levels:
        level_start.append(level_start[-1] + len(level))
    child_start = [0]
    for ch in children:
        child_start.append(child_start[-1] + len(ch))
    flat = [J, len(levels), *par, *order, *level_start, *child_start,
            *(j for ch in children for j in ch)]
    packed = (ctypes.c_int * len(flat))(*flat)
    return KinematicTree(par, levels, children, packed,
                         ctypes.addressof(packed))


def topo_order(parents: Sequence[int]) -> Tuple[int, ...]:
    """Joints other than the root, parents before children (stable by
    depth), as nemo_tpu's ``_topo_order``."""
    return kinematic_tree(tuple(int(p) for p in parents)).order[1:]


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
# the kernels' arithmetic on the CPU (csrc/fk.cu, step for step)
# ---------------------------------------------------------------------------

def _dot3(a, b):
    """The kernel's dot3 over the last axis: fma(a2, b2, fma(a1, b1,
    a0 b0))."""
    return _fma(a[..., 2], b[..., 2],
                _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def fk_fwd_emulation(R_l: torch.Tensor, t_l: torch.Tensor, parents
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """csrc/fk.cu's forward on f32 CPU tensors: level by level, each entry
    one dot3 of the parent's row with the local column."""
    tree = kinematic_tree(tuple(int(p) for p in parents))
    R_g, t_g = R_l.clone(), t_l.clone()
    for level in tree.levels[1:]:
        js = list(level)
        ps = [tree.parents[j] for j in js]
        Rp = R_g[:, ps]
        R_g[:, js] = _dot3(Rp[..., :, None, :],
                           R_l[:, js].transpose(-1, -2)[..., None, :, :])
        t_g[:, js] = _dot3(Rp, t_l[:, js][..., None, :]) + t_g[:, ps]
    return R_g, t_g


def fk_bwd_emulation(R_l, t_l, R_g, gR_g, gt_g, parents
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """csrc/fk.cu's backward on f32 CPU tensors: deepest level first, the
    level's local cotangents, then each parent folding its children's
    contributions into its accumulator in the kernel's order."""
    tree = kinematic_tree(tuple(int(p) for p in parents))
    accR, acct = gR_g.clone(), gt_g.clone()
    gR_l, gt_l = torch.empty_like(R_l), torch.empty_like(t_l)
    for d in range(len(tree.levels) - 1, 0, -1):
        js = list(tree.levels[d])
        RpT = R_g[:, [tree.parents[j] for j in js]].transpose(-1, -2)
        gR_l[:, js] = _dot3(RpT[..., :, None, :],
                            accR[:, js].transpose(-1, -2)[..., None, :, :])
        gt_l[:, js] = _dot3(RpT, acct[:, js][..., None, :])
        for p in tree.levels[d - 1]:
            for j in tree.children[p]:
                accR[:, p] = accR[:, p] + _fma(
                    acct[:, j][..., :, None], t_l[:, j][..., None, :],
                    _dot3(accR[:, j][..., :, None, :],
                          R_l[:, j][..., None, :, :]))
                acct[:, p] = acct[:, p] + acct[:, j]
    gR_l[:, 0], gt_l[:, 0] = accR[:, 0], acct[:, 0]
    return gR_l, gt_l


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/fk.cu)
# ---------------------------------------------------------------------------

def fk_fwd_cuda(R_l: torch.Tensor, t_l: torch.Tensor, parents
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the K1 forward kernel (CUDA tensors only)."""
    B, J = R_l.shape[:2]
    dev = R_l.device
    _build.check_input("R_l", R_l, (B, J, 3, 3), dev)
    _build.check_input("t_l", t_l, (B, J, 3), dev)
    tree = _kernel_tree(parents, J)
    lib = _build.library()
    R_g = torch.empty_like(R_l)
    t_g = torch.empty_like(t_l)
    with launch(LAUNCHES, "fk_fwd"):
        err = lib.nemo_fk_fwd(R_l.data_ptr(), t_l.data_ptr(), tree.address,
                              B, J, R_g.data_ptr(), t_g.data_ptr(),
                              _build.stream_handle(dev))
        _build.check(err, "nemo_fk_fwd")
    return R_g, t_g


def fk_bwd_cuda(R_l, t_l, R_g, gR_g, gt_g, parents
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the K1 backward kernel (CUDA tensors only). It keeps its
    accumulators on-chip: no scratch is allocated."""
    B, J = R_l.shape[:2]
    dev = R_l.device
    for name, t, shape in (("R_l", R_l, (B, J, 3, 3)), ("t_l", t_l, (B, J, 3)),
                           ("R_g", R_g, (B, J, 3, 3)),
                           ("gR_g", gR_g, (B, J, 3, 3)),
                           ("gt_g", gt_g, (B, J, 3))):
        _build.check_input(name, t, shape, dev)
    tree = _kernel_tree(parents, J)
    lib = _build.library()
    gR_l = torch.empty_like(R_l)
    gt_l = torch.empty_like(t_l)
    with launch(LAUNCHES, "fk_bwd"):
        err = lib.nemo_fk_bwd(R_l.data_ptr(), t_l.data_ptr(), R_g.data_ptr(),
                              gR_g.data_ptr(), gt_g.data_ptr(), tree.address,
                              B, J, gR_l.data_ptr(), gt_l.data_ptr(),
                              _build.stream_handle(dev))
        _build.check(err, "nemo_fk_bwd")
    return gR_l, gt_l


def _kernel_tree(parents, J: int) -> KinematicTree:
    tree = kinematic_tree(tuple(parents))
    if len(tree.parents) != J:
        raise ValueError(f"parents has {len(tree.parents)} entries for J={J}")
    return tree


def fk_empty_cuda(B: int, J: int, backward: bool, device) -> None:
    """Launch an empty kernel on K1's grid and shared memory at (B, J): its
    device time is the launch floor beside K1's (not counted in
    LAUNCHES)."""
    _build.check(_build.library().nemo_fk_empty(
        B, J, int(backward), _build.stream_handle(torch.device(device))),
        "nemo_fk_empty")


def fk_attributes(backward: bool = False, J: int = 24) -> dict:
    """The forward or backward kernel's registers a thread, shared memory
    (the dynamic bytes at J joints) and spills (local memory)."""
    return _build.kernel_attributes("nemo_fk_attributes", int(backward), J)


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
