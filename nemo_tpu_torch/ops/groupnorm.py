"""GroupNorm followed by ReLU: kernel K7 (forward and backward).

``group_norm_relu(x (R, C), gamma (C,), beta (C,), groups)`` is
``relu(group_norm(x))`` with each row's C columns in ``groups`` groups of
neighbouring columns, eps 1e-5: the layer between every pair of linear
layers of HuMoR's MLPs (models/humor.py apply_mlp). It replaces no TPU
kernel: XLA fuses the JAX package's composition (nemo_tpu/models/humor.py
``_group_norm``), which eager PyTorch runs as some 30 kernels a layer.

On a CUDA tensor the forward and backward launch ``csrc/groupnorm.cu``
(one warp a row, the row in registers, each group's sums by shuffles in a
fixed order; the forward saves each (row, group)'s mean and 1 / sqrt(var +
eps), from which the backward recomputes the normalised value and the
ReLU's mask). The backward gives dgamma and dbeta only where gamma or beta
needs a gradient, by partials summed in a fixed order. On a CPU tensor the
op runs the plain version, the eager composition;
``GroupNormReLU`` on CPU tensors runs the kernels' arithmetic
(ops/_emulation.py gn_relu_fwd_emulation, gn_relu_bwd_emulation).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._emulation import gn_relu_bwd_emulation, gn_relu_fwd_emulation
from ..utils.trace import launch

LAUNCHES = {"humor_gn_fwd": 0, "humor_gn_bwd": 0}

EPS = 1e-5
KWARPS = 8                 # rows a block (csrc/groupnorm.cu kWarps)
_MAX_PARTIAL_BLOCKS = 256  # kMaxPartialBlocks
_ROWS_PER_PARTIAL_BLOCK = 64


def wgrad_blocks(R: int) -> int:
    """Blocks of the backward that sums dgamma and dbeta at R rows, each of
    ceil(R / blocks) rows but the last (csrc/groupnorm.cu wgrad_blocks)."""
    if R <= _ROWS_PER_PARTIAL_BLOCK:
        return 1
    nb = min(-(-R // _ROWS_PER_PARTIAL_BLOCK), _MAX_PARTIAL_BLOCKS)
    rpb = -(-R // nb)
    return -(-R // rpb)


def refusal(C: int, groups: int) -> Optional[str]:
    """Why the kernels do not take width C in ``groups`` groups, or None
    where they do: C a multiple of 128 up to 1024, groups of S columns with
    S a multiple of 4 and S / 4 a divisor or a multiple of 32."""
    if C % 128 or not 0 < C <= 1024:
        return f"C = {C}: K7 takes a multiple of 128 up to 1024"
    if groups <= 0 or C % groups:
        return f"C = {C} does not split into {groups} groups"
    S = C // groups
    q = S // 4
    if S % 4 or (32 % q if q <= 32 else q % 32):
        return (f"groups of {S} columns: K7 takes S a multiple of 4 with "
                "S / 4 a divisor or a multiple of 32")
    return None


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def group_norm_plain(x: torch.Tensor, gamma, beta, groups: int,
                     eps: float = EPS) -> torch.Tensor:
    """GroupNorm of (R, C) rows as HuMoR's MLPs compose it (models/humor.py
    ``_group_norm``): the group's mean, the mean of the centred squares,
    the division by sqrt(var + eps), the affine step."""
    R, C = x.shape
    xg = x.reshape(R, groups, C // groups)
    m = xg.mean(dim=2, keepdim=True)
    v = ((xg - m) ** 2).mean(dim=2, keepdim=True)
    xg = (xg - m) / torch.sqrt(v + eps)
    return xg.reshape(R, C) * gamma + beta


def group_norm_relu_plain(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, groups: int,
                          eps: float = EPS) -> torch.Tensor:
    """The eager composition that K7 replaces: group_norm_plain, then a
    ReLU."""
    return torch.relu(group_norm_plain(x, gamma, beta, groups, eps))


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/groupnorm.cu)
# ---------------------------------------------------------------------------

def _check(x, gamma, beta, groups) -> Tuple[int, int]:
    R, C = x.shape
    why = refusal(C, groups)
    if why:
        raise ValueError(why)
    dev = x.device
    _build.check_input("x", x, (R, C), dev)
    _build.check_input("gamma", gamma, (C,), dev)
    _build.check_input("beta", beta, (C,), dev)
    return R, C


def gn_relu_fwd_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     groups: int, eps: float = EPS
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K7's forward (CUDA tensors, 16-byte aligned): (y (R, C), mean
    (R, G), rstd (R, G))."""
    R, C = _check(x, gamma, beta, groups)
    y = torch.empty_like(x)
    mean = x.new_empty((R, groups))
    rstd = x.new_empty((R, groups))
    with launch(LAUNCHES, "humor_gn_fwd"):
        _build.check(_build.library().nemo_gn_relu_fwd(
            R, C, groups, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            eps, y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            _build.stream_handle(x.device)), "nemo_gn_relu_fwd")
    return y, mean, rstd


def gn_relu_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     mean: torch.Tensor, rstd: torch.Tensor, gy: torch.Tensor,
                     groups: int, wgrad: bool = False):
    """Launch K7's backward (CUDA tensors): (dx, dgamma, dbeta), the last
    two None unless wgrad."""
    R, C = _check(x, gamma, beta, groups)
    dev = x.device
    _build.check_input("gy", gy, (R, C), dev)
    _build.check_input("mean", mean, (R, groups), dev)
    _build.check_input("rstd", rstd, (R, groups), dev)
    lib = _build.library()
    dx = torch.empty_like(x)
    dgamma = dbeta = None
    ptrs = (0, 0, 0)
    if wgrad:
        dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(beta)
        scratch = x.new_empty((lib.nemo_gn_relu_scratch_floats(R, C),))
        ptrs = (dgamma.data_ptr(), dbeta.data_ptr(), scratch.data_ptr())
    with launch(LAUNCHES, "humor_gn_bwd"):
        _build.check(lib.nemo_gn_relu_bwd(
            R, C, groups, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), gy.data_ptr(), dx.data_ptr(),
            *ptrs, _build.stream_handle(dev)), "nemo_gn_relu_bwd")
    return dx, dgamma, dbeta


def gn_relu_attributes(backward: bool = False, wgrad: bool = False,
                       C: int = 1024) -> dict:
    """K7's forward or backward kernel (wgrad: the one that sums dgamma and
    dbeta) at width C: registers a thread, shared memory, spills."""
    return _build.kernel_attributes("nemo_gn_relu_attributes", int(backward),
                                    int(wgrad), C)


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

class GroupNormReLU(torch.autograd.Function):
    """Forward = K7's forward kernel, backward = K7's backward kernel (on
    CPU tensors their emulations). x is copied once, contiguous and 16-byte
    aligned, where it is not already."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps):
        x, gamma, beta = (_build.kernel_operand(t, 16)
                          for t in (x, gamma, beta))
        if _build.route(x, gamma, beta) == "cpu":
            y, mean, rstd = gn_relu_fwd_emulation(x, gamma, beta, groups, eps)
        else:
            y, mean, rstd = gn_relu_fwd_cuda(x, gamma, beta, groups, eps)
        ctx.groups = groups
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        gy = _build.kernel_operand(gy.contiguous(), 16)
        wgrad = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        if _build.route(x, gy) == "cpu":
            dx, dg, db = gn_relu_bwd_emulation(x, gamma, beta, mean, rstd, gy,
                                               ctx.groups, wgrad)
        else:
            dx, dg, db = gn_relu_bwd_cuda(x, gamma, beta, mean, rstd, gy,
                                          ctx.groups, wgrad)
        return (dx if ctx.needs_input_grad[0] else None,
                dg if ctx.needs_input_grad[1] else None,
                db if ctx.needs_input_grad[2] else None, None, None)


def group_norm_relu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    groups: int, eps: float = EPS) -> torch.Tensor:
    """relu(group_norm(x)) over (R, C) rows in ``groups`` groups: K7 on
    CUDA tensors, the plain version on CPU tensors."""
    if _build.route(x, gamma, beta) == "cpu":
        return group_norm_relu_plain(x, gamma, beta, groups, eps)
    return GroupNormReLU.apply(x, gamma, beta, groups, eps)
