"""Neural modules of the NeMo fit: FCNN, MotionNet, RotNet, monotonic phase
warps, RBF.

Port of nemo_tpu/modules/networks.py. Weights are stored ``(in, out)`` as in
the JAX parameter pytree (``x @ W + b``), so converted JAX parameters load
without transposes. The MotionNet runs as plain ``torch.matmul`` by default,
as the JAX package runs it outside any kernel by default; ``mlp="fused"``
sends its trunk and heads through K6 (``ops.mlp.motion_net_mlp``), the
counterpart of the JAX package's ``NEMO_TPU_NET_FUSED=1``. RotNet and FCNN
stay plain, as in JAX.

Every network product goes through :func:`net_dot` at one of
``ops.mlp.NET_PRECISIONS``, the counterpart of the JAX package's
``NEMO_TPU_NET_PRECISION`` (``networks._dot``): "highest" (f32, the
default), "high" (the bf16x3 split of ``mlp_pallas._kdot``) or "bf16" (one
bf16 pass, f32 accumulation). JAX's fourth name, "default", is the TPU
compiler's choice of passes, not a function the JAX code writes down, and
is refused.

Initializers follow torch's defaults as the JAX package does, drawing from an
explicit ``torch.Generator``; they cannot reproduce jax.random's numbers, so
parity tests start from converted JAX parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..geometry.rotations import rot6d_to_rotmat, rotmat_to_aa
from ..ops.lbs import bf16_round
from ..ops.mlp import bf16_parts, check_precision, mm_parts, motion_net_mlp

IDENTITY_6D = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
MLP_MODES = ("plain", "fused")


class _NetDotHigh(torch.autograd.Function):
    """x @ W in bf16x3 (ops.mlp.mm_parts); the backward applies the same
    split to g W^T and x^T g, as JAX's autodiff carries precision=HIGH into
    the transposes. The forward's parts of x and W are saved, and g is split
    once, so each tensor is split once a step."""

    @staticmethod
    def forward(ctx, x, W):
        xp, Wp = bf16_parts(x), bf16_parts(W)
        ctx.save_for_backward(*xp, *Wp)
        return mm_parts(xp, Wp)

    @staticmethod
    def backward(ctx, g):
        x_hi, x_lo, W_hi, W_lo = ctx.saved_tensors
        gp = bf16_parts(g)
        gx = (mm_parts(gp, (W_hi.t(), W_lo.t()))
              if ctx.needs_input_grad[0] else None)
        gW = (mm_parts((x_hi.t(), x_lo.t()), gp)
              if ctx.needs_input_grad[1] else None)
        return gx, gW


class _NetDotBf16(torch.autograd.Function):
    """bf16(x) @ bf16(W), f32 accumulation and output: ``networks._dot``'s
    function at bf16. Its backward is what JAX's autodiff of that dot
    computes: the f32 cotangent g times the bf16 operand in f32, the result
    rounded to bf16 (gx = bf16(g bf16(W)^T), gW = bf16(bf16(x)^T g)). K6b
    rounds the operands instead (ops.mlp.motion_net_mlp_bwd_plain): the two
    are different functions, as in JAX."""

    @staticmethod
    def forward(ctx, x, W):
        xb, Wb = bf16_round(x), bf16_round(W)
        ctx.save_for_backward(xb, Wb)
        return xb @ Wb

    @staticmethod
    def backward(ctx, g):
        xb, Wb = ctx.saved_tensors
        gx = bf16_round(g @ Wb.t()) if ctx.needs_input_grad[0] else None
        gW = bf16_round(xb.t() @ g) if ctx.needs_input_grad[1] else None
        return gx, gW


def net_dot(x: torch.Tensor, W: torch.Tensor,
            precision: str = "highest") -> torch.Tensor:
    """x @ W at one of NET_PRECISIONS, with its gradient. On the card the
    bf16 forms are f32 products of the bf16-rounded parts with TF32 off:
    each product of two bf16 values is exact in f32, so that is the
    function of bf16 operands with an f32 result."""
    check_precision(precision)
    if precision == "highest":
        return x @ W
    if precision == "high":
        return _NetDotHigh.apply(x, W)
    return _NetDotBf16.apply(x, W)


def _uniform(shape, bound: float, generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def _linear_init(fan_in: int, fan_out: int, generator):
    """torch.nn.Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return (_uniform((fan_in, fan_out), bound, generator),
            _uniform((fan_out,), bound, generator))


class FCNN(nn.Module):
    """3-layer ReLU MLP (reference neural_motion_model.py:58-71)."""

    def __init__(self, input_dim: int, h_dim: int, output_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for i, (a, b) in enumerate(((input_dim, h_dim), (h_dim, h_dim),
                                    (h_dim, output_dim)), start=1):
            W, bias = _linear_init(a, b, generator)
            setattr(self, f"W{i}", nn.Parameter(W))
            setattr(self, f"b{i}", nn.Parameter(bias))

    def forward(self, x: torch.Tensor, precision: str = "highest"
                ) -> torch.Tensor:
        h = torch.relu(net_dot(x, self.W1, precision) + self.b1)
        h = torch.relu(net_dot(h, self.W2, precision) + self.b2)
        return net_dot(h, self.W3, precision) + self.b3


class MotionNet(nn.Module):
    """Trunk -> (per-joint 6D rotations, linear head); n_joints counts the
    global orientation plus the body joints (24 for NeMo)."""

    def __init__(self, input_dim: int, h_dim: int, n_joints: int,
                 n_linear_out: int = 3, init_last_layer_zero: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_joints = n_joints
        self.trunk = FCNN(input_dim, h_dim, h_dim, generator)
        gain = 1e-5 if init_last_layer_zero else 0.01
        a = gain * math.sqrt(6.0 / (h_dim + n_joints * 6))
        self.W_rot = nn.Parameter(_uniform((h_dim, n_joints * 6), a, generator))
        b_rot = (torch.tensor(IDENTITY_6D).repeat(n_joints)
                 if init_last_layer_zero else torch.zeros(n_joints * 6))
        self.b_rot = nn.Parameter(b_rot)
        W_lin, b_lin = _linear_init(h_dim, n_linear_out, generator)
        self.W_lin = nn.Parameter(W_lin)
        self.b_lin = nn.Parameter(b_lin)

    def forward(self, x: torch.Tensor, mlp: str = "plain",
                precision: str = "highest"
                ) -> Tuple[dict, dict, torch.Tensor]:
        """(pose_dict, orient_dict, trans); the dicts carry 'rot6d',
        'rotmat' and 'pose' (axis-angle). Joint 0 is the global orient.
        mlp: "plain" (torch matmuls) or "fused" (K6, the same forward);
        precision: the products' (net_dot). At "bf16" the two modes'
        backwards differ as JAX's do (_NetDotBf16)."""
        B = x.shape[0]
        if mlp == "fused":
            rot6d, trans = motion_net_mlp(self, x, precision)
        elif mlp == "plain":
            z = torch.relu(self.trunk(x, precision))
            rot6d = net_dot(z, self.W_rot, precision) + self.b_rot
            trans = net_dot(z, self.W_lin, precision) + self.b_lin
        else:
            raise ValueError(f"mlp {mlp!r}: expected one of {MLP_MODES}")
        rotmat = rot6d_to_rotmat(rot6d.reshape(B, self.n_joints, 6))
        pose = rotmat_to_aa(rotmat).reshape(B, self.n_joints * 3)
        orient = {"rot6d": rot6d[:, :6], "rotmat": rotmat[:, :1],
                  "pose": pose[:, :3]}
        pose_d = {"rot6d": rot6d[:, 6:], "rotmat": rotmat[:, 1:],
                  "pose": pose[:, 3:]}
        return pose_d, orient, trans


class RotNet(nn.Module):
    """Trunk -> per-joint 6D rotations: model version 0's pose and orient
    networks (reference neural_motion_model.py:74-103)."""

    def __init__(self, input_dim: int, h_dim: int, n_joints: int,
                 init_last_layer_zero: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_joints = n_joints
        self.trunk = FCNN(input_dim, h_dim, h_dim, generator)
        gain = 1e-5 if init_last_layer_zero else 0.01
        a = gain * math.sqrt(6.0 / (h_dim + n_joints * 6))
        self.W_rot = nn.Parameter(_uniform((h_dim, n_joints * 6), a, generator))
        self.b_rot = nn.Parameter(
            torch.tensor(IDENTITY_6D).repeat(n_joints) if init_last_layer_zero
            else torch.zeros(n_joints * 6))

    def forward(self, x: torch.Tensor, precision: str = "highest") -> dict:
        """{'rot6d', 'rotmat', 'pose' (axis-angle)} over all n_joints;
        precision: the products' (net_dot)."""
        B = x.shape[0]
        rot6d = net_dot(torch.relu(self.trunk(x, precision)), self.W_rot,
                        precision) + self.b_rot
        rotmat = rot6d_to_rotmat(rot6d.reshape(B, self.n_joints, 6))
        pose = rotmat_to_aa(rotmat).reshape(B, self.n_joints * 3)
        return {"rot6d": rot6d, "rotmat": rotmat, "pose": pose}


class MonotonicNets(nn.Module):
    """Per-view monotonic phase warps as stacked (num_views, n_nodes)
    parameters (reference monotonic_network.py:7-39)."""

    def __init__(self, num_views: int, n_nodes: int, init: str = "rand",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if init == "linear":
            shifts = torch.linspace(0.0, 1.0, n_nodes).repeat(num_views, 1)
        elif init == "rand":
            shifts = torch.rand((num_views, n_nodes), generator=generator)
        else:
            raise ValueError(f"unknown init {init!r}")
        self.shifts = nn.Parameter(shifts.clamp(0.0, 1.0))
        self.scales = nn.Parameter(torch.full((num_views, n_nodes), 15.0))


def _monotonic_pass(shifts, scales, x):
    z = torch.relu(scales) * (x - torch.relu(shifts))
    return torch.sigmoid(z).mean(dim=-1, keepdim=True)


def apply_monotonic_single(shifts, scales, x):
    """One warp, renormalized so f(0) = 0 and f(1) = 1."""
    y = _monotonic_pass(shifts, scales, x)
    y0 = _monotonic_pass(shifts, scales, torch.zeros_like(x))
    y1 = _monotonic_pass(shifts, scales, torch.ones_like(x))
    return (y - y0) / (y1 - y0 + 1e-6)


def apply_monotonic_gather(p: MonotonicNets, view_idx: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """Warp each sample (B, 1) through its own view's network (a gather of
    per-sample parameters, not all views x all samples)."""
    return apply_monotonic_single(p.shifts[view_idx], p.scales[view_idx], x)


# ---------------------------------------------------------------------------
# RBF phase embedding (reference nemo/rbf.py:11-139)
# ---------------------------------------------------------------------------

RBF_KERNELS: Dict[str, Callable] = {
    "gaussian": lambda a: torch.exp(-(a ** 2)),
    "linear": lambda a: a,
    "quadratic": lambda a: a ** 2,
    "inverse quadratic": lambda a: 1.0 / (1.0 + a ** 2),
    "multiquadric": lambda a: torch.sqrt(1.0 + a ** 2),
    "inverse multiquadric": lambda a: 1.0 / torch.sqrt(1.0 + a ** 2),
    "spline": lambda a: a ** 2 * torch.log(a + 1.0),
    "poisson one": lambda a: (a - 1.0) * torch.exp(-a),
    "poisson two": lambda a: ((a - 2.0) / 2.0) * a * torch.exp(-a),
    "matern32": lambda a: ((1.0 + math.sqrt(3.0) * a)
                           * torch.exp(-math.sqrt(3.0) * a)),
    "matern52": lambda a: ((1.0 + math.sqrt(5.0) * a + (5.0 / 3.0) * a ** 2)
                           * torch.exp(-math.sqrt(5.0) * a)),
}


class RBF(nn.Module):
    """Fixed centres linspace(0, 1, K); learned log_sigmas, init 0."""

    def __init__(self, out_features: int):
        super().__init__()
        if out_features <= 2:
            raise ValueError("RBF needs more than 2 features")
        self.log_sigmas = nn.Parameter(torch.zeros(out_features))


def apply_rbf(p: RBF, x: torch.Tensor, kernel: str = "linear") -> torch.Tensor:
    """x (B, 1) -> (B, K) with squared distances d = (x - c)^2 / e^log_sigma
    (no sqrt, the reference's NaN-gradient fix)."""
    K = p.log_sigmas.shape[0]
    c = torch.linspace(0.0, 1.0, K, dtype=x.dtype, device=x.device)
    d = (x - c[None, :]) ** 2 / torch.exp(p.log_sigmas)[None, :]
    return RBF_KERNELS[kernel](d)
