"""The fused MotionNet MLP: kernel K6 (forward K6f, backward K6b).

Replaces nemo_tpu/ops/mlp_pallas.py: ``_mlp_fwd_impl`` (``_fwd_kernel``)
and ``_mlp_vjp_bwd`` (``_bwd_kernel``), glued by ``jax.custom_vjp`` there
and by the ``torch.autograd.Function`` :class:`MotionNetMLP` here, behind
the same contract: ``motion_net_mlp(motion, x) -> (rot6d, trans)``.

The trunk's three linear layers, each followed by a ReLU (the third is the
ReLU ``apply_motion_net`` puts on the trunk), and both heads concatenated
into one (H, O) output product, O = 6 n_joints + n_linear_out. The heads
are concatenated in the autograd graph, so their gradients split back to
the raw ``W_rot``/``W_lin``/``b_rot``/``b_lin`` and optimizer state keeps
its shapes, as JAX's differentiable ``pad_motion_net_params`` does. Nothing
is padded: the kernels mask the ragged edges.

On a CUDA tensor the op launches ``csrc/mlp.cu`` (f32 FMA on the CUDA
cores, operations-bound at the fit's batch; the source note has the design),
with no fallback. On a CPU tensor it runs :func:`motion_net_mlp_plain` and
:func:`motion_net_mlp_bwd_plain`, which mirror ``_fwd_kernel`` and
``_bwd_kernel`` step by step.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

LAUNCHES = {"mlp_fwd": 0, "mlp_bwd": 0}

Acts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def motion_net_mlp_plain(x, W1, b1, W2, b2, W3, b3, Wo, bo) -> Acts:
    """(out (B, O), h1, h2, z (B, H)) of ``_fwd_kernel``: three linear +
    ReLU layers, then the concatenated heads (no ReLU)."""
    h1 = torch.relu(x @ W1 + b1)
    h2 = torch.relu(h1 @ W2 + b2)
    z = torch.relu(h2 @ W3 + b3)
    return z @ Wo + bo, h1, h2, z


def motion_net_mlp_bwd_plain(gout, x, h1, h2, z, W1, W2, W3, Wo):
    """(gx, gW1, gb1, gW2, gb2, gW3, gb3, gWo, gbo) of ``_bwd_kernel`` under
    the cotangent gout (B, O): weight gradients act^T g, bias gradients
    column sums, and each cotangent masked by its saved post-ReLU
    activation (act > 0)."""
    gWo, gbo = z.t() @ gout, gout.sum(0)
    gz = (gout @ Wo.t()) * (z > 0)
    gW3, gb3 = h2.t() @ gz, gz.sum(0)
    gh2 = (gz @ W3.t()) * (h2 > 0)
    gW2, gb2 = h1.t() @ gh2, gh2.sum(0)
    gh1 = (gh2 @ W2.t()) * (h1 > 0)
    gW1, gb1 = x.t() @ gh1, gh1.sum(0)
    return gh1 @ W1.t(), gW1, gb1, gW2, gb2, gW3, gb3, gWo, gbo


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/mlp.cu)
# ---------------------------------------------------------------------------

def _dims(x, W1, Wo, **tensors):
    """Validate the operands against (B, D, H, O) from x, W1 and Wo;
    returns (B, D, H, O, device)."""
    (B, D), H, O = x.shape, W1.shape[1], Wo.shape[1]
    dev = x.device
    shapes = {"x": (B, D), "W1": (D, H), "b1": (H,), "W2": (H, H),
              "b2": (H,), "W3": (H, H), "b3": (H,), "Wo": (H, O), "bo": (O,),
              "h1": (B, H), "h2": (B, H), "z": (B, H), "gout": (B, O)}
    for name, t in dict(x=x, W1=W1, Wo=Wo, **tensors).items():
        _build.check_input(name, t, shapes[name], dev)
    return B, D, H, O, dev


def _scratch(lib, B, D, H, O, dev) -> torch.Tensor:
    n = lib.nemo_mlp_scratch_floats(B, D, H, O)
    if n < 0:
        raise ValueError(f"nemo_mlp: shape (B, D, H, O) = {(B, D, H, O)} "
                         "is out of the kernels' range")
    return torch.empty(max(n, 1), dtype=torch.float32, device=dev)


def mlp_fwd_cuda(x, W1, b1, W2, b2, W3, b3, Wo, bo) -> Acts:
    """Launch K6f (CUDA tensors only): (out (B, O), h1, h2, z (B, H))."""
    B, D, H, O, dev = _dims(x, W1, Wo, b1=b1, W2=W2, b2=b2, W3=W3, b3=b3,
                            bo=bo)
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((B, O), **f32)
    h1, h2, z = (torch.empty((B, H), **f32) for _ in range(3))
    scratch = _scratch(lib, B, D, H, O, dev)
    err = lib.nemo_mlp_fwd(B, D, H, O, *(t.data_ptr() for t in (
        x, W1, b1, W2, b2, W3, b3, Wo, bo, out, h1, h2, z, scratch)),
        _build.stream_handle(dev))
    _build.check(err, "nemo_mlp_fwd")
    LAUNCHES["mlp_fwd"] += 1
    return out, h1, h2, z


def mlp_bwd_cuda(gout, x, h1, h2, z, W1, W2, W3, Wo):
    """Launch K6b (CUDA tensors only): (gx, gW1, gb1, gW2, gb2, gW3, gb3,
    gWo, gbo) under the f32 cotangent gout (B, O)."""
    B, D, H, O, dev = _dims(x, W1, Wo, gout=gout, h1=h1, h2=h2, z=z, W2=W2,
                            W3=W3)
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=dev)
    grads = [torch.empty(s, **f32) for s in
             ((B, D), (D, H), (H,), (H, H), (H,), (H, H), (H,), (H, O), (O,))]
    scratch = _scratch(lib, B, D, H, O, dev)
    err = lib.nemo_mlp_bwd(B, D, H, O, *(t.data_ptr() for t in (
        gout, x, h1, h2, z, W1, W2, W3, Wo, *grads, scratch)),
        _build.stream_handle(dev))
    _build.check(err, "nemo_mlp_bwd")
    LAUNCHES["mlp_bwd"] += 1
    return tuple(grads)


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

class MotionNetMLP(torch.autograd.Function):
    """K6f forward saving x, h1, h2, z; K6b backward."""

    @staticmethod
    def forward(ctx, x, W1, b1, W2, b2, W3, b3, Wo, bo):
        args = tuple(t.contiguous() for t in (x, W1, b1, W2, b2, W3, b3, Wo,
                                                bo))
        fwd = motion_net_mlp_plain if _build.route(*args) == "cpu" \
            else mlp_fwd_cuda
        out, h1, h2, z = fwd(*args)
        x, W1, _, W2, _, W3, _, Wo, _ = args
        ctx.save_for_backward(x, h1, h2, z, W1, W2, W3, Wo)
        return out

    @staticmethod
    def backward(ctx, gout):
        saved = ctx.saved_tensors
        gout = gout.contiguous()
        bwd = motion_net_mlp_bwd_plain if _build.route(gout, *saved) == "cpu" \
            else mlp_bwd_cuda
        return bwd(gout, *saved)


def motion_net_mlp(motion, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rot6d (B, 6 n_joints), trans (B, n_linear_out)) = MotionNet(x)
    through K6. motion: a ``modules.networks.MotionNet`` (its raw
    parameters; the heads are concatenated here, differentiably); x (B, D).
    """
    t = motion.trunk
    Wo = torch.cat([motion.W_rot, motion.W_lin], dim=1)
    bo = torch.cat([motion.b_rot, motion.b_lin])
    out = MotionNetMLP.apply(x, t.W1, t.b1, t.W2, t.b2, t.W3, t.b3, Wo, bo)
    rot_out = motion.W_rot.shape[1]
    return out[:, :rot_out], out[:, rot_out:]
