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

On a CUDA tensor the op launches ``csrc/mlp.cu`` (every product on the
tensor cores in 3xTF32, operations-bound at the fit's batch; the source
note has the design), with no fallback. On a CPU tensor it runs
:func:`motion_net_mlp_plain` and :func:`motion_net_mlp_bwd_plain`, which
mirror ``_fwd_kernel`` and ``_bwd_kernel`` step by step;
:func:`motion_net_mlp_split_emulation` and
:func:`motion_net_mlp_bwd_split_emulation` repeat the kernels' arithmetic
for the tests.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ._emulation import in_order, mm_3xtf32

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
# the kernels' arithmetic, emulated (tests only)
# ---------------------------------------------------------------------------

# csrc/mlp.cu's output tile (kBM x kBN), contraction slice (kBK), the depth
# of one tensor-core sum (kChain), blocks a launch aims at per SM, and the
# split's limits
TILE_M, TILE_N, SLICE, CHAIN = 128, 64, 32, 16
BLOCKS_PER_SM, MAX_SPLIT, MIN_SPLIT_SLICES = 2, 16, 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tiles(rows: int, N: int) -> int:
    return _cdiv(rows, TILE_M) * _cdiv(N, TILE_N)


def split_plan(tiles: int, others: int, K: int, num_sms: int = 132
               ) -> Tuple[int, int]:
    """(S, slices a range) of a product with ``tiles`` output tiles launched
    beside ``others`` tiles of another product (csrc/mlp.cu: plan)."""
    kt = _cdiv(K, SLICE)
    S = max(1, min((BLOCKS_PER_SM * num_sms - others) // tiles,
                   kt // MIN_SPLIT_SLICES, MAX_SPLIT))
    kps = _cdiv(kt, S)
    return _cdiv(kt, kps), kps


def _product(a, b, others: int, num_sms: int, ones_row: bool = False):
    """a (M, K) @ b (K, N) as the GEMM routine sums it: each CHAIN-deep
    piece in 3xTF32, the pieces of a contraction range summed in order, then
    the ranges' partials in order; with ``ones_row`` one more row of ones in
    a (the bias gradient: b's column sums)."""
    if ones_row:
        a = torch.cat([a, a.new_ones((1, a.shape[1]))])
    K = a.shape[1]
    _, kps = split_plan(_tiles(a.shape[0], b.shape[1]), others, K, num_sms)
    w = kps * SLICE
    return in_order([
        in_order([mm_3xtf32(a[:, k:k + CHAIN], b[k:k + CHAIN])
                  for k in range(r, min(r + w, K), CHAIN)])
        for r in range(0, K, w)])


def motion_net_mlp_split_emulation(x, W1, b1, W2, b2, W3, b3, Wo, bo,
                                   num_sms: int = 132) -> Acts:
    """(out, h1, h2, z) in K6f's arithmetic: each layer's product in
    3xTF32 CHAIN deep at a time, those sums and the split-K partials in the
    kernel's order for the plan at ``num_sms``, then the bias and the ReLU. Nothing on the main path
    calls it: the tests hold it against the JAX kernel and
    motion_net_mlp_plain to show that the split and the reduction order stay
    inside the tolerances."""
    h1 = torch.relu(_product(x, W1, 0, num_sms) + b1)
    h2 = torch.relu(_product(h1, W2, 0, num_sms) + b2)
    z = torch.relu(_product(h2, W3, 0, num_sms) + b3)
    return _product(z, Wo, 0, num_sms) + bo, h1, h2, z


def motion_net_mlp_bwd_split_emulation(gout, x, h1, h2, z, W1, W2, W3, Wo,
                                       num_sms: int = 132):
    """(gx, gW1, gb1, gW2, gb2, gW3, gb3, gWo, gbo) in K6b's arithmetic: a
    layer's gW (with the bias gradient as its ones row) and gact products
    planned as the one launch that holds both, each in 3xTF32 with its
    partials summed in order, then the ReLU mask. For the tests, as
    :func:`motion_net_mlp_split_emulation`."""
    B = gout.shape[0]
    grads = []
    g = gout
    for act, W in ((z, Wo), (h2, W3), (h1, W2), (x, W1)):
        K_in, N = W.shape
        tw, ta = _tiles(K_in + 1, N), _tiles(B, K_in)
        gWb = _product(act.t(), g, ta, num_sms, ones_row=True)
        gact = _product(g, W.t(), tw, num_sms)
        if act is not x:
            gact = gact * (act > 0)
        grads = [gWb[:-1], gWb[-1]] + grads
        g = gact
    return (g, *grads)


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


def gemm_attributes(pair: bool = False) -> dict:
    """The GEMM kernel's registers a thread, shared memory and spills (local
    memory), as the CUDA runtime reports them for the built library: the
    forward's instantiation, or (pair) the backward's."""
    return _build.kernel_attributes("nemo_mlp_attributes", int(pair))


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
