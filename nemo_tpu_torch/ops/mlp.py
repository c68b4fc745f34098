"""The fused MotionNet MLP: kernel K6 (forward K6f, backward K6b).

Replaces nemo_tpu/ops/mlp_pallas.py: ``_mlp_fwd_impl`` (``_fwd_kernel``)
and ``_mlp_vjp_bwd`` (``_bwd_kernel``), glued by ``jax.custom_vjp`` there
and by the ``torch.autograd.Function`` :class:`MotionNetMLP` here, behind
the same contract: ``motion_net_mlp(motion, x, precision) -> (rot6d,
trans)``.

The trunk's three linear layers, each followed by a ReLU (the third is the
ReLU ``apply_motion_net`` puts on the trunk), and both heads concatenated
into one (H, O) output product, O = 6 n_joints + n_linear_out. The heads
are concatenated in the autograd graph, so their gradients split back to
the raw ``W_rot``/``W_lin``/``b_rot``/``b_lin`` and optimizer state keeps
its shapes, as JAX's differentiable ``pad_motion_net_params`` does. Nothing
is padded: the kernels mask the ragged edges.

Precision. Every product runs at one of NET_PRECISIONS, ``_kdot``'s three
policies (the JAX package's NEMO_TPU_NET_PRECISION): "highest" (f32),
"high" (both operands split into hi = bf16(a) and lo = bf16(a - hi), the
three products hi.hi + lo.hi + hi.lo summed in f32, lo.lo dropped) or
"bf16" (both operands rounded to bf16, one product, f32 result). The bias
gradients are f32 column sums of the cotangent at every precision.

On a CUDA tensor the op launches ``csrc/mlp.cu`` (every product on the
tensor cores: 3xTF32 at "highest", three bf16 ``mma.sync`` products at
"high", one at "bf16"; the source note has the design), with no fallback.
On a CPU tensor it runs :func:`motion_net_mlp_plain` and
:func:`motion_net_mlp_bwd_plain`, which mirror ``_fwd_kernel`` and
``_bwd_kernel`` step by step; :func:`motion_net_mlp_split_emulation` and
:func:`motion_net_mlp_bwd_split_emulation` repeat the kernels' arithmetic
for the tests.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ..utils.trace import launch
from ._emulation import in_order, mm_3xtf32
from .lbs import bf16_round

NET_PRECISIONS = ("highest", "high", "bf16")
# csrc/mlp.cu's Arith: the products' arithmetic a precision selects
_ARITH = {"highest": 0, "high": 1, "bf16": 2}


def _key(kernel: str, precision: str) -> str:
    """A launch counter's key: the f32 kernels under their names, the
    others with the precision as a suffix (mlp_fwd_high, mlp_bwd_bf16)."""
    return kernel + ("" if precision == "highest" else "_" + precision)


LAUNCHES = {_key(k, p): 0 for p in NET_PRECISIONS
            for k in ("mlp_fwd", "mlp_bwd")}

Acts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def check_precision(precision: str) -> None:
    """Refuse a name that is not one of NET_PRECISIONS (JAX's "default",
    a TPU compiler's choice of passes, included)."""
    if precision not in NET_PRECISIONS:
        raise ValueError(f"net precision {precision!r}: expected one of "
                         f"{NET_PRECISIONS}")


def bf16_parts(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of ``_kdot``'s split, in f32: hi = bf16(a), lo = bf16(a -
    hi), each rounded to nearest even."""
    hi = bf16_round(a)
    return hi, bf16_round(a - hi)


def mm_parts(a, b) -> torch.Tensor:
    """a @ b at "high" from the (hi, lo) parts of each operand, in
    ``_kdot``'s order: hi.hi + lo.hi + hi.lo. Each product of two bf16
    values is exact in f32, so f32 matrix products of the parts (TF32 off)
    compute it."""
    (a_hi, a_lo), (b_hi, b_lo) = a, b
    return a_hi @ b_hi + a_lo @ b_hi + a_hi @ b_lo


def mm_bf16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b at "high": mm_parts of the operands' bf16_parts."""
    return mm_parts(bf16_parts(a), bf16_parts(b))


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b at "bf16": both operands rounded to bf16, f32 sums."""
    return bf16_round(a) @ bf16_round(b)


_MM = {"highest": torch.matmul, "high": mm_bf16x3, "bf16": mm_bf16}


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def motion_net_mlp_plain(x, W1, b1, W2, b2, W3, b3, Wo, bo,
                         precision: str = "highest") -> Acts:
    """(out (B, O), h1, h2, z (B, H)) of ``_fwd_kernel``: three linear +
    ReLU layers, then the concatenated heads (no ReLU), each product at
    ``precision``."""
    return _fwd(_products(precision), x, W1, b1, W2, b2, W3, b3, Wo, bo)


def motion_net_mlp_bwd_plain(gout, x, h1, h2, z, W1, W2, W3, Wo,
                             precision: str = "highest"):
    """(gx, gW1, gb1, gW2, gb2, gW3, gb3, gWo, gbo) of ``_bwd_kernel`` under
    the cotangent gout (B, O): weight gradients act^T g and cotangents g
    W^T, each product at ``precision`` through ``_kdot`` (at "bf16" both
    operands rounded, the f32 result kept; the plain MotionNet's backward
    rounds the result instead, modules.networks._NetDotBf16), bias
    gradients f32 column sums, and each cotangent masked by its saved
    post-ReLU activation (act > 0)."""
    return _bwd(_products(precision), gout, x, h1, h2, z, W1, W2, W3, Wo)


def _products(precision: str):
    """mm(a, b, kind of a, kind of b) at ``precision`` (the kinds: "act",
    "W" or "g", read only by the misrounded variants)."""
    f = _MM[precision]
    return lambda a, b, ka, kb: f(a, b)


def _fwd(mm, x, W1, b1, W2, b2, W3, b3, Wo, bo) -> Acts:
    h1 = torch.relu(mm(x, W1, "act", "W") + b1)
    h2 = torch.relu(mm(h1, W2, "act", "W") + b2)
    z = torch.relu(mm(h2, W3, "act", "W") + b3)
    return mm(z, Wo, "act", "W") + bo, h1, h2, z


def _bwd(mm, gout, x, h1, h2, z, W1, W2, W3, Wo):
    gWo, gbo = mm(z.t(), gout, "act", "g"), gout.sum(0)
    gz = mm(gout, Wo.t(), "g", "W") * (z > 0)
    gW3, gb3 = mm(h2.t(), gz, "act", "g"), gz.sum(0)
    gh2 = mm(gz, W3.t(), "g", "W") * (h2 > 0)
    gW2, gb2 = mm(h1.t(), gh2, "act", "g"), gh2.sum(0)
    gh1 = mm(gh2, W2.t(), "g", "W") * (h1 > 0)
    gW1, gb1 = mm(x.t(), gh1, "act", "g"), gh1.sum(0)
    return mm(gh1, W1.t(), "g", "W"), gW1, gb1, gW2, gb2, gW3, gb3, gWo, gbo


# At "bf16" the kernels and the plain versions round the same operands and
# sum exact products in f32 in other orders. Where two such sums straddle a
# bf16 rounding point, the next layer's operand moves by one bf16 step (2^-8
# of it): one term of a sum, so a few 1e-4 of a tensor's largest entry.
# A rounding point moved (an operand of one kind left in f32) moves every
# term by up to as much, so the card's checks also hold each bf16 output
# within MISROUNDED_SHARE of the plain version's distance from every
# variant with one kind of operand unrounded (misrounding_shares).
MISROUNDINGS = ("act", "W", "g")
MISROUNDED_SHARE = 0.2


def _misrounded(moved: str):
    def mm(a, b, ka, kb):
        return ((a if ka == moved else bf16_round(a))
                @ (b if kb == moved else bf16_round(b)))
    return mm


def misrounding_shares(got_fwd: Acts, got_bwd, fwd_args, bwd_args,
                       precision: str = "bf16") -> dict:
    """{(moved, output name): ||got - plain|| / ||variant - plain||} for the
    kernels' forward outputs ``got_fwd`` on ``fwd_args`` (x and the weights
    and biases, as motion_net_mlp_plain takes them) and backward outputs
    ``got_bwd`` on ``bwd_args`` (as motion_net_mlp_bwd_plain takes them,
    with the kernel's saved activations). At "bf16": over every variant of
    the plain versions with one kind of operand (MISROUNDINGS) left in f32
    that changes that output. At "high": split_shares. Frobenius norms, as
    ops.lbs.misrounding_shares. Tests only."""
    if precision == "high":
        return split_shares(got_fwd, got_bwd, fwd_args, bwd_args[0])
    names = ("out", "h1", "h2", "z", "gx", "gW1", "gb1", "gW2", "gb2", "gW3",
             "gb3", "gWo", "gbo")
    got = (*got_fwd, *got_bwd)
    plain = (*motion_net_mlp_plain(*fwd_args, precision="bf16"),
             *motion_net_mlp_bwd_plain(*bwd_args, precision="bf16"))
    shares = {}
    for moved in MISROUNDINGS:
        mm = _misrounded(moved)
        variant = (*_fwd(mm, *fwd_args), *_bwd(mm, *bwd_args))
        for name, k, p, w in zip(names, got, plain, variant):
            dist = float((w - p).norm())
            if dist > 0:
                shares[moved, name] = float((k - p).norm()) / dist
    return shares


# At "high" the kernels split the operands as the plain versions do,
# multiply the parts exactly and sum in f32 in other orders. Through the
# layers that order moves some of the next layer's lo parts by one of their
# bf16 steps (about 2^-17 of the operand), which puts the layered outputs
# about 0.4 of the split's own error away from the plain version: too near
# to tell the split from its neighbours. So "high" is held one product at a
# time, on the kernel's own operands (split_shares), against variants that
# move one point of the split: the full f32 product, lo.lo added, lo.hi or
# hi.lo dropped. There order is all that is left (0.061 at most for the CPU
# emulation at the smoke's shapes); a 3xTF32 product reads 1 against the
# f32 variant and 1.7 against lo.lo added.
SPLIT_VARIANTS = ("f32", "lo.lo added", "lo.hi dropped", "hi.lo dropped")


def _split_variant(name: str):
    def mm(a, b):
        if name == "f32":
            return a @ b
        a_hi, a_lo = bf16_parts(a)
        b_hi, b_lo = bf16_parts(b)
        out = a_hi @ b_hi
        if name != "lo.hi dropped":
            out = out + a_lo @ b_hi
        if name != "hi.lo dropped":
            out = out + a_hi @ b_lo
        return out + a_lo @ b_lo if name == "lo.lo added" else out
    return mm


def _one_products(mm, fwd_args, acts, gout) -> dict:
    """The outputs of K6 that take one product of operands the kernel was
    given or wrote, at mm: each forward layer on the kernel's input to it,
    gWo = z^T gout and, at B = 1, gb3 = gz = (gout Wo^T) masked by z > 0
    (the one g W^T product whose operands are known; over more rows gb3's
    f32 column sums add order noise as large as the split's error, O = 147
    being a short contraction)."""
    x, W1, b1, W2, b2, W3, b3, Wo, bo = fwd_args
    h1, h2, z = acts
    out = {"out": mm(z, Wo) + bo, "h1": torch.relu(mm(x, W1) + b1),
           "h2": torch.relu(mm(h1, W2) + b2),
           "z": torch.relu(mm(h2, W3) + b3), "gWo": mm(z.t(), gout)}
    if gout.shape[0] == 1:
        out["gb3"] = (mm(gout, Wo.t()) * (z > 0))[0]
    return out


def split_shares(got_fwd: Acts, got_bwd, fwd_args, gout) -> dict:
    """{(variant, output name): ||got - plain|| / ||variant - plain||} for
    the "high" kernels' outputs that take one product (_one_products), the
    plain version and each of SPLIT_VARIANTS computed on the kernel's own
    operands. Tests only."""
    got = dict(zip(("out", "h1", "h2", "z"), got_fwd), gb3=got_bwd[6],
               gWo=got_bwd[7])
    acts = tuple(got_fwd[1:])
    plain = _one_products(mm_bf16x3, fwd_args, acts, gout)
    shares = {}
    for name in SPLIT_VARIANTS:
        variant = _one_products(_split_variant(name), fwd_args, acts, gout)
        for k, p in plain.items():
            dist = float((variant[k] - p).norm())
            if dist > 0:
                shares[name, k] = float((got[k] - p).norm()) / dist
    return shares


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


def _chain_bf16x3(a, b):
    """One k16 step of the "high" kernel: three bf16 ``mma.sync`` products
    into fresh registers, lo.hi, then hi.lo, then hi.hi (the order of
    csrc/mlp.cu's 3xTF32 step)."""
    a_hi, a_lo = bf16_parts(a)
    b_hi, b_lo = bf16_parts(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


_CHAIN = {"highest": mm_3xtf32, "high": _chain_bf16x3, "bf16": mm_bf16}


def _product(a, b, others: int, num_sms: int, ones_row: bool = False,
             precision: str = "highest"):
    """a (M, K) @ b (K, N) as the GEMM routine sums it: each CHAIN-deep
    piece in the precision's arithmetic (3xTF32, three bf16 products, or
    one), the pieces of a contraction range summed in order, then the
    ranges' partials in order; with ``ones_row`` one more row of ones in a
    (the f32 kernel's bias gradient: b's column sums)."""
    if ones_row:
        a = torch.cat([a, a.new_ones((1, a.shape[1]))])
    K = a.shape[1]
    _, kps = split_plan(_tiles(a.shape[0], b.shape[1]), others, K, num_sms)
    w = kps * SLICE
    piece = _CHAIN[precision]
    return in_order([
        in_order([piece(a[:, k:k + CHAIN], b[k:k + CHAIN])
                  for k in range(r, min(r + w, K), CHAIN)])
        for r in range(0, K, w)])


def motion_net_mlp_split_emulation(x, W1, b1, W2, b2, W3, b3, Wo, bo,
                                   num_sms: int = 132,
                                   precision: str = "highest") -> Acts:
    """(out, h1, h2, z) in K6f's arithmetic: each layer's product in the
    precision's arithmetic CHAIN deep at a time, those sums and the split-K
    partials in the kernel's order for the plan at ``num_sms``, then the
    bias and the ReLU. Nothing on the main path calls it: the tests hold it
    against the JAX kernel and motion_net_mlp_plain to show that the split
    and the reduction order stay inside the tolerances."""
    def layer(a, W, b):
        return _product(a, W, 0, num_sms, precision=precision) + b
    h1 = torch.relu(layer(x, W1, b1))
    h2 = torch.relu(layer(h1, W2, b2))
    z = torch.relu(layer(h2, W3, b3))
    return layer(z, Wo, bo), h1, h2, z


def motion_net_mlp_bwd_split_emulation(gout, x, h1, h2, z, W1, W2, W3, Wo,
                                       num_sms: int = 132,
                                       precision: str = "highest"):
    """(gx, gW1, gb1, gW2, gb2, gW3, gb3, gWo, gbo) in K6b's arithmetic: a
    layer's gW and gact products planned as the one launch that holds both,
    each in the precision's arithmetic with its partials summed in order,
    then the ReLU mask. The bias gradient is gW's ones row in 3xTF32
    ("highest"); at the other precisions the launch's column-sum blocks add
    g's rows in f32, in order. For the tests, as
    :func:`motion_net_mlp_split_emulation`."""
    B = gout.shape[0]
    ones_row = precision == "highest"
    grads = []
    g = gout
    for act, W in ((z, Wo), (h2, W3), (h1, W2), (x, W1)):
        K_in, N = W.shape
        tw, ta = _tiles(K_in + ones_row, N), _tiles(B, K_in)
        gWb = _product(act.t(), g, ta, num_sms, ones_row, precision)
        gb = gWb[-1] if ones_row else in_order(list(g.unbind(0)))
        gact = _product(g, W.t(), tw, num_sms, precision=precision)
        if act is not x:
            gact = gact * (act > 0)
        grads = [gWb[:K_in], gb] + grads
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


def gemm_attributes(pair: bool = False, precision: str = "highest") -> dict:
    """The GEMM kernel's registers a thread, shared memory and spills (local
    memory), as the CUDA runtime reports them for the built library: the
    forward's instantiation, or (pair) the backward's, at ``precision``."""
    check_precision(precision)
    return _build.kernel_attributes("nemo_mlp_attributes", int(pair),
                                    _ARITH[precision])


def mlp_fwd_cuda(x, W1, b1, W2, b2, W3, b3, Wo, bo,
                 precision: str = "highest") -> Acts:
    """Launch K6f at ``precision`` (CUDA tensors only): (out (B, O), h1, h2,
    z (B, H))."""
    check_precision(precision)
    B, D, H, O, dev = _dims(x, W1, Wo, b1=b1, W2=W2, b2=b2, W3=W3, b3=b3,
                            bo=bo)
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((B, O), **f32)
    h1, h2, z = (torch.empty((B, H), **f32) for _ in range(3))
    scratch = _scratch(lib, B, D, H, O, dev)
    with launch(LAUNCHES, _key("mlp_fwd", precision)):
        err = lib.nemo_mlp_fwd(_ARITH[precision], B, D, H, O, *(
            t.data_ptr() for t in (x, W1, b1, W2, b2, W3, b3, Wo, bo, out,
                                   h1, h2, z, scratch)),
            _build.stream_handle(dev))
        _build.check(err, "nemo_mlp_fwd")
    return out, h1, h2, z


def mlp_bwd_cuda(gout, x, h1, h2, z, W1, W2, W3, Wo,
                 precision: str = "highest"):
    """Launch K6b at ``precision`` (CUDA tensors only): (gx, gW1, gb1, gW2,
    gb2, gW3, gb3, gWo, gbo) under the f32 cotangent gout (B, O)."""
    check_precision(precision)
    B, D, H, O, dev = _dims(x, W1, Wo, gout=gout, h1=h1, h2=h2, z=z, W2=W2,
                            W3=W3)
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=dev)
    grads = [torch.empty(s, **f32) for s in
             ((B, D), (D, H), (H,), (H, H), (H,), (H, H), (H,), (H, O), (O,))]
    scratch = _scratch(lib, B, D, H, O, dev)
    with launch(LAUNCHES, _key("mlp_bwd", precision)):
        err = lib.nemo_mlp_bwd(_ARITH[precision], B, D, H, O, *(
            t.data_ptr() for t in (gout, x, h1, h2, z, W1, W2, W3, Wo,
                                   *grads, scratch)),
            _build.stream_handle(dev))
        _build.check(err, "nemo_mlp_bwd")
    return tuple(grads)


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

class MotionNetMLP(torch.autograd.Function):
    """K6f forward saving x, h1, h2, z; K6b backward; both at the
    precision given first."""

    @staticmethod
    def forward(ctx, precision, x, W1, b1, W2, b2, W3, b3, Wo, bo):
        args = tuple(t.contiguous() for t in (x, W1, b1, W2, b2, W3, b3, Wo,
                                                bo))
        fwd = motion_net_mlp_plain if _build.route(*args) == "cpu" \
            else mlp_fwd_cuda
        out, h1, h2, z = fwd(*args, precision=precision)
        x, W1, _, W2, _, W3, _, Wo, _ = args
        ctx.save_for_backward(x, h1, h2, z, W1, W2, W3, Wo)
        ctx.precision = precision
        return out

    @staticmethod
    def backward(ctx, gout):
        saved = ctx.saved_tensors
        gout = gout.contiguous()
        bwd = motion_net_mlp_bwd_plain if _build.route(gout, *saved) == "cpu" \
            else mlp_bwd_cuda
        return (None, *bwd(gout, *saved, precision=ctx.precision))


def motion_net_mlp(motion, x: torch.Tensor, precision: str = "highest"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rot6d (B, 6 n_joints), trans (B, n_linear_out)) = MotionNet(x)
    through K6, every product at ``precision`` (NET_PRECISIONS). motion: a
    ``modules.networks.MotionNet`` (its raw parameters; the heads are
    concatenated here, differentiably); x (B, D).
    """
    check_precision(precision)
    t = motion.trunk
    Wo = torch.cat([motion.W_rot, motion.W_lin], dim=1)
    bo = torch.cat([motion.b_rot, motion.b_lin])
    out = MotionNetMLP.apply(precision, x, t.W1, t.b1, t.W2, t.b2, t.W3,
                             t.b3, Wo, bo)
    rot_out = motion.W_rot.shape[1]
    return out[:, :rot_out], out[:, rot_out:]
