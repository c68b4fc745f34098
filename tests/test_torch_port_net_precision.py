"""The network products at ``high`` (bf16x3) and ``bf16`` on the CPU, against
nemo_tpu.

The JAX package selects the MotionNet's, RotNet's and FCNN's matmul
precision with NEMO_TPU_NET_PRECISION (``networks._dot`` for the plain
networks, ``mlp_pallas._kdot`` inside the fused kernels K6f/K6b); the port
takes it as an argument (``net_precision``). On the CPU, XLA computes
``jnp.dot(precision=HIGH)`` in full f32, so ``high`` is held against
``_kdot``'s explicit split, called directly, and, for the plain networks
in the fit, against ``networks._dot`` patched to that split in both
directions as a TPU computes it (``_jax_high_dot``). ``bf16`` is held
against ``_dot``'s explicit casts, whose autodiff rounds the gradient's
result to bf16, and against K6's interpret-mode kernels, which round the
operands instead: two different functions, each reproduced in its mode.
The environment variables are read when a JAX function is traced, so each
JAX computation here is traced fresh under its setting.

Tolerances, of each tensor's largest entry (or as stated). ``high``: the
same split and exact bf16 products, f32 sums in another order: values 2e-6
(one product) or 1e-5 (the MLP), gradients 1e-4. ``bf16``: the operands
rounded alike and exact products summed in f32 in other orders, so where a
sum straddles a rounding point the next layer's operand (or a rounded
gradient) moves by one bf16 step: values and gradients 1e-3, rounded
results elementwise within one bf16 step (2^-7 of the entry), and every
output of the MLP much nearer the port's plain version than to a variant
with one kind of operand left in f32 (``mlp.misrounding_shares``). The fit
as tests/test_torch_port_mlp.py holds it (loss rtol 2e-5, metrics 5e-5,
gradients 1e-4 of each tensor's largest entry; at ``bf16`` the gradients
1e-3). ``highest`` gives the bits of the code before the precisions
existed.
"""

import contextlib
import dataclasses
import functools
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu import fit as jfit
from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.data import synthetic_problem as jax_synthetic_problem
from nemo_tpu.fit.loop import _sample_batch
from nemo_tpu.modules import networks as jnet
from nemo_tpu.ops import mlp_pallas
from nemo_tpu.priors import init_vposer as jax_init_vposer
from nemo_tpu.priors import synthetic_gmm_prior as jax_synthetic_gmm
from nemo_tpu.utils.checkpoint import _flatten_with_paths
from nemo_tpu_torch import fit as tfit
from nemo_tpu_torch.body.assets import smpl_from_numpy, synthetic_smpl_model
from nemo_tpu_torch.data.synthetic import synthetic_problem
from nemo_tpu_torch.modules import networks as tnet
from nemo_tpu_torch.ops import mlp
from nemo_tpu_torch.priors.gmm import gmm_from_numpy
from nemo_tpu_torch.priors.vposer import init_vposer
from nemo_tpu_torch.utils.checkpoint import params_from_numpy, vposer_from_numpy

torch.set_num_threads(1)
HIGH = jax.lax.Precision.HIGH
G_WT = (((1,), (1,)), ((), ()))      # g W^T, as _bwd_kernel contracts
AT_G = (((0,), (0,)), ((), ()))      # act^T g
D, H, J = 19, 72, 24
BF16_STEP = 2.0 ** -7
PRECISIONS = ("high", "bf16")
NAMES = ("out", "h1", "h2", "z", "gx", "gW1", "gb1", "gW2", "gb2", "gW3",
         "gb3", "gWo", "gbo")


def _rs(seed):
    return np.random.RandomState(seed)


def _close(got, want, rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: {err:.3e} > {rel:g} x {scale:.3e}"


def _within_bf16_step(got, want, name=""):
    """Rounded results: each entry within one bf16 step of the other's."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = BF16_STEP * np.abs(want) + 1e-6 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), name


@contextlib.contextmanager
def _net_precision(monkeypatch, name):
    """NEMO_TPU_NET_PRECISION=name for JAX functions traced inside, with
    the trace caches cleared on both sides."""
    monkeypatch.setenv("NEMO_TPU_NET_PRECISION", name)
    jax.clear_caches()
    try:
        yield
    finally:
        monkeypatch.delenv("NEMO_TPU_NET_PRECISION")
        jax.clear_caches()


def _kdot_high(a, b, dims=None):
    return mlp_pallas._kdot(a, b, HIGH, dims)


@functools.lru_cache(maxsize=None)
def _jax_high_dot_fn():
    @jax.custom_vjp
    def dot(x, w):
        return _kdot_high(x, w)

    def fwd(x, w):
        return _kdot_high(x, w), (x, w)

    def bwd(res, g):
        x, w = res
        return _kdot_high(g, w, G_WT), _kdot_high(x, g, AT_G)

    dot.defvjp(fwd, bwd)
    return dot


def _jax_high_dot():
    """networks._dot at HIGH as a TPU computes it: _kdot's bf16x3 split in
    the forward, and JAX's autodiff carrying precision=HIGH into the two
    transposes (g W^T, x^T g). On the CPU jnp.dot(precision=HIGH) is f32."""
    return mock.patch.object(jnet, "_dot", _jax_high_dot_fn())


@contextlib.contextmanager
def _jax_fused():
    """nemo_tpu's fused MotionNet path forced on, its Pallas calls in
    interpret mode (tests/test_mlp_pallas.py's route)."""
    orig = mlp_pallas.pl.pallas_call

    def call(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    jax.clear_caches()
    try:
        with mock.patch.object(mlp_pallas.pl, "pallas_call", call), \
                mock.patch.object(mlp_pallas, "mlp_pallas_available",
                                  lambda: True):
            yield
    finally:
        jax.clear_caches()


# ---------------------------------------------------------------------------
# net_dot: one product and its gradients
# ---------------------------------------------------------------------------

SHAPES = [(13, 19, 72), (64, 256, 64)]


def _operands(M, K, N, seed):
    rs = _rs(seed)
    return (rs.randn(M, K).astype(np.float32),
            (rs.randn(K, N) / np.sqrt(K)).astype(np.float32),
            rs.randn(M, N).astype(np.float32))


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_net_dot_high_matches_kdot(M, K, N):
    """net_dot at "high" and its backward against _kdot(., ., HIGH) called
    directly: x W, g W^T and x^T g (2e-6 of the largest entry), and off the
    f32 product by more (the split is in effect)."""
    x, w, g = _operands(M, K, N, M + K)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = tnet.net_dot(xt, wt, "high")
    out.backward(torch.tensor(g))
    jx, jw, jg = jnp.asarray(x), jnp.asarray(w), jnp.asarray(g)
    _close(out.detach(), _kdot_high(jx, jw), 2e-6, "x W")
    _close(xt.grad, _kdot_high(jg, jw, G_WT), 2e-6, "g W^T")
    _close(wt.grad, _kdot_high(jx, jg, AT_G), 2e-6, "x^T g")
    exact = x.astype(np.float64) @ w.astype(np.float64)
    assert np.abs(out.detach().numpy() - exact).max() > 1e-7 * np.abs(
        exact).max()


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_net_dot_high_reuses_the_forwards_split(M, K, N):
    """net_dot at "high" splits x and W once (its backward reuses the
    forward's parts) and g once, and gives the bits of splitting every
    operand anew: x W, g W^T and x^T g equal mm_bf16x3 of the tensors."""
    x, w, g = (torch.tensor(a) for a in _operands(M, K, N, M + 2 * K))
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    with mock.patch.object(tnet, "bf16_parts",
                           wraps=tnet.bf16_parts) as split:
        out = tnet.net_dot(xt, wt, "high")
        out.backward(g)
    assert split.call_count == 3
    assert torch.equal(out, mlp.mm_bf16x3(x, w))
    assert torch.equal(xt.grad, mlp.mm_bf16x3(g, w.t()))
    assert torch.equal(wt.grad, mlp.mm_bf16x3(x.t(), g))


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_net_dot_bf16_matches_jax_dot(M, K, N, monkeypatch):
    """net_dot at "bf16" against networks._dot with
    NEMO_TPU_NET_PRECISION=bf16, forward and jax.vjp: the forward within
    2e-6, the gradients bf16(g bf16(W)^T) and bf16(bf16(x)^T g) within one
    bf16 step entry by entry; and not K6b's function, bf16(g) bf16(W)^T,
    kept in f32, which differs from it by more."""
    x, w, g = _operands(M, K, N, M + N)
    with _net_precision(monkeypatch, "bf16"):
        out_j, vjp = jax.vjp(jnet._dot, jnp.asarray(x), jnp.asarray(w))
        gx_j, gw_j = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = tnet.net_dot(xt, wt, "bf16")
    out.backward(torch.tensor(g))
    _close(out.detach(), out_j, 2e-6, "x W")
    _within_bf16_step(xt.grad, gx_j, "gx")
    _within_bf16_step(wt.grad, gw_j, "gW")
    assert (xt.grad.numpy() == xt.grad.to(torch.bfloat16).float().numpy()
            ).all(), "gx is rounded to bf16"
    k6 = mlp.mm_bf16(torch.tensor(g), torch.tensor(w).t())
    assert float((k6 - xt.grad).abs().max()) > 10 * float(
        (xt.grad - torch.tensor(np.asarray(gx_j))).abs().max())


def test_highest_is_the_f32_product():
    """At "highest" net_dot is x @ W, bit for bit, with its gradients."""
    x, w, g = _operands(13, 19, 72, 0)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = tnet.net_dot(xt, wt)
    out.backward(torch.tensor(g))
    assert torch.equal(out, torch.tensor(x) @ torch.tensor(w))
    assert torch.equal(xt.grad, torch.tensor(g) @ torch.tensor(w).t())
    assert torch.equal(wt.grad, torch.tensor(x).t() @ torch.tensor(g))


@pytest.mark.parametrize("name", ["default", "DEFAULT", "tf32", "HIGH"])
def test_unknown_precision_raises(name):
    """Only the three precisions: JAX's "default" (a TPU compiler's choice
    of passes) and anything else is refused, naming the three."""
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="highest"):
        tnet.net_dot(x, torch.zeros(3, 4), name)
    m = tnet.MotionNet(3, 8, 24)
    for mode in tnet.MLP_MODES:
        with pytest.raises(ValueError, match="highest"):
            m(x, mlp=mode, precision=name)
    smpl = synthetic_smpl_model(300)
    bundle, _ = synthetic_problem(smpl, num_views=2, num_frames=12)
    with pytest.raises(ValueError, match="highest"):
        tfit.build_assets(bundle, smpl, tfit.NemoConfig(label_type="gt"),
                          device="cpu", net_precision=name)


# ---------------------------------------------------------------------------
# K6's plain versions against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------

def _jax_motion(seed=0):
    return jnet.init_motion_net(jax.random.PRNGKey(seed), D, H, J,
                                init_last_layer_zero=False)


def _motion_from_jax(p):
    m = tnet.MotionNet(D, H, J)
    with torch.no_grad():
        for name, t in m.named_parameters():
            node = p
            for k in name.split("."):
                node = node[k]
            t.copy_(torch.tensor(np.asarray(node)))
    return m


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("B", [13, 1])
def test_k6_plain_matches_jax_kernel(B, precision, monkeypatch):
    """ops.mlp.motion_net_mlp (the plain versions of K6f/K6b) at "high" and
    "bf16" against mlp_pallas.motion_net_mlp in interpret mode under
    NEMO_TPU_NET_PRECISION: rot6d and trans, and the gradients of every raw
    MotionNet tensor and of x under a random cotangent. "high": 1e-5
    (values), 1e-4 (gradients); "bf16": 1e-3."""
    p, x = _jax_motion(B), _rs(B).randn(B, D).astype(np.float32)
    rs = _rs(B + 1)
    crot = rs.randn(B, J * 6).astype(np.float32)
    ctr = rs.randn(B, 3).astype(np.float32)

    def loss(p, x):
        r, t = mlp_pallas.motion_net_mlp(p, x, J)
        return jnp.sum(r * crot) + jnp.sum(t * ctr), (r, t)

    with _net_precision(monkeypatch, precision), _jax_fused():
        (_, (rot_j, tr_j)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    m = _motion_from_jax(p)
    xt = torch.tensor(x, requires_grad=True)
    rot, tr = mlp.motion_net_mlp(m, xt, precision)
    ((rot * torch.tensor(crot)).sum() + (tr * torch.tensor(ctr)).sum()
     ).backward()
    tol_v, tol_g = (1e-5, 1e-4) if precision == "high" else (1e-3, 1e-3)
    _close(rot.detach(), rot_j, tol_v, "rot6d")
    _close(tr.detach(), tr_j, tol_v, "trans")
    flat = {k.replace("/", "."): v for k, v in _flatten_with_paths(gp).items()}
    got = dict(m.named_parameters())
    assert sorted(flat) == sorted(got)
    for k, want in flat.items():
        _close(got[k].grad, want, tol_g, k)
    _close(xt.grad, gx, tol_g, "x")


def _mlp_args(B, seed):
    """x in [0, 1) and the init's U(+-1/sqrt(fan_in)) weights at (D, H,
    147), and an N(0, 1) cotangent, as torch tensors."""
    rs = _rs(seed)
    u = lambda *s, fan_in: torch.tensor(
        ((rs.rand(*s) * 2 - 1) / np.sqrt(fan_in)).astype(np.float32))
    O = 147
    args = (torch.tensor(rs.rand(B, D).astype(np.float32)),
            u(D, H, fan_in=D), u(H, fan_in=D), u(H, H, fan_in=H),
            u(H, fan_in=H), u(H, H, fan_in=H), u(H, fan_in=H),
            u(H, O, fan_in=H), u(O, fan_in=H))
    return args, torch.tensor(rs.randn(B, O).astype(np.float32))


def _jax_mlp(args, gout, precision, monkeypatch):
    """(out, h1, h2, z) of mlp_pallas._mlp_fwd_impl and the 9 gradients of
    _mlp_vjp_bwd (bias gradients flattened) in interpret mode, on the
    unpadded operands, under NEMO_TPU_NET_PRECISION=precision."""
    x, W1, b1, W2, b2, W3, b3, Wo, bo = (jnp.asarray(a.numpy()) for a in args)
    pp = {"W1": W1, "b1": b1[None], "W2": W2, "b2": b2[None], "W3": W3,
          "b3": b3[None], "Wo": Wo, "bo": bo[None]}
    name = "BF16" if precision == "bf16" else "HIGH"
    with _net_precision(monkeypatch, precision), _jax_fused():
        fwd = mlp_pallas._mlp_fwd_impl(pp, x, name)
        gp, gx = mlp_pallas._mlp_vjp_bwd(name, (pp, x, *fwd[1:]),
                                         jnp.asarray(gout.numpy()))
    grads = (gx, gp["W1"], gp["b1"][0], gp["W2"], gp["b2"][0], gp["W3"],
             gp["b3"][0], gp["Wo"], gp["bo"][0])
    return ([torch.tensor(np.asarray(a)) for a in fwd],
            [torch.tensor(np.asarray(a)) for a in grads])


@pytest.mark.parametrize("precision", PRECISIONS)
def test_jax_kernel_rounds_where_the_plain_version_does(precision,
                                                        monkeypatch):
    """K6's JAX kernels on the same operands as the port's plain versions,
    every output: "high" within 1e-5 / 1e-4; "bf16" within 1e-3. Each
    output's distance from the plain version is at most
    mlp.MISROUNDED_SHARE of each variant's that changes it (the check the
    card holds the CUDA kernels to): at "bf16" the variants with one kind
    of operand unrounded, at "high" those that move one point of the split
    (mlp.split_shares)."""
    args, gout = _mlp_args(13, 5)
    jf, jb = _jax_mlp(args, gout, precision, monkeypatch)
    pf = mlp.motion_net_mlp_plain(*args, precision=precision)
    bwd_args = (gout, args[0], *jf[1:], args[1], args[3], args[5], args[7])
    pb = mlp.motion_net_mlp_bwd_plain(*bwd_args, precision=precision)
    tol_v, tol_g = (1e-5, 1e-4) if precision == "high" else (1e-3, 1e-3)
    for n, a, b in zip(NAMES, jf + jb, pf + pb):
        _close(a, b, tol_v if n[0] != "g" else tol_g, n)
    shares = mlp.misrounding_shares(jf, jb, args, bwd_args, precision)
    assert len(shares) >= 20 and max(shares.values()) <= \
        mlp.MISROUNDED_SHARE, shares


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("B", [13, 1, 300])
def test_split_emulation_matches_plain(B, precision):
    """The CUDA kernels' arithmetic at "high" and "bf16" (16-deep steps of
    three bf16 products or one, split-K partials and the bias column sums
    in the kernels' order) against the plain versions: "high" 1e-5 / 1e-4,
    "bf16" 1e-3, both plus the misrounding shares; the plan at 1 SM (no
    split) against 132 (a split) likewise."""
    args, gout = _mlp_args(B, B)
    tol_v, tol_g = (1e-5, 1e-4) if precision == "high" else (1e-3, 1e-3)
    ef = mlp.motion_net_mlp_split_emulation(*args, precision=precision)
    bwd_args = (gout, args[0], *ef[1:], args[1], args[3], args[5], args[7])
    eb = mlp.motion_net_mlp_bwd_split_emulation(*bwd_args,
                                                precision=precision)
    pf = mlp.motion_net_mlp_plain(*args, precision=precision)
    pb = mlp.motion_net_mlp_bwd_plain(*bwd_args, precision=precision)
    for n, a, b in zip(NAMES, ef + eb, pf + pb):
        assert a.shape == b.shape, n
        _close(a, b, tol_v if n[0] != "g" else tol_g, n)
    one = mlp.motion_net_mlp_bwd_split_emulation(*bwd_args, num_sms=1,
                                                 precision=precision)
    for n, a, b in zip(NAMES[4:], one, eb):
        _close(a, b, tol_g, n)
    shares = mlp.misrounding_shares(ef, eb, args, bwd_args, precision)
    assert max(shares.values()) <= mlp.MISROUNDED_SHARE, shares


@pytest.mark.parametrize("B", [1, 300])
@pytest.mark.parametrize("split", mlp.SPLIT_VARIANTS + ("3xTF32",))
def test_split_shares_refuse_other_splits(split, B):
    """The check that holds "high" to its split (mlp.split_shares) refuses
    a kernel that splits otherwise: K6's arithmetic with each of
    mlp.SPLIT_VARIANTS in place of bf16x3, and the 3xTF32 instantiation
    ("highest"), each read above mlp.MISROUNDED_SHARE on some output."""
    args, gout = _mlp_args(B, B + 2)
    if split == "3xTF32":
        ef = mlp.motion_net_mlp_split_emulation(*args)
        bwd_args = (gout, args[0], *ef[1:], args[1], args[3], args[5],
                    args[7])
        eb = mlp.motion_net_mlp_bwd_split_emulation(*bwd_args)
    else:
        mm = mlp._split_variant(split)
        ef = mlp._fwd(lambda a, b, ka, kb: mm(a, b), *args)
        bwd_args = (gout, args[0], *ef[1:], args[1], args[3], args[5],
                    args[7])
        eb = mlp._bwd(lambda a, b, ka, kb: mm(a, b), *bwd_args)
    shares = mlp.misrounding_shares(ef, eb, args, bwd_args, "high")
    assert max(shares.values()) > mlp.MISROUNDED_SHARE, shares


def test_bias_gradients_are_f32_column_sums():
    """At every precision the bias gradients are the f32 column sums of the
    cotangent, in the plain versions and in the kernels' emulation (no ones
    row through a bf16 product, which would sum bf16(g))."""
    args, gout = _mlp_args(13, 7)
    for precision in mlp.NET_PRECISIONS:
        fwd = mlp.motion_net_mlp_plain(*args, precision=precision)
        bwd_args = (gout, args[0], *fwd[1:], args[1], args[3], args[5],
                    args[7])
        gbo = mlp.motion_net_mlp_bwd_plain(*bwd_args, precision=precision)[8]
        assert torch.equal(gbo, gout.sum(0))
        em = mlp.motion_net_mlp_bwd_split_emulation(*bwd_args,
                                                    precision=precision)[8]
        torch.testing.assert_close(em, gout.sum(0), rtol=1e-6, atol=1e-6)
    bf = mlp.motion_net_mlp_bwd_split_emulation(
        *bwd_args, precision="bf16")[8]
    assert not torch.equal(bf, mlp.bf16_round(gout).sum(0))


def _parent_mlp(x, W1, b1, W2, b2, W3, b3, Wo, bo, gout):
    """K6's plain versions as they were before the precisions (f32)."""
    h1 = torch.relu(x @ W1 + b1)
    h2 = torch.relu(h1 @ W2 + b2)
    z = torch.relu(h2 @ W3 + b3)
    out = z @ Wo + bo
    gWo, gbo = z.t() @ gout, gout.sum(0)
    gz = (gout @ Wo.t()) * (z > 0)
    gW3, gb3 = h2.t() @ gz, gz.sum(0)
    gh2 = (gz @ W3.t()) * (h2 > 0)
    gW2, gb2 = h1.t() @ gh2, gh2.sum(0)
    gh1 = (gh2 @ W2.t()) * (h1 > 0)
    gW1, gb1 = x.t() @ gh1, gh1.sum(0)
    return (out, h1, h2, z), (gh1 @ W1.t(), gW1, gb1, gW2, gb2, gW3, gb3,
                              gWo, gbo)


def test_highest_gives_the_parents_bits():
    """At "highest" K6's plain versions, their emulation and the networks
    give the bits of the code before the precisions existed."""
    args, gout = _mlp_args(13, 9)
    pf, pb = _parent_mlp(*args, gout)
    got_f = mlp.motion_net_mlp_plain(*args)
    got_b = mlp.motion_net_mlp_bwd_plain(gout, args[0], *got_f[1:], args[1],
                                         args[3], args[5], args[7])
    assert all(torch.equal(a, b) for a, b in zip(got_f + got_b, pf + pb))
    fc = tnet.FCNN(D, H, 3, torch.Generator().manual_seed(0))
    x = args[0]
    want = torch.relu(torch.relu(x @ fc.W1 + fc.b1) @ fc.W2 + fc.b2) \
        @ fc.W3 + fc.b3
    assert torch.equal(fc(x), want)
    m = tnet.MotionNet(D, H, J, generator=torch.Generator().manual_seed(1))
    z = torch.relu(m.trunk(x))
    _, _, trans = m(x)
    assert torch.equal(trans, z @ m.W_lin + m.b_lin)


# ---------------------------------------------------------------------------
# the fit: fit_loss and its gradients, a trajectory, the quality gates
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problems():
    """JAX and port assets for V2 (RBF, instance codes, the v2v prior) and
    V0 (RotNet/FCNN), one synthetic problem, JAX's init carried across."""
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    bundle, _ = jax_synthetic_problem(jm, num_views=2, num_frames=12, seed=0)
    gmm = jax_synthetic_gmm(4)
    vposer = jax_init_vposer(jax.random.PRNGKey(7))
    out = {}
    for version in (2, 0):
        cfg = jfit.NemoConfig(
            model_version=version, h_dim=H, instance_code_size=4,
            phase_rbf_dim=16 if version == 2 else 0, rbf_kernel="quadratic",
            monotonic_network_n_nodes=4, batch_size=16, weight_vp_loss=10.0,
            weight_vp_z_loss=1.0, weight_gmm_loss=0.5, label_type="gt",
            lr_factor=0.5, n_steps=3, warmup_step=3, opt_cam_step=3)
        jassets = jfit.build_assets(bundle, jm, cfg, gmm=gmm, vposer=vposer)
        tcfg = tfit.NemoConfig(**dataclasses.asdict(cfg))
        tassets = tfit.build_assets(
            bundle, smpl_from_numpy(jm), tcfg,
            gmm=gmm_from_numpy(gmm.means, gmm.precisions, gmm.nll_weights),
            vposer=vposer_from_numpy({k: np.asarray(v) for k, v in
                                      vposer.items()}), device="cpu")
        params = jfit.init_params(jax.random.PRNGKey(0), cfg,
                                  jassets.num_views, jassets.img_d0)
        rng = np.random.RandomState(3)
        perturbed = jax.tree_util.tree_map(
            lambda a: a + 0.05 * jnp.asarray(rng.randn(*a.shape)
                                             .astype(np.float32)), params)
        out[version] = dict(cfg=cfg, tcfg=tcfg, jassets=jassets,
                            tassets=tassets, params=perturbed)
    return out


def _batch(seed):
    rng = np.random.RandomState(1000 + seed)
    return (rng.randint(0, 2, size=16).astype(np.int32),
            rng.randint(0, 12, size=16).astype(np.int32))


def _jax_route(precision, fused, monkeypatch):
    """The JAX context computing the MotionNet as a TPU would at
    ``precision``: the fused kernels in interpret mode under the variable,
    or the plain _dot (at "high" patched to the bf16x3 split)."""
    stack = contextlib.ExitStack()
    stack.enter_context(_net_precision(monkeypatch, precision))
    if fused:
        stack.enter_context(_jax_fused())
    elif precision == "high":
        stack.enter_context(_jax_high_dot())
    return stack


def _jax_loss_grads(pb, vi, fi):
    fn = lambda p, v, f: jfit.fit_loss(p, pb["cfg"], pb["jassets"], v, f,
                                       training=False)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        pb["params"], jnp.asarray(vi), jnp.asarray(fi))
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        _flatten_with_paths(grads)


def _port_loss_grads(pb, assets, vi, fi):
    tp = tfit.init_params(pb["tcfg"], assets.num_views, assets.img_d0)
    params_from_numpy(tp, _flatten_with_paths(pb["params"]))
    loss, metrics = tfit.fit_loss(tp, pb["tcfg"], assets,
                                  torch.as_tensor(vi).long(),
                                  torch.as_tensor(fi).long())
    loss.backward()
    grads = {n.replace(".", "/"): (p.grad.numpy().copy() if p.grad is not None
                                   else np.zeros(tuple(p.shape), np.float32))
             for n, p in tp.named_parameters()}
    return float(loss.detach()), {k: float(v.detach())
                                  for k, v in metrics.items()}, grads


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("case", ["v2_plain", "v2_fused", "v0_plain"])
def test_fit_loss_and_grads_match_jax(problems, case, precision,
                                      monkeypatch):
    """fit_loss and every parameter gradient against nemo_tpu's at the same
    network precision: V2 with the plain MotionNet and with K6, V0 with its
    RotNet/FCNN networks. Loss rtol 2e-5, metrics 5e-5, gradients 1e-4
    ("high") or 1e-3 ("bf16", K6) of each tensor's largest entry (b_lin's,
    0 by construction, at W_lin's scale). The plain networks' "bf16"
    gradients are rounded results (bf16(g W^T), bf16(x^T g)), and the
    upstream ones (instance codes, RBF widths) sums of them: one rounded
    entry one step apart moves them by a bf16 step of that entry, so they
    hold one bf16 step (2^-7) of the tensor's largest entry."""
    version, mode = (2 if case.startswith("v2") else 0), case.split("_")[1]
    pb = problems[version]
    vi, fi = _batch(version + len(precision))
    with _jax_route(precision, mode == "fused", monkeypatch):
        loss_j, m_j, g_j = _jax_loss_grads(pb, vi, fi)
    assets = dataclasses.replace(pb["tassets"], motion_mlp=mode,
                                 net_precision=precision)
    loss_t, m_t, g_t = _port_loss_grads(pb, assets, vi, fi)
    np.testing.assert_allclose(loss_t, loss_j, rtol=2e-5)
    assert sorted(m_t) == sorted(m_j)
    for k in m_j:
        np.testing.assert_allclose(m_t[k], m_j[k], rtol=5e-5, err_msg=k)
    rel = {"high": 1e-4, "bf16": 1e-3 if mode == "fused" else BF16_STEP
           }[precision]
    assert sorted(g_t) == sorted(g_j)
    for k, gj in g_j.items():
        scale = g_j["motion/W_lin"] if k == "motion/b_lin" else gj
        np.testing.assert_allclose(
            g_t[k], gj, rtol=1e-3,
            atol=rel * float(np.abs(scale).max()) + 1e-9, err_msg=k)
    highest = dataclasses.replace(assets, net_precision="highest")
    assert _port_loss_grads(pb, highest, vi, fi)[0] != loss_t


def _replay(seed, B, V, F, warmup, main):
    """The JAX fitter's batch stream (fit/loop.py's key threading)."""
    key = jax.random.PRNGKey(seed)
    _k_init, key = jax.random.split(key)
    out = {"warmup": [], "main": []}
    for _ in range(warmup):
        key, k1 = jax.random.split(key)
        out["warmup"].append(_sample_batch(k1, B, V, F))
    for _ in range(main):
        key, k1, _k2 = jax.random.split(key, 3)
        out["main"].append(_sample_batch(k1, B, V, F))
    return out


def test_three_stage_trajectory_at_high_matches_jax(problems, monkeypatch):
    """warmup -> camera -> main, 3 steps each, V2 with the MotionNet through
    K6 at "high" in both packages (the JAX kernels in interpret mode): the
    per-step losses within rtol 1e-4 and the eval within 1e-3."""
    pb = problems[2]
    cfg = pb["cfg"]
    with _jax_route("high", True, monkeypatch):
        fitter = jfit.NemoFitter(cfg, pb["jassets"], seed=0)
        params0 = fitter.state.params
        wm, cm = fitter.warmup(), fitter.opt_cam()
        fm = fitter.fit(chunk=3)
        ej = fitter.eval_loss()
    batches = _replay(0, cfg.batch_size, 2, 12, 3, 3)
    assets = dataclasses.replace(pb["tassets"], motion_mlp="fused",
                                 net_precision="high")
    tf = tfit.NemoFitter(pb["tcfg"], assets, seed=0,
                         batch_source=lambda s, i: batches[s][i])
    params_from_numpy(tf.params, _flatten_with_paths(params0))
    twm, tcm = tf.warmup(), tf.opt_cam()
    tfm = tf.fit(chunk=3)
    np.testing.assert_allclose(twm["warmup_loss"], wm["warmup_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(tcm["cam_loss"], cm["cam_loss"], rtol=1e-4)
    for k in ("total_loss", "kp_loss", "vp_recon_loss", "gmm_loss"):
        np.testing.assert_allclose(tfm[k], fm[k], rtol=1e-4, err_msg=k)
    et = tf.eval_loss()
    for k in ej:
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-3, err_msg=k)


@functools.lru_cache(maxsize=None)
def _quality_run(seed):
    """The quality gates' fits: one seed for all three precisions, so every
    batch is the same; 5 warmup, 5 camera and 40 main steps of a 640-vertex
    body, 3 views x 24 frames (test_torch_port_skin_bf16.py's gate, cut
    from tests/test_fit.py's 30/50/150 steps at h_dim 64, batch 64):
    ({precision: main-stage total_loss curve}, {precision: final
    kp_loss})."""
    bundle, _ = synthetic_problem(synthetic_smpl_model(640, seed=1),
                                  num_views=3, num_frames=24,
                                  warp_strength=0.4, seed=3)
    cfg = tfit.NemoConfig(
        model_version=2, h_dim=32, instance_code_size=4, phase_rbf_dim=16,
        rbf_kernel="linear", monotonic_network_n_nodes=10,
        phase_init="linear", batch_size=32, lr_phase=1e-3, lr_factor=1.0,
        weight_vp_loss=1.0, weight_vp_z_loss=0.01, weight_gmm_loss=0.0,
        warmup_step=5, opt_cam_step=5, n_steps=40, label_type="gt")
    smpl = synthetic_smpl_model(640, seed=1)
    curves, finals = {}, {}
    for precision in mlp.NET_PRECISIONS:
        assets = tfit.build_assets(
            bundle, smpl, cfg, device="cpu", net_precision=precision,
            vposer=init_vposer(generator=torch.Generator().manual_seed(7)))
        fitter = tfit.NemoFitter(cfg, assets, seed=seed)
        fitter.warmup()
        fitter.opt_cam()
        metrics = fitter.fit(chunk=40)
        assert np.isfinite(metrics["total_loss"]).all(), precision
        curves[precision] = np.asarray(metrics["total_loss"], np.float64)
        finals[precision] = fitter.eval_loss()["kp_loss"]
    return curves, finals


# the per-seed median per-step |delta total_loss| bound: the house 5% for
# "high" (docs/precision_knobs.md), the catastrophe gate of
# tests/test_fit.py's test_net_bf16_quality (15%) for "bf16"
TRAJECTORY_BOUND = {"high": 0.05, "bf16": 0.15}


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("seed", [0, 1])
def test_net_precision_quality(seed, precision):
    """Per seed, against "highest" from the same seed and batches: the
    median per-step relative |delta total_loss| under TRAJECTORY_BOUND,
    and the trajectory changed (the precision is in effect)."""
    curves, _ = _quality_run(seed)
    rel = np.abs(curves[precision] - curves["highest"]) / np.abs(
        curves["highest"])
    assert np.median(rel) < TRAJECTORY_BOUND[precision], np.median(rel)
    assert rel.max() > 0


@pytest.mark.parametrize("precision", PRECISIONS)
def test_net_precision_quality_across_seeds(precision):
    """Over seeds 0 and 1 (tests/test_fit.py:466-473's bounds): the median
    final kp_loss ratio against "highest" at most 1.15, each at most
    1.30."""
    ratios = []
    for seed in (0, 1):
        _, finals = _quality_run(seed)
        ratios.append(finals[precision] / finals["highest"])
    assert np.median(ratios) <= 1.15, ratios
    assert max(ratios) <= 1.30, ratios


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

_FLAGS = ["--synthetic_assets", "--model_version", "2", "--phase_rbf_dim",
          "8", "--rbf_kernel", "quadratic", "--h_dim", "16",
          "--monotonic_network_n_nodes", "4", "--instance_code_size", "4",
          "--batch_size", "16", "--n_steps", "2", "--warmup_step", "1",
          "--opt_cam_step", "1", "--save_every", "2", "--label_type", "gt",
          "--loss", "mse_robust", "--weight_gmm_loss", "0.5",
          "--weight_vp_loss", "1.0", "--vp_v2v_n_verts", "64", "--device",
          "cpu"]


@pytest.mark.parametrize("mode", ["plain", "fused"])
def test_cli_net_precision_and_skin_io_bf16(tmp_path, mode):
    """--net_precision high --skin_io_bf16 through cli/fit.py on the CPU,
    in both MotionNet modes: the stages run, the eval CSVs are written,
    and config.json records both flags."""
    from nemo_tpu_torch.cli.fit import main
    assert main(_FLAGS + ["--net_precision", "high", "--skin_io_bf16",
                          "--motion_mlp", mode, "--out_dir",
                          str(tmp_path)]) == 0
    out = tmp_path / "000000"
    for name in ("eval_2d.csv", "eval_3d.csv", "losses.npz"):
        assert (out / name).exists(), name
    args = json.loads((out / "config.json").read_text())["args"]
    assert args["net_precision"] == "high" and args["skin_io_bf16"] is True
    assert args["motion_mlp"] == mode


@pytest.mark.parametrize("name", ["default", "tf32"])
def test_cli_refuses_other_precisions(tmp_path, name, capsys):
    """The CLI takes only the three precisions and names them."""
    from nemo_tpu_torch.cli.fit import main
    with pytest.raises(SystemExit):
        main(_FLAGS + ["--net_precision", name, "--out_dir", str(tmp_path)])
    assert "highest" in capsys.readouterr().err
