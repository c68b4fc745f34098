"""K6's GEMM arithmetic on the CPU, before any card sees it.

``mlp.motion_net_mlp_split_emulation`` and
``mlp.motion_net_mlp_bwd_split_emulation`` repeat what csrc/mlp.cu computes:
every product as three TF32 products (x = big + small, each rounded to the
nearest TF32 by masking mantissa bits; the bias gradient's row of ones splits
exactly), and each product's contraction cut into the kernel's split-K
ranges for the plan at a given SM count, each range summed 16 deep at a
time and the partials in order, as the kernel sums them. They
are held, at small widths and at the reference width H = 1000 with a small
batch, under a random N(0, 1) cotangent and a "fit" one whose translation
columns sum to zero over the batch (as ``trans - trans0`` makes b_lin's
gradient 0 in the fit), against

- nemo_tpu's fused MLP (``mlp_pallas.motion_net_mlp``, its Pallas calls in
  interpret mode as tests/test_torch_port_mlp.py runs them): forward atol
  1e-5, gradients atol 2e-4 and rtol 1e-4 (tests/test_mlp_pallas.py's);
- the port's plain versions: values within 1e-5 and gradients within 1e-4
  of each tensor's largest entry (the kernels' own tolerances on the card);
- the plain versions in f64, where the split's own error stays within 1e-6
  of each tensor's largest entry;
- themselves with another SM count, where only the split-K ranges, and so
  the order of the partials, differ.

b_lin's gradient (gbo's last three entries) is held to the scale of
W_lin's (gWo's last three columns): under the fit cotangent both are sums
that cancel to noise.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.ops import mlp_pallas
from nemo_tpu_torch.ops import _emulation, lbs, mlp

torch.set_num_threads(1)
J = 24                      # joints: O = 6 J + 3
SHAPES = {"small": (13, 19, 136), "wide": (4, 105, 1000)}  # (B, D, H)
FWD = ("out", "h1", "h2", "z")
BWD = ("gx", "gW1", "gb1", "gW2", "gb2", "gW3", "gb3", "gWo", "gbo")


@pytest.fixture(scope="module", params=sorted(SHAPES))
def case(request):
    B, D, H = SHAPES[request.param]
    O = 6 * J + 3
    rs = np.random.RandomState(B + H)

    def u(*shape, fan_in):
        return ((rs.rand(*shape) * 2 - 1) / np.sqrt(fan_in)).astype(np.float32)

    p = [rs.rand(B, D).astype(np.float32), u(D, H, fan_in=D), u(H, fan_in=D),
         u(H, H, fan_in=H), u(H, fan_in=H), u(H, H, fan_in=H), u(H, fan_in=H),
         u(H, O, fan_in=H), u(O, fan_in=H)]
    g = rs.randn(B, O).astype(np.float32)
    g_fit = g.copy()
    g_fit[:, -3:] -= g_fit[:, -3:].mean(0)
    return dict(name=request.param, p=p, g={"random": g, "fit": g_fit})


@pytest.fixture(params=["random", "fit"])
def cotangent(request):
    return request.param


def _fwd_args(c, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype) for a in c["p"]]


def _bwd_args(c, cotangent, acts, dtype=torch.float32):
    """(gout, x, h1, h2, z, W1, W2, W3, Wo) reading the activations acts."""
    a = _fwd_args(c, dtype)
    return [torch.tensor(c["g"][cotangent], dtype=dtype), a[0],
            *(t.to(dtype) for t in acts), a[1], a[3], a[5], a[7]]


def _scaled(got, want, names, rel):
    """Each tensor within rel of its largest entry; gbo's b_lin entries at
    the scale of gWo's W_lin columns."""
    got, want = dict(zip(names, got)), dict(zip(names, want))
    for name in names:
        a = np.asarray(got[name], dtype=np.float64)
        b = np.asarray(want[name], dtype=np.float64)
        if name == "gbo":
            lin = float(np.abs(np.asarray(want["gWo"], np.float64)[:, -3:]).max())
            np.testing.assert_allclose(a[-3:], b[-3:], rtol=0, atol=rel * lin,
                                       err_msg="gbo (b_lin)")
            a, b = a[:-3], b[:-3]
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max(),
                                   err_msg=name)


@contextlib.contextmanager
def _jax_interpret():
    orig = mlp_pallas.pl.pallas_call

    def call(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    jax.clear_caches()
    try:
        with mock.patch.object(mlp_pallas.pl, "pallas_call", call):
            yield
    finally:
        jax.clear_caches()


def test_split_matches_jax_kernel(case, cotangent):
    """Against mlp_pallas's _fwd_kernel and _bwd_kernel in interpret mode,
    through its public motion_net_mlp on the raw MotionNet pytree."""
    x, W1, b1, W2, b2, W3, b3, Wo, bo = case["p"]
    R = 6 * J
    p = {"trunk": {"W1": W1, "b1": b1, "W2": W2, "b2": b2, "W3": W3,
                   "b3": b3},
         "W_rot": Wo[:, :R], "b_rot": bo[:R], "W_lin": Wo[:, R:],
         "b_lin": bo[R:]}
    p = jax.tree_util.tree_map(jnp.asarray, p)
    gout = case["g"][cotangent]

    def loss(p, x):
        rot, tr = mlp_pallas.motion_net_mlp(p, x, J)
        out = jnp.concatenate([rot, tr], axis=1)
        return jnp.sum(out * gout), out

    with _jax_interpret():
        (_, out_j), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    t = gp["trunk"]
    want = [gx, t["W1"], t["b1"], t["W2"], t["b2"], t["W3"], t["b3"],
            jnp.concatenate([gp["W_rot"], gp["W_lin"]], axis=1),
            jnp.concatenate([gp["b_rot"], gp["b_lin"]])]
    fwd = mlp.motion_net_mlp_split_emulation(*_fwd_args(case))
    np.testing.assert_allclose(fwd[0].numpy(), np.asarray(out_j), atol=1e-5)
    got = mlp.motion_net_mlp_bwd_split_emulation(
        *_bwd_args(case, cotangent, fwd[1:]))
    for name, a, b in zip(BWD, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4,
                                   rtol=1e-4, err_msg=name)


def test_split_matches_plain(case, cotangent):
    """Against motion_net_mlp_plain and motion_net_mlp_bwd_plain, both
    backwards reading the emulation's activations (the same ReLU masks, as
    the card's check reads the kernel's)."""
    a = _fwd_args(case)
    fwd = mlp.motion_net_mlp_split_emulation(*a)
    _scaled(fwd, mlp.motion_net_mlp_plain(*a), FWD, 1e-5)
    b = _bwd_args(case, cotangent, fwd[1:])
    _scaled(mlp.motion_net_mlp_bwd_split_emulation(*b),
            mlp.motion_net_mlp_bwd_plain(*b), BWD, 1e-4)


def test_split_error_against_float64(case, cotangent):
    """The split's own error: within 1e-6 of each tensor's largest entry of
    the plain versions in f64 (about 3e-7 at these sizes), far inside the
    kernels' 1e-5 and 1e-4."""
    fwd = mlp.motion_net_mlp_split_emulation(*_fwd_args(case))
    _scaled(fwd, mlp.motion_net_mlp_plain(*_fwd_args(case, torch.float64)),
            FWD, 1e-6)
    got = mlp.motion_net_mlp_bwd_split_emulation(
        *_bwd_args(case, cotangent, fwd[1:]))
    want = mlp.motion_net_mlp_bwd_plain(
        *_bwd_args(case, cotangent, fwd[1:], torch.float64))
    _scaled(got, want, BWD, 1e-6)


def test_split_reduction_order_is_the_only_difference(case):
    """One SM against 132: the plans split some contractions differently
    (the same 3xTF32 products, the partials grouped otherwise), and the
    outputs agree to f32 rounding of the sums."""
    B, D, H = SHAPES[case["name"]]
    plans = [[mlp.split_plan(mlp._tiles(B, n), 0, k, sms)
              for n, k in ((H, D), (H, H), (6 * J + 3, H))] for sms in (1, 132)]
    assert plans[0] != plans[1]
    a = _fwd_args(case)
    one = mlp.motion_net_mlp_split_emulation(*a, num_sms=1)
    full = mlp.motion_net_mlp_split_emulation(*a, num_sms=132)
    _scaled(one, full, FWD, 1e-6)
    b = _bwd_args(case, "random", full[1:])
    _scaled(mlp.motion_net_mlp_bwd_split_emulation(*b, num_sms=1),
            mlp.motion_net_mlp_bwd_split_emulation(*b, num_sms=132), BWD, 2e-6)


@pytest.mark.parametrize("B", [1, 4, 13, 512, 960])
def test_split_plan_stays_in_its_limits(B):
    """csrc/mlp.cu's plan at the reference widths: every range at least
    MIN_SPLIT_SLICES slices (or the whole contraction), at most MAX_SPLIT
    ranges, the ranges cover the contraction, and a split launch stays
    within one wave of BLOCKS_PER_SM blocks an SM."""
    D, H, O = 105, 1000, 147
    target = mlp.BLOCKS_PER_SM * 132
    fwd = [(mlp._tiles(B, n), 0, k) for n, k in ((H, D), (H, H), (O, H))]
    bwd = []
    for k_in, n in ((H, O), (H, H), (D, H)):
        tw, ta = mlp._tiles(k_in + 1, n), mlp._tiles(B, k_in)
        bwd += [(tw, ta, B), (ta, tw, n)]
    for tiles, others, K in fwd + bwd:
        S, kps = mlp.split_plan(tiles, others, K)
        kt = -(-K // mlp.SLICE)
        assert 1 <= S <= mlp.MAX_SPLIT
        assert (S - 1) * kps < kt <= S * kps
        if S > 1:
            assert kps >= mlp.MIN_SPLIT_SLICES
            assert tiles * S + others <= target


def test_emulation_helpers_are_shared():
    """The skinning kernels' emulation and K6's use one copy of the TF32
    rounding and the 3xTF32 product (lbs re-exports them by their old
    names); the bias gradient's row of ones splits exactly."""
    assert lbs._tf32 is _emulation.tf32
    assert lbs._mm_3xtf32 is _emulation.mm_3xtf32
    x = torch.tensor([1.0 + 2.0 ** -11, 3.0, -(1.0 + 3 * 2.0 ** -12)])
    assert _emulation.tf32(x).tolist() == [1.0 + 2.0 ** -10, 3.0,
                                           -(1.0 + 2.0 ** -10)]
    ones = torch.ones(5)
    assert torch.equal(_emulation.tf32(ones), ones)
    assert not _emulation.tf32(ones - _emulation.tf32(ones)).any()
