"""bf16 skinning tables (``--skin_bf16``) on the CPU, against nemo_tpu.

With posedirs_t and W_t in bfloat16 the port's skinning ops compute the
TPU kernels' bf16 function (nemo_tpu/ops/lbs_pallas.py with tile_tables'
dtype bf16): pf and A rounded to bf16, the contractions bf16 x bf16 summed
in f32, gm = g . [vp; 1] and gvp rounded to bf16 in the backward, vp stored
in bf16. JAX's CPU route is the XLA fallback, which rounds only the tables,
so the reference here is the Pallas kernels themselves in interpret mode
(``_fwd_pallas``, ``_bwd_pallas``, ``_v2v_fwdbwd_pallas`` and
``_v2v_fwd_pallas`` through ``skin_v2v_l1`` with ``_use_pallas`` forced on).

Tolerances, of each tensor's largest entry: vertices 2e-6, gradients 1e-5,
the total 1e-6 relative. The two sides differ only in the order of their f32
sums (about 1e-7), and where that moves g . vp or gvp across a bf16 rounding
boundary, by one bf16 step in one term. Each error is also held to 1/20 of
the bf16-vs-f32 gap of the same output (the JAX kernels with f32 tables), so
a port that rounded at other points, or not at all, would fail although it
stayed within bf16's own tolerance. Inputs are built from a seed with numpy
as smpl_verts_t's are, on the synthetic SMPL at V = 300 and 640, with B = 8
and a ragged 13. With f32 tables every plain version gives the bits it gave
before bf16 tables existed. The fit: fit_loss and its gradients at init and
a 3 + 3 + 3-step trajectory against JAX with NEMO_TPU_SKIN_BF16=1, and a
quality gate in the shape of tests/test_fit.py's test_skin_bf16_quality.
"""

import dataclasses
import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu import fit as jfit
from nemo_tpu.body import smpl as jsmpl
from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.data import synthetic_problem as jax_synthetic_problem
from nemo_tpu.fit.loop import _sample_batch
from nemo_tpu.ops import lbs_pallas
from nemo_tpu.ops.fk_pallas import fk_compose as jax_fk_compose
from nemo_tpu.priors import init_vposer as jax_init_vposer
from nemo_tpu.priors import synthetic_gmm_prior as jax_synthetic_gmm
from nemo_tpu.utils.checkpoint import _flatten_with_paths
from nemo_tpu_torch import fit as tfit
from nemo_tpu_torch.body.assets import smpl_from_numpy, synthetic_smpl_model
from nemo_tpu_torch.body.constants import SMPL_PARENTS
from nemo_tpu_torch.body.smpl import subset_skin_tables
from nemo_tpu_torch.data.synthetic import synthetic_problem
from nemo_tpu_torch.ops import lbs
from nemo_tpu_torch.priors.gmm import gmm_from_numpy
from nemo_tpu_torch.priors.vposer import init_vposer
from nemo_tpu_torch.utils.checkpoint import params_from_numpy, vposer_from_numpy

torch.set_num_threads(1)
PARENTS = tuple(int(p) for p in SMPL_PARENTS)
BF16 = torch.bfloat16
CASES = [(300, 8), (640, 13)]
IDS = [f"V{v}-B{b}" for v, b in CASES]
REL = {"verts": 2e-6, "grad": 1e-5, "total": 1e-6}
GAP_SHARE = 1 / 20
COTANGENTS = ("random", "sign")
STORED = ("recompute", "stored_vp")


def _interpret():
    orig = lbs_pallas.pl.pallas_call

    def call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)
    return mock.patch.object(lbs_pallas.pl, "pallas_call", call)


@functools.lru_cache(maxsize=None)
def _case(V, B):
    """numpy inputs: both pose sets as smpl_v2v_l1_sum builds them, the
    tables, a N(0,1) cotangent and its sign."""
    jm = jax_synthetic_smpl(num_vertices=V, seed=0)
    rng = np.random.RandomState(V + B)
    from scipy.spatial.transform import Rotation
    parents = np.asarray(jm.parents)
    Jr = np.asarray(jm.J_regressor) @ np.asarray(jm.v_template)
    t_l = np.broadcast_to(np.concatenate([Jr[:1], Jr[1:] - Jr[parents[1:]]]),
                          (B, 24, 3))

    def side():
        R = Rotation.from_rotvec(0.7 * rng.randn(B * 24, 3)).as_matrix()
        R = R.reshape(B, 24, 3, 3).astype(np.float32)
        Rg, tg = (np.asarray(a) for a in jax_fk_compose(
            jnp.asarray(R), jnp.asarray(t_l), PARENTS))
        t_rel = tg - np.einsum('bnij,nj->bni', Rg, Jr)
        pf = (R[:, 1:] - np.eye(3, dtype=np.float32)).reshape(B, 207)
        A = np.concatenate([Rg, t_rel[..., None]], -1).reshape(B, 24, 12)
        return pf, A.astype(np.float32)

    pf_o, A_o = side()
    pf_r, A_r = side()
    g = rng.randn(B, 3, V).astype(np.float32)
    return dict(V=V, B=B, pf_o=pf_o, A_o=A_o, pf_r=pf_r, A_r=A_r,
                vsh=np.ascontiguousarray(np.asarray(jm.v_template).T),
                pd=np.asarray(jm.posedirs_t), W=np.asarray(jm.lbs_weights_t),
                g={"random": g, "sign": np.sign(g)})


def _tables(c, dtype):
    """The port's tables: torch tensors of the logical layout."""
    return (torch.tensor(c["pd"]).to(dtype), torch.tensor(c["W"]).to(dtype))


def _t(c, *keys):
    return [torch.tensor(c[k]) for k in keys]


def _stored_vp(c, dtype):
    """The orig side's posed vertices as the pair mode stores them (the
    tables' dtype), from the port's plain version."""
    pd, W = _tables(c, dtype)
    return lbs.v2v_pair_plain(*_t(c, "pf_o", "A_o", "vsh"), pd, W,
                              *_t(c, "pf_r", "A_r"), want_vp=True)[2]


def _jax_v2v(c, tiles, vjp, monkeypatch):
    """(total, (gpf, gA, gvsh)) of nemo_tpu's skin_v2v_l1 on the Pallas
    route in interpret mode, in the vjp mode the JAX package's knobs
    select."""
    monkeypatch.setenv("NEMO_TPU_SKIN_FUSED_VJP", "1" if vjp == "fused"
                       else "0")
    monkeypatch.setenv("NEMO_TPU_SKIN_VP_RES", "1" if vjp == "pair_vp"
                       else "0")
    pd_tiles, w_tiles = tiles
    pf_r, A_r = jnp.asarray(c["pf_r"]), jnp.asarray(c["A_r"])

    def loss(pf, A, vsh):
        return lbs_pallas.skin_v2v_l1(c["V"], pf, A, vsh, pd_tiles, w_tiles,
                                      pf_r, A_r)
    with _interpret(), mock.patch.object(lbs_pallas, "_use_pallas",
                                         lambda: True):
        total, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(c[k]) for k in ("pf_o", "A_o", "vsh")))
    return np.asarray(total), tuple(np.asarray(x) for x in grads)


@functools.lru_cache(maxsize=None)
def _jax_ops(V, B, bf16):
    """Every op of nemo_tpu's Pallas kernels in interpret mode, with bf16
    or f32 tables: {"verts", ("bwd", cotangent, stored), ("v2v", vjp)}."""
    c = _case(V, B)
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    pd_tiles, w_tiles, _ = lbs_pallas.tile_tables(c["pd"], c["W"], tv=128,
                                                  dtype=dtype)
    Vp = pd_tiles.shape[0] * pd_tiles.shape[-1]
    args = [jnp.asarray(c[k]) for k in ("pf_o", "A_o", "vsh")]
    vp = _stored_vp(c, BF16 if bf16 else torch.float32).float().numpy()
    vp_tiles = jnp.asarray(np.pad(vp, ((0, 0), (0, 0), (0, Vp - V))), dtype)
    out = {}
    with _interpret():
        out["verts"] = np.asarray(lbs_pallas._fwd_pallas(
            *args, pd_tiles, w_tiles, V, tb=B))
        for cot in COTANGENTS:
            for stored in STORED:
                out[("bwd", cot, stored)] = tuple(np.asarray(x) for x in
                                                  lbs_pallas._bwd_pallas(
                    *args, pd_tiles, w_tiles, V, jnp.asarray(c["g"][cot]),
                    tb=B, vp=vp_tiles if stored == "stored_vp" else None))
    with pytest.MonkeyPatch.context() as mp:
        for vjp in lbs.VJP_MODES:
            out[("v2v", vjp)] = _jax_v2v(c, (pd_tiles, w_tiles), vjp, mp)
    return out


def _port_v2v(c, pd, W, vjp):
    """(total, (gpf, gA, gvsh)) through the public op on the CPU."""
    pf, A, vsh = (torch.tensor(c[k], requires_grad=True)
                  for k in ("pf_o", "A_o", "vsh"))
    total = lbs.skin_v2v_l1(c["V"], pf, A, vsh, pd, W,
                            *_t(c, "pf_r", "A_r"), vjp=vjp)
    total.backward()
    return total.detach().numpy(), (pf.grad.numpy(), A.grad.numpy(),
                                    vsh.grad.numpy())


def _port_ops(c):
    """The port's bf16 outputs, keyed as _jax_ops'."""
    pd, W = _tables(c, BF16)
    side = _t(c, "pf_o", "A_o", "vsh") + [pd, W]
    pf, A, vsh = _t(c, "pf_o", "A_o", "vsh")
    out = {"verts": lbs.skin_verts_t(c["V"], pf, A, vsh, pd, W).numpy()}
    vp = _stored_vp(c, BF16)
    for cot in COTANGENTS:
        for stored in STORED:
            out[("bwd", cot, stored)] = tuple(x.numpy() for x in
                                              lbs.skin_bwd_plain(
                *side, torch.tensor(c["g"][cot]),
                vp=vp if stored == "stored_vp" else None))
    for vjp in lbs.VJP_MODES:
        out[("v2v", vjp)] = _port_v2v(c, pd, W, vjp)
    return out


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _close(got, want, rel, name):
    scale = float(np.abs(np.asarray(want, np.float64)).max())
    err = _err(got, want)
    assert err <= rel * scale, f"{name}: {err:.3e} > {rel:g} x {scale:.3e}"


# ---------------------------------------------------------------------------
# the ops against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V,B", CASES, ids=IDS)
def test_skin_verts_t_matches_jax_kernel(V, B):
    """K3f's function: skin_verts_t with bf16 tables against _fwd_pallas."""
    c = _case(V, B)
    pd, W = _tables(c, BF16)
    got = lbs.skin_verts_t(V, *_t(c, "pf_o", "A_o", "vsh"), pd, W)
    assert got.dtype == torch.float32
    _close(got.numpy(), _jax_ops(V, B, True)["verts"], REL["verts"], "verts")


@pytest.mark.parametrize("stored", STORED)
@pytest.mark.parametrize("cotangent", COTANGENTS)
@pytest.mark.parametrize("V,B", CASES, ids=IDS)
def test_skin_bwd_matches_jax_kernel(V, B, cotangent, stored):
    """K3b's function, recomputing vp (_bwd_kernel) and reading the bf16
    vp the pair mode stores (_bwd_kernel_vp), under a N(0,1) cotangent and
    its sign."""
    c = _case(V, B)
    got = _port_ops(c)[("bwd", cotangent, stored)]
    want = _jax_ops(V, B, True)[("bwd", cotangent, stored)]
    for name, a, b in zip(("gpf", "gA", "gvsh"), got, want):
        _close(a, b, REL["grad"], name)


@pytest.mark.parametrize("vjp", lbs.VJP_MODES)
@pytest.mark.parametrize("V,B", CASES, ids=IDS)
def test_skin_v2v_l1_matches_jax_kernel(V, B, vjp):
    """K2 in each gradient mode (fused: _v2v_fwdbwd_pallas; pair and
    pair_vp: _v2v_fwd_pallas, then _bwd_pallas on the sign and the stored
    bf16 vp): the total and the gradients of pf, A and v_shaped."""
    c = _case(V, B)
    total, grads = _port_ops(c)[("v2v", vjp)]
    total_j, grads_j = _jax_ops(V, B, True)[("v2v", vjp)]
    np.testing.assert_allclose(total, total_j, rtol=REL["total"])
    for name, a, b in zip(("gpf", "gA", "gvsh"), grads, grads_j):
        _close(a, b, REL["grad"], name)


def _outputs(ops):
    """Every output tensor of _jax_ops / _port_ops, by name."""
    out = {"verts": ops["verts"]}
    for key, val in ops.items():
        if key == "verts":
            continue
        tensors = val if key[0] == "bwd" else (val[0],) + tuple(val[1])
        names = ("gpf", "gA", "gvsh") if key[0] == "bwd" else (
            "total", "gpf", "gA", "gvsh")
        out.update({key[1:] + (n,): t for n, t in zip(names, tensors)})
    return out


@pytest.mark.parametrize("V,B", CASES, ids=IDS)
def test_error_is_a_twentieth_of_the_bf16_gap(V, B):
    """The discriminating check: for every output, the port's distance to
    the JAX bf16 kernel is at most 1/20 of the JAX kernel's own bf16-vs-f32
    gap. Rounding pf, A, gm or gvp at another point (or not at all) moves
    an output by a share of that gap, not by f32 noise."""
    c = _case(V, B)
    port = _outputs(_port_ops(c))
    bf, f32 = _outputs(_jax_ops(V, B, True)), _outputs(_jax_ops(V, B, False))
    assert sorted(port, key=str) == sorted(bf, key=str)
    for k in bf:
        gap = _err(bf[k], f32[k])
        assert gap > 0, k
        assert _err(port[k], bf[k]) <= GAP_SHARE * gap, (
            k, _err(port[k], bf[k]), gap)


@pytest.mark.parametrize("stored", STORED)
@pytest.mark.parametrize("cotangent", COTANGENTS)
@pytest.mark.parametrize("V,B", CASES, ids=IDS)
def test_misrounding_shares_pass_the_jax_kernel(V, B, cotangent, stored):
    """The card tests' rounding-point check: the JAX kernel's bf16
    gradients, whose f32 sums run in another order than the plain
    version's, lie within lbs.MISROUNDED_SHARE of the plain version's
    distance from every lbs.skin_bwd_misrounded variant
    (lbs.misrounding_shares), and each variant, taken for a kernel's
    gradients, fails the check on the gradients it changes."""
    c = _case(V, B)
    pd, W = _tables(c, BF16)
    side = _t(c, "pf_o", "A_o", "vsh") + [pd, W]
    g = torch.tensor(c["g"][cotangent])
    vp = _stored_vp(c, BF16) if stored == "stored_vp" else None
    jax_grads = tuple(torch.tensor(x) for x in
                      _jax_ops(V, B, True)[("bwd", cotangent, stored)])
    shares = lbs.misrounding_shares(jax_grads, *side, g, vp=vp)
    assert {m for m, _ in shares} >= {"A", "gvp", "gvsh"}, shares
    assert max(shares.values()) <= lbs.MISROUNDED_SHARE, shares
    for moved in {m for m, _ in shares}:
        variant = lbs.skin_bwd_misrounded(*side, g, vp, moved)
        bad = lbs.misrounding_shares(variant, *side, g, vp=vp)
        assert max(bad.values()) > lbs.MISROUNDED_SHARE, (moved, bad)


@pytest.mark.parametrize("V,B", CASES, ids=IDS)
def test_f32_rounding_is_not_bf16(V, B):
    """The same check the other way: the port's f32 tables give the JAX f32
    kernels' outputs, far (over 1/20 of the gap) from the bf16 ones."""
    c = _case(V, B)
    pd, W = _tables(c, torch.float32)
    got = lbs.skin_verts_t(V, *_t(c, "pf_o", "A_o", "vsh"), pd, W).numpy()
    bf, f32 = _jax_ops(V, B, True)["verts"], _jax_ops(V, B, False)["verts"]
    gap = _err(bf, f32)
    assert _err(got, f32) <= GAP_SHARE * gap
    assert _err(got, bf) > GAP_SHARE * gap


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------

def _bits(t):
    """bf16 tensor or array -> its 16-bit patterns."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


@pytest.mark.parametrize("V", [300, 640])
def test_bf16_tables_equal_jax_tiles(V, monkeypatch):
    """synthetic_smpl_model(skin_dtype=bf16) holds _untile(tile_tables(...,
    bf16)) bit for bit; every other field stays f32 and equals the f32
    model's; the subset tables keep the dtype and equal JAX's subset tiles
    (which read NEMO_TPU_SKIN_BF16)."""
    jm = jax_synthetic_smpl(num_vertices=V, seed=0)
    tiles = lbs_pallas.tile_tables(np.asarray(jm.posedirs_t),
                                   np.asarray(jm.lbs_weights_t),
                                   dtype=jnp.bfloat16)
    pd_j, w_j = lbs_pallas._untile(*tiles)
    got = synthetic_smpl_model(V, seed=0, skin_dtype=BF16)
    f32 = synthetic_smpl_model(V, seed=0)
    assert got.posedirs_t.dtype == got.lbs_weights_t.dtype == BF16
    np.testing.assert_array_equal(_bits(got.posedirs_t), _bits(pd_j))
    np.testing.assert_array_equal(_bits(got.lbs_weights_t), _bits(w_j))
    for f in ("v_template", "posedirs", "lbs_weights", "J_regressor",
              "fused_EP", "fused_EW"):
        a, b = getattr(got, f), getattr(f32, f)
        assert a.dtype == torch.float32 and torch.equal(a, b), f
    assert f32.posedirs_t.dtype == torch.float32
    monkeypatch.setenv("NEMO_TPU_SKIN_BF16", "1")
    jm_b = jax_synthetic_smpl(num_vertices=V, seed=0)
    vidx_j, pd_s, w_s = jsmpl.subset_skin_tables(jm_b, 64)
    vidx, pd_t, w_t = subset_skin_tables(got, 64)
    np.testing.assert_array_equal(vidx.numpy(), np.asarray(vidx_j))
    pd_u, w_u = lbs_pallas._untile(pd_s, w_s, len(vidx))
    assert pd_t.dtype == w_t.dtype == BF16
    np.testing.assert_array_equal(_bits(pd_t), _bits(pd_u))
    np.testing.assert_array_equal(_bits(w_t), _bits(w_u))


@pytest.mark.parametrize("bf16", [False, True])
def test_smpl_from_numpy_carries_the_table_dtype(bf16, monkeypatch):
    """A JAX model tiled in bf16 (NEMO_TPU_SKIN_BF16=1) carries across with
    bf16 tables, equal to its tiles bit for bit; one tiled in f32 with f32
    tables; an explicit skin_dtype wins."""
    monkeypatch.setenv("NEMO_TPU_SKIN_BF16", "1" if bf16 else "0")
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    got = smpl_from_numpy(jm)
    pd_j, w_j = lbs_pallas._untile(jm.pd_tiles, jm.w_tiles, 300)
    if bf16:
        assert got.posedirs_t.dtype == BF16
        np.testing.assert_array_equal(_bits(got.posedirs_t), _bits(pd_j))
        np.testing.assert_array_equal(_bits(got.lbs_weights_t), _bits(w_j))
    else:
        assert got.posedirs_t.dtype == torch.float32
        np.testing.assert_array_equal(got.posedirs_t.numpy(),
                                      np.asarray(pd_j))
    assert got.posedirs.dtype == torch.float32
    other = smpl_from_numpy(jm, skin_dtype=torch.float32 if bf16 else BF16)
    assert other.posedirs_t.dtype == (torch.float32 if bf16 else BF16)


# ---------------------------------------------------------------------------
# f32 tables: the plain versions as they were
# ---------------------------------------------------------------------------

def _posed_f32(pf, pd, vsh):
    return torch.einsum('bp,pkv->bkv', pf, pd) + vsh


def _blend_f32(A, W):
    return torch.einsum('bjl,jv->blv', A, W).reshape(A.shape[0], 3, 4, -1)


def _hom(vp):
    return torch.cat([vp, vp.new_ones((vp.shape[0], 1, vp.shape[-1]))], 1)


def _verts_f32(pf, A, vsh, pd, W):
    return torch.einsum('bikv,bkv->biv', _blend_f32(A, W),
                        _hom(_posed_f32(pf, pd, vsh)))


def _bwd_f32(pf, A, vsh, pd, W, g, vp=None):
    """ops/lbs.py's skin_bwd_plain before bf16 tables, verbatim."""
    B = pf.shape[0]
    vposed = _posed_f32(pf, pd, vsh) if vp is None else vp
    M4 = _blend_f32(A, W)
    gM4 = torch.einsum('biv,bkv->bikv', g, _hom(vposed))
    ga = torch.einsum('bikv,jv->bjik', gM4, W).reshape(B, 24, 12)
    gvposed = torch.einsum('bikv,biv->bkv', M4[:, :, :3], g)
    return (torch.einsum('bkv,pkv->bp', gvposed, pd), ga, gvposed.sum(dim=0))


@pytest.mark.parametrize("V,B", CASES, ids=IDS)
def test_f32_tables_give_the_same_bits(V, B):
    """With f32 tables every plain version (and so every CPU output of the
    port) is bit-identical to the formulas it had before bf16 tables."""
    c = _case(V, B)
    pd, W = _tables(c, torch.float32)
    side = _t(c, "pf_o", "A_o", "vsh") + [pd, W]
    rec = _t(c, "pf_r", "A_r")
    assert torch.equal(lbs.skin_verts_t_plain(*side), _verts_f32(*side))
    g = torch.tensor(c["g"]["random"])
    vp = _posed_f32(side[0], pd, side[2])
    for stored in (None, vp):
        for a, b in zip(lbs.skin_bwd_plain(*side, g, vp=stored),
                        _bwd_f32(*side, g, vp=stored)):
            assert torch.equal(a, b)
    total, sign, vp_got = lbs.v2v_pair_plain(*side, *rec, want_vp=True)
    diff = _verts_f32(*rec, side[2], pd, W) - _verts_f32(*side)
    assert torch.equal(total, diff.abs().sum())
    assert torch.equal(sign, torch.sign(diff))
    assert vp_got.dtype == torch.float32 and torch.equal(vp_got, vp)
    total2, grads = lbs.v2v_l1_plain(*side, *rec, grad=True)
    assert torch.equal(total2, total)
    for a, b in zip(grads, _bwd_f32(*side, torch.sign(diff))):
        assert torch.equal(a, b)


def test_kernel_inputs_are_checked_by_table_dtype():
    """The launchers take bf16 tables (both of them) and a stored vp in the
    tables' dtype; mixed tables or an f32 vp with bf16 tables are refused
    before any launch (the check runs on any device)."""
    c = _case(300, 8)
    pd, W = _tables(c, BF16)
    pf, A, vsh = _t(c, "pf_o", "A_o", "vsh")
    g = torch.tensor(c["g"]["random"])
    assert lbs._check_skin_inputs(pf, A, vsh, pd, W)[3] == lbs.BF16
    assert lbs._check_skin_inputs(pf, A, vsh, pd.float(), W.float())[3] == ""
    with pytest.raises(TypeError, match="W_t"):
        lbs._check_skin_inputs(pf, A, vsh, pd, W.float())
    with pytest.raises(TypeError, match="vp"):
        lbs._check_skin_inputs(pf, A, vsh, pd, W, g=g, vp=g)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lbs._check_skin_inputs(pf, A, vsh, pd.half(), W.half())
    # the tables read two elements at a time where V is even: 4 bytes bf16
    assert lbs._alignment("posedirs_t", pd, 300) == 4
    assert lbs._alignment("posedirs_t", pd, 301) == 2
    assert lbs._alignment("posedirs_t", pd.float(), 300) == 8
    assert lbs._alignment("vp", pd, 300) == 2
    assert all(lbs.LAUNCHES[k + lbs.BF16] == 0 for k in lbs._KERNELS)


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------

WARMUP, CAM, MAIN = 3, 3, 3


@pytest.fixture(scope="module")
def problem():
    """JAX's assets built with NEMO_TPU_SKIN_BF16=1 (bf16 tiles), the port's
    from the same model (bf16 tables, carried by smpl_from_numpy)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEMO_TPU_SKIN_BF16", "1")
        cfg = jfit.NemoConfig(
            model_version=2, h_dim=32, instance_code_size=4,
            phase_rbf_dim=8, rbf_kernel="quadratic",
            monotonic_network_n_nodes=4, batch_size=16, weight_vp_loss=10.0,
            weight_vp_z_loss=1.0, weight_gmm_loss=0.5, label_type="gt",
            lr_factor=0.5, n_steps=MAIN, warmup_step=WARMUP,
            opt_cam_step=CAM)
        jm = jax_synthetic_smpl(num_vertices=300, seed=0)
        assert jm.pd_tiles.dtype == jnp.bfloat16
        bundle, _ = jax_synthetic_problem(jm, num_views=2, num_frames=12,
                                          seed=0)
        gmm = jax_synthetic_gmm(4)
        vposer = jax_init_vposer(jax.random.PRNGKey(7))
        jassets = jfit.build_assets(bundle, jm, cfg, gmm=gmm, vposer=vposer)
    tcfg = tfit.NemoConfig(**dataclasses.asdict(cfg))
    tassets = tfit.build_assets(
        bundle, smpl_from_numpy(jm), tcfg,
        gmm=gmm_from_numpy(gmm.means, gmm.precisions, gmm.nll_weights),
        vposer=vposer_from_numpy({k: np.asarray(v) for k, v in
                                  vposer.items()}), device="cpu")
    assert tassets.smpl.posedirs_t.dtype == BF16
    params = jfit.init_params(jax.random.PRNGKey(0), cfg, jassets.num_views,
                              jassets.img_d0)
    return dict(cfg=cfg, tcfg=tcfg, jassets=jassets, tassets=tassets,
                params=params)


def _jax_pallas():
    """nemo_tpu's skinning on its Pallas kernels in interpret mode."""
    stack = mock.patch.object(lbs_pallas, "_use_pallas", lambda: True)
    return stack, _interpret()


def _port_params(pb):
    tp = tfit.init_params(pb["tcfg"], pb["tassets"].num_views,
                          pb["tassets"].img_d0)
    return params_from_numpy(tp, _flatten_with_paths(pb["params"]))


def test_fit_loss_and_grads_match_jax_bf16(problem):
    """fit_loss and every parameter gradient at init against JAX's with
    bf16 tables on the Pallas route: the loss within rtol 2e-5, each
    metric 5e-5 (tests/test_reference_twin.py), each gradient within 1e-4
    of its tensor's largest entry (tests/test_torch_port_fit.py)."""
    cfg, jassets = problem["cfg"], problem["jassets"]
    rng = np.random.RandomState(1001)
    vi = rng.randint(0, 2, size=16).astype(np.int32)
    fi = rng.randint(0, 12, size=16).astype(np.int32)
    use, interp = _jax_pallas()
    with use, interp:
        (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
            lambda p, v, f: jfit.fit_loss(p, cfg, jassets, v, f,
                                          training=False),
            has_aux=True))(problem["params"], jnp.asarray(vi),
                           jnp.asarray(fi))
    tp = _port_params(problem)
    loss_t, metrics_t = tfit.fit_loss(tp, problem["tcfg"], problem["tassets"],
                                      torch.as_tensor(vi).long(),
                                      torch.as_tensor(fi).long())
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=2e-5)
    assert float(metrics_j["vp_recon_loss"]) > 0
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics_t[k].detach()),
                                   float(metrics_j[k]), rtol=5e-5,
                                   err_msg=k)
    flat_j = _flatten_with_paths(grads_j)
    for n, p in tp.named_parameters():
        gj = flat_j[n.replace(".", "/")]
        gt = p.grad.numpy() if p.grad is not None else np.zeros_like(gj)
        np.testing.assert_allclose(gt, gj, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(gj).max()) + 1e-9,
                                   err_msg=n)


def _replay(seed, V, F, B):
    """The JAX fitter's batch stream (fit/loop.py's key threading)."""
    key = jax.random.PRNGKey(seed)
    _k_init, key = jax.random.split(key)
    out = {"warmup": [], "main": []}
    for _ in range(WARMUP):
        key, k1 = jax.random.split(key)
        out["warmup"].append(_sample_batch(k1, B, V, F))
    for _ in range(MAIN):
        key, k1, _k2 = jax.random.split(key, 3)
        out["main"].append(_sample_batch(k1, B, V, F))
    return out


def test_three_stage_trajectory_matches_jax_bf16(problem):
    """warmup -> camera -> main, 3 steps each, through both fitters with
    bf16 tables: per-step losses within rtol 1e-4 (the first 5 steps of
    tests/test_reference_twin.py) and the eval within 1e-3."""
    cfg = problem["cfg"]
    use, interp = _jax_pallas()
    with use, interp:
        fitter = jfit.NemoFitter(cfg, problem["jassets"], seed=0)
        params0 = fitter.state.params
        wm, cm = fitter.warmup(), fitter.opt_cam()
        fm = fitter.fit(chunk=MAIN)
        ej = fitter.eval_loss()
    batches = _replay(0, 2, 12, cfg.batch_size)
    tf = tfit.NemoFitter(problem["tcfg"], problem["tassets"], seed=0,
                         batch_source=lambda s, i: batches[s][i])
    params_from_numpy(tf.params, _flatten_with_paths(params0))
    twm, tcm = tf.warmup(), tf.opt_cam()
    tfm = tf.fit(chunk=MAIN)
    for name, j, t in (("warmup", wm["warmup_loss"], twm["warmup_loss"]),
                       ("camera", cm["cam_loss"], tcm["cam_loss"])):
        np.testing.assert_allclose(t, j, rtol=1e-4, err_msg=name)
    for k in ("total_loss", "kp_loss", "vp_recon_loss", "gmm_loss"):
        np.testing.assert_allclose(tfm[k], fm[k], rtol=1e-4, err_msg=k)
    et = tf.eval_loss()
    for k in ej:
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-3, err_msg=k)


@functools.lru_cache(maxsize=None)
def _quality_run(seed):
    """f32 and bf16 tables, one seed for both, so every batch is the same;
    5 warmup, 5 camera and 40 main steps of a 640-vertex body, 3 views x 24
    frames: ({table: main-stage total_loss curve}, {table: final kp_loss})."""
    curves, finals = {}, {}
    bundle, _ = synthetic_problem(synthetic_smpl_model(640, seed=1),
                                  num_views=3, num_frames=24,
                                  warp_strength=0.4, seed=3)
    cfg = tfit.NemoConfig(
        model_version=2, h_dim=32, instance_code_size=4, phase_rbf_dim=16,
        rbf_kernel="linear", monotonic_network_n_nodes=10,
        phase_init="linear", batch_size=32, lr_phase=1e-3, lr_factor=1.0,
        weight_vp_loss=1.0, weight_vp_z_loss=0.01, weight_gmm_loss=0.0,
        warmup_step=5, opt_cam_step=5, n_steps=40, label_type="gt")
    for name, dtype in (("f32", torch.float32), ("bf16", BF16)):
        smpl = synthetic_smpl_model(640, seed=1, skin_dtype=dtype)
        assets = tfit.build_assets(
            bundle, smpl, cfg, device="cpu",
            vposer=init_vposer(generator=torch.Generator().manual_seed(7)))
        assert assets.smpl.posedirs_t.dtype == dtype
        fitter = tfit.NemoFitter(cfg, assets, seed=seed)
        fitter.warmup()
        fitter.opt_cam()
        metrics = fitter.fit(chunk=40)
        assert np.isfinite(metrics["total_loss"]).all(), name
        curves[name] = np.asarray(metrics["total_loss"], np.float64)
        finals[name] = fitter.eval_loss()["kp_loss"]
    return curves, finals


@pytest.mark.parametrize("seed", [0, 1])
def test_skin_bf16_quality(seed):
    """The quality gate of tests/test_fit.py's test_skin_bf16_quality on the
    port, cut to run in seconds (_quality_run): the median per-step
    relative |delta total_loss| stays under 5%, the final kp_loss within
    1.3x."""
    curves, finals = _quality_run(seed)
    rel = np.abs(curves["bf16"] - curves["f32"]) / np.abs(curves["f32"])
    assert np.median(rel) < 0.05, np.median(rel)
    assert rel.max() > 0          # the tables did change the computation
    assert finals["bf16"] / finals["f32"] <= 1.3, finals


def test_skin_bf16_quality_across_seeds():
    """The cross-seed bounds of tests/test_fit.py:466-473 over seeds 0 and 1
    (the same runs as test_skin_bf16_quality): the median of the final
    kp_loss ratios bf16 / f32 at most 1.15, each at most 1.30."""
    ratios = []
    for seed in (0, 1):
        _, finals = _quality_run(seed)
        ratios.append(finals["bf16"] / finals["f32"])
    assert np.median(ratios) <= 1.15, ratios
    assert max(ratios) <= 1.30, ratios


def test_keypoints_meshes_and_evals_ignore_the_table_dtype():
    """At the same parameters, everything but the v2v prior is
    bit-identical with bf16 and f32 tables: predict's joints and full
    meshes (which feed the evals and the renders), the projections, the
    keypoint and GMM terms; only vp_recon_loss reads the skinning tables."""
    bundle, _ = synthetic_problem(synthetic_smpl_model(300, seed=0),
                                  num_views=2, num_frames=6, seed=0)
    cfg = tfit.NemoConfig(
        model_version=2, h_dim=16, instance_code_size=4, phase_rbf_dim=8,
        rbf_kernel="quadratic", monotonic_network_n_nodes=4, batch_size=12,
        weight_vp_loss=10.0, weight_vp_z_loss=1.0, label_type="gt")
    vi = torch.arange(12) % 2
    fi = torch.arange(12) % 6
    out = {}
    for dtype in (torch.float32, BF16):
        assets = tfit.build_assets(
            bundle, synthetic_smpl_model(300, seed=0, skin_dtype=dtype), cfg,
            device="cpu",
            vposer=init_vposer(generator=torch.Generator().manual_seed(7)))
        params = tfit.init_params(cfg, 2, assets.img_d0,
                                  torch.Generator().manual_seed(0))
        with torch.no_grad():
            pr = tfit.predict(params, cfg, assets, vi, fi, want_vertices=True)
            p2 = tfit.project_to_views(params, cfg, assets, pr["j"], vi)
            _, metrics = tfit.fit_loss(params, cfg, assets, vi, fi)
        out[dtype] = (pr["j"], pr["v"], p2, metrics)
    (j32, v32, p32, m32), (jb, vb, pb, mb) = out[torch.float32], out[BF16]
    assert torch.equal(j32, jb) and torch.equal(v32, vb)
    assert torch.equal(p32, pb)
    for k in m32:
        if k not in ("vp_recon_loss", "total_loss"):
            assert torch.equal(m32[k], mb[k]), k
    assert not torch.equal(m32["vp_recon_loss"], mb["vp_recon_loss"])
