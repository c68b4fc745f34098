"""The one-pass forward kernel's arithmetic on the CPU, before any card sees it.

csrc/skin_fwd.cuh's skin_fwd_kernel runs K3f and K2's pair mode:
the posed vertices as three TF32 products on the tensor cores (x = big +
small, each rounded to the nearest TF32 by masking mantissa bits), the
blend and the vertices in f32, and in the pair mode one |diff| partial a
block, summed in block order. ``lbs.skin_fwd_split_emulation`` and
``lbs.v2v_pair_split_emulation`` repeat that arithmetic. They are held
against

- nemo_tpu's ``_fwd_pallas`` and ``_v2v_fwd_pallas(want_vp=True)`` in
  Pallas interpret mode (as tests/test_torch_port_configs.py runs them) at
  V=300, and its XLA path (``_skin_verts_t_xla``, ``_v2v_fwd``) at V=1024
  and 6890,
- the port's plain versions, and the plain versions in float64,

with the kernel's tolerances: vertices and vp within 1e-5 of the largest
entry, the total within rtol 1e-5, the sign equal. Inputs are built like
smpl_verts_t's and smpl_v2v_l1_sum's on the synthetic SMPL, B = 8 and a
ragged 37; the rec side is offset by +-10 m, so no vertex difference lies
near 0, where sign(rec - orig) could flip between two summation orders.
The range rule (``lbs.fwd_ranges``) is checked against hand-computed
cases.
"""

import functools
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.ops import lbs_pallas
from nemo_tpu.ops.fk_pallas import fk_compose as jax_fk_compose
from nemo_tpu_torch.body.constants import SMPL_PARENTS
from nemo_tpu_torch.ops import lbs

torch.set_num_threads(1)
PARENTS = tuple(int(p) for p in SMPL_PARENTS)
REL = 1e-5    # vertices, vp: of the largest entry; the total: relative


@functools.lru_cache(maxsize=None)
def _model(V):
    jm = jax_synthetic_smpl(num_vertices=V, seed=0)
    pd, W = np.asarray(jm.posedirs_t), np.asarray(jm.lbs_weights_t)
    pd_tiles, w_tiles, _ = lbs_pallas.tile_tables(pd, W, tv=128)
    return jm, pd, W, jnp.asarray(pd_tiles), jnp.asarray(w_tiles)


@pytest.fixture(scope="module", params=[(300, 8), (300, 37), (1024, 8),
                                        (1024, 37), (6890, 8), (6890, 37)],
                ids=lambda p: f"V{p[0]}-B{p[1]}")
def case(request):
    V, B = request.param
    jm, pd, W, pd_tiles, w_tiles = _model(V)
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
        A = np.concatenate([Rg, t_rel[..., None]], -1).astype(np.float32)
        return pf, A

    pf_o, A_o = side()
    pf_r, A_r = side()
    A_r[..., 3] += 10.0 * np.sign(rng.randn(B, 1, 3))
    c = dict(V=V, B=B, pf_o=pf_o, A_o=A_o.reshape(B, 24, 12),
             pf_r=pf_r, A_r=A_r.reshape(B, 24, 12).astype(np.float32),
             vsh=np.ascontiguousarray(np.asarray(jm.v_template).T), pd=pd,
             W=W, pd_tiles=pd_tiles, w_tiles=w_tiles)
    t = lambda *ks: [torch.tensor(c[k]) for k in ks]
    c["side"] = t("pf_o", "A_o", "vsh", "pd", "W")
    c["pair"] = c["side"] + t("pf_r", "A_r")
    return c


def _close(got, want, rel=REL, name=""):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               rtol=0, atol=rel * np.abs(want).max(),
                               err_msg=name)


def _check_pair(got, total, sign, vp, rel=REL):
    np.testing.assert_allclose(float(got[0]), float(total), rtol=rel)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(sign))
    _close(got[2], vp, rel, "vp")


def _interpret():
    orig = lbs_pallas.pl.pallas_call

    def call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)
    return mock.patch.object(lbs_pallas.pl, "pallas_call", call)


def _jax(c, *keys):
    return [jnp.asarray(c[k]) for k in keys]


def test_skin_fwd_split_matches_jax(case):
    """K3f's arithmetic against the TPU kernel (_fwd_pallas, interpret
    mode) at V=300 and the XLA path at V=1024 and 6890."""
    c, V = case, case["V"]
    got = lbs.skin_fwd_split_emulation(*c["side"])
    args = _jax(c, "pf_o", "A_o", "vsh")
    if V == 300:
        with _interpret():
            want = lbs_pallas._fwd_pallas(*args, c["pd_tiles"], c["w_tiles"],
                                          V)
    else:
        want = lbs_pallas._skin_verts_t_xla(*args, *_jax(c, "pd", "W"))
    _close(got, want)


def test_pair_split_matches_jax(case):
    """The pair mode's arithmetic against the TPU kernel
    (_v2v_fwd_pallas(want_vp=True), interpret mode) at V=300 and the XLA
    path's total and sign (_v2v_fwd) at V=1024 and 6890, with vp against
    the XLA path's posed vertices."""
    c, V, B = case, case["V"], case["B"]
    got = lbs.v2v_pair_split_emulation(*c["pair"], want_vp=True)
    o, r = _jax(c, "pf_o", "A_o"), _jax(c, "pf_r", "A_r")
    vsh = jnp.asarray(c["vsh"])
    if V == 300:
        with _interpret():
            total, sign, vp = lbs_pallas._v2v_fwd_pallas(
                *o, *r, vsh, c["pd_tiles"], c["w_tiles"], V, want_vp=True)
        # both come back lane-padded, vp batch-padded too
        sign = np.asarray(sign.astype(jnp.float32))[:, :, :V]
        vp = np.asarray(vp)[:B, :, :V]
    else:
        total, res = lbs_pallas._v2v_fwd(V, *o, vsh, c["pd_tiles"],
                                         c["w_tiles"], *r)
        sign = res[5]
        vp = jnp.einsum('bp,pkv->bkv', o[0], jnp.asarray(c["pd"]),
                        precision=lbs_pallas.HI) + vsh
    _check_pair(got, total, sign, vp)


def test_fwd_split_matches_plain(case):
    c = case
    _close(lbs.skin_fwd_split_emulation(*c["side"]),
           lbs.skin_verts_t_plain(*c["side"]))
    _check_pair(lbs.v2v_pair_split_emulation(*c["pair"], want_vp=True),
                *lbs.v2v_pair_plain(*c["pair"], want_vp=True))


def test_fwd_split_error_against_float64(case):
    """The split's own error against the plain versions in f64: the
    vertices, vp and the total within 2e-6 (relative as above), the sign
    equal."""
    c = case
    side64 = [a.double() for a in c["side"]]
    pair64 = [a.double() for a in c["pair"]]
    _close(lbs.skin_fwd_split_emulation(*c["side"]),
           lbs.skin_verts_t_plain(*side64), rel=2e-6)
    _check_pair(lbs.v2v_pair_split_emulation(*c["pair"], want_vp=True),
                *lbs.v2v_pair_plain(*pair64, want_vp=True), rel=2e-6)


def test_pair_split_reduction_order_is_the_only_difference(case):
    """One SM against 132: the same arithmetic, the |diff| partials grouped
    otherwise; the sign and vp identical, the totals within f32
    rounding."""
    c = case
    one = lbs.v2v_pair_split_emulation(*c["pair"], want_vp=True, num_sms=1)
    full = lbs.v2v_pair_split_emulation(*c["pair"], want_vp=True)
    assert torch.equal(one[1], full[1]) and torch.equal(one[2], full[2])
    np.testing.assert_allclose(float(one[0]), float(full[0]), rtol=1e-6)
    no_vp = lbs.v2v_pair_split_emulation(*c["pair"], want_vp=False)
    assert no_vp[2] is None and torch.equal(no_vp[0], full[0])


@pytest.mark.parametrize("B,V,sides,want", [
    (512, 6890, 1, 8),     # 16 batch tiles: 128 blocks, one wave of 54 tiles
    (960, 1024, 1, 4),     # path A: 30 batch tiles, 120 blocks of 16 tiles
    (512, 6890, 2, 4),     # 32 tiles of 16 rows: 128 blocks of 108 tiles
    (960, 6890, 2, 2),     # 60 batch tiles: 120 blocks of 216 tiles
    (960, 6890, 1, 13),    # 30 batch tiles: 3 waves of 34 tiles
    (37, 300, 1, 19),      # 2 batch tiles, one tile a range
    (1, 5, 1, 1),          # one tile in all
    (5000, 6890, 1, 3),    # 157 batch tiles, R capped at 4 x 132 / 157
])
def test_fwd_ranges(B, V, sides, want):
    """The forward kernel's ranges on 132 SMs: of R up to 4 SMs / batch
    tiles and the tile count, the fewest (waves x (largest range + 2))."""
    assert lbs.fwd_ranges(B, V, sides, 132) == want
