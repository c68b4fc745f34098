"""The one-pass K3b kernel's arithmetic on the CPU, before any card sees it.

``lbs.skin_bwd_split_emulation`` repeats what csrc/skin.cu's one-pass
backward computes: the posedirs contractions (the recomputed posed vertices
and gpf) as three TF32 products (x = big + small, each rounded to the
nearest TF32 by masking mantissa bits), and the per-block partials (gpf and
gA a vertex range, gvsh a batch tile) summed in the kernel's fixed order.
It is held, in both of the kernel's modes (vp recomputed, vp stored) and
under a random N(0,1) and a sign cotangent, against

- nemo_tpu's ``_bwd_pallas`` in interpret mode (as
  tests/test_torch_port_configs.py runs it) and its XLA path ``_bwd_xla``,
- the port's plain version ``skin_bwd_plain``,

each gradient within 1e-4 of its largest entry, the kernel's own tolerance
on the card; against the plain version in f64, where the split's own error
stays within 5e-6 of each gradient's largest entry; and against itself with
another count of vertex ranges, where only the order of the partials
differs. Inputs are built like smpl_verts_t's, on the synthetic SMPL at
V=300, 1024 (path A's subset size) and 6890, B=8.
"""

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
B = 8
NAMES = ("gpf", "gA", "gvsh")


@pytest.fixture(scope="module", params=[300, 1024, 6890])
def case(request):
    V = request.param
    jm = jax_synthetic_smpl(num_vertices=V, seed=0)
    rng = np.random.RandomState(V)
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(0.7 * rng.randn(B * 24, 3)).as_matrix()
    R = R.reshape(B, 24, 3, 3).astype(np.float32)
    parents = np.asarray(jm.parents)
    Jr = np.asarray(jm.J_regressor) @ np.asarray(jm.v_template)
    t_l = np.broadcast_to(np.concatenate([Jr[:1], Jr[1:] - Jr[parents[1:]]]),
                          (B, 24, 3))
    Rg, tg = (np.asarray(a) for a in jax_fk_compose(
        jnp.asarray(R), jnp.asarray(t_l), PARENTS))
    t_rel = tg - np.einsum('bnij,nj->bni', Rg, Jr)
    pd, W = np.asarray(jm.posedirs_t), np.asarray(jm.lbs_weights_t)
    pd_tiles, w_tiles, _ = lbs_pallas.tile_tables(pd, W, tv=128)
    c = dict(V=V, pf=(R[:, 1:] - np.eye(3, dtype=np.float32)).reshape(B, 207),
             A34=np.concatenate([Rg, t_rel[..., None]], -1).reshape(
                 B, 24, 12).astype(np.float32),
             vsh=np.ascontiguousarray(np.asarray(jm.v_template).T), pd=pd,
             W=W, pd_tiles=jnp.asarray(pd_tiles), w_tiles=jnp.asarray(w_tiles))
    c["vp"] = (np.einsum('bp,pkv->bkv', c["pf"], pd) + c["vsh"]).astype(
        np.float32)
    g = rng.randn(B, 3, V).astype(np.float32)
    c["g"] = {"random": g, "sign": np.sign(g)}
    return c


@pytest.fixture(params=["random", "sign"])
def cotangent(request):
    return request.param


@pytest.fixture(params=["recompute", "stored_vp"])
def mode(request):
    return request.param


def _args(c, cotangent, mode):
    """(positional torch args, vp) of skin_bwd_split_emulation and
    skin_bwd_plain."""
    args = [torch.tensor(c[k]) for k in ("pf", "A34", "vsh", "pd", "W")]
    vp = torch.tensor(c["vp"]) if mode == "stored_vp" else None
    return args + [torch.tensor(c["g"][cotangent])], vp


def _check(got, want, rel=1e-4):
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b, dtype=np.float64)
        np.testing.assert_allclose(np.asarray(a, dtype=np.float64), b,
                                   rtol=0, atol=rel * np.abs(b).max(),
                                   err_msg=name)


def _interpret():
    orig = lbs_pallas.pl.pallas_call

    def call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)
    return mock.patch.object(lbs_pallas.pl, "pallas_call", call)


def test_split_matches_jax_kernel(case, cotangent, mode):
    """Against the TPU kernel itself (_bwd_kernel, or _bwd_kernel_vp on the
    stored posed vertices padded to the tiles' width) in interpret mode,
    and against the XLA path, which recomputes vp."""
    c, V = case, case["V"]
    args, vp = _args(c, cotangent, mode)
    got = lbs.skin_bwd_split_emulation(*args, vp=vp)
    j_args = [jnp.asarray(c[k]) for k in ("pf", "A34", "vsh")]
    g = jnp.asarray(c["g"][cotangent])
    vp_tiles = None
    if vp is not None:
        Vp = c["pd_tiles"].shape[0] * c["pd_tiles"].shape[-1]
        vp_tiles = jnp.asarray(np.pad(c["vp"], ((0, 0), (0, 0), (0, Vp - V))))
    with _interpret():
        want_j = lbs_pallas._bwd_pallas(*j_args, c["pd_tiles"], c["w_tiles"],
                                        V, g, tb=8, vp=vp_tiles)
    _check(got, want_j)
    want_x = lbs_pallas._bwd_xla(*j_args, jnp.asarray(c["pd"]),
                                 jnp.asarray(c["W"]), g)
    _check(got, want_x)


def test_split_matches_plain(case, cotangent, mode):
    args, vp = _args(case, cotangent, mode)
    _check(lbs.skin_bwd_split_emulation(*args, vp=vp),
           lbs.skin_bwd_plain(*args, vp=vp))


def test_split_error_against_float64(case, cotangent, mode):
    """The split's own error: under 1e-6 of each gradient's largest entry
    at these sizes (bound 5e-6 here), well inside the kernel's 1e-4."""
    args, vp = _args(case, cotangent, mode)
    want = lbs.skin_bwd_plain(*(a.double() for a in args),
                              vp=None if vp is None else vp.double())
    _check(lbs.skin_bwd_split_emulation(*args, vp=vp), want, rel=5e-6)


def test_split_reduction_order_is_the_only_difference(case, cotangent, mode):
    """One SM (two vertex ranges) against 132 (up to 264): the same split
    arithmetic, the partials summed in another grouping. gvsh, one batch
    tile at B=8, is identical; gpf and gA agree to f32 rounding."""
    args, vp = _args(case, cotangent, mode)
    one = lbs.skin_bwd_split_emulation(*args, vp=vp, num_sms=1)
    full = lbs.skin_bwd_split_emulation(*args, vp=vp, num_sms=132)
    assert lbs.fused_ranges(B, case["V"], 1) == 2
    assert torch.equal(one[2], full[2])
    _check(one, full, rel=2e-6)


def test_stored_vp_reads_what_it_is_given(case):
    """Mode 2 takes vp as given: fed the posed vertices mode 1 recomputes
    (3xTF32), it gives mode 1's gradients bit for bit."""
    args, _ = _args(case, "random", "recompute")
    vp = lbs._posed_3xtf32(args[0], args[3], args[2])
    for a, b in zip(lbs.skin_bwd_split_emulation(*args, vp=vp),
                    lbs.skin_bwd_split_emulation(*args)):
        assert torch.equal(a, b)
