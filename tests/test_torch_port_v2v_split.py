"""The fused K2 kernel's arithmetic on the CPU, before any card sees it.

``lbs.v2v_l1_split_emulation`` repeats what csrc/v2v.cu's warp-specialised
kernel computes: both posedirs contractions as three TF32 products (x = big
+ small, each part rounded to the nearest TF32 by masking mantissa bits),
vph in two feature halves, and the per-block partials of its 16-row,
16-vertex-tile blocks summed in the kernel's fixed order. It is held against
nemo_tpu's skin_v2v_l1 (run through its XLA path, as test_torch_port_ops.py
runs it) and against the port's plain version, with the kernel's own
tolerances: the total within rtol 1e-5, each gradient within 1e-4 of its
largest entry. Inputs are built like smpl_v2v_l1_sum's, on the synthetic
SMPL at V=300 and at the full V=6890, B=8; the rec side is offset by +-10 m
so no vertex difference lies near 0, where sign(rec - orig) could flip
between two summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.ops.fk_pallas import fk_compose as jax_fk_compose
from nemo_tpu.ops.lbs_pallas import skin_v2v_l1 as jax_skin_v2v_l1
from nemo_tpu_torch.body.constants import SMPL_PARENTS
from nemo_tpu_torch.ops import lbs

torch.set_num_threads(1)
PARENTS = tuple(int(p) for p in SMPL_PARENTS)
B = 8


def _rotations(rng, n, scale=0.7):
    from scipy.spatial.transform import Rotation
    aa = scale * rng.randn(n * 24, 3)
    return Rotation.from_rotvec(aa).as_matrix().reshape(n, 24, 3, 3).astype(
        np.float32)


@pytest.fixture(scope="module", params=[300, 6890])
def case(request):
    V = request.param
    jm = jax_synthetic_smpl(num_vertices=V, seed=0)
    rng = np.random.RandomState(V)
    parents = np.asarray(jm.parents)
    Jr = np.asarray(jm.J_regressor) @ np.asarray(jm.v_template)
    t_l = np.broadcast_to(np.concatenate([Jr[:1], Jr[1:] - Jr[parents[1:]]]),
                          (B, 24, 3))

    def side(R):
        pf = (R[:, 1:] - np.eye(3, dtype=np.float32)).reshape(B, 207)
        Rg, tg = (np.asarray(a) for a in jax_fk_compose(
            jnp.asarray(R), jnp.asarray(t_l), PARENTS))
        t_rel = tg - np.einsum('bnij,nj->bni', Rg, Jr)
        return pf, np.concatenate([Rg, t_rel[..., None]], -1).reshape(
            B, 24, 12).astype(np.float32)

    pf_o, A_o = side(_rotations(rng, B))
    pf_r, A_r = side(_rotations(rng, B))
    A_r = A_r.reshape(B, 24, 3, 4)
    A_r[..., 3] += 10.0 * np.sign(rng.randn(B, 1, 3))
    A_r = A_r.reshape(B, 24, 12).astype(np.float32)
    vsh = np.ascontiguousarray(np.asarray(jm.v_template).T)
    c = dict(jm=jm, V=V, pf_o=pf_o, A_o=A_o, pf_r=pf_r, A_r=A_r, vsh=vsh)
    c["args"] = [torch.tensor(c[k]) for k in ("pf_o", "A_o", "vsh")] + [
        torch.tensor(np.asarray(jm.posedirs_t)),
        torch.tensor(np.asarray(jm.lbs_weights_t)),
        torch.tensor(pf_r), torch.tensor(A_r)]
    return c


def _check(total, grads, total_want, grads_want):
    np.testing.assert_allclose(float(total), float(total_want), rtol=1e-5)
    for name, got, want in zip(("gpf", "gA", "gvsh"), grads, grads_want):
        want = np.asarray(want)
        np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_split_matches_jax_kernel(case):
    """The emulated kernel against nemo_tpu's skin_v2v_l1: its total, and
    its orig-side gradients, which are minus those of the raw sign
    cotangent."""
    jm = case["jm"]
    f = lambda pf_o, A_o, vsh: jax_skin_v2v_l1(
        case["V"], pf_o, A_o, vsh, jm.pd_tiles, jm.w_tiles,
        jnp.asarray(case["pf_r"]), jnp.asarray(case["A_r"]))
    total_j, grads_j = jax.value_and_grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(case[k]) for k in ("pf_o", "A_o", "vsh")))
    total, grads = lbs.v2v_l1_split_emulation(*case["args"])
    _check(total, [-g for g in grads], total_j, grads_j)


def test_split_matches_plain(case):
    total, grads = lbs.v2v_l1_split_emulation(*case["args"])
    total_p, grads_p = lbs.v2v_l1_plain(*case["args"], grad=True)
    _check(total, grads, total_p, grads_p)


def test_split_error_against_float64(case):
    """The split's own error, against the plain version in f64: about 2e-7
    of the total and under 1e-6 of each gradient's largest entry at
    V=6890 (bounds 1e-6 and 5e-6 here), well inside the kernel's
    tolerances."""
    total, grads = lbs.v2v_l1_split_emulation(*case["args"])
    total_d, grads_d = lbs.v2v_l1_plain(*(a.double() for a in case["args"]),
                                        grad=True)
    assert abs(float(total) - float(total_d)) <= 1e-6 * abs(float(total_d))
    for got, want in zip(grads, grads_d):
        err = float((got.double() - want).abs().max())
        assert err <= 5e-6 * float(want.abs().max())


@pytest.mark.parametrize("num_sms", [1, 132])
def test_split_reduction_order_is_the_only_difference(case, num_sms):
    """With fewer ranges (one SM: two ranges) the same split arithmetic
    gives the same total and gradients up to the order of the partials."""
    total, grads = lbs.v2v_l1_split_emulation(*case["args"], num_sms=num_sms)
    total_1, grads_1 = lbs.v2v_l1_split_emulation(*case["args"],
                                                  num_sms=100000)
    _check(total, grads, total_1, grads_1)


def test_tf32_rounding():
    """Nearest TF32, ties away from zero: 10 mantissa bits kept, the low 13
    zero, and big + small within 2^-22 of x."""
    rng = np.random.RandomState(0)
    x = torch.tensor(np.concatenate([
        rng.randn(10000), 1e-6 * rng.randn(100), 1e6 * rng.randn(100),
        [0.0, 1.0, -1.0]]).astype(np.float32))
    big = lbs._tf32(x)
    assert not (big.view(torch.int32) & 0x1fff).any()
    assert bool(((big - x).abs() <= x.abs() * 2.0 ** -11).all())
    small = lbs._tf32(x - big)
    assert bool(((big + small - x).abs() <= x.abs() * 2.0 ** -21).all())
    # the halfway point between two TF32 values rounds away from zero
    half = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert lbs._tf32(half).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


@pytest.mark.parametrize("B_,V,want", [(512, 6890, 16), (960, 6890, 8),
                                       (1, 5, 1), (70, 1000, 63),
                                       (5000, 6890, 2)])
def test_fused_ranges(B_, V, want):
    """Two even waves at one block an SM on 132 SMs, no more ranges than
    16-vertex tiles."""
    assert lbs.fused_ranges(B_, V, 132) == want


@pytest.mark.parametrize("B_,V,want", [(1, 5, 1), (37, 300, 19),
                                       (70, 1000, 21), (512, 6890, 4),
                                       (960, 6890, 2), (3000, 6890, 2),
                                       (4224, 6890, 1), (28200, 6890, 2)])
def test_ws_ranges(B_, V, want):
    """K2's f32 kernel's ranges on 132 SMs (csrc/v2v.cu: ws_ranges): the
    fewest tile times, each wave its longest range plus 2, at least 2
    ranges allowed: the benchmark cell's 28200 rows (1763 batch tiles) get
    2 ranges of 216 and 215 tiles, 1.15 waves fewer than one range."""
    assert lbs.ws_ranges(B_, V, 132) == want
    n_bt, n_t = -(-B_ // lbs.WS_ROWS), -(-V // lbs.FUSED_VERTS)
    cap = min(max(2, 4 * 132 // n_bt), n_t)
    cost = lambda R: -(-(n_bt * R) // 132) * (-(-n_t // R) + 2)
    assert all(cost(want) <= cost(R) for R in range(1, cap + 1))


@pytest.mark.parametrize("B_,V", [(28200, 6890), (37, 300), (1, 5)])
def test_ws_blocks_cover_each_row_and_vertex_once(B_, V):
    """The emulation's blocks: 16-row batch tiles and ranges of whole
    16-vertex tiles, covering [0, B) and [0, V) once, in order."""
    rows, ranges = lbs._ws_blocks(B_, V, 132)
    assert rows[0][0] == 0 and rows[-1][1] == B_
    assert all(b1 - b0 == lbs.WS_ROWS for b0, b1 in rows[:-1])
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert ranges[0][0] == 0 and ranges[-1][1] == V
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo % lbs.FUSED_VERTS == 0 for lo, _ in ranges)
    if B_ == 28200:
        assert len(rows) == 1763 and ranges == [(0, 3440), (3440, 6890)]


def test_posed_halves_sum_the_two_feature_halves(case):
    """vp by feature half: each half's 3xTF32 product, added in order, then
    v_shaped; within 1e-6 of the whole-axis product (f32 sums of 207
    terms in another order)."""
    pf, vsh, pd = case["args"][0], case["args"][2], case["args"][3]
    V = vsh.shape[-1]
    halves = lbs._posed_halves(pf, pd, vsh)
    pd2 = pd.reshape(207, 3 * V)
    want = (lbs._mm_3xtf32(pf[:, :104], pd2[:104]) +
            lbs._mm_3xtf32(pf[:, 104:], pd2[104:]))
    assert torch.equal(halves, want.reshape(-1, 3, V) + vsh)
    whole = lbs._posed_3xtf32(pf, pd, vsh)
    assert float((halves - whole).abs().max()) <= \
        1e-6 * float(whole.abs().max())


@pytest.mark.parametrize("num_sms", [1, 132])
def test_split_across_batch_tiles_against_float64(num_sms):
    """40 rows: three 16-row batch tiles (the last ragged) and, on one SM,
    one range of every tile, on 132 SMs a range a tile: the emulation
    within 1e-6 of the total and 5e-6 of each gradient's largest entry of
    the plain version in f64, as at B = 8."""
    B_, V = 40, 300
    rng = np.random.RandomState(40)
    f = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32))
    W = torch.tensor(rng.rand(24, V).astype(np.float32))
    W = W / W.sum(0, keepdim=True)
    A_r = f(B_, 24, 12)
    A_r.view(B_, 24, 3, 4)[..., 3] += 10.0 * torch.sign(f(B_, 1, 3))
    args = (0.1 * f(B_, 207), f(B_, 24, 12), f(3, V), 0.01 * f(207, 3, V), W,
            0.1 * f(B_, 207), A_r)
    total, grads = lbs.v2v_l1_split_emulation(*args, num_sms=num_sms)
    total_d, grads_d = lbs.v2v_l1_plain(*(a.double() for a in args),
                                        grad=True)
    assert abs(float(total) - float(total_d)) <= 1e-6 * abs(float(total_d))
    for got, want in zip(grads, grads_d):
        err = float((got.double() - want).abs().max())
        assert err <= 5e-6 * float(want.abs().max())


@pytest.mark.parametrize("V,width", [(300, 304), (6890, 6896), (32, 32)])
def test_padded_posedirs(V, width):
    """The fused kernel's posedirs copy: rows padded with zeros to a
    multiple of 16 vertices, the table's values in front, a new tensor."""
    pd = torch.randn(207, 3, V)
    pad = lbs.padded_posedirs(pd)
    assert pad.shape == (207, 3, width) and pad.dtype == pd.dtype
    assert torch.equal(pad[..., :V], pd) and not pad[..., V:].any()
    assert pad.data_ptr() != pd.data_ptr()


@pytest.mark.parametrize("skin_dtype", [torch.float32, torch.bfloat16])
def test_smpl_model_holds_padded_posedirs(skin_dtype):
    """SMPLModel makes K2's padded copy once, at set-up, with f32 tables
    (none with bf16 ones, whose kernel reads posedirs_t), and .to() carries
    it."""
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    m = synthetic_smpl_model(300, seed=0, skin_dtype=skin_dtype)
    if skin_dtype == torch.bfloat16:
        assert m.posedirs_pad is None and m.to("cpu").posedirs_pad is None
        return
    assert torch.equal(m.posedirs_pad, lbs.padded_posedirs(m.posedirs_t))
    assert torch.equal(m.to("cpu").posedirs_pad, m.posedirs_pad)
