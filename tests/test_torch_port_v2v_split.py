"""The fused K2 kernel's arithmetic on the CPU, before any card sees it.

``lbs.v2v_l1_split_emulation`` repeats what csrc/v2v.cu's one-pass kernel
computes: both posedirs contractions as three TF32 products (x = big +
small, each rounded to the nearest TF32 by masking mantissa bits) and the
per-block partials summed in the kernel's fixed order. It is held against
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
