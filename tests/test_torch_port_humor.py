"""The port's HuMoR 3D fitting path against nemo_tpu's, on the CPU.

Covers K4's plain version (``ops.chamfer``) and its gradients, the HuMoR
model, the robust weighting, the init-state prior, the three-stage
``humor_motion_fit``, process-amass and the AMASS fitting observations, the
fitting evaluation, and the ``humor_tool`` CLI. Both sides get the same
numpy inputs (``np.random.default_rng``) at a small size: the 150-vertex
synthetic SMPL, ``latent_size`` 8, T 4-8, 48-64 points. On the JAX side the
chamfer runs its XLA reference (``_nn_one_way_xla``), the path the JAX
package's own tests take off the TPU. Each JAX reference is computed once,
in a module-scoped fixture. Tolerances are stated per test.
"""

import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.body.smpl import smpl_forward as jax_smpl_forward
from nemo_tpu.geometry import batch_rodrigues as jax_rodrigues
from nemo_tpu.models import humor as jhumor
from nemo_tpu.models import humor_fit as jfit
from nemo_tpu.models import humor_fit_eval as jeval
from nemo_tpu.ops import chamfer as jchamfer
from nemo_tpu.data import amass_process as jamass
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.data import amass_process as tamass
from nemo_tpu_torch.models import humor as thumor
from nemo_tpu_torch.models import humor_fit as tfit
from nemo_tpu_torch.models import humor_fit_eval as teval
from nemo_tpu_torch.ops import chamfer as tchamfer

torch.set_num_threads(1)
LATENT = 8
# distances: XLA's HIGHEST-precision matmul sums a.b in its own order, the
# port in the kernel's order (a0 b0 + a1 b1) + a2 b2
D_RTOL, D_ATOL = 1e-5, 1e-6


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# K4: nn_one_way / chamfer_distance (plain version) against the JAX XLA path
# ---------------------------------------------------------------------------

def _chamfer_case(name):
    """(a (T, N, 3), b (T, M, 3)) float32."""
    rng = np.random.default_rng(len(name))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    if name == "ragged":
        return f(3, 37, 3), f(3, 101, 3)
    if name == "one_point":
        return f(1, 1, 3), f(1, 1, 3)
    if name == "duplicates":
        # every candidate twice (k and k + 40) and some queries exactly on a
        # candidate: the lowest index must win each tie
        b = f(2, 40, 3)
        b = np.concatenate([b, b], axis=1)
        a = np.concatenate([f(2, 20, 3), b[:, 5:15]], axis=1)
        return a, b
    if name == "chunks":
        # M across _nn_one_way_xla's 1024-point chunk boundary
        return f(2, 9, 3), f(2, 1500, 3)
    if name == "scan_to_mesh":
        # the fit's direction: a scan near a body-sized vertex cloud
        b = 0.3 * f(4, 150, 3)
        return b[:, :64] + 0.01 * f(4, 64, 3), b
    raise KeyError(name)


CHAMFER_CASES = ("ragged", "one_point", "duplicates", "chunks",
                 "scan_to_mesh")


@pytest.fixture(scope="module")
def jax_nn():
    """JAX's (dist, idx) per case, frame by frame through vmap."""
    nn = jax.jit(jax.vmap(lambda a, b: jchamfer.nn_one_way(a, b,
                                                           use_pallas=False)))
    out = {}
    for name in CHAMFER_CASES:
        a, b = _chamfer_case(name)
        d, i = nn(jnp.asarray(a), jnp.asarray(b))
        out[name] = (np.asarray(d), np.asarray(i))
    return out


def _separated(a, b, d, rtol, atol):
    """Queries whose best and second-best distinct candidate positions are
    further apart than the distance tolerance (float64)."""
    d64 = ((a[:, :, None].astype(np.float64) - b[:, None]) ** 2).sum(-1)
    best = d64.argmin(-1)
    same = (b[np.arange(b.shape[0])[:, None, None], best[..., None]]
            == b[:, None]).all(-1)                    # (T, N, M)
    second = np.where(same, np.inf, d64).min(-1)
    return second - d64.min(-1) > atol + rtol * np.abs(d)


@pytest.mark.parametrize("name", CHAMFER_CASES)
def test_nn_one_way_plain_matches_jax(jax_nn, name):
    """Distances within rtol 1e-5 / atol 1e-6 of JAX; indices equal
    wherever the best and second-best candidate positions are further apart
    than that tolerance (0 queries are excluded in these cases: every query
    is separated, and exact ties only come from duplicated positions, where
    both sides must return the lowest index)."""
    a, b = _chamfer_case(name)
    d, i = tchamfer.nn_one_way(_t(a), _t(b))
    jd, ji = jax_nn[name]
    assert d.dtype == torch.float32 and i.dtype == torch.int64
    np.testing.assert_allclose(d.numpy(), jd, rtol=D_RTOL, atol=D_ATOL)
    sep = _separated(a, b, jd, D_RTOL, D_ATOL)
    assert sep.all(), f"{int((~sep).sum())} queries excluded"
    np.testing.assert_array_equal(i.numpy(), ji)
    # against float64 brute force: the lowest index among equal positions
    d64 = ((a[:, :, None].astype(np.float64) - b[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(i.numpy(), d64.argmin(-1))
    # one frame as 2-D inputs, and a small chunk: the same bits
    d0, i0 = tchamfer.nn_one_way(_t(a[0]), _t(b[0]))
    assert torch.equal(d0, d[0]) and torch.equal(i0, i[0])
    dc, ic = tchamfer.nn_one_way_plain(_t(a), _t(b), chunk=7)
    assert torch.equal(dc, d) and torch.equal(ic, i)


def test_nn_one_way_duplicates_take_lowest_index():
    a, b = _chamfer_case("duplicates")
    _, i = tchamfer.nn_one_way(_t(a), _t(b))
    assert (i.numpy() < 40).all()
    np.testing.assert_array_equal(i.numpy()[:, 20:], np.arange(5, 15)[None]
                                  .repeat(2, 0))


@pytest.mark.parametrize("name", ["ragged", "duplicates", "scan_to_mesh"])
def test_chamfer_distance_and_grad_match_jax(name):
    """Both directions and the gradient of chamfer_loss against jax.grad of
    the per-frame JAX op (vmapped): values rtol 1e-5 / atol 1e-6; gradients
    (sums of a few 2 (x - y) terms per point) atol 1e-5."""
    a, b = _chamfer_case(name)

    def jloss(x, y):
        d1, d2 = jax.vmap(jchamfer.chamfer_distance)(x, y)
        return d1.mean() + d2.mean()

    jd1, jd2 = jax.jit(jax.vmap(jchamfer.chamfer_distance))(jnp.asarray(a),
                                                            jnp.asarray(b))
    jga, jgb = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(a),
                                                        jnp.asarray(b))
    x, y = _t(a).requires_grad_(), _t(b).requires_grad_()
    d1, d2 = tchamfer.chamfer_distance(x, y)
    np.testing.assert_allclose(d1.detach().numpy(), np.asarray(jd1),
                               rtol=D_RTOL, atol=D_ATOL)
    np.testing.assert_allclose(d2.detach().numpy(), np.asarray(jd2),
                               rtol=D_RTOL, atol=D_ATOL)
    tchamfer.chamfer_loss(x, y).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jga), atol=1e-5)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(jgb), atol=1e-5)


def test_chamfer_loss_one_frame_matches_jax():
    """2-D inputs: the JAX op as it is, no vmap."""
    a, b = _chamfer_case("ragged")
    jl, jg = jax.jit(jax.value_and_grad(jchamfer.chamfer_loss))(
        jnp.asarray(a[1]), jnp.asarray(b[1]))
    x = _t(a[1]).requires_grad_()
    loss = tchamfer.chamfer_loss(x, _t(b[1]))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=1e-5)


def test_chamfer_distance_far_from_origin_stays_non_negative():
    """Scan points sub-millimetre from their matches, 3.5 m from the origin
    (a walking subject's trans): the search's expansion |x|^2 + |y|^2 -
    2 x.y cancels to a few ulp of |x|^2 (~2e-6) and goes negative, in the
    JAX package (its points3d loss is then NaN) as in nn_one_way;
    chamfer_distance returns the matched pairs' distances computed directly,
    within rtol 1e-5 of float64, and the port's points3d loss stays
    finite."""
    rng = np.random.default_rng(13)
    b = (np.array([3.5, 0.1, 1.0]) + 0.3 * rng.standard_normal((1, 200, 3))
         ).astype(np.float32)
    a = (b[:, :64] + 1e-4 * rng.standard_normal((1, 64, 3))).astype(
        np.float32)
    jd, _ = jax.vmap(jchamfer.chamfer_distance)(jnp.asarray(a),
                                                jnp.asarray(b))
    assert float(jd.min()) < -1e-12
    assert not np.isfinite(float(jfit.points3d_loss(a, b)))
    d_search, i = tchamfer.nn_one_way(_t(a), _t(b))
    assert float(d_search.min()) < -1e-12
    d, _ = tchamfer.chamfer_distance(_t(a), _t(b))
    want = ((a.astype(np.float64) - b[0, i.numpy()[0]]) ** 2).sum(-1)
    assert float(d.min()) >= 0.0
    np.testing.assert_allclose(d.numpy(), want, rtol=1e-5, atol=1e-10)
    v = _t(b).requires_grad_()
    loss = tfit.points3d_loss(_t(a), v)
    loss.backward()
    assert np.isfinite(float(loss.detach())) and torch.isfinite(v.grad).all()


@pytest.mark.parametrize("robust", ["bisquare", "none"])
def test_points3d_loss_and_grad_match_jax(robust):
    """points3d_loss (one-way chamfer -> sqrt -> bisquare weights on the
    detached residuals) and its gradient with respect to the vertices:
    value rtol 1e-5, gradient atol 1e-5 x its largest entry."""
    rng = np.random.default_rng(11)
    obs = rng.standard_normal((3, 48, 3)).astype(np.float32)
    verts = (0.8 * rng.standard_normal((3, 60, 3))).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda v: jfit.points3d_loss(jnp.asarray(obs), v, robust)))(
            jnp.asarray(verts))
    v = _t(verts).requires_grad_()
    loss = tfit.points3d_loss(_t(obs), v, robust)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    scale = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg),
                               atol=1e-5 * scale)


@pytest.mark.parametrize("n", [7, 8])
def test_robust_std_lower_median(n):
    """robust_std uses torch.median's lower middle order statistic on even
    counts, as nemo_tpu's: equal to JAX within 1e-6, and on an even count
    different from np.median's average."""
    rng = np.random.default_rng(n)
    res = np.abs(rng.standard_normal((3, n))).astype(np.float32)
    got = tfit.robust_std(_t(res)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfit.robust_std(
        jnp.asarray(res))), rtol=1e-6)
    srt = np.sort(res, axis=1)
    np.testing.assert_array_equal(
        tfit._lower_median(_t(res)).numpy()[:, 0], srt[:, (n - 1) // 2])
    w = tfit.bisquare_robust_weights(_t(res)).numpy()
    np.testing.assert_allclose(w, np.asarray(jfit.bisquare_robust_weights(
        jnp.asarray(res))), atol=1e-6)


# ---------------------------------------------------------------------------
# HuMoR model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def humor_pair():
    """JAX's init_humor parameters (latent 8, the reference widths) and the
    port's copy of them."""
    cfg = jhumor.HumorConfig(latent_size=LATENT)
    jp = jax.jit(jhumor.init_humor, static_argnums=1)(jax.random.PRNGKey(0),
                                                      cfg)
    tp = thumor.humor_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return cfg, thumor.HumorConfig(**dataclasses.asdict(cfg)), jp, tp


def _states(rng, B):
    """Plausible packed states: small rotations, metre-scale positions."""
    x = 0.05 * rng.standard_normal((B, jhumor.STATE_DIM))
    x[:, 6:9] = 0.4 * rng.standard_normal((B, 3))          # root_orient
    x[:, 12:75] = 0.2 * rng.standard_normal((B, 63))       # pose_body
    x[:, 75:141] = 0.5 * rng.standard_normal((B, 66))      # joints
    return x.astype(np.float32)


def test_humor_from_numpy_carries_every_array(humor_pair):
    _, _, jp, tp = humor_pair
    assert set(tp) == {"encoder", "decoder", "prior"}
    for m in jp:
        assert set(tp[m]) == set(jp[m])
        for k in jp[m]:
            assert tp[m][k].dtype == torch.float32
            np.testing.assert_array_equal(tp[m][k].numpy(),
                                          np.asarray(jp[m][k]))
    assert tp["prior"]["w0"].shape == (207, 1024)
    assert tp["decoder"]["w3"].shape == (512 + LATENT, 207 + 9)


def test_humor_prior_and_decode_match_jax(humor_pair):
    """The conditional prior and one decode step within rtol 1e-5 / atol
    1e-5 (1024-wide f32 matmuls in another summation order)."""
    jcfg, tcfg, jp, tp = humor_pair
    rng = np.random.default_rng(1)
    past = _states(rng, 5)
    z = rng.standard_normal((5, LATENT)).astype(np.float32)
    jm, jv = jax.jit(jhumor.humor_prior, static_argnums=1)(
        jp, jcfg, jnp.asarray(past))
    tm, tv = thumor.humor_prior(tp, tcfg, _t(past))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    jx, jc = jax.jit(jhumor.humor_decode, static_argnums=1)(
        jp, jcfg, jnp.asarray(z), jnp.asarray(past))
    tx, tc = thumor.humor_decode(tp, tcfg, _t(z), _t(past))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    nxt = _states(rng, 5)
    jqm, jqv = jax.jit(jhumor.humor_posterior, static_argnums=1)(
        jp, jcfg, jnp.asarray(past), jnp.asarray(nxt))
    tqm, tqv = thumor.humor_posterior(tp, tcfg, _t(past), _t(nxt))
    np.testing.assert_allclose(tqm.numpy(), np.asarray(jqm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tqv.numpy(), np.asarray(jqv), rtol=1e-5,
                               atol=1e-5)


def test_world2aligned_helpers_match_jax():
    """The heading-removal rotations from root orientations and from joints,
    and canonicalize_state: within 1e-5 (f32 trigonometry)."""
    rng = np.random.default_rng(12)
    x = _states(rng, 6)
    R = jax_rodrigues(jnp.asarray(x[:, 6:9]))
    joints = x[:, 75:141].reshape(6, 22, 3)
    for jfn, tfn, arg in (
            (jhumor.compute_world2aligned_mat,
             thumor.compute_world2aligned_mat, np.asarray(R)),
            (jhumor.compute_world2aligned_joints_mat,
             thumor.compute_world2aligned_joints_mat, joints)):
        np.testing.assert_allclose(tfn(_t(arg)).numpy(),
                                   np.asarray(jfn(jnp.asarray(arg))),
                                   atol=1e-5)
    for got, want in zip(thumor.canonicalize_state(_t(x)),
                         jhumor.canonicalize_state(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("canonicalize", [False, True])
def test_humor_roll_out_matches_jax(humor_pair, canonicalize):
    """A 4-step rollout from a given latent sequence, in the world frame
    or through the aligned-local frame: every output within rtol 1e-5 /
    atol 1e-5."""
    jcfg, tcfg, jp, tp = humor_pair
    rng = np.random.default_rng(2)
    x0 = _states(rng, 2)
    z = (0.5 * rng.standard_normal((2, 4, LATENT))).astype(np.float32)
    jo = jax.jit(jhumor.humor_roll_out, static_argnums=(1, 3),
                 static_argnames="canonicalize")(
        jp, jcfg, jnp.asarray(x0), 4, z_seq=jnp.asarray(z),
        canonicalize=canonicalize)
    to = thumor.humor_roll_out(tp, tcfg, _t(x0), 4, z_seq=_t(z),
                               canonicalize=canonicalize)
    assert set(to) == set(jo)
    for k in jo:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_convert_humor_state_dict_matches_jax():
    """A reference-layout state dict (Linear at 3k, GroupNorm at 3k-2,
    DataParallel prefix) converts to the same arrays as nemo_tpu's."""
    rng = np.random.default_rng(3)
    cfg = jhumor.HumorConfig(latent_size=LATENT)
    sd = {}
    for name, widths in (("encoder", [414, 16, 16, 16, 16, 16]),
                         ("decoder", [215, 16, 16, 16, 216]),
                         ("prior_net", [207, 16, 16, 16, 16, 16])):
        for k in range(len(widths) - 1):
            sd[f"module.{name}.net.{3 * k}.weight"] = rng.standard_normal(
                (widths[k + 1], widths[k])).astype(np.float32)
            sd[f"module.{name}.net.{3 * k}.bias"] = rng.standard_normal(
                widths[k + 1]).astype(np.float32)
            if k:
                sd[f"module.{name}.net.{3 * k - 2}.weight"] = \
                    rng.standard_normal(widths[k]).astype(np.float32)
                sd[f"module.{name}.net.{3 * k - 2}.bias"] = \
                    rng.standard_normal(widths[k]).astype(np.float32)
    jp = jhumor.convert_humor_state_dict(sd, cfg)
    tp = thumor.convert_humor_state_dict(sd, thumor.HumorConfig(LATENT))
    for m in jp:
        for k in jp[m]:
            np.testing.assert_array_equal(tp[m][k].numpy(),
                                          np.asarray(jp[m][k]))


# ---------------------------------------------------------------------------
# init-state prior
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prior_gmm_path(tmp_path_factory):
    """A synthetic prior_gmm.npz in train_state_prior's format: 3
    components over the 138-dim init state."""
    rng = np.random.default_rng(4)
    K, D = 3, 138
    A = 0.1 * rng.standard_normal((K, D, D))
    covs = np.einsum("kij,klj->kil", A, A) + 0.3 * np.eye(D)
    path = tmp_path_factory.mktemp("prior") / "prior_gmm.npz"
    np.savez(path, weights=rng.dirichlet(np.ones(K)),
             means=0.2 * rng.standard_normal((K, D)), covariances=covs)
    return str(path)


def test_init_state_gmm_nll_matches_jax(prior_gmm_path):
    """NLL and its gradient under the full-covariance GMM: rtol 1e-5 (a
    138-dim triangular solve and logsumexp in another order)."""
    rng = np.random.default_rng(5)
    state = (0.3 * rng.standard_normal(138)).astype(np.float32)
    jprior = jfit.load_init_motion_prior(prior_gmm_path)
    tprior = tfit.load_init_motion_prior(os.path.dirname(prior_gmm_path))
    for k in jprior:
        np.testing.assert_allclose(tprior[k].numpy(), np.asarray(jprior[k]),
                                   rtol=1e-6, err_msg=k)
    jl, jg = jax.jit(jax.value_and_grad(jfit.init_state_gmm_nll))(
        jnp.asarray(state), jprior)
    s = _t(state).requires_grad_()
    loss = tfit.init_state_gmm_nll(s, tprior)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5 * float(np.abs(jg).max()))


# ---------------------------------------------------------------------------
# the three-stage fit
# ---------------------------------------------------------------------------

FIT_T = 6
FIT_CFG = dict(steps_stage1=6, steps_stage2=8, steps_stage3=6, lr=1e-2,
               joints3d_weight=1.0, verts3d_weight=1.0, points3d_weight=1.0,
               joints3d_smooth_weight=0.1, joints3d_rollout_weight=1.0,
               shape_prior_weight=1.67e-4, motion_prior_weight=5e-4,
               init_motion_prior_weight=5e-4, joint_consistency_weight=1.0,
               bone_length_weight=10.0, contact_vel_weight=1.0,
               contact_height_weight=1.0, floor_reg_weight=0.1)


@pytest.fixture(scope="module")
def fit_problem(humor_pair, prior_gmm_path):
    """Observations of a true motion through the 150-vertex SMPL: joints
    (one occluded), 5 marker vertices, a 48-point noisy scan; JAX's fit
    from a perturbed initializer, computed once."""
    jcfg, _, jp, _ = humor_pair
    rng = np.random.default_rng(6)
    jm = jax_synthetic_smpl(num_vertices=150, seed=0)
    T = FIT_T
    pose = (0.2 * rng.standard_normal((T, 72))).astype(np.float32)
    trans = np.cumsum(0.01 * rng.standard_normal((T, 3)), 0).astype(
        np.float32)
    rot = jax_rodrigues(jnp.asarray(pose.reshape(T, 24, 3)))
    v, _, jf = jax_smpl_forward(jm, jnp.zeros((1, 10)), rot[:, 1:],
                                rot[:, :1], want_vertices=True,
                                transl=jnp.asarray(trans),
                                want_fk_joints=True)
    v = np.asarray(v)
    joints = np.asarray(jf[:, :22]).copy()
    joints[:, 10] = np.inf
    inds = np.array([3, 40, 77, 101, 140])
    pts = v[:, rng.choice(150, 48, replace=False)] + 0.005 * \
        rng.standard_normal((T, 48, 3))
    obs = {"joints3d": joints, "verts3d": v[:, inds],
           "points3d": pts.astype(np.float32)}
    init_pose = (pose + 0.1 * rng.standard_normal((T, 72))).astype(
        np.float32)
    init_pose[:, 3:] = 0.0
    cfg = jfit.MotionOptConfig(**FIT_CFG)
    jobs = {k: jnp.asarray(x) for k, x in obs.items()}
    jobs["verts3d_inds"] = inds
    out = jfit.humor_motion_fit(
        jm, jp, jcfg, None, jnp.asarray(init_pose), jnp.zeros(3),
        jnp.zeros(2), cfg=cfg,
        init_motion_prior=jfit.load_init_motion_prior(prior_gmm_path),
        obs3d=jobs)
    return dict(jm=jm, obs=obs, inds=inds, init_pose=init_pose,
                jout={k: np.asarray(x) for k, x in out.items()})


@pytest.fixture(scope="module")
def port_fit(fit_problem, humor_pair, prior_gmm_path):
    _, tcfg, _, tp = humor_pair
    obs = {k: _t(x) for k, x in fit_problem["obs"].items()}
    obs["verts3d_inds"] = fit_problem["inds"]
    out = tfit.humor_motion_fit(
        smpl_from_numpy(fit_problem["jm"]), tp, tcfg, None,
        _t(fit_problem["init_pose"]), cfg=tfit.MotionOptConfig(**FIT_CFG),
        init_motion_prior=tfit.load_init_motion_prior(prior_gmm_path),
        obs3d=obs)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_motion_fit_loss_history_matches_jax(fit_problem, port_fit, stage):
    """Per-stage loss histories (every 3D term, the init-state prior, the
    rollout, contacts and floor) within the trajectory tolerances of
    tests/test_reference_twin.py: rtol 1e-4 for the first 5 steps, 1e-3
    after."""
    key = f"stage{stage}_loss"
    got, want = port_fit[key], fit_problem["jout"][key]
    assert got.shape == want.shape == (FIT_CFG[f"steps_stage{stage}"],)
    np.testing.assert_allclose(got[:5], want[:5], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_motion_fit_outputs_match_jax(fit_problem, port_fit):
    """The fitted motion after 20 Adam steps: within 1e-3 of JAX (rtol;
    atol 1e-3 for entries near 0), and the same keys; stage 2's loss
    falls and stage 1's trans started at the scan's mean."""
    jout = fit_problem["jout"]
    assert set(port_fit) == set(jout)
    for k in ("pose", "trans", "betas", "z", "floor", "stage2_pose",
              "stage2_trans"):
        np.testing.assert_allclose(port_fit[k], jout[k], rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    assert port_fit["stage2_loss"][-1] < port_fit["stage2_loss"][0]


def test_motion_fit_refuses_unported_paths(humor_pair):
    _, tcfg, _, tp = humor_pair
    smpl = smpl_from_numpy(jax_synthetic_smpl(num_vertices=150, seed=0))
    pose = torch.zeros((4, 72))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfit.humor_motion_fit(smpl, tp, tcfg, torch.zeros((4, 25, 3)), pose)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfit.humor_motion_fit(smpl, tp, tcfg, None, pose,
                              cfg=tfit.MotionOptConfig(optimizer="lbfgs"))


# ---------------------------------------------------------------------------
# AMASS processing and fitting observations
# ---------------------------------------------------------------------------

def _raw_amass(T=150):
    """The JAX CLI test's synthetic raw sequence (tests/test_humor_tool_cli
    .py): a swaying, walking motion at 120 fps."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 4 * np.pi, T)[:, None]
    poses = np.zeros((T, 156))
    poses[:, :3] = 0.2 * np.stack(
        [np.sin(t[:, 0]), np.cos(t[:, 0]), 0 * t[:, 0]], 1)
    poses[:, 3:66] = 0.15 * np.sin(t + rng.uniform(0, np.pi, (1, 63)))
    trans = np.stack([0.3 * t[:, 0], 0.1 * np.sin(t[:, 0]), np.zeros(T)], 1)
    return dict(poses=poses, trans=trans, betas=rng.standard_normal(16) * 0.3,
                gender=np.array("neutral"), mocap_framerate=np.array(120.0))


@pytest.fixture(scope="module")
def amass_pair():
    """The 150-vertex SMPL on both sides and JAX's processed sequence."""
    jm = jax_synthetic_smpl(num_vertices=150, seed=0)
    jseq = jamass.process_amass_seq(_raw_amass(), jm)
    return jm, smpl_from_numpy(jm), jseq


def test_process_amass_seq_matches_jax(amass_pair):
    """Every field of the processed sequence: floats within atol 1e-5 (the
    SMPL forward's f32 tolerance, through finite differences at 120 fps
    for the velocities: atol 2e-3), contacts and scalars equal."""
    _, tm, jseq = amass_pair
    tseq = tamass.process_amass_seq(_raw_amass(), tm)
    assert set(tseq) == set(jseq)
    for k, v in jseq.items():
        if v is None:
            assert tseq[k] is None, k
        elif isinstance(v, str) or k in ("contacts", "fps"):
            np.testing.assert_array_equal(tseq[k], v, err_msg=k)
        else:
            atol = 2e-3 if k.endswith("vel") or "_vel_" in k else 1e-5
            np.testing.assert_allclose(tseq[k], v, atol=atol, err_msg=k)


@pytest.mark.parametrize("mode", ["clean", "noisy_partial"])
def test_amass_fit_observations_match_jax(amass_pair, mode):
    """Joints and marker observations equal bit for bit (copies of the
    sequence, plus the same seeded noise); the sampled scan points and the
    full-vertex GT within 1e-5 (the SMPL forward's float tolerance: the
    surface sampler draws the same faces and barycentrics)."""
    jm, tm, jseq = amass_pair
    kw = dict(seq_len=8, return_joints=True, return_verts=True,
              return_points=True, num_samp_pts=64, seed=3)
    if mode == "noisy_partial":
        kw.update(noise_std=0.01, make_partial=True, partial_height=0.3,
                  drop_middle=True, root_only=True)
    jobs, jgt = jamass.amass_fit_observations(jseq, jm, **kw)
    tobs, tgt = tamass.amass_fit_observations(jseq, tm, **kw)
    assert set(tobs) == set(jobs) == {"joints3d", "verts3d", "points3d"}
    assert set(tgt) == set(jgt)
    for k in ("joints3d", "verts3d"):
        np.testing.assert_array_equal(tobs[k], jobs[k], err_msg=k)
    np.testing.assert_allclose(tobs["points3d"], jobs["points3d"], atol=1e-5)
    assert tobs["points3d"].shape == (8, 64, 3)
    for k in jgt:
        np.testing.assert_allclose(tgt[k], jgt[k], atol=1e-5, err_msg=k)


def test_resize_points_matches_jax():
    from nemo_tpu.data.humor_rgb import resize_points
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    for n in (4, 10, 23):
        np.testing.assert_array_equal(
            tamass.resize_points(pts, n, np.random.default_rng(n)),
            resize_points(pts, n, np.random.default_rng(n)))


# ---------------------------------------------------------------------------
# fitting evaluation
# ---------------------------------------------------------------------------

def _numpy_bodies(trans, root_orient, pose_body, betas):
    """A deterministic stand-in for the SMPL forward (numpy): joints and a
    6890-vertex cloud that move with every input, so every metric of
    quant_eval_3d sees the fit's differences."""
    T = trans.shape[0]
    base = np.linspace(-1, 1, 6890 * 3).reshape(1, 6890, 3)
    verts = base * (1.0 + 0.1 * betas[:, :1, None]) + trans[:, None] + \
        0.1 * np.sin(root_orient.sum(-1))[:, None, None]
    joints = np.concatenate([verts[:, :66:3], pose_body[:, :6].reshape(
        T, 2, 3)], axis=1)
    return joints.astype(np.float32), verts.astype(np.float32)


def _write_results(root, save):
    rng = np.random.default_rng(7)
    T = 7
    for i in range(3):
        gt = {"trans": rng.standard_normal((T, 3)),
              "root_orient": 0.3 * rng.standard_normal((T, 3)),
              "pose_body": 0.2 * rng.standard_normal((T, 63)),
              "betas": 0.5 * rng.standard_normal(10),
              "contacts": (rng.random((T, 22)) > 0.5).astype(np.float32)}
        gt = {k: v.astype(np.float32) for k, v in gt.items()}
        pred = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(
            np.float32) for k, v in gt.items() if k != "contacts"}
        obs = {"joints3d": np.where(rng.random((T, 22, 1)) > 0.8, np.inf,
                                    rng.standard_normal((T, 22, 3)))
               .astype(np.float32)}
        save(os.path.join(root, f"seq_{i}"), pred, gt=gt, observations=obs,
             optim_bm="synthetic", gt_bm="synthetic")


def test_eval_fitting_results_dirs_matches_jax(tmp_path):
    """The same result directories through both evaluators: the same
    sequence names, the same CSV files, headers equal and every value
    within 1e-5."""
    root = str(tmp_path / "results")
    _write_results(root, teval.save_fitting_results)
    jdir, tdir = str(tmp_path / "jax_eval"), str(tmp_path / "port_eval")
    assert teval.eval_fitting_results_dirs(root, tdir, _numpy_bodies) == \
        jeval.eval_fitting_results_dirs(root, jdir, _numpy_bodies)
    files = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == files and len(files) == 9
    for name in files:
        with open(os.path.join(jdir, name)) as f:
            want = list(csv.reader(f))
        with open(os.path.join(tdir, name)) as f:
            got = list(csv.reader(f))
        assert len(got) == len(want) and got[0] == want[0], name
        for rg, rw in zip(got[1:], want[1:]):
            assert [x for x in rg if not _is_num(x)] == \
                [x for x in rw if not _is_num(x)], name
            np.testing.assert_allclose(
                [float(x) for x in rg if _is_num(x)],
                [float(x) for x in rw if _is_num(x)], rtol=1e-5, atol=1e-5,
                err_msg=name)
    # the results layer: what one side writes the other reads
    for name in ("stage3_results", "gt_results", "observations"):
        a = teval.load_fitting_results(os.path.join(root, "seq_0"), name)
        b = jeval.load_fitting_results(os.path.join(root, "seq_0"), name)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with open(os.path.join(root, "seq_0", "meta.txt")) as f:
        assert f.read() == "optim_bm synthetic\ngt_bm synthetic\n"


def _is_num(x):
    try:
        float(x)
        return True
    except ValueError:
        return False


def test_quant_eval_3d_matches_jax():
    """One sequence's metric dict, key by key, within 1e-6."""
    rng = np.random.default_rng(8)
    T = 9
    mk = lambda: {"joints3d": rng.standard_normal((T, 22, 3)),
                  "verts3d": rng.standard_normal((T, 43, 3)),
                  "mesh3d": rng.standard_normal((T, 100, 3)),
                  "contacts": (rng.random((T, 22)) > 0.5).astype(float)}
    pred, gt = mk(), mk()
    obs = {"verts3d": np.where(rng.random((T, 43, 1)) > 0.7, np.inf, 0.0)}
    got = teval.quant_eval_3d(pred, gt, obs)
    want = jeval.quant_eval_3d(pred, gt, obs)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_humor_tool_process_then_fit_amass_cpu(tmp_path):
    """process-amass -> fit-amass --device cpu with joints, verts and points
    observations at a small size: the result directory and the eval CSV
    family, finite stage-3 results."""
    from nemo_tpu_torch.cli.humor_tool import main
    raw = tmp_path / "raw" / "HumanEva" / "S1"
    raw.mkdir(parents=True)
    np.savez(raw / "walk_poses.npz", **_raw_amass())
    proc = str(tmp_path / "proc")
    assert main(["process-amass", "--amass_root", str(tmp_path / "raw"),
                 "--out", proc, "--datasets", "HumanEva",
                 "--device", "cpu"]) == 0
    out = str(tmp_path / "fit")
    assert main(["fit-amass", "--amass", proc, "--out", out,
                 "--seq_len", "8", "--obs", "joints", "verts", "points",
                 "--num_samp_pts", "64", "--latent_size", str(LATENT),
                 "--steps", "3", "4", "3", "--noise_std", "0.005",
                 "--device", "cpu"]) == 0
    res = os.listdir(os.path.join(out, "results_out"))
    assert len(res) == 1
    seq_dir = os.path.join(out, "results_out", res[0])
    for name in ("stage3_results.npz", "gt_results.npz", "observations.npz",
                 "meta.txt"):
        assert os.path.exists(os.path.join(seq_dir, name)), name
    with np.load(os.path.join(seq_dir, "observations.npz")) as d:
        assert d["points3d"].shape == (8, 64, 3)
        assert d["verts3d"].shape == (8, 43, 3)
    with np.load(os.path.join(seq_dir, "stage3_results.npz")) as d:
        assert d["pose_body"].shape == (8, 63)
        assert all(np.isfinite(d[k]).all() for k in d.files)
    csvs = sorted(os.listdir(os.path.join(out, "eval_out")))
    assert "stage3_results_per_seq_mean.csv" in csvs
    assert "stage3_results_agg_mean.csv" in csvs
    assert "compare_mean.csv" in csvs


@pytest.mark.parametrize("humor_file", ["humor.pth", "humor.npz"])
def test_humor_tool_from_files_matches_defaults(tmp_path, humor_file):
    """process-amass and fit-amass with --smpl_path (the synthetic body's
    .npz) and --humor_ckpt (init_humor's weights from --seed, as a torch
    checkpoint or humor_tool's flat .npz) give bit for bit the results of
    the runs on the synthetic body and the seeded random weights."""
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.cli.humor_tool import main
    from nemo_tpu_torch.utils import asset_files
    raw = tmp_path / "raw" / "HumanEva" / "S1"
    raw.mkdir(parents=True)
    np.savez(raw / "walk_poses.npz", **_raw_amass())
    smpl = asset_files.write_smpl_npz(
        str(tmp_path / "SMPL_NEUTRAL.npz"), asset_files.smpl_file_arrays(
            synthetic_smpl_model(device="cpu")))
    hp = thumor.init_humor(torch.Generator().manual_seed(0),
                           thumor.HumorConfig(latent_size=LATENT))
    write = asset_files.write_humor_ckpt if humor_file.endswith(".pth") \
        else asset_files.write_humor_npz
    ckpt = write(str(tmp_path / humor_file), hp)
    results = []
    for tag, files in (("default", []), ("files", ["--smpl_path", smpl])):
        proc, out = str(tmp_path / f"proc_{tag}"), str(tmp_path / tag)
        assert main(["process-amass", "--amass_root", str(tmp_path / "raw"),
                     "--out", proc, "--device", "cpu"] + files) == 0
        extra = files + (["--humor_ckpt", ckpt] if files else [])
        assert main(["fit-amass", "--amass", proc, "--out", out,
                     "--seq_len", "8", "--obs", "joints", "points",
                     "--num_samp_pts", "32", "--latent_size", str(LATENT),
                     "--steps", "2", "2", "2", "--no_eval",
                     "--device", "cpu"] + extra) == 0
        res = os.path.join(out, "results_out")
        with np.load(os.path.join(res, os.listdir(res)[0],
                                  "stage3_results.npz")) as d:
            results.append({k: d[k] for k in d.files})
    assert sorted(results[0]) == sorted(results[1])
    for k in results[0]:
        np.testing.assert_array_equal(results[1][k], results[0][k], k)


def test_humor_tool_defaults_to_the_card(tmp_path):
    """Without --device the CLI asks for CUDA: on a machine without a card
    it raises instead of running on the CPU."""
    from nemo_tpu_torch.cli.humor_tool import build_parser, main
    args = build_parser().parse_args(["fit-amass", "--amass", "x",
                                      "--out", "y"])
    assert args.device == "cuda" and args.steps == [30, 70, 70]
    assert args.seq_len == 60 and args.num_samp_pts == 512
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["process-amass", "--amass_root", str(tmp_path),
              "--out", str(tmp_path / "o")])
