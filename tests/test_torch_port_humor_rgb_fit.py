"""The port's HuMoR fit with the 2D keypoint term against nemo_tpu's, on
the CPU.

Both packages get the same numpy inputs at a small size: the 150-vertex
synthetic SMPL, HuMoR at latent 8 with JAX's ``init_humor`` weights, 6
frames, 6/6/4 Adam steps (STEPS says why stage 3 stops at 4), in three
cases: RGB at ``fit-rgb``'s
defaults, the same with ``optimize_camera``, and ``fit-prox --rgbd``'s
fit_proxd columns (kp2d 0.001, points3d 1.0, an observed floor). The
tolerances are the trajectory tests' (tests/test_torch_port_humor.py):
loss histories within rtol 1e-4 for the first 5 steps and 1e-3 after,
fitted arrays within rtol and atol 1e-3.

JAX's chamfer expands |x|^2 + |y|^2 - 2 x.y, which cancels (and its
points3d loss goes NaN through sqrt) for a point near its match a few
metres from the origin, where PROX scans lie (ROADMAP.md Queue 3). Where
points3d is on, JAX's ``chamfer_distance`` is replaced, in these tests
only, by one that takes JAX's own nearest neighbours and recomputes each
matched pair's distance directly, as the port does, with the same
gradient. The JAX package is not edited. The CLI is held against JAX's in
tests/test_torch_port_humor_rgb_cli.py.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nemo_tpu.ops.chamfer as jchamfer
from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.body.smpl import smpl_forward as jax_smpl_forward
from nemo_tpu.data.humor_rgb import DEFAULT_FOCAL_LEN, DEFAULT_GROUND
from nemo_tpu.geometry import batch_rodrigues as jax_rodrigues
from nemo_tpu.geometry.camera import perspective_projection as jax_project
from nemo_tpu.models import humor as jhumor
from nemo_tpu.models import humor_fit as jfit
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.models import humor as thumor
from nemo_tpu_torch.models import humor_fit as tfit

torch.set_num_threads(2)
LATENT = 8
T = 6
# stage 3 stops at 4 steps: at its 5th and 6th Adam updates the RGB fits
# part by up to 1.2e-3 between the port at one and at two CPU threads
# (f32 sums in another order, ~5e-8 after stage 2, amplified through the
# latents' near-zero gradients), as much as from JAX; after 4 they agree
# within 3e-5 and with JAX within 6% of the tolerance
STEPS = dict(steps_stage1=6, steps_stage2=6, steps_stage3=4)
CAM_T = np.float32([0.0, 0.0, 2.5])
CENTER = np.float32([960.0, 540.0])
FOCAL = DEFAULT_FOCAL_LEN[0]
# fit-prox's fit_proxd.cfg columns (nemo_tpu/cli/humor_tool.py cmd_fit_prox)
PROXD = dict(points3d_weight=1.0, kp2d_weight=0.001,
             joints3d_smooth_weight=100.0, shape_prior_weight=0.034,
             motion_prior_weight=0.075, init_motion_prior_weight=0.075,
             joint_consistency_weight=100.0, bone_length_weight=2000.0,
             contact_vel_weight=100.0, contact_height_weight=10.0,
             floor_reg_weight=1.0)
CASES = {"rgb": {}, "camera": dict(optimize_camera=True), "proxd": PROXD}


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _direct_chamfer(x1, x2):
    """JAX's chamfer_distance with each matched pair's distance computed
    directly: JAX's own neighbours, the same gradient as its VJP."""
    _, i1 = jchamfer.nn_one_way(x1, x2)
    _, i2 = jchamfer.nn_one_way(x2, x1)
    i1, i2 = jax.lax.stop_gradient(i1), jax.lax.stop_gradient(i2)
    return (((x1 - x2[i1]) ** 2).sum(-1), ((x2 - x1[i2]) ** 2).sum(-1))


@contextlib.contextmanager
def _jax_direct_chamfer():
    real = jchamfer.chamfer_distance
    jchamfer.chamfer_distance = _direct_chamfer
    try:
        yield
    finally:
        jchamfer.chamfer_distance = real


@pytest.fixture(scope="module")
def humor_pair():
    cfg = jhumor.HumorConfig(latent_size=LATENT)
    jp = jax.jit(jhumor.init_humor, static_argnums=1)(jax.random.PRNGKey(0),
                                                      cfg)
    tp = thumor.humor_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return cfg, thumor.HumorConfig(**dataclasses.asdict(cfg)), jp, tp


@pytest.fixture(scope="module")
def body():
    jm = jax_synthetic_smpl(num_vertices=150, seed=0)
    return jm, smpl_from_numpy(jm)


def _motion(jm, rng, T):
    """A true motion's (T, 25) joints and (T, V) vertices."""
    pose = (0.2 * rng.standard_normal((T, 72))).astype(np.float32)
    pose[:, :3] = [np.pi, 0.0, 0.0]            # upright in the camera frame
    trans = np.cumsum(0.01 * rng.standard_normal((T, 3)), 0).astype(
        np.float32)
    rot = jax_rodrigues(jnp.asarray(pose.reshape(T, 24, 3)))
    v, j = jax_smpl_forward(jm, jnp.zeros((1, 10)), rot[:, 1:], rot[:, :1],
                            want_vertices=True, transl=jnp.asarray(trans))
    return np.asarray(j[:, :25]), np.asarray(v)


def _keypoints(j25, rng):
    """OpenPose keypoints of the joints through the fit's camera: 2 px of
    noise, confidences in (0.5, 1), a few zero."""
    B = j25.shape[0]
    uv = np.asarray(jax_project(
        jnp.asarray(j25), jnp.broadcast_to(jnp.eye(3), (B, 3, 3)),
        jnp.broadcast_to(jnp.asarray(CAM_T), (B, 3)), FOCAL,
        jnp.broadcast_to(jnp.asarray(CENTER), (B, 2))))
    kp = np.concatenate([uv + 2.0 * rng.standard_normal(uv.shape),
                         0.5 + 0.5 * rng.random(uv.shape[:2] + (1,))], -1)
    kp[rng.random(kp.shape[:2]) < 0.1, 2] = 0.0
    return kp.astype(np.float32)


@pytest.fixture(scope="module", params=list(CASES))
def fit_case(request, humor_pair, body):
    """One case's inputs and JAX's fit, computed once: RGB at fit-rgb's
    defaults, the same with optimize_camera, and fit_proxd's columns with a
    48-point scan about 2 m from the origin and an observed floor."""
    jcfg, _, jp, _ = humor_pair
    jm, _ = body
    rng = np.random.default_rng(20)
    j25, v = _motion(jm, rng, T)
    kp = _keypoints(j25, rng)
    cfg = dict(STEPS, **CASES[request.param])
    obs = {"floor_plane": DEFAULT_GROUND.astype(np.float32)}
    if request.param == "proxd":
        pts = v[:, rng.choice(v.shape[1], 48, replace=False)]
        obs["points3d"] = (pts + [0.3, -0.2, 2.0] + 0.005 *
                           rng.standard_normal(pts.shape)).astype(np.float32)
        obs["floor_plane"] = np.float32([0.02, -0.97, 0.1, -1.1])
    with _jax_direct_chamfer():
        out = jfit.humor_motion_fit(
            jm, jp, jcfg, jnp.asarray(kp), jnp.zeros((T, 72)),
            jnp.asarray(CAM_T), jnp.asarray(CENTER), focal_length=FOCAL,
            cfg=jfit.MotionOptConfig(**cfg),
            obs3d={k: jnp.asarray(x) for k, x in obs.items()})
    return dict(name=request.param, kp=kp, cfg=cfg, obs=obs,
                jout={k: np.asarray(x) for k, x in out.items()})


@pytest.fixture(scope="module")
def port_fit(fit_case, humor_pair, body):
    _, tcfg, _, tp = humor_pair
    out = tfit.humor_motion_fit(
        body[1], tp, tcfg, _t(fit_case["kp"]), torch.zeros((T, 72)),
        _t(CAM_T), _t(CENTER), focal_length=FOCAL,
        cfg=tfit.MotionOptConfig(**fit_case["cfg"]),
        obs3d={k: _t(x) for k, x in fit_case["obs"].items()})
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_kp2d_fit_loss_history_matches_jax(fit_case, port_fit, stage):
    """Each stage's loss history within rtol 1e-4 for the first 5 steps and
    1e-3 after, in the RGB, optimize_camera and fit_proxd cases."""
    key = f"stage{stage}_loss"
    got, want = port_fit[key], fit_case["jout"][key]
    assert got.shape == want.shape == (STEPS[f"steps_stage{stage}"],)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got[:5], want[:5], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_kp2d_fit_outputs_match_jax(fit_case, port_fit):
    """The fitted motion, latents, floor and (optimize_camera) camera
    within rtol and atol 1e-3 of JAX's, with the same keys."""
    jout = fit_case["jout"]
    assert set(port_fit) == set(jout)
    assert ("cam_R" in jout) == (fit_case["name"] == "camera")
    for k in jout:
        np.testing.assert_allclose(port_fit[k], jout[k], rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    assert port_fit["stage1_loss"][-1] < port_fit["stage1_loss"][0]
