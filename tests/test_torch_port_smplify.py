"""SMPLify and TemporalSMPLify against nemo_tpu on the CPU, and the port's
L-BFGS (fit/lbfgs.py) against optax.lbfgs.

* Every loss, the angle prior and their gradients: 1e-5 relative (float32
  sums in another order). The temporal body loss is also taken on a track
  with repeated frames, where the L1 smoothness terms tie and JAX's |x|
  has slope +1.
* L-BFGS: a convex quadratic-plus-quartic over three leaves, 20
  iterations, losses and parameters at 1e-5 relative; Rosenbrock from
  three starts, the first 10 iterations at 1e-5 and all 20 within 4x
  the spread of optax against itself started one float32 ulp away in
  each coordinate (the zoom linesearch branches on loss values, so on an
  ill-conditioned function a rounding difference changes the trajectory,
  in optax too);
  the failure branches (an unbounded linear function: 20 doublings and
  the best safe step; an infinite wall: the safe step) over 5
  iterations at 1e-5.
* temporal_smplify_fit / run_temporal_smplify on an 8-frame track with
  max_iter 3 (both stages' first iterations): losses, pose, betas,
  weak_cam at 1e-4 relative, the accept mask equal.
* smplify_fit: 4 Adam steps a stage at 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.priors import robustifiers as jrob
from nemo_tpu.priors import smplify as jsmplify
from nemo_tpu.priors import synthetic_gmm_prior as jax_gmm
from nemo_tpu.priors import temporal_smplify as jts
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.fit.lbfgs import lbfgs_run
from nemo_tpu_torch.priors import robustifiers as trob
from nemo_tpu_torch.priors import smplify as tsmplify
from nemo_tpu_torch.priors import temporal_smplify as tts
from nemo_tpu_torch.priors.gmm import synthetic_gmm_prior as torch_gmm

LOSS_RTOL = 1e-5
FIT_RTOL = 1e-4
B = 8


def _rel(got, want, rtol, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


@pytest.fixture(scope="module")
def bodies():
    jm = jax_synthetic_smpl(num_vertices=150, seed=0)
    return jm, smpl_from_numpy(jm), jax_gmm(), torch_gmm()


def _inputs(seed=0, repeat=False):
    rng = np.random.RandomState(seed)
    joints = (0.3 * rng.randn(B, 49, 3)).astype(np.float32)
    if repeat:          # frames 2-4 identical: the smoothness terms tie
        joints[3] = joints[2]
        joints[4] = joints[2]
    cam_t = np.stack([0.05 * rng.randn(B), 0.05 * rng.randn(B),
                      8.0 + rng.rand(B)], 1).astype(np.float32)
    j2d = (112 + 40 * rng.randn(B, 49, 2)).astype(np.float32)
    conf = (0.3 + 0.7 * rng.rand(B, 49)).astype(np.float32)
    conf[1, 27] = 0.0                    # one frame's OP torso invalid
    return {"body_pose": (0.2 * rng.randn(B, 69)).astype(np.float32),
            "betas": (0.3 * rng.randn(1, 10)).astype(np.float32),
            "joints": joints, "cam_t": cam_t,
            "cam_t_est": cam_t + 0.1, "center": np.full((B, 2), 112.0,
                                                          np.float32),
            "j2d": j2d, "conf": conf}


def _loss_cases(gj, gt):
    """name -> fn(inputs, pose, betas, joints, cam_t), for JAX and torch."""
    def mk(smp, ts, rob, gmm):
        def camera(fn):
            return lambda x, p, b, j, c: fn(j, c, x["cam_t_est"], x["center"],
                                            x["j2d"], x["conf"])

        def body(fn, **kw):
            return lambda x, p, b, j, c: fn(p, b, j, c, x["center"],
                                            x["j2d"], x["conf"], gmm,
                                            **kw).sum()

        return {"smplify_body": body(smp.smplify_body_fitting_loss),
                "smplify_camera": camera(smp.smplify_camera_fitting_loss),
                "temporal_camera": camera(ts.temporal_camera_fitting_loss),
                "temporal_body": body(ts.temporal_body_fitting_loss),
                "temporal_reprojection": body(ts.temporal_body_fitting_loss,
                                              output="reprojection"),
                "angle_prior": lambda x, p, b, j, c:
                    rob.angle_prior(p).sum()}
    return mk(jsmplify, jts, jrob, gj), mk(tsmplify, tts, trob, gt)


@pytest.mark.parametrize("repeat", [False, True])
def test_losses_and_gradients(bodies, repeat):
    _, _, gj, gt = bodies
    x = _inputs(repeat=repeat)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    jcases, tcases = _loss_cases(gj, gt)
    args = ("body_pose", "betas", "joints", "cam_t")
    for name in jcases:
        jval, jgrads = jax.jit(jax.value_and_grad(
            lambda *a: jcases[name](jx, *a), argnums=(0, 1, 2, 3)))(
            *(jx[k] for k in args))
        leaves = [tx[k].clone().requires_grad_(True) for k in args]
        tval = tcases[name](tx, *leaves)
        tgrads = torch.autograd.grad(tval, leaves, allow_unused=True)
        _rel(tval, jval, LOSS_RTOL, name)
        for k, g, w in zip(args, tgrads, jgrads):
            g = torch.zeros_like(tx[k]) if g is None else g
            _rel(g, w, LOSS_RTOL, f"{name} d/d{k}")
    per_frame = tts.temporal_body_fitting_loss(
        tx["body_pose"], tx["betas"], tx["joints"], tx["cam_t"],
        tx["center"], tx["j2d"], tx["conf"], gt, output="reprojection")
    assert per_frame.shape == (B, 49)
    assert tts.IGN_JOINTS == jts.IGN_JOINTS
    assert tsmplify._TORSO_OP == jsmplify._TORSO_OP
    assert tsmplify._TORSO_GT == jsmplify._TORSO_GT


# ---------------------------------------------------------------------------
# L-BFGS against optax.lbfgs
# ---------------------------------------------------------------------------

def _optax_run(f, n, p0):
    opt = optax.lbfgs()
    vg = optax.value_and_grad_from_state(f)

    def step(carry, _):
        p, state = carry
        loss, g = vg(p, state=state)
        upd, state = opt.update(g, state, p, value=loss, grad=g, value_fn=f)
        return (optax.apply_updates(p, upd), state), loss

    (p, _), losses = jax.lax.scan(step, (p0, opt.init(p0)), None, length=n)
    return p, losses


@functools.lru_cache(maxsize=None)
def _optax_jit(f, n):
    """One compiled optax run per (function, n): the Rosenbrock starts and
    their one-ulp neighbours share it."""
    return jax.jit(functools.partial(_optax_run, f, n))


def _both(fj, ft, p0, n):
    pj, lj = _optax_jit(fj, n)({k: jnp.asarray(v) for k, v in p0.items()})
    stats = {}
    pt, lt = lbfgs_run(ft, {k: torch.from_numpy(v) for k, v in p0.items()},
                       n, stats=stats)
    assert lt.shape == (n,) and stats["host_reads"] >= n
    return ({k: np.asarray(v) for k, v in pj.items()}, np.asarray(lj),
            {k: v.numpy() for k, v in pt.items()}, lt.numpy())


def test_lbfgs_convex():
    rng = np.random.RandomState(0)
    A = rng.randn(12, 12).astype(np.float32)
    Q = (A @ A.T / 12 + 0.1 * np.eye(12)).astype(np.float32)
    b = rng.randn(12).astype(np.float32)

    def fj(p):
        return (0.5 * p["x"] @ (jnp.asarray(Q) @ p["x"])
                - jnp.asarray(b) @ p["x"] + jnp.sum((p["y"] - 1.0) ** 4)
                + jnp.sum(p["a"] ** 2))

    def ft(p):
        return (0.5 * p["x"] @ (torch.from_numpy(Q) @ p["x"])
                - torch.from_numpy(b) @ p["x"]
                + torch.sum((p["y"] - 1.0) ** 4) + torch.sum(p["a"] ** 2))

    p0 = {"x": rng.randn(12).astype(np.float32),
          "y": rng.randn(3, 2).astype(np.float32),
          "a": rng.randn(2).astype(np.float32)}
    pj, lj, pt, lt = _both(fj, ft, p0, 20)
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
    # the parameters as one vector (a leaf at its minimum 0 has no scale
    # of its own)
    _rel(np.concatenate([pt[k].ravel() for k in sorted(pt)]),
         np.concatenate([pj[k].ravel() for k in sorted(pj)]), LOSS_RTOL,
         "parameters")


def _rosen_j(p):
    x = p["x"]
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _rosen_t(p):
    x = p["x"]
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


@pytest.mark.parametrize("x0", [(-1.2, 1.0), (0.5, -0.3), (-0.7, 0.9)])
def test_lbfgs_rosenbrock(x0):
    p0 = {"x": np.asarray(x0, np.float32)}
    pj, lj, pt, lt = _both(_rosen_j, _rosen_t, p0, 20)
    rel = np.abs(lt - lj) / np.abs(lj)
    assert rel[:10].max() <= LOSS_RTOL, rel
    # optax against itself from starts one ulp away, each coordinate
    # either way: the running largest relative spread of the losses
    run = _optax_jit(_rosen_j, 20)
    spread = np.zeros(20)
    for i in range(2):
        for to in (-10.0, 10.0):
            x = p0["x"].copy()
            x[i] = np.nextafter(x[i], np.float32(to))
            _, l2 = run({"x": jnp.asarray(x)})
            spread = np.maximum(spread, np.abs(np.asarray(l2) - lj)
                                / np.abs(lj))
    spread = np.maximum.accumulate(spread)
    assert (rel <= 4 * spread + LOSS_RTOL).all(), (rel, spread)


@pytest.mark.parametrize("case", ["unbounded", "wall"])
def test_lbfgs_failure_branches(case):
    if case == "unbounded":
        fj = lambda p: -0.5 * jnp.sum(p["x"])
        ft = lambda p: -0.5 * torch.sum(p["x"])
    else:
        fj = lambda p: jnp.sum((p["x"] - 2.0) ** 2) + jnp.where(
            jnp.max(p["x"]) > 0.7, jnp.inf, 0.0)
        ft = lambda p: torch.sum((p["x"] - 2.0) ** 2) + torch.where(
            torch.max(p["x"]) > 0.7, torch.inf, 0.0)
    p0 = {"x": np.asarray([-1.0, -0.5, 0.2], np.float32)}
    pj, lj, pt, lt = _both(fj, ft, p0, 5)
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
    _rel(pt["x"], pj["x"], LOSS_RTOL, "x")


# ---------------------------------------------------------------------------
# the fits
# ---------------------------------------------------------------------------

def _track(seed=1):
    rng = np.random.RandomState(seed)
    pose = (0.15 * rng.randn(B, 72)).astype(np.float32)
    betas = (0.3 * rng.randn(B, 10)).astype(np.float32)
    cam = np.stack([0.9 + 0.05 * rng.rand(B), 0.02 * rng.randn(B),
                    0.02 * rng.randn(B)], -1).astype(np.float32)
    j2d = np.concatenate([112 + 40 * rng.randn(B, 49, 2),
                          0.3 + 0.7 * rng.rand(B, 49, 1)],
                         -1).astype(np.float32)
    return pose, betas, cam, j2d


def test_run_temporal_smplify(bodies):
    jm, tm, gj, gt = bodies
    pose, betas, cam, j2d = _track()
    jout, jupd = jts.run_temporal_smplify(
        jm, gj, *map(jnp.asarray, (pose, betas, cam, j2d)), opt_steps=1,
        max_iter=3)
    stats = {}
    tout, tupd = tts.run_temporal_smplify(
        tm, gt, *map(torch.from_numpy, (pose, betas, cam, j2d)),
        opt_steps=1, max_iter=3, stats=stats)
    for k in ("losses", "pose", "betas", "cam_t", "weak_cam", "pre_loss",
              "new_loss", "reproj_loss", "verts", "joints"):
        _rel(tout[k], jout[k], FIT_RTOL, k)
    np.testing.assert_array_equal(tupd.numpy(), np.asarray(jupd))
    assert set(stats) == {"camera", "body"}
    assert all(s["host_reads"] == s["linesearch_steps"] >= 3
               for s in stats.values())


def test_smplify_fit(bodies):
    jm, tm, gj, gt = bodies
    rng = np.random.RandomState(2)
    pose = (0.2 * rng.randn(2, 72)).astype(np.float32)
    cam_t = np.array([[0.0, 0.2, 8.3], [0.1, 0.1, 8.0]], np.float32)
    center = np.full((2, 2), 112.0, np.float32)
    kp = np.concatenate([112 + 30 * rng.randn(2, 49, 2),
                         np.ones((2, 49, 1))], -1).astype(np.float32)
    betas = np.zeros((1, 10), np.float32)
    args = (pose, betas, cam_t, center, kp)
    jout = jsmplify.smplify_fit(jm, gj, *map(jnp.asarray, args),
                                num_iters=4)
    tout = tsmplify.smplify_fit(tm, gt, *map(torch.from_numpy, args),
                                num_iters=4)
    for k in ("pose", "betas", "cam_t", "loss"):
        _rel(tout[k], jout[k], LOSS_RTOL, k)
