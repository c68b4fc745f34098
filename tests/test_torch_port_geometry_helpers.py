"""The port's geometry helpers and experiment utilities against nemo_tpu's
on the CPU: apply_extrinsics and estimate_translation (geometry/camera.py),
euler_to_quat, euler_to_rotmat and rot6d_to_aa (geometry/rotations.py),
the torch similarity_transform, rigid_transform, apply_rigid_transform and
reconstruction_error (geometry/procrustes.py), and find_latest_ckpt
(utils/exp.py).

The inputs are those of tests/test_{camera,procrustes,rotations}.py
(np.random.RandomState(0), scipy's seeded rotations). An SVD's singular
vectors have arbitrary signs, so the Procrustes functions are compared by
what they produce: the aligned points, scales, rotations, translations
and errors. Tolerances: 1e-5 of each output's largest entry (1e-4 for
estimate_translation's 3x3 solve of squared focal-length terms, whose
normal equations have entries near f^2 = 2.5e7).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as sRot

import nemo_tpu.geometry as jgeo
import nemo_tpu.utils.exp as jexp
import nemo_tpu_torch.geometry as tgeo
import nemo_tpu_torch.utils as tutils


def _close(got, want, rtol, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def test_exports():
    """Every name nemo_tpu.geometry exports, the port's too."""
    assert sorted(tgeo.__all__) == sorted(jgeo.__all__)
    for name in tgeo.__all__:
        assert getattr(tgeo, name) is not None, name
    assert "find_latest_ckpt" in tutils.__all__


# ---------------------------------------------------------------------------
# camera


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_extrinsics(rng, inverse):
    pts = rng.randn(5, 7, 3).astype(np.float32)
    R = sRot.random(5, random_state=2).as_matrix().astype(np.float32)
    t = rng.randn(5, 3).astype(np.float32)
    want = jgeo.apply_extrinsics(_j(pts), _j(R), _j(t), inverse=inverse)
    got = tgeo.apply_extrinsics(_t(pts), _t(R), _t(t), inverse=inverse)
    _close(got, want, 1e-6, "points")
    back = tgeo.apply_extrinsics(got, _t(R), _t(t), inverse=not inverse)
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-5)


def _manual_project(S, t, f, c):
    p = S + t
    return f * p[:, :2] / p[:, 2:3] + c


@pytest.mark.parametrize("case", ["clean", "masked", "batch"])
def test_estimate_translation(rng, case):
    """test_camera.py's known translation, its confidence weighting (half
    the joints corrupted by 300 px at confidence 0) and a batch of 6 with
    graded confidences, one negative (clipped to 0)."""
    f, img = 5000.0, 224.0
    if case == "batch":
        S = rng.randn(6, 25, 3).astype(np.float32)
        t_true = np.stack([0.3 * rng.randn(6), 0.3 * rng.randn(6),
                           8.0 + rng.rand(6)], 1).astype(np.float32)
        j2d = np.stack([_manual_project(S[i], t_true[i], f, img / 2)
                        for i in range(6)]) + rng.randn(6, 25, 2)
        conf = rng.rand(6, 25).astype(np.float32)
        conf[0, 3] = -0.5
    else:
        S = rng.randn(1, 25, 3).astype(np.float32)
        t_true = np.array([[0.3, -0.2, 8.0]], np.float32)
        j2d = _manual_project(S[0], t_true[0], f, img / 2)[None]
        conf = np.ones((1, 25), np.float32)
        if case == "masked":
            j2d[0, ::2] += 300.0
            conf[0, ::2] = 0.0
    j2d = j2d.astype(np.float32)
    want = jgeo.estimate_translation(_j(S), _j(j2d), _j(conf),
                                     focal_length=f, img_size=img)
    got = tgeo.estimate_translation(_t(S), _t(j2d), _t(conf),
                                    focal_length=f, img_size=img)
    _close(got, want, 1e-4, "t")
    if case != "batch":
        np.testing.assert_allclose(got.numpy(), t_true, atol=1e-2)


# ---------------------------------------------------------------------------
# rotations


def test_euler(rng):
    e = rng.uniform(-1, 1, (16, 3)).astype(np.float32)
    _close(tgeo.euler_to_quat(_t(e)), jgeo.euler_to_quat(_j(e)), 1e-6,
           "quat")
    R = tgeo.euler_to_rotmat(_t(e))
    _close(R, jgeo.euler_to_rotmat(_j(e)), 1e-6, "rotmat")
    eye = torch.eye(3).expand(16, 3, 3)
    assert torch.allclose(R @ R.transpose(-1, -2), eye, atol=1e-5)


def test_rot6d_to_aa(rng):
    """Random 6D inputs, the identity's (axis-angle exactly 0) and its
    gradient there finite, as test_rotations.py asks of rotmat_to_aa."""
    x = rng.randn(64, 6).astype(np.float32)
    x[0] = [1, 0, 0, 1, 0, 0]
    got = tgeo.rot6d_to_aa(_t(x))
    _close(got, jgeo.rot6d_to_aa(_j(x)), 1e-5, "aa")
    assert torch.equal(got[0], torch.zeros(3))
    eps = torch.zeros(6, requires_grad=True)
    tgeo.rot6d_to_aa(torch.tensor([1., 0, 0, 1, 0, 0]) + eps).sum().backward()
    assert torch.isfinite(eps.grad).all()


# ---------------------------------------------------------------------------
# procrustes


def _similar(rng):
    S1 = rng.randn(4, 15, 3).astype(np.float32)
    R = sRot.random(4, random_state=1).as_matrix().astype(np.float32)
    s = rng.uniform(0.5, 2.0, (4, 1, 1)).astype(np.float32)
    t = rng.randn(4, 1, 3).astype(np.float32)
    return S1, (s * np.einsum('bij,bnj->bni', R, S1) + t).astype(np.float32)


@pytest.mark.parametrize("case", ["exact", "noisy", "mirror"])
def test_similarity_transform(rng, case):
    """test_procrustes.py's exact similarity, the same with noise, and its
    mirrored set (a proper rotation must come back): the aligned points,
    scale, R and t against JAX's and the float64 twin's."""
    S1, S2 = _similar(rng)
    if case == "noisy":
        S2 = (S2 + 0.05 * rng.randn(*S2.shape)).astype(np.float32)
    if case == "mirror":
        S1 = rng.randn(1, 10, 3).astype(np.float32)
        S2 = S1 * np.array([-1, 1, 1], np.float32)
    want = jgeo.similarity_transform(_j(S1), _j(S2))
    got = tgeo.similarity_transform(_t(S1), _t(S2))
    w64 = jgeo.similarity_transform_np(S1, S2)
    for g, w, x, what in zip((got[0],) + got[1], (want[0],) + want[1],
                             (w64[0],) + w64[1], ("S1_hat", "scale", "R",
                                                  "t")):
        _close(g, w, 1e-5, what)
        _close(g, x, 1e-5, what + " (f64)")
    assert (np.linalg.det(got[1][1].numpy()) > 0).all()


@pytest.mark.parametrize("case", ["exact", "random", "mirror"])
def test_rigid_transform(rng, case):
    A = rng.randn(3, 12, 3).astype(np.float32)
    if case == "exact":
        R = sRot.random(3, random_state=7).as_matrix().astype(np.float32)
        B = np.einsum('bij,bnj->bni', R, A) + rng.randn(3, 1, 3)
    elif case == "random":
        B = rng.randn(3, 12, 3)
    else:
        B = A * np.array([-1.0, 1.0, 1.0])
    B = B.astype(np.float32)
    jR, jt = jgeo.rigid_transform(_j(A), _j(B))
    tR, tt = tgeo.rigid_transform(_t(A), _t(B))
    _close(tR, jR, 1e-5, "R")
    _close(tt, jt, 1e-5, "t")
    for i in range(3):
        R64, t64 = jgeo.rigid_transform_np(A[i], B[i])
        _close(tR[i], R64, 1e-5, "R (f64)")
        _close(tt[i], t64, 1e-5, "t (f64)")
    assert (np.linalg.det(tR.numpy()) > 0).all()
    _close(tgeo.apply_rigid_transform(_t(A), tR, tt),
           jgeo.apply_rigid_transform(_j(A), jR, jt), 1e-5, "applied")


@pytest.mark.parametrize("pa", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", None])
def test_reconstruction_error(rng, pa, reduction):
    """Random sets and test_procrustes.py's similar pairs, every
    reduction, with and without alignment."""
    S1, S2 = _similar(rng)
    S3 = rng.randn(4, 15, 3).astype(np.float32)
    for a, b in ((S1, S2), (S1, S3)):
        want = jgeo.reconstruction_error(_j(a), _j(b), pa=pa,
                                         reduction=reduction)
        got = tgeo.reconstruction_error(_t(a), _t(b), pa=pa,
                                        reduction=reduction)
        w64 = jgeo.reconstruction_error_np(a, b, pa=pa, reduction=reduction)
        # an aligned exact pair's error is f32 rounding: held absolutely
        tol = 1e-5 * max(float(np.abs(w64).max()), 1.0)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= tol
        assert np.abs(got.numpy() - w64).max() <= tol


# ---------------------------------------------------------------------------
# utils/exp


def test_find_latest_ckpt(tmp_path):
    d = str(tmp_path / "ckpt")
    assert tutils.find_latest_ckpt(d) == jexp.find_latest_ckpt(d) == ""
    os.makedirs(d)
    assert tutils.find_latest_ckpt(d) == ""
    for n in ("sd_000010", "sd_000002", "sd_000100"):
        os.makedirs(os.path.join(d, n))
    assert tutils.find_latest_ckpt(d) == jexp.find_latest_ckpt(d) == \
        "sd_000100"
