"""The port's eval tables (eval/metrics.py) against nemo_tpu's (CPU).

The same numpy poses go through both packages' SMPL grids and tables. The
SMPL forwards differ only by f32 ordering noise (~1e-6 m on metre-scale
coordinates), so the millimetre tables agree to atol 1e-2 mm; the 2D tables
are float64 numpy on identical inputs on both sides and agree to rtol 1e-12.
Column names and their order must be identical, since they become the CSV
header.
"""

import numpy as np
import pytest
import torch

from nemo_tpu import eval as jeval
from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.eval import metrics as teval

torch.set_num_threads(1)
V, F = 2, 12


@pytest.fixture(scope="module")
def models():
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    return jm, smpl_from_numpy(jm)


@pytest.fixture(scope="module")
def poses():
    """GT poses that hold still for the first and last frames and move
    fast in between (so dynamic_only selects a strict sub-span, with no
    velocity near the 2 m/s threshold), and predictions/baselines near GT."""
    rng = np.random.RandomState(0)
    gt = np.repeat(0.3 * rng.randn(V, 1, 72), F, axis=1)
    gt[:, 4:8] += 0.8 * rng.randn(V, 4, 72)
    pred = gt[..., 3:] + 0.1 * rng.randn(V, F, 69)
    vibe = gt[..., 3:] + 0.2 * rng.randn(V, F, 69)
    trans = np.cumsum(0.05 * rng.randn(V, F, 3), axis=1)
    return {k: v.astype(np.float32) for k, v in
            dict(gt=gt, pred=pred, vibe=vibe, trans=trans).items()}


def _same_table(t, j, **tol):
    assert list(t) == list(j)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], err_msg=k, **tol)


def test_smpl_grid_forward(models, poses):
    jm, tm = models
    vj, jj = jeval.smpl_grid_forward(jm, poses["pred"].reshape(-1, 69))
    vt, jt = teval.smpl_grid_forward(tm, poses["pred"].reshape(-1, 69))
    # metre-scale coordinates after 8 chained rotations: ~1e-6 noise
    np.testing.assert_allclose(vt, vj, atol=2e-5)
    np.testing.assert_allclose(jt, jj, atol=2e-5)


@pytest.mark.parametrize("dynamic_only", [False, True])
def test_eval_3d(models, poses, dynamic_only):
    jm, tm = models
    fm = np.array([1.0, 2.0])
    args = (poses["pred"], poses["gt"], {"vibe": poses["vibe"]})
    kw = dict(dynamic_only=dynamic_only, framerate_multiplier=fm)
    _same_table(teval.eval_3d(tm, *args, **kw),
                jeval.eval_3d(jm, *args, **kw), rtol=0, atol=1e-2)
    if dynamic_only:
        _, j15 = teval.smpl_grid_forward(tm, poses["gt"][0, :, 3:])
        mask = teval.dynamic_frame_mask(j15[:, :15], fm[0])
        assert 0 < mask.sum() < F


def test_eval_2d(poses):
    rng = np.random.RandomState(1)
    gt = np.concatenate([100 * rng.rand(V, F, 25, 2),
                         rng.rand(V, F, 25, 1)], -1)
    pred = gt[..., :2] + 3 * rng.randn(V, F, 25, 2)
    op = gt + np.concatenate([3 * rng.randn(V, F, 25, 2),
                              np.zeros((V, F, 25, 1))], -1)
    bbox = 50 + 10 * rng.rand(V, F)
    _same_table(teval.eval_2d(pred, {"op": op}, gt, bbox),
                jeval.eval_2d(pred, {"op": op}, gt, bbox), rtol=1e-12)


def test_eval_3d_global_and_csv(models, poses, tmp_path):
    jm, tm = models
    pred_v, pred_j = [], []
    for v in range(V):
        vv, jj = teval.smpl_grid_forward(tm, poses["pred"][v])
        pred_v.append(vv + poses["trans"][v][:, None])
        pred_j.append(jj[:, :25] + poses["trans"][v][:, None])
    args = (np.stack(pred_j), np.stack(pred_v), poses["gt"], poses["trans"])
    t = teval.eval_3d_global(tm, *args)
    j = jeval.eval_3d_global(jm, *args)
    _same_table(t, j, rtol=0, atol=1e-2)
    teval.write_csv(t, str(tmp_path / "t.csv"))
    jeval.write_csv(j, str(tmp_path / "j.csv"))
    rows = [open(tmp_path / n).read().splitlines() for n in ("t.csv", "j.csv")]
    assert rows[0][0] == rows[1][0] == ",mpjpe-ours,mpvpe-ours"
    assert len(rows[0]) == len(rows[1]) == V + 1
