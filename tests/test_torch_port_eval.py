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


@pytest.mark.parametrize("V_,num_views,view_idxs", [
    (4, -1, ()), (4, 2, ()), (4, 9, ()), (4, 0, ()), (4, -1, (3, 1)),
    (4, 2, (0,))])
def test_eval_view_indices(V_, num_views, view_idxs):
    got = teval.eval_view_indices(V_, num_views, view_idxs)
    want = jeval.metrics.eval_view_indices(V_, num_views, view_idxs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# (num_frames, num_views, view_idxs, pa, dynamic_only)
SUBSAMPLING = [(5, -1, (), True, False), (-1, 1, (), False, False),
               (7, -1, (1,), True, True), (20, 2, (1, 0), False, True)]


def _rel_table(t, j, rtol=5e-5):
    """Equal columns in order, each value within rtol relative (atol 1e-3
    mm for PA values near 0)."""
    _same_table(t, j, rtol=rtol, atol=1e-3)


@pytest.mark.parametrize("num_frames,num_views,view_idxs,pa,dynamic_only",
                         SUBSAMPLING)
def test_eval_3d_subsampling(models, poses, num_frames, num_views, view_idxs,
                             pa, dynamic_only):
    """eval_3d's frame and view subsampling and pa=False; baseline_masks is
    taken and unused on both sides."""
    jm, tm = models
    args = (poses["pred"], poses["gt"], {"vibe": poses["vibe"]})
    kw = dict(baseline_masks={"vibe": np.ones((V, F))}, pa=pa,
              num_frames=num_frames, num_views=num_views,
              view_idxs=view_idxs, dynamic_only=dynamic_only,
              framerate_multiplier=np.array([1.0, 2.0]))
    t = teval.eval_3d(tm, *args, **kw)
    _rel_table(t, jeval.eval_3d(jm, *args, **kw))
    assert any(k.startswith("pa_mpjpe") for k in t) == pa
    n = len(view_idxs) if view_idxs else (V if num_views <= 0
                                          else min(V, num_views))
    assert all(len(c) == n for c in t.values())


def test_eval_3d_pa(models, poses):
    jm, tm = models
    t = teval.eval_3d_pa(tm, poses["pred"], poses["gt"])
    _rel_table(t, jeval.eval_3d_pa(jm, poses["pred"], poses["gt"]))
    full = teval.eval_3d(tm, poses["pred"], poses["gt"])
    np.testing.assert_allclose(t["pa_mpjpe-ours"], full["pa_mpjpe-ours"],
                               rtol=5e-5)


@pytest.mark.parametrize("num_frames,num_views,view_idxs", [
    (-1, -1, ()), (5, -1, ()), (-1, 1, ()), (7, -1, (1, 0))])
def test_eval_3d_global_glamr(models, poses, num_frames, num_views,
                              view_idxs):
    """The GLAMR world baseline's columns and its aligned root track
    ('glamr-t'), under frame and view subsampling: every column and every
    aligned track as nemo_tpu's."""
    jm, tm = models
    rng = np.random.RandomState(5)
    pred_v, pred_j = [], []
    for v in range(V):
        vv, jj = teval.smpl_grid_forward(tm, poses["pred"][v])
        pred_v.append(vv + poses["trans"][v][:, None])
        pred_j.append(jj[:, :25] + poses["trans"][v][:, None])
    glamr_pose = np.concatenate(
        [0.2 * rng.randn(V, F, 3), poses["vibe"]], -1).astype(np.float32)
    glamr_trans = (poses["trans"] + 0.1 * rng.randn(V, F, 3)).astype(
        np.float32)
    args = (np.stack(pred_j), np.stack(pred_v), poses["gt"], poses["trans"])
    kw = dict(glamr_pose=glamr_pose, glamr_trans=glamr_trans,
              pred_trans=poses["trans"], want_aligned=True,
              num_frames=num_frames, num_views=num_views,
              view_idxs=view_idxs)
    t, ta = teval.eval_3d_global(tm, *args, **kw)
    j, ja = jeval.eval_3d_global(jm, *args, **kw)
    assert list(t) == ["mpjpe-ours", "mpvpe-ours", "mpjpe-glamr",
                       "mpvpe-glamr"]
    _rel_table(t, j)
    assert sorted(ta) == sorted(ja) == ["glamr-t", "gt-t", "pred-t"]
    for k in ja:
        assert ta[k].shape == ja[k].shape, k
        np.testing.assert_allclose(ta[k], ja[k], rtol=5e-5, atol=1e-6,
                                   err_msg=k)
