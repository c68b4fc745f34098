"""The port's composed figures against nemo_tpu's, on the CPU.

Both packages draw every mesh panel through their rasterizer: JAX's Pallas
kernel in interpret mode and the port's K5 plain version (each package's
``_resolve_method`` pointed at its rasterizer in the test only, as
tests/test_torch_port_render.py does). The returned grids agree within
1e-5, but for pixels whose face ids differ on ulp-level depth ties, at
most 0.1% of them (tests/test_torch_port_render.py's raster contract), and
the same files are written. The inputs: a 300-vertex synthetic
body on a 2-view, 6-frame synthetic problem at 48 x 64 with written PNG
frames, GT cameras and a GLAMR baseline (the GT motion perturbed).
gt_cameras_for_render is equal; the root-trajectory panels give the same
distances (1e-9) and PNG names, or, with matplotlib hidden, the named
skip; the per-joint frames have JAX's count and names and their decoded
pixels lie within one 8-bit level of JAX's.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nemo_tpu.ops.raster_pallas as jraster
from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.body.smpl import smpl_forward as jax_smpl_forward
from nemo_tpu.data import synthetic_problem as jax_synthetic_problem
from nemo_tpu.geometry.rotations import batch_rodrigues as jax_rodrigues
from nemo_tpu.render import figures as jfig
from nemo_tpu.render import keypoints as jkp
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.geometry.camera import camera_from_params_np
from nemo_tpu_torch.render import figures as tfig
from nemo_tpu_torch.render import keypoints as tkp
from nemo_tpu_torch.render import mesh as tmesh
from nemo_tpu_torch.render.video import _write_png

torch.set_num_threads(2)
HW = (48, 64)
V, F = 2, 6


@pytest.fixture(autouse=True)
def rasterizers(monkeypatch):
    monkeypatch.setattr(jraster, "raster_pallas_available", lambda: True)
    fn = jraster.rasterize_triangles_pallas
    monkeypatch.setattr(jraster, "rasterize_triangles_pallas",
                        lambda *a, **k: fn(*a, interpret=True, **k))
    monkeypatch.setattr(tmesh, "_resolve_method",
                        lambda method, device: "raster")


@pytest.fixture(scope="module")
def prob(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    bundle, truth = jax_synthetic_problem(jm, num_views=V, num_frames=F,
                                          img_hw=HW)
    rng = np.random.RandomState(7)
    paths = []
    for v in range(V):
        row = []
        for f in range(F):
            p = str(d / f"v{v}_{f:03d}.png")
            _write_png(p, rng.rand(*HW, 3).astype(np.float32))
            row.append(p)
        paths.append(row)
    gl_pose = bundle.gt3d_pose + 0.05 * rng.randn(
        *bundle.gt3d_pose.shape).astype(np.float32)
    bundle = dataclasses.replace(
        bundle, frame_paths=np.asarray(paths),
        glamr_orient=gl_pose[..., :3],
        glamr_trans=bundle.gt3d_trans + np.float32([0.3, 0.0, 0.1]),
        baseline_poses={"glamr": np.concatenate(
            [gl_pose[..., 3:], np.zeros((V, F, 3), np.float32)], -1)})
    rot = jax_rodrigues(jnp.asarray(truth["pose"][:F]).reshape(-1, 3))
    rot = rot.reshape(F, 24, 3, 3)
    verts, _ = jax_smpl_forward(jm, jnp.zeros((1, 10)), rot[:, 1:],
                                rot[:, :1], want_vertices=True)
    verts = np.asarray(verts)
    verts = np.stack([verts, verts + np.float32([0.05, 0.0, 0.0])])
    cams = [camera_from_params_np(bundle.gt_cameras[v], HW[0], HW[1], 150.0)
            for v in range(V)]
    return dict(jm=jm, tm=smpl_from_numpy(jm), bundle=bundle, verts=verts,
                cams=cams, faces=np.asarray(jm.faces))


def _pair(tmp_path, name, jcall, tcall):
    """Both packages' grids, written as j_<name> and t_<name>."""
    want = jcall(str(tmp_path / f"j_{name}"))
    got = tcall(str(tmp_path / f"t_{name}"))
    assert (tmp_path / f"t_{name}").is_file()
    return np.asarray(got), np.asarray(want)


def _close(got, want, covered=0.0, background=None):
    assert got.shape == want.shape and got.dtype == np.float32
    bad = np.abs(got - want).max(-1) > 1e-5
    assert bad.mean() <= 1e-3, bad.sum()
    if covered:
        bg = np.ones_like(got) if background is None else background
        assert (np.abs(got - bg).max(-1) > 1e-3).mean() > covered


def test_input_figure(prob, tmp_path):
    b = prob["bundle"]
    got, want = _pair(tmp_path, "in.png",
                      lambda p: jfig.render_input_figure(p, b, num_frames=3),
                      lambda p: tfig.render_input_figure(p, b, num_frames=3))
    _close(got, want)
    assert got.shape == (2 * HW[0], 3 * HW[1], 3)
    assert np.abs(got - 1).max() > 0.5                 # the frames, not white


def test_rollout_mv_figure(prob, tmp_path):
    a = (prob["verts"], prob["faces"], prob["cams"], prob["bundle"])
    got, want = _pair(
        tmp_path, "mv.png",
        lambda p: jfig.render_rollout_mv_figure(p, 1, *a, num_frames=3),
        lambda p: tfig.render_rollout_mv_figure(p, 1, *a, num_frames=3,
                                                device="cpu"))
    _close(got, want, covered=0.01)


@pytest.mark.parametrize("kw", [{}, {"frame_idxs": [0, 5], "color": [0.8,
                                                                     0.2,
                                                                     0.2]},
                                {"spread_people": False}])
def test_pretty_rollout_figure(prob, tmp_path, kw):
    a = (prob["verts"], prob["faces"], prob["cams"], prob["bundle"])
    got, want = _pair(
        tmp_path, "pretty.png",
        lambda p: jfig.render_pretty_rollout_figure(p, *a, num_frames=3,
                                                    **kw),
        lambda p: tfig.render_pretty_rollout_figure(p, *a, num_frames=3,
                                                    device="cpu", **kw))
    _close(got, want)
    assert got.shape == (2 * HW[0], HW[1], 3)
    assert (np.abs(got - 1).max(-1) > 1e-3).mean() > 0.3


def test_pretty_individual_figure(prob, tmp_path):
    verts = prob["verts"][0, :3]
    want = jfig.render_pretty_individual_figure(
        str(tmp_path / "j"), verts, prob["faces"], prob["cams"][0],
        prob["bundle"])
    got = tfig.render_pretty_individual_figure(
        str(tmp_path / "t"), verts, prob["faces"], prob["cams"][0],
        prob["bundle"], device="cpu")
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["0.png", "1.png", "2.png"]
    from PIL import Image
    for g, w in zip(got, want):
        a = np.asarray(Image.open(g)).astype(int)
        b = np.asarray(Image.open(w)).astype(int)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1


def test_3d_rollout_figure(prob, tmp_path):
    R0 = np.asarray(prob["cams"][0].rotation, np.float32)
    for init in (None, R0):
        a = (prob["verts"], prob["faces"], prob["bundle"])
        got, want = _pair(
            tmp_path, "3d.png",
            lambda p: jfig.render_3d_rollout_figure(
                p, *a, init_orient_rotmat=init, num_frames=3),
            lambda p: tfig.render_3d_rollout_figure(
                p, *a, init_orient_rotmat=init, num_frames=3,
                device="cpu"))
        _close(got, want, covered=0.01)
        assert got.shape == (2 * HW[0], 3 * HW[1], 3)


def test_gt_cameras_for_render_equal(prob):
    b = prob["bundle"]
    for focal in (5000.0, 80.0):
        want = jfig.gt_cameras_for_render(b.gt_cameras, b.img_hw, focal)
        got = tfig.gt_cameras_for_render(b.gt_cameras, b.img_hw, focal)
        assert len(got) == len(want) == V
        for g, w in zip(got, want):
            for field in ("rotation", "translation", "focal_length",
                          "center"):
                np.testing.assert_array_equal(np.asarray(getattr(g, field)),
                                              np.asarray(getattr(w, field)))
        np.testing.assert_array_equal(got[0].center, np.float32(HW))


@pytest.mark.parametrize("which", ["gt", "pred_in_gt", "glamr"])
def test_world_rollouts(prob, tmp_path, which):
    b, jm, tm = prob["bundle"], prob["jm"], prob["tm"]
    pred = prob["verts"][:, :, :] * np.float32(1.02) + np.float32(
        [0.1, -0.2, 0.3])
    calls = {
        "gt": (lambda p: jfig.render_gt_rollout(p, jm, b, num_frames=3,
                                                focal_length=80.0),
               lambda p: tfig.render_gt_rollout(p, tm, b, num_frames=3,
                                                focal_length=80.0,
                                                device="cpu")),
        "pred_in_gt": (
            lambda p: jfig.render_pred_in_gt_rollout(p, jm, pred, b,
                                                     num_frames=3,
                                                     focal_length=80.0),
            lambda p: tfig.render_pred_in_gt_rollout(p, tm, pred, b,
                                                     num_frames=3,
                                                     focal_length=80.0,
                                                     device="cpu")),
        "glamr": (lambda p: jfig.render_glamr_rollout(p, jm, b, num_frames=3,
                                                      focal_length=80.0),
                  lambda p: tfig.render_glamr_rollout(p, tm, b,
                                                      num_frames=3,
                                                      focal_length=80.0,
                                                      device="cpu")),
    }[which]
    got, want = _pair(tmp_path, f"{which}.png", *calls)
    _close(got, want)
    assert got.shape == (2 * HW[0], 3 * HW[1], 3)


def test_glamr_rollout_needs_its_slots(prob, tmp_path):
    b = dataclasses.replace(prob["bundle"], glamr_trans=None)
    for fn, m in ((jfig.render_glamr_rollout, prob["jm"]),
                  (tfig.render_glamr_rollout, prob["tm"])):
        with pytest.raises(ValueError, match="no GLAMR world baseline"):
            fn(str(tmp_path / "g.png"), m, b)


def test_root_trajectories(tmp_path):
    rng = np.random.RandomState(2)
    gt, pred, gl = (np.cumsum(rng.randn(20, 3), 0) for _ in range(3))
    for glamr in (gl, None):
        want = jfig.render_global_root_trajectories(str(tmp_path / "j"), gt,
                                                    pred, glamr)
        got = tfig.render_global_root_trajectories(str(tmp_path / "t"), gt,
                                                   pred, glamr)
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-9
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j")) == ["glamr.png", "gt.png",
                                               "pred.png"]


def test_root_trajectories_without_matplotlib(tmp_path, monkeypatch,
                                              capsys):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rng = np.random.RandomState(3)
    gt, pred = rng.randn(10, 3), rng.randn(10, 3)
    errs = tfig.render_global_root_trajectories(str(tmp_path / "t"), gt,
                                                pred)
    want = float(np.sqrt(((pred.astype(np.float64) - gt) ** 2).sum(-1))
                 .mean())
    assert errs == {"pred": want}
    out = capsys.readouterr().out
    for name in ("gt.png", "pred.png"):
        assert f"matplotlib is not installed: skipped " \
               f"{tmp_path / 't' / name}" in out
    assert not (tmp_path / "t").exists()


def test_per_joint_keypoint_frames(prob, tmp_path):
    b = prob["bundle"]
    pts = b.labels["gt"].copy()
    pts[0, :, 3, 2] = 0.2                       # one joint under threshold
    n_j = jkp.render_per_joint_keypoint_frames(str(tmp_path / "j"), pts, b,
                                               num_frames=2)
    n_t = tkp.render_per_joint_keypoint_frames(str(tmp_path / "t"), pts, b,
                                               num_frames=2)
    names = sorted(os.listdir(tmp_path / "j"))
    assert n_t == n_j == len(names) > 0
    assert sorted(os.listdir(tmp_path / "t")) == names
    from PIL import Image
    for name in names:
        a = np.asarray(Image.open(tmp_path / "t" / name))[..., :3]
        w = np.asarray(Image.open(tmp_path / "j" / name))[..., :3]
        assert a.shape == w.shape == HW + (3,)
        assert np.abs(a.astype(int) - w.astype(int)).max() <= 1, name
