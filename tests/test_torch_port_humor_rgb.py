"""The port's HuMoR RGB / PROX data layer, 2D term, fitting frame and RGB
evaluation against nemo_tpu's, on the CPU.

The same inputs, made from numpy seeds, go through both packages:
``data/humor_rgb.py`` on small OpenPose, PlaneRCNN and PROX trees written by
``nemo_tpu_torch.utils.raw_layout`` (every array equal bit for bit: both
sides run the same numpy on the same inputs), the image readers (the
port's PIL reader against ``plt.imread``, value for value, for 8-bit L,
RGB and RGBA masks, JPEGs and every 16-bit depth value), the reprojection
term (value and gradient within rtol 1e-5; gradients at atol 1e-5 of
their largest entry), the camera->prior family (within 1e-5, both
directions of ``apply_cam2prior``), ``quant_eval_2d`` (every key within
1e-6), ``stitch_rgb_results`` (every written array within 1e-6, the
_prior file within 1e-5) and ``eval_fitting_results_dirs`` with the
per-stage files (the CSVs within 1e-5). The fits and the CLI are in
tests/test_torch_port_humor_rgb_fit.py.
"""

import csv
import os

import jax
import jax.numpy as jnp
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch
from PIL import Image

from nemo_tpu.data import humor_rgb as jrgb
from nemo_tpu.models import humor_fit as jfit
from nemo_tpu.models import humor_fit_eval as jeval
from nemo_tpu.render import video as jvideo
from nemo_tpu_torch.data import humor_rgb as trgb
from nemo_tpu_torch.data import images
from nemo_tpu_torch.models import humor_fit as tfit
from nemo_tpu_torch.models import humor_fit_eval as teval
from nemo_tpu_torch.render import video as tvideo
from nemo_tpu_torch.utils import raw_layout as rl

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _equal(got, want):
    """Nested dicts / lists / arrays equal bit for bit (NaN where NaN)."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)) and not (
            want and isinstance(want[0], (int, float, np.number))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, str):
        assert got == want
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# image readers: PIL against plt.imread
# ---------------------------------------------------------------------------

def _mask_images(tmp_path):
    rng = np.random.default_rng(0)
    a = (rng.random((23, 31)) < 0.5).astype(np.uint8) * 255
    a[0, :4] = [0, 1, 127, 254]
    rgb = rng.integers(0, 256, (23, 31, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (23, 31, 4), dtype=np.uint8)
    paths = {}
    for name, arr in (("l.png", a), ("rgb.png", rgb), ("rgba.png", rgba),
                      ("l.jpg", a), ("rgb.jpg", rgb)):
        paths[name] = str(tmp_path / name)
        Image.fromarray(arr).save(paths[name])
    return paths


def _jax_mask(p):
    """The JAX readers' mask conversion of plt.imread (humor_rgb.py,
    cli/humor_tool.py fit-prox)."""
    img = plt.imread(p)
    if img.ndim == 3:
        img = img[..., 0]
    return (img * 255).astype(np.uint8) if img.dtype != np.uint8 else img


def test_imread_matches_matplotlib(tmp_path):
    """images.imread gives plt.imread's array (dtype, shape, values) for
    8-bit L, RGB and RGBA PNGs and L and RGB JPEGs; read_mask the JAX
    readers' uint8 mask."""
    for name, p in _mask_images(tmp_path).items():
        _equal(images.imread(p), plt.imread(p))
        _equal(images.read_mask(p), _jax_mask(p))
        if name == "l.png":   # an 8-bit mask reads back its stored bytes
            _equal(images.read_mask(p), np.asarray(Image.open(p)))


def test_read_depth_matches_matplotlib_for_every_value(tmp_path):
    """All 65536 16-bit values: read_depth equals the JAX depth reader's
    plt.imread(p) * 65535.0, and both give the stored integer."""
    vals = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    p = str(tmp_path / "depth.png")
    Image.fromarray(vals).save(p)
    want = plt.imread(p)
    want = want * 65535.0 if want.max() <= 1.0 else want
    got = images.read_depth(p)
    _equal(got, want)
    np.testing.assert_array_equal(got, vals.astype(np.float32))


def test_load_frame_matches_jax(tmp_path):
    """render/video._load_frame (PIL) against the JAX package's
    (matplotlib) for a PNG and a JPEG frame, cropped and padded."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    for name in ("f.png", "f.jpg"):
        p = str(tmp_path / name)
        Image.fromarray(img).save(p)
        for hw in ((20, 30), (16, 40)):
            _equal(tvideo._load_frame(p, hw), jvideo._load_frame(p, hw))
    assert tvideo._load_frame(str(tmp_path / "missing.png"), (4, 4)) is None


# ---------------------------------------------------------------------------
# keypoints, masks, PlaneRCNN, the RGB video walk
# ---------------------------------------------------------------------------

def _video(tmp_path, F=11, H=48, W=64, seed=2):
    """An OpenPose directory of F frames (frames 3 and 7 empty), the
    frames as JPEGs, person masks, and a PlaneRCNN result dir."""
    rng = np.random.default_rng(seed)
    kp = np.zeros((F, 25, 3), np.float32)
    kp[..., 0] = W * rng.random((F, 25))
    kp[..., 1] = H * rng.random((F, 25))
    kp[..., 2] = rng.random((F, 25))
    kp_dir = rl.write_video_keypoints(str(tmp_path / "vid"), kp,
                                      empty=(3, 7),
                                      frames_dir=str(tmp_path / "frames"),
                                      frame_hw=(H, W))
    mask_dir = tmp_path / "masks"
    mask_dir.mkdir()
    for f in range(F):
        m = (rng.random((H, W)) < 0.4).astype(np.uint8) * 255
        Image.fromarray(m).save(mask_dir / f"{f:06d}.png")
    planes = tmp_path / "planes"
    planes.mkdir()
    params = np.stack([np.array([2.0, 0.3, 0.1]),
                       np.array([0.05, 0.1, -1.4]), rng.standard_normal(3)])
    pm = np.zeros((3, 16, 20), np.uint8)
    pm[0, -10:, :] = 1
    pm[1, -10:, :12] = 1
    np.save(planes / "000_plane_parameters_0.npy", params)
    np.save(planes / "000_plane_masks_0.npy", pm)
    return kp_dir, str(tmp_path / "frames"), str(mask_dir), str(planes)


def test_keypoints_masks_and_planes_match_jax(tmp_path):
    kp_dir, _, mask_dir, planes = _video(tmp_path)
    files = sorted(os.listdir(kp_dir))
    for f in files[:4]:
        _equal(trgb.read_keypoints(os.path.join(kp_dir, f)),
               jrgb.read_keypoints(os.path.join(kp_dir, f)))
    _equal(trgb.load_planercnn_res(planes), jrgb.load_planercnn_res(planes))
    rng = np.random.default_rng(3)
    j = (rng.random((4, 25, 3)) * [70, 50, 1]).astype(np.float32)
    masks = [(rng.random((48, 64)) < 0.5).astype(np.uint8)
             for _ in range(4)]
    _equal(trgb.mask_joints2d(j, masks), jrgb.mask_joints2d(j, masks))
    big = [(rng.random((1080, 1920)) < 0.5).astype(np.uint8)
           for _ in range(4)]
    j[..., :2] *= 20
    _equal(trgb.mask_joints2d(j, big, 1920, 1080),
           jrgb.mask_joints2d(j, big, 1920, 1080))
    for args in ((25, 10, 3), (40, 12, 2), (30, 10, 5), (110, 60, 10)):
        _equal(trgb.split_overlapping_intervals(*args),
               jrgb.split_overlapping_intervals(*args))


@pytest.mark.parametrize("mode", ["whole", "split", "masked"])
def test_rgb_video_observations_match_jax(tmp_path, mode):
    """load_rgb_video_observations on the same tree: the whole video, the
    overlapping split with frames, and the split with occluding masks (the
    port's PIL mask reader against the JAX default, matplotlib) and the
    PlaneRCNN floor."""
    kp_dir, frames, mask_dir, planes = _video(tmp_path)
    cam = np.array([[500., 0, 32], [0, 500., 24], [0, 0, 1]])
    kw = {} if mode == "whole" else dict(seq_len=5, overlap_len=2,
                                         img_path=frames)
    if mode == "masked":
        kw.update(masks_path=mask_dir, mask_joints=True,
                  planercnn_path=planes)
    got = trgb.load_rgb_video_observations(kp_dir, cam, video_name="v",
                                           **kw)
    want = jrgb.load_rgb_video_observations(kp_dir, cam, video_name="v",
                                            **kw)
    assert len(want) == (1 if mode == "whole" else 3)
    _equal(got, want)


# ---------------------------------------------------------------------------
# PROX: calibration, projection, scans, the recording walk
# ---------------------------------------------------------------------------

def _fits(rng, T, missing=(3,), nan=(5,)):
    fits = []
    for t in range(T):
        fit = {"transl": rng.standard_normal((1, 3)).astype(np.float32),
               "betas": rng.standard_normal((1, 10)).astype(np.float32),
               "body_pose": rng.standard_normal((1, 63)).astype(np.float32),
               "global_orient":
                   rng.standard_normal((1, 3)).astype(np.float32)}
        if t in nan:
            fit["transl"] = np.array([[np.nan, 0, 0]], np.float32)
        fits.append(None if t in missing else fit)
    return fits


def _prox(tmp_path, rng, T=12, quant=True, recording="vicon_03301_01"):
    """A PROX tree with Kinect-sized depth (a noisy plane ~2 m out), masks
    occluding a band of the colour frame, and a PlaneRCNN floor."""
    kp = np.zeros((T, 25, 3))
    kp[..., 0] = 1920 * rng.random((T, 25))
    kp[..., 1] = 1080 * rng.random((T, 25))
    kp[..., 2] = rng.random((T, 25))
    depths = [(16000 + 500 * rng.standard_normal((424, 512))).astype(
        np.uint16) for _ in range(T)]
    mask = np.zeros((1080, 1920), np.uint8)
    mask[:, :700] = 255
    root = str(tmp_path / "prox")
    rl.write_prox_tree(root, kp, lambda t: depths[t], lambda t: mask,
                       _fits(rng, T), quant=quant, recording=recording)
    data = os.path.join(root, "quantitative" if quant else "qualitative")
    planes = os.path.join(data, "planes", recording.split("_")[0])
    os.makedirs(planes)
    params = np.array([[0.05, 0.1, -1.4], [2.0, 0.3, 0.1]])
    pm = np.zeros((2, 16, 20), np.uint8)
    pm[0, -10:] = 1
    np.save(os.path.join(planes, "0_plane_parameters_0.npy"), params)
    np.save(os.path.join(planes, "0_plane_masks_0.npy"), pm)
    return root, data


def test_projection_and_scans_match_jax(tmp_path):
    """The Brown-Conrady pair, back-projection and create_scan in both
    masking modes and frames, on the written calibration."""
    rng = np.random.default_rng(4)
    root, data = _prox(tmp_path, rng, T=2)
    calib_dir = os.path.join(data, "calibration")
    tc = trgb.load_prox_calibration(calib_dir)
    _equal(tc, jrgb.load_prox_calibration(calib_dir))
    uv = rng.uniform(0, 500, (50, 2))
    cam = tc["depth_cam"]
    _equal(trgb._undistort_points(uv, cam["camera_mtx"], cam["k"]),
           jrgb._undistort_points(uv, cam["camera_mtx"], cam["k"]))
    pts = rng.uniform(-1, 1, (40, 3)) + [0, 0, 3]
    for c in (tc["color_cam"], dict(tc["color_cam"], R=[0.01, 0.02, 0.03])):
        _equal(trgb._distort_project(pts, c), jrgb._distort_project(pts, c))
    depth = rng.uniform(1.0, 4.0, (424, 512))
    _equal(trgb.unproject_depth_image(depth, cam),
           jrgb.unproject_depth_image(depth, cam))
    # the mask lies in the colour frame, or (mask_on_color False) the depth
    for on_color, hw in ((True, (1080, 1920)), (False, (424, 512))):
        mask = (rng.random(hw) < 0.5).astype(np.uint8)
        for coord in ("color", "depth"):
            _equal(trgb.create_scan(mask, depth, tc, on_color, coord),
                   jrgb.create_scan(mask, depth, tc, on_color, coord))
    for n in (5, 4096):
        _equal(trgb.resize_points(pts, n, np.random.default_rng(n)),
               jrgb.resize_points(pts, n, np.random.default_rng(n)))


def test_depth_points_match_jax(tmp_path):
    """load_prox_depth_points on written 16-bit depth PNGs: the port's
    PIL reader against the JAX default (matplotlib), flipped and not, with
    an empty first scan (zeros) and an empty later one (the previous)."""
    rng = np.random.default_rng(5)
    root, data = _prox(tmp_path, rng, T=4)
    obs = trgb.load_prox_observations(root, quant=True, seq_len=4,
                                      return_fitting=False)[0]
    calib = trgb.load_prox_calibration(os.path.join(data, "calibration"))
    full = np.zeros((1080, 1920), np.uint8)
    masks = [np.full((1080, 1920), 255, np.uint8), full, full,
             np.full((1080, 1920), 255, np.uint8)]
    for flip in (True, False):
        got = trgb.load_prox_depth_points(obs["depth_paths"], masks, calib,
                                          max_pts=64, flip=flip)
        want = jrgb.load_prox_depth_points(obs["depth_paths"], masks, calib,
                                           max_pts=64, flip=flip)
        assert got.shape == (4, 64, 3)
        assert np.all(got[0] == 0) and np.all(got[3] == got[2])
        _equal(got, want)


@pytest.mark.parametrize("quant,flip,mask_joints", [
    (True, True, False), (True, False, True), (False, True, True)])
def test_prox_observations_match_jax(tmp_path, quant, flip, mask_joints):
    """load_prox_observations: the flip convention, masked joints (PIL
    against matplotlib), cam2world, calibration, the PlaneRCNN floor and
    the ground-truth fits (one missing, one non-finite)."""
    rng = np.random.default_rng(6)
    rec = "vicon_03301_01" if quant else "N3Office_00162_01"
    root, _ = _prox(tmp_path, rng, T=12, quant=quant, recording=rec)
    kw = dict(quant=quant, seq_len=5, flip=flip, mask_joints=mask_joints,
              load_floor_plane=True, return_fitting=True)
    got = trgb.load_prox_observations(root, **kw)
    want = jrgb.load_prox_observations(root, **kw)
    assert len(want) == 2
    _equal(got, want)
    assert got[0]["gender"] == ("male" if quant else "female")


def test_prox_walk_matches_jax(tmp_path):
    """prox_recordings and prox_subsequences (the qualitative edge trim, a
    named recording, one subsequence), prox_data_paths_from_img,
    read_fitting_seq with its validity list, prox_gender."""
    for rec, n in (("N3Office_00034_01", 200), ("MPH16_00162_01", 30),
                   ("Werkraum_03301_01", 5), ("BadScene_00001_01", 40)):
        d = tmp_path / "qualitative" / "recordings" / rec / "Color"
        d.mkdir(parents=True)
        for i in range(n):
            (d / f"s001_frame_{i:05d}.jpg").touch()
    root = str(tmp_path)
    for split in ("train", "test"):
        _equal(trgb.prox_recordings(root, split=split),
               jrgb.prox_recordings(root, split=split))
    for kw in (dict(seq_len=10), dict(seq_len=10, split="test"),
               dict(seq_len=7, recording="MPH16_00162_01"),
               dict(seq_len=10, recording="N3Office_00034_01",
                    recording_subseq_idx=1)):
        got = trgb.prox_subsequences(root, **kw)
        _equal(got, jrgb.prox_subsequences(root, **kw))
        assert got[0]
    imgs = trgb.prox_subsequences(root, seq_len=10)[0][0]
    for quant in (True, False):
        _equal(trgb.prox_data_paths_from_img(imgs, root, quant),
               jrgb.prox_data_paths_from_img(imgs, root, quant))
    rng = np.random.default_rng(7)
    proot, _ = _prox(tmp_path / "q", rng, T=8)
    seqs, _ = trgb.prox_subsequences(proot, quant=True, seq_len=8)
    paths = trgb.prox_data_paths_from_img(seqs[0], proot, quant=True)
    got = trgb.read_fitting_seq(paths["fitting"], return_valid=True)
    _equal(got, jrgb.read_fitting_seq(paths["fitting"], return_valid=True))
    assert got[1][3] is False and got[1][5] is False
    for name in ("vicon_03301_01", "MPH16_00162_01"):
        assert trgb.prox_gender(name) == jrgb.prox_gender(name)


# ---------------------------------------------------------------------------
# the 2D term and the camera->prior frame
# ---------------------------------------------------------------------------

def test_reproj_loss_value_and_grad_match_jax():
    """_reproj_loss with the identity and a learned camera: value within
    rtol 1e-5, gradients (joints, cam_t, cam_R) within rtol 1e-5 and atol
    1e-5 of their largest entry."""
    rng = np.random.default_rng(8)
    B = 6
    j3 = (0.4 * rng.standard_normal((B, 25, 3))).astype(np.float32)
    kp = np.concatenate([900 + 300 * rng.random((B, 25, 2)),
                         rng.random((B, 25, 1))], -1).astype(np.float32)
    kp[:, :3, 2] = 0.0
    cam_t = np.float32([0.1, -0.2, 2.5])
    center = np.float32([960.0, 540.0])
    R = jfit.batch_rodrigues(jnp.float32([[0.05, -0.1, 0.02]]))[0]
    for cam_R in (None, np.asarray(R)):
        def jloss(j, t, r):
            return jfit._reproj_loss(j, t, jnp.asarray(center), 1060.0,
                                     jnp.asarray(kp), 100.0, cam_R=r)
        r0 = jnp.eye(3) if cam_R is None else jnp.asarray(cam_R)
        jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(j3), jnp.asarray(cam_t), r0)
        tj, tt = _t(j3).requires_grad_(), _t(cam_t).requires_grad_()
        tr = (torch.eye(3) if cam_R is None else _t(cam_R)).requires_grad_()
        tl = tfit._reproj_loss(tj, tt, _t(center), torch.tensor(1060.0),
                               _t(kp), 100.0, cam_R=tr)
        tl.backward()
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for g, w in zip((tj.grad, tt.grad, tr.grad), jg):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())


def test_floor_plane_helpers_match_jax():
    rng = np.random.default_rng(9)
    fp = rng.standard_normal((6, 3)).astype(np.float32)
    np.testing.assert_allclose(tfit.parse_floor_plane(_t(fp)).numpy(),
                               np.asarray(jfit.parse_floor_plane(fp)),
                               rtol=1e-5, atol=1e-5)
    pt, dr, pl = (rng.standard_normal((5, n)).astype(np.float32)
                  for n in (3, 3, 4))
    for got, want in zip(tfit.compute_plane_intersection(_t(pt), _t(dr),
                                                         _t(pl)),
                         jfit.compute_plane_intersection(pt, dr, pl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tfit.bdot(_t(pt), _t(dr), True).numpy(),
                               np.asarray(jfit.bdot(pt, dr, True)),
                               rtol=1e-5, atol=1e-6)


def _np_joints_fn(pose_body, betas, root_orient, trans):
    """A deterministic numpy stand-in for the SMPL joints: 22 joints that
    move with every input."""
    f = lambda a: np.asarray(a, np.float32)
    base = np.linspace(-0.5, 0.5, 66, dtype=np.float32).reshape(1, 22, 3)
    return (base * (1 + 0.1 * f(betas)[:, :1, None])
            + f(trans)[:, None]
            + 0.05 * np.sin(f(root_orient) + f(pose_body)[:, :3])[:, None])


def test_cam2prior_matches_jax():
    """compute_cam2prior on a (3,) optimization-form plane and on a (4,)
    plane, then apply_cam2prior forward (re-floored through the joints
    function) and inverse, within 1e-5 of JAX."""
    rng = np.random.default_rng(10)
    B, T = 2, 7
    trans = rng.standard_normal((B, T, 3)).astype(np.float32)
    ro = (0.5 * rng.standard_normal((B, T, 3))).astype(np.float32)
    body = (0.2 * rng.standard_normal((B, T, 63))).astype(np.float32)
    betas = rng.standard_normal((B, T, 10)).astype(np.float32)
    joints = _np_joints_fn(body[:, 0], betas[:, 0], ro[:, 0], trans[:, 0])
    for fp in (np.float32([[0.05, -0.9, 0.1], [-0.1, -1.2, 0.05]]),
               np.float32([[0.0, -1.0, 0.0, -0.5], [0.1, -0.99, 0.0, -1.1]])):
        got = tfit.compute_cam2prior(_t(fp), _t(trans[:, 0]), _t(ro[:, 0]),
                                     _t(joints))
        want = jfit.compute_cam2prior(jnp.asarray(fp),
                                      jnp.asarray(trans[:, 0]),
                                      jnp.asarray(ro[:, 0]),
                                      jnp.asarray(joints))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        for inverse in (False, True):
            d = {"trans": trans, "root_orient": ro}
            g = tfit.apply_cam2prior({k: _t(v) for k, v in d.items()},
                                     *got, _t(body), _t(betas), 3,
                                     _np_joints_fn, inverse=inverse)
            w = jfit.apply_cam2prior({k: jnp.asarray(v) for k, v in
                                      d.items()}, *want, jnp.asarray(body),
                                     jnp.asarray(betas), 3, _np_joints_fn,
                                     inverse=inverse)
            assert list(g) == list(w)
            for k in w:
                np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                           atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# RGB evaluation and the results layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_masks", [False, True])
def test_quant_eval_2d_matches_jax(with_masks):
    rng = np.random.default_rng(11)
    T = 8
    pj = rng.standard_normal((T, 22, 3))
    pc = rng.standard_normal((T, 12, 3)) + [0, 0, 3]
    gc = pc + 0.05 * rng.standard_normal((T, 12, 3))
    gc[2] = np.inf
    kw = {}
    if with_masks:
        kw = dict(vis_mask=(rng.random((T, 1080, 1920)) < 0.3).astype(
            np.uint8), cam_intrins=(1060.0, 1060.0, 960.0, 540.0))
    fp = np.array([0.0, -1.0, 0.0, -0.8])
    got = teval.quant_eval_2d(pj, fp, pc, gc, **kw)
    want = jeval.quant_eval_2d(pj, fp, pc, gc, **kw)
    assert list(got) == list(want)
    assert ("joints3d_vis" in got) == with_masks
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    assert teval.COMP_EE_INDS == jeval.COMP_EE_INDS
    assert teval.COMP_LEGS_INDS == jeval.COMP_LEGS_INDS
    assert (teval.COMP_ROOT_IDX, teval.IMW, teval.IMH) == \
        (jeval.COMP_ROOT_IDX, jeval.IMW, jeval.IMH)


def _rgb_results(root, save):
    """Three overlapping subsequence result dirs as fit-rgb writes them."""
    rng = np.random.default_rng(12)
    intervals = [(0, 6), (4, 10), (8, 14)]
    dirs = []
    for i, _ in enumerate(intervals):
        T = 6
        s3 = {"betas": (0.3 * rng.standard_normal(10)).astype(np.float32),
              "trans": rng.standard_normal((T, 3)).astype(np.float32),
              "root_orient": (0.4 * rng.standard_normal((T, 3))).astype(
                  np.float32),
              "pose_body": (0.2 * rng.standard_normal((T, 63))).astype(
                  np.float32),
              "floor_plane": np.array([0.02, -0.95, 0.1, -0.6 - 0.1 * i])}
        obs = {"joints2d": rng.random((T, 25, 3)).astype(np.float32),
               "img_paths": np.asarray([f"/f/{i}_{t}.jpg"
                                        for t in range(T)])}
        d = os.path.join(root, f"vid_{i:04d}")
        save(d, s3, gt={"cam_mtx": np.eye(3) * (i + 2)}, observations=obs,
             optim_bm="synthetic", gt_bm="synthetic")
        dirs.append(d)
    return intervals, dirs


def test_stitch_rgb_results_matches_jax(tmp_path):
    """Both stitchers on the same three result dirs: the same files, every
    array within 1e-6 (strings equal), the _prior file within 1e-5."""
    root = str(tmp_path / "res")
    intervals, dirs = _rgb_results(root, teval.save_fitting_results)
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    ft = teval.stitch_rgb_results(intervals, dirs, out_t, _np_joints_fn)
    fj = jeval.stitch_rgb_results(intervals, dirs, out_j, _np_joints_fn)
    names = sorted(os.listdir(fj))
    assert sorted(os.listdir(ft)) == names
    assert "stage3_results_prior.npz" in names
    for name in names:
        if not name.endswith(".npz"):
            with open(os.path.join(ft, name)) as a, \
                    open(os.path.join(fj, name)) as b:
                assert a.read() == b.read()
            continue
        with np.load(os.path.join(ft, name)) as a, \
                np.load(os.path.join(fj, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                if b[k].dtype.kind in "US":
                    _equal(a[k], b[k])
                    continue
                atol = 1e-5 if name.endswith("_prior.npz") else 1e-6
                np.testing.assert_allclose(a[k], b[k], atol=atol,
                                           err_msg=f"{name}:{k}")
    with np.load(os.path.join(ft, "stage3_results.npz")) as a:
        assert a["trans"].shape == (14, 3)


def _numpy_bodies(trans, root_orient, pose_body, betas):
    T = trans.shape[0]
    base = np.linspace(-1, 1, 6890 * 3).reshape(1, 6890, 3)
    verts = base * (1.0 + 0.1 * betas[:, :1, None]) + trans[:, None] + \
        0.1 * np.sin(root_orient.sum(-1))[:, None, None]
    joints = np.concatenate([verts[:, :66:3], pose_body[:, :6].reshape(
        T, 2, 3)], axis=1)
    return joints.astype(np.float32), verts.astype(np.float32)


def _is_num(x):
    try:
        float(x)
        return True
    except ValueError:
        return False


def _csvs_equal(tdir, jdir, n_files):
    files = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == files and len(files) == n_files
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


def test_eval_stages_match_jax(tmp_path):
    """A results tree with stage1/stage2/stage3_init files (one sequence
    lacks stage 2) through both evaluators with eval_stages: the same CSV
    family for the four result names, within 1e-5; without eval_stages
    the stage3 files alone, as before."""
    rng = np.random.default_rng(13)
    root = str(tmp_path / "results")
    T = 7
    for i in range(3):
        gt = {"trans": rng.standard_normal((T, 3)),
              "root_orient": 0.3 * rng.standard_normal((T, 3)),
              "pose_body": 0.2 * rng.standard_normal((T, 63)),
              "betas": 0.5 * rng.standard_normal(10),
              "contacts": (rng.random((T, 22)) > 0.5).astype(np.float32)}
        gt = {k: v.astype(np.float32) for k, v in gt.items()}
        mk = lambda s: {k: (v + s * rng.standard_normal(v.shape)).astype(
            np.float32) for k, v in gt.items() if k != "contacts"}
        stages = {"stage1_results": mk(0.3), "stage3_init_results": mk(0.1)}
        if i != 1:
            stages["stage2_results"] = mk(0.2)
        teval.save_fitting_results(os.path.join(root, f"seq_{i}"), mk(0.05),
                                   gt=gt, stages=stages)
    for stages, n in ((True, 4 * 6 + 3), (False, 9)):
        tdir = str(tmp_path / f"t{stages}")
        jdir = str(tmp_path / f"j{stages}")
        assert teval.eval_fitting_results_dirs(
            root, tdir, _numpy_bodies, eval_stages=stages) == \
            jeval.eval_fitting_results_dirs(root, jdir, _numpy_bodies,
                                            eval_stages=stages)
        _csvs_equal(tdir, jdir, n)
    assert teval.STAGES_RES_NAMES == jeval.STAGES_RES_NAMES
    with open(os.path.join(root, "seq_0", "meta.txt")) as f:
        assert f.read() == "optim_bm neutral\ngt_bm neutral\n"
