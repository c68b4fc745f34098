"""The port's vibe_demo CLI against nemo_tpu's on the same files, end to end
on the CPU.

Both CLIs read one frames directory (8 frames of 64 x 64, a person
walking right) with its OpenPose JSONs (STAF person ids), a 150-vertex
SMPL .npz and a SPIN-layout checkpoint with a GRU, written by the port
(utils/asset_files.write_spin_ckpt) from the port's initializers' draws,
the backbone's batch norms calibrated (asset_files.calibrate_batch_norm). They
run --out_res 64 with bbox tracking, and with pose tracking and
--run_smplify --smplify_max_iter 2. The pickles are equal key for key:
ids, frame ids and the accept mask exactly, floats to 1e-4 of each
array's largest entry (the networks' float32 sums in other orders, then
two L-BFGS iterations a stage). The port's pickle loads with joblib and
through the port's data/vibe.py reader, and --render_out writes a frame
for every input frame.
"""

import json
import os

import joblib
import numpy as np
import pytest
import torch

from nemo_tpu.cli import vibe_demo as jdemo
from nemo_tpu_torch.body.assets import synthetic_smpl_model
from nemo_tpu_torch.cli import vibe_demo as tdemo
from nemo_tpu_torch.data.vibe import load_vibe_pickle
from nemo_tpu_torch.models import hmr as thmr
from nemo_tpu_torch.models import resnet as tresnet
from nemo_tpu_torch.models import vibe as tvibe
from nemo_tpu_torch.render.video import _write_png
from nemo_tpu_torch.utils import asset_files as af
from nemo_tpu_torch.utils import pickles

T, H, W = 8, 64, 64
RTOL = 1e-4


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("vibe_demo")
    rng = np.random.RandomState(0)
    frames, op = d / "vid.frames", d / "vid.frames.op"
    frames.mkdir()
    op.mkdir()
    for f in range(T):
        img = rng.rand(H, W, 3).astype(np.float32) * 0.2
        x0 = 12 + f
        img[18:50, x0:x0 + 24] = 0.8
        _write_png(str(frames / f"{f:06d}.png"), img)
        kp = np.zeros((25, 3), np.float32)
        kp[:, 0] = x0 + 24 * rng.rand(25)
        kp[:, 1] = 18 + 32 * rng.rand(25)
        kp[:, 2] = 0.5 + 0.5 * rng.rand(25)
        with open(op / f"{f:06d}_keypoints.json", "w") as fh:
            json.dump({"people": [{"person_id": [11], "pose_keypoints_2d":
                                   kp.ravel().tolist()}]}, fh)
    backbone = tresnet.init_resnet50(torch.Generator().manual_seed(0))
    af.calibrate_batch_norm(backbone, torch.from_numpy(
        rng.randn(T, 3, H, W).astype(np.float32)))
    head = thmr.init_hmr_head(torch.Generator().manual_seed(1))
    gru = tvibe.init_gru(torch.Generator().manual_seed(2))
    ckpt = af.write_spin_ckpt(str(d / "spin_model.pth.tar"), backbone,
                              head, gru)
    smpl = af.write_smpl_npz(str(d / "smpl.npz"), af.smpl_file_arrays(
        synthetic_smpl_model(num_vertices=150, seed=0)))
    return {"dir": d, "common": [
        "--frames_dir", str(frames), "--openpose_dir", str(op),
        "--spin_ckpt", ckpt, "--smpl_path", smpl, "--min_track_len", "6",
        "--out_res", "64"]}


def _equal_pickles(got, want):
    assert sorted(got) == sorted(want)
    for pid in want:
        assert sorted(got[pid]) == sorted(want[pid]), pid
        for k, w in want[pid].items():
            g = got[pid][k]
            assert g.shape == w.shape and g.dtype == w.dtype, (k, g.dtype,
                                                                w.dtype)
            if w.dtype.kind in "biu" or k in ("bboxes", "bbox_cs",
                                              "joints2d"):
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                scale = max(float(np.abs(w).max()), 1e-6)
                err = float(np.abs(g - w).max())
                assert err <= RTOL * scale, f"{k}: {err} > {RTOL} * {scale}"


@pytest.mark.parametrize("mode", ["bbox", "pose_smplify"])
def test_vibe_demo_cli(inputs, mode):
    d = inputs["dir"]
    extra = ([] if mode == "bbox" else
             ["--tracking_method", "pose", "--run_smplify",
              "--smplify_max_iter", "2"])
    jout, tout = str(d / f"jax_{mode}.pkl"), str(d / f"torch_{mode}.pkl")
    assert jdemo.main(inputs["common"] + extra + ["--out", jout]) == 0
    render = str(d / f"render_{mode}.mp4")
    assert tdemo.main(inputs["common"] + extra + [
        "--out", tout, "--device", "cpu", "--render_out", render]) == 0
    want = joblib.load(jout)
    got = joblib.load(tout)
    _equal_pickles(got, want)
    _equal_pickles(pickles.load(tout), want)
    pid = 11 if mode != "bbox" else 0
    assert list(got) == [pid]
    if mode != "bbox":
        assert got[pid]["smplify_update"].dtype == np.bool_
        assert got[pid]["joints2d"].shape == (T, 25, 3)
    # the next step of the recipe reads this pickle through data/vibe.py
    person = load_vibe_pickle(tout, T)
    fids = got[pid]["frame_ids"]
    np.testing.assert_array_equal(person["pose"][fids], got[pid]["pose"])
    np.testing.assert_array_equal(person["betas"], got[pid]["betas"])
    np.testing.assert_array_equal(person["orig_cam"][fids],
                                  got[pid]["orig_cam"])
    np.testing.assert_array_equal(person["mask"][fids], 1.0)
    # --render_out: without ffmpeg, one PNG a frame in <out>.frames
    dst = render if os.path.exists(render) else render + ".frames"
    if dst.endswith(".frames"):
        assert len(os.listdir(dst)) == T


def test_vibe_demo_device_and_flags(inputs, tmp_path):
    """--device cuda without a card raises; the flag set is the JAX CLI's
    plus --device."""
    def dests(parser):
        return {a.dest for a in parser._actions} - {"help"}
    assert dests(tdemo.build_parser()) == dests(jdemo.build_parser()) | {
        "device"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tdemo.main(inputs["common"] + ["--out", str(tmp_path / "x.pkl")])
