"""The port's preprocessing stage against nemo_tpu's, on the CPU.

Raw per-view layouts are written from a numpy seed with
``nemo_tpu_torch.utils.raw_layout``: OpenPose JSON directories of different
lengths (under the three directory names the packer probes) with empty and
two-person frames, ``_gt_2d.npy`` and ``_gt_new/`` GT, VIBE pickles with
several tracklets at both locations, a MoSh mocap pickle, GT cameras in
all three formats, SPIN thetas at widths 69, 72 and 85, Penn Action mats,
vs / PARE (rotation matrices) / GLAMR baselines, and a Penn Action
seq_names layout with one sequence whose VIBE dict is empty. JAX's
``preprocess.main`` and the port's pack each layout; every bundle array
must be equal, PARE's axis-angle within 1e-6. Each loader, the native
library, the GT camera fit and ``video_tool``'s commands are held against
their JAX counterparts.
"""

import json
import os

import numpy as np
import pytest
import torch

from nemo_tpu_torch.utils import raw_layout as rl

PARE_ATOL = 1e-6


def _kp(rng, T, x0=200.0, y0=150.0):
    """(T, 25, 3) keypoints in a box, confidence in (0.3, 1)."""
    kp = np.zeros((T, 25, 3), np.float32)
    kp[..., 0] = x0 + 300 * rng.rand(T, 25)
    kp[..., 1] = y0 + 500 * rng.rand(T, 25)
    kp[..., 2] = 0.3 + 0.7 * rng.rand(T, 25)
    return kp


def _rotmats(rng, n):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3).astype(np.float32)


def _tracklet(rng, frame_ids, kp=None, rotmat=False, cam=True):
    """A VIBE-style tracklet over frame_ids; joints2d near kp (the
    tracklet that follows the person) or far off (another person)."""
    n = len(frame_ids)
    j2d = (kp[frame_ids, :, :2] if kp is not None else
           1500 + 100 * rng.rand(n, 25, 2)).astype(np.float32)
    j2d = np.concatenate([j2d, 300 * rng.rand(n, 24, 2).astype(np.float32)],
                         1)
    t = {"pose": (_rotmats(rng, n * 24).reshape(n, 24, 3, 3) if rotmat
                  else (0.3 * rng.randn(n, 72)).astype(np.float32)),
         "betas": (0.5 * rng.randn(n, 10)).astype(np.float32),
         "joints3d": rng.randn(n, 49, 3).astype(np.float32),
         "joints2d_img_coord": j2d,
         "frame_ids": np.asarray(frame_ids)}
    if cam:
        t["orig_cam"] = rng.rand(n, 4).astype(np.float32)
    return t


def _openpose_frames(rng, kp, empty_every=5, double_every=4):
    """Per-frame detections: nobody on every empty_every-th frame, a second
    person after the first on every double_every-th."""
    frames = []
    for f in range(kp.shape[0]):
        if f % empty_every == 2:
            frames.append([])
        elif f % double_every == 1:
            frames.append([kp[f], _kp(rng, 1, 900.0, 50.0)[0]])
        else:
            frames.append([kp[f]])
    return frames


def write_mocap_layout(root, seed=0, lens=(12, 15, 18)):
    """A NeMo-MoCap-style action of len(lens) views. Returns the YAML path
    and {flag: comma-joined paths} for every optional input."""
    rng = np.random.RandomState(seed)
    exp = os.path.join(root, "exp")
    names = [f"view{v}.mp4" for v in range(len(lens))]
    op_suffix = (".frames.op", ".op", "_openpose")
    flags = {k: [] for k in ("--gt_cam_paths", "--spin_npys", "--penn_mats",
                             "--vs_pkls", "--pare_pkls", "--glamr_pkls")}
    from scipy.io import savemat
    for v, (name, T) in enumerate(zip(names, lens)):
        base = os.path.join(exp, name)
        kp = _kp(rng, T)
        rl.write_openpose_dir(base + op_suffix[v % 3],
                              _openpose_frames(rng, kp))
        os.makedirs(base + ".frames")
        for f in range(T + v):
            open(os.path.join(base + ".frames", f"{f:06d}.png"), "wb").close()
        if v == 1:
            rl.write_gt_new_dir(base + "_gt_new",
                                300 * rng.rand(T, 2, 17, 2))
        else:
            np.save(base + "_gt_2d.npy", _kp(rng, T))
        vibe = (os.path.join(exp, name + "_vibe", "vibe_output.pkl")
                if v != 1 else os.path.join(exp, "vibe", name,
                                            "vibe_output.pkl"))
        ids = np.arange(1, T - 1)
        rl.write_pickle(vibe, {3: _tracklet(rng, np.arange(T // 2)),
                               7: _tracklet(rng, ids, kp),
                               9: _tracklet(rng, np.arange(2, T))})
        cam9 = rng.randn(9).astype(np.float32)
        flags["--gt_cam_paths"].append(rl.write_camera(
            os.path.join(root, "cams", name + (".npy", ".pkl", ".pt")[v % 3]),
            cam9, focal=4000.0 + v))
        spin = rng.randn(T, (69, 72, 85)[v % 3]).astype(np.float32)
        np.save(os.path.join(root, f"spin{v}.npy"), spin)
        flags["--spin_npys"].append(os.path.join(root, f"spin{v}.npy"))
        mat = os.path.join(root, f"penn{v}.mat")
        savemat(mat, {"x": 400 * rng.rand(T, 13), "y": 300 * rng.rand(T, 13),
                      "visibility": (rng.rand(T, 13) > 0.2).astype(float)})
        flags["--penn_mats"].append(mat)
        flags["--vs_pkls"].append(rl.write_pickle(
            os.path.join(root, "vs", f"{v}.pkl"),
            {1: _tracklet(rng, np.arange(T)), 4: _tracklet(rng, ids, kp)}))
        flags["--pare_pkls"].append(rl.write_pickle(
            os.path.join(root, "pare", f"{v}.pkl"),
            {0: _tracklet(rng, np.arange(T // 2), rotmat=True),
             2: _tracklet(rng, ids, kp, rotmat=True)}))
        Tg = T - 2 if v == 0 else T + 2     # GLAMR shorter / longer
        flags["--glamr_pkls"].append(rl.write_pickle(
            os.path.join(root, "glamr", f"{v}.pkl"),
            {"person_data": [{
                "smpl_pose": rng.randn(Tg, 72 if v == 2 else 69).astype(
                    np.float32),
                "smpl_orient_cam": rng.randn(Tg, 3).astype(np.float32),
                "root_trans_cam": rng.randn(Tg, 3).astype(np.float32),
                "kp_2d": (300 * rng.rand(Tg, 25, 3)).astype(np.float32)}]}))
    mocap = rl.write_pickle(os.path.join(root, "mocap.pkl"), {
        "fullpose": (0.2 * rng.randn(max(lens) + 5, 156)).astype(np.float32),
        "trans": rng.randn(max(lens) + 5, 3).astype(np.float32)})
    cfg = rl.write_action_yaml(os.path.join(root, "action.yml"), exp, names)
    out = {k: ",".join(v) for k, v in flags.items()}
    out["--mocap_pkl"] = mocap
    return cfg, out


def write_penn_layout(root, seed=0, lens=(14, 11, 17)):
    """A Penn Action seq_names layout; the second sequence's VIBE output
    is an empty dict (skipped by the packer)."""
    from scipy.io import savemat
    rng = np.random.RandomState(seed)
    penn = os.path.join(root, "penn")
    sids = [f"{i:04d}" for i in range(1, len(lens) + 1)]
    for i, (sid, T) in enumerate(zip(sids, lens)):
        fdir = os.path.join(penn, "frames", sid)
        os.makedirs(fdir)
        for f in range(T):
            open(os.path.join(fdir, f"{f + 1:06d}.jpg"), "wb").close()
        os.makedirs(os.path.join(penn, "labels"), exist_ok=True)
        savemat(os.path.join(penn, "labels", f"{sid}.mat"),
                {"x": 400 * rng.rand(T, 13), "y": 300 * rng.rand(T, 13),
                 "visibility": np.ones((T, 13))})
        kp = _kp(rng, T)
        rl.write_openpose_dir(os.path.join(penn, "openpose", sid),
                              _openpose_frames(rng, kp))
        vibe = {} if i == 1 else {
            1: _tracklet(rng, np.arange(T), kp),
            5: _tracklet(rng, np.arange(3, T))}
        rl.write_pickle(os.path.join(penn, "vibe_results", sid,
                                     "vibe_output.pkl"), vibe)
    cfg = rl.write_action_yaml(os.path.join(root, "penn.yml"),
                               seq_names=sids)
    return cfg, penn


def _bundle_arrays(path):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


def _assert_same_bundle(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if k == "bpose_pare":
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=PARE_ATOL,
                                       err_msg=k)
        else:
            assert np.array_equal(a[k], b[k]), k


def _pack_both(tmp_path, argv):
    from nemo_tpu.cli.preprocess import main as jax_main
    from nemo_tpu_torch.cli.preprocess import main as port_main
    jout, pout = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    assert jax_main(argv + ["--out", jout]) == 0
    assert port_main(argv + ["--out", pout]) == 0
    return _bundle_arrays(jout), _bundle_arrays(pout)


def _mocap_argv(cfg, flags, keys):
    argv = ["--nemo_cfg_path", cfg]
    for k in keys:
        argv += [k, flags[k]]
    return argv


ALL_INPUTS = ("--gt_cam_paths", "--spin_npys", "--vs_pkls", "--pare_pkls",
              "--glamr_pkls", "--mocap_pkl")

LAYOUTS = {
    # every optional input; F = min over views, image size inferred
    "every_input": (ALL_INPUTS, []),
    # the common grid cut and shifted, the image size given
    "n_frames_start_phase": (ALL_INPUTS, ["--n_frames", "9", "--start_phase",
                                          "0.25", "--img_h", "720",
                                          "--img_w", "1280"]),
    # Penn mats as the GT labels
    "penn_mats": (("--penn_mats", "--mocap_pkl"), []),
    # the OpenPose directories and what the exp_dir holds, nothing else
    "exp_dir_only": ((), ["--n_frames", "40"]),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pack_equals_jax(tmp_path, layout):
    cfg, flags = write_mocap_layout(str(tmp_path / "raw"))
    keys, extra = LAYOUTS[layout]
    jb, pb = _pack_both(tmp_path, _mocap_argv(cfg, flags, keys) + extra)
    _assert_same_bundle(jb, pb)
    if layout == "every_input":
        assert {"labels_op", "labels_gt", "labels_vibe", "labels_vs",
                "labels_pare", "bpose_vs", "bpose_pare", "bpose_glamr",
                "glamr_orient", "glamr_trans", "spin_theta", "gt3d_pose",
                "gt3d_trans", "gt_cameras", "frame_paths", "vibe_orient",
                "vibe_betas", "vibe_cam"} <= set(pb)
        assert pb["labels_op"].shape == (3, 12, 25, 3)
        # SMPL-H fullpose: the body's 66, the two hand slots zero
        assert np.array_equal(pb["gt3d_pose"][..., 66:], 0 * pb[
            "gt3d_pose"][..., 66:])


def test_pack_penn_seq_names_equals_jax(tmp_path):
    cfg, penn = write_penn_layout(str(tmp_path / "raw"))
    for extra in ([], ["--n_frames", "6", "--start_phase", "0.2"]):
        jb, pb = _pack_both(tmp_path, ["--nemo_cfg_path", cfg, "--penn_root",
                                       penn] + extra)
        _assert_same_bundle(jb, pb)
        # the sequence with the empty VIBE dict is skipped
        assert pb["labels_op"].shape[0] == 2
    F = pb["labels_op"].shape[1]
    assert F == min(6, 14 - round(14 * 0.2) - 1)


def test_openpose_parsers_agree(tmp_path, monkeypatch, capsys):
    """preprocess reads every view through the native parser where its
    library builds, and says so; without the library it falls back to the
    json module and packs the same bundle."""
    from nemo_tpu_torch.cli.preprocess import main
    from nemo_tpu_torch.data import PARSER_CALLS
    from nemo_tpu_torch.ops import native
    cfg, flags = write_mocap_layout(str(tmp_path / "raw"))
    out = {}
    for parser in ("native", "json"):
        if parser == "json":
            monkeypatch.setattr(native, "get_native", lambda: None)
        path = str(tmp_path / f"{parser}.npz")
        capsys.readouterr()
        assert main(["--nemo_cfg_path", cfg, "--out", path]) == 0
        assert PARSER_CALLS[parser] == 3 and sum(PARSER_CALLS.values()) == 3
        report = [ln for ln in capsys.readouterr().out.splitlines()
                  if "OpenPose parser:" in ln]
        assert len(report) == 1 and f"{parser} 3 view(s)" in report[0]
        out[parser] = _bundle_arrays(path)
    _assert_same_bundle(out["native"], out["json"])


# ---------------------------------------------------------------------------
# each loader against its JAX counterpart
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw"))
    cfg, flags = write_mocap_layout(root, seed=3)
    return root, cfg, flags


def _op_dirs(root):
    exp = os.path.join(root, "exp")
    return sorted(os.path.join(exp, d) for d in os.listdir(exp)
                  if d.endswith((".op", "_openpose")))


def _equal_tree(a, b):
    """a and b hold the same values, dtypes, shapes and container types."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert type(b) is np.ndarray
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.hasobject:
            _equal_tree(a.tolist(), b.tolist())
        else:
            assert np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def test_openpose_loaders_equal_jax(raw):
    import nemo_tpu.data.openpose as J
    import nemo_tpu_torch.data.openpose as P
    root = raw[0]
    for d in _op_dirs(root):
        for n in sorted(os.listdir(d)):
            _equal_tree(J.parse_openpose_json(os.path.join(d, n)),
                        P.parse_openpose_json(os.path.join(d, n)))
        for native in (True, False):
            for nf in (None, 7):
                _equal_tree(J.load_openpose_dir(d, nf, use_native=native),
                            P.load_openpose_dir(d, nf, use_native=native))
        for nf in (None, 9):
            _equal_tree(J.read_posetrack_keypoints(d, nf),
                        P.read_posetrack_keypoints(d, nf))
        pose = P.load_openpose_dir(d)
        _equal_tree(J.flip_horizontal(pose, 640.0),
                    P.flip_horizontal(pose, 640.0))


def test_native_parser_bit_identical_to_json(raw):
    from nemo_tpu_torch.data.openpose import (openpose_json_paths,
                                              parse_openpose_json)
    from nemo_tpu_torch.ops.native import parse_openpose_batch_native
    for d in _op_dirs(raw[0]):
        paths = openpose_json_paths(d)
        for person in (0, 1):
            got = parse_openpose_batch_native(paths, person)
            want = np.stack([parse_openpose_json(p, person)
                             if len(json.load(open(p))["people"]) > person
                             else np.zeros((25, 3), np.float32)
                             for p in paths])
            assert np.array_equal(got, want)


def test_native_library_equals_jax(rng):
    from nemo_tpu.ops import native as J
    from nemo_tpu_torch.ops import native as P
    assert P.get_native() is not None and J.get_native() is not None
    assert P.build_native().startswith(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "build", "nemo_tpu_torch"))
    for n, m in ((60, 90), (1, 7), (257, 33)):
        a = rng.randn(n, 3).astype(np.float32)
        b = rng.randn(m, 3).astype(np.float32)
        _equal_tree(J.chamfer_forward_native(a, b),
                    P.chamfer_forward_native(a, b))


def test_gt_loaders_equal_jax(raw):
    import nemo_tpu.data.openpose as J
    import nemo_tpu_torch.data.openpose as P
    root, _, flags = raw
    gt_new = os.path.join(root, "exp", "view1.mp4_gt_new")
    for nf in (None, 5):
        _equal_tree(J.load_gt2d_pkl_dir(gt_new, nf),
                    P.load_gt2d_pkl_dir(gt_new, nf))
    for p in flags["--gt_cam_paths"].split(","):
        if not p.endswith(".npy"):
            _equal_tree(J.load_gt_camera_pt(p), P.load_gt_camera_pt(p))


def test_gt_camera_formats(tmp_path, rng):
    """The three camera formats give the same cam9; the torch file's focal
    as a 0-d or a 1-element tensor, or a float."""
    from nemo_tpu.data.openpose import load_gt_camera_pt as jax_load
    from nemo_tpu_torch.data.openpose import load_gt_camera_pt
    cam9 = rng.randn(9).astype(np.float32)
    np.testing.assert_array_equal(
        np.load(rl.write_camera(str(tmp_path / "c.npy"), cam9)), cam9)
    for name, focal in (("j.pkl", None), ("a.pt", torch.tensor(4321.0)),
                        ("b.pt", torch.tensor([4321.0])), ("c.pt", 4321.0)):
        path = str(tmp_path / name)
        if focal is None:
            rl.write_camera(path, cam9, 4321.0)
        else:
            torch.save((torch.from_numpy(cam9), focal), path)
        got = load_gt_camera_pt(path)
        _equal_tree(got, jax_load(path))
        assert np.array_equal(got[0], cam9) and got[1] == 4321.0


def test_penn_loaders_equal_jax(raw):
    import nemo_tpu.data.penn_action as J
    import nemo_tpu_torch.data.penn_action as P
    for mat in raw[2]["--penn_mats"].split(","):
        _equal_tree(J.load_penn_sequence(mat), P.load_penn_sequence(mat))
    from scipy.io import loadmat
    d = loadmat(mat)
    lab = {k: d[k] for k in ("x", "y", "visibility")}
    out = P.penn_gt_to_op(lab)
    _equal_tree(J.penn_gt_to_op(lab), out)
    # Penn's left shoulder feeds OP's RShoulder slot (2)
    assert np.array_equal(out[:, 2, 0], lab["x"][:, 1].astype(np.float32))


def _vibe_pickles(root):
    exp = os.path.join(root, "exp")
    return [os.path.join(exp, "view0.mp4_vibe", "vibe_output.pkl"),
            os.path.join(exp, "vibe", "view1.mp4", "vibe_output.pkl"),
            os.path.join(exp, "view2.mp4_vibe", "vibe_output.pkl")]


def test_vibe_loaders_equal_jax(raw):
    import joblib
    import nemo_tpu.data.vibe as J
    import nemo_tpu_torch.data.vibe as P
    from nemo_tpu_torch.data import load_openpose_dir
    root = raw[0]
    for v, pkl in enumerate(_vibe_pickles(root)):
        op = load_openpose_dir(_op_dirs(root)[v])
        T = op.shape[0]
        raw_d = joblib.load(pkl)
        for t in raw_d.values():
            _equal_tree(J.densify_person(t, T), P.densify_person(t, T))
        dense = {k: P.densify_person(t, T) for k, t in raw_d.items()}
        _equal_tree(J.select_person_near_gt(dense, op),
                    P.select_person_near_gt(dense, op))
        for gt in (op, None):
            jp = J.load_vibe_pickle(pkl, T, gt_2d=gt)
            pp = P.load_vibe_pickle(pkl, T, gt_2d=gt)
            _equal_tree(jp, pp)
            _equal_tree(P.load_vibe_pickle(raw_d, T, gt_2d=gt), pp)
            for fn in ("vibe_to_theta", "person_joints2d",
                       "vibe_render_arrays"):
                _equal_tree(getattr(J, fn)(jp), getattr(P, fn)(pp))
        assert P.select_person_near_gt({}, op) is None
        assert P.load_vibe_pickle({}, T) is None


@pytest.mark.parametrize("kind", ["vs", "pare", "glamr"])
def test_baseline_loaders_equal_jax(raw, kind):
    import nemo_tpu.data.vibe as J
    import nemo_tpu_torch.data.vibe as P
    from nemo_tpu_torch.data import load_openpose_dir
    root, _, flags = raw
    for v, pkl in enumerate(flags[f"--{kind}_pkls"].split(",")):
        op = load_openpose_dir(_op_dirs(root)[v])
        for T, gt in ((op.shape[0], op), (op.shape[0] + 3, None)):
            if gt is None:
                gt = np.concatenate([op, np.zeros((3, 25, 3), np.float32)])
            ja = J.load_baseline_arrays(pkl, T, kind, gt_2d=gt)
            pa = P.load_baseline_arrays(pkl, T, kind, gt_2d=gt)
            if kind == "pare":
                np.testing.assert_allclose(ja["theta"], pa["theta"], rtol=0,
                                           atol=PARE_ATOL)
                assert np.abs(pa["theta"][:, :69]).max() > 0.5
                ja = {k: w for k, w in ja.items() if k != "theta"}
                pa = {k: w for k, w in pa.items() if k != "theta"}
            _equal_tree(ja, pa)
        if kind != "pare":
            _equal_tree(J.load_baseline_pickle(pkl, T, kind, gt),
                        P.load_baseline_pickle(pkl, T, kind, gt))


def test_resampling_and_action_config_equal_jax(raw, rng):
    from nemo_tpu.data import bundle as J
    from nemo_tpu.utils import load_action_config as jax_cfg
    from nemo_tpu_torch.data import bundle as P
    from nemo_tpu_torch.utils import load_action_config
    arrs = [rng.randn(n, 4, 3).astype(np.float32) for n in (7, 12, 30)]
    for F in (1, 5, 12, 40):
        for start in (0.0, 0.1, 0.5):
            _equal_tree(J.resample_to_common_frames(arrs, F, start),
                        P.resample_to_common_frames(arrs, F, start))
            for n in (1, 7, 30):
                _equal_tree(J.resample_indices(n, F, start),
                            P.resample_indices(n, F, start))
    assert load_action_config(raw[1]) == jax_cfg(raw[1])


# ---------------------------------------------------------------------------
# the GT camera fit
# ---------------------------------------------------------------------------

def _camera_problem(seed=0, F=20):
    """World joints and their projections through a known camera near
    the default initialisation."""
    from nemo_tpu_torch.geometry.camera import (camera_from_params,
                                                perspective_projection)
    rng = np.random.RandomState(seed)
    j3 = (rng.randn(F, 25, 3) * [0.3, 0.8, 0.3]).astype(np.float32)
    ay, ax = 0.1, 0.05      # yaw and pitch of the true camera
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    c = np.concatenate([[0.2, -0.1, 9.0], (Ry @ Rx)[:, :2].reshape(6)]
                       ).astype(np.float32)
    cam = camera_from_params(torch.from_numpy(c)[None], 1000, 1900)
    j2 = perspective_projection(
        torch.from_numpy(j3), cam.rotation.expand(F, 3, 3),
        cam.translation.expand(F, 3), cam.focal_length.expand(F),
        cam.center.expand(F, 2)).numpy()
    conf = 0.5 + 0.5 * rng.rand(F, 25, 1)
    return j3, np.concatenate([j2, conf], -1).astype(np.float32)


@pytest.mark.parametrize("with_conf", [True, False])
def test_fit_gt_camera_equals_jax(with_conf):
    import jax.numpy as jnp
    from nemo_tpu.data.camera_fit import fit_gt_camera as jax_fit
    from nemo_tpu_torch.data.camera_fit import fit_gt_camera
    j3, j2 = _camera_problem()
    if not with_conf:
        j2 = j2[..., :2]
    jr = jax_fit(jnp.asarray(j3), jnp.asarray(j2), 1000.0, 1900.0,
                 num_steps=300)
    pr = fit_gt_camera(j3, j2, 1000.0, 1900.0, num_steps=300, device="cpu")
    jl, pl = np.asarray(jr["loss"]), pr["loss"].numpy()
    assert pl.shape == (300,) and pr["cam9"].shape == (9,)
    np.testing.assert_allclose(pl[:50], jl[:50], rtol=1e-5)
    np.testing.assert_allclose(pr["cam9"].numpy(), np.asarray(jr["cam9"]),
                               atol=1e-4)
    assert pl[-1] < 0.01 * pl[0]


def test_fit_gt_camera_init_and_device():
    from nemo_tpu_torch.data.camera_fit import fit_gt_camera
    j3, j2 = _camera_problem(1)
    init = np.array([0., 0., 9.5, 1., 0., 0., 1., 0., 0.], np.float32)
    a = fit_gt_camera(j3, j2, 1000.0, 1900.0, num_steps=5, init=init,
                      device="cpu")
    b = fit_gt_camera(j3, j2, 1000.0, 1900.0, num_steps=5,
                      init=torch.from_numpy(init), device="cpu")
    assert torch.equal(a["loss"], b["loss"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            fit_gt_camera(j3, j2, 1000.0, 1900.0, num_steps=1)


# ---------------------------------------------------------------------------
# video_tool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("names", [["a.mp4", "b.mp4"], ["tennis_swing.0"]])
def test_video_tool_commands_equal_jax(tmp_path, capsys, names):
    from nemo_tpu.cli.video_tool import main as jax_main
    from nemo_tpu_torch.cli.video_tool import main as port_main
    import yaml
    cfg = str(tmp_path / "nemo-config.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"exp_dir": str(tmp_path / "exps"),
                        "videos": {"names": names,
                                   "root_dir": str(tmp_path / "videos")}}, f)
    runs = [["frames", "--nemo_cfg_path", cfg, "--print_only"],
            ["frames", "--nemo_cfg_path", cfg, "--print_only", "--suffix",
             ""],
            ["openpose", "--nemo_cfg_path", cfg, "--print_only"],
            ["openpose", "--nemo_cfg_path", cfg, "--print_only", "--runtime",
             "singularity"],
            ["assemble", "--frame_dir", str(tmp_path / "fr"), "--out",
             str(tmp_path / "o.mp4"), "--fps", "25", "--print_only"]]
    for argv in runs:
        assert jax_main(argv) == 0
        want = capsys.readouterr().out
        assert port_main(argv) == 0
        got = capsys.readouterr().out
        assert got == want and got.strip()
        if argv[0] == "frames":
            assert os.path.join("exps", names[0]) in got


def test_video_module_equals_jax(tmp_path):
    from nemo_tpu.data import video as J
    from nemo_tpu_torch.data import video as P
    kw = dict(run=False)
    assert P.video_to_frames("v.mp4", str(tmp_path / "f"), fps=10, **kw) == \
        J.video_to_frames("v.mp4", str(tmp_path / "f"), fps=10, **kw)
    assert P.frames_to_video("d", "o.mp4", 24, **kw) == \
        J.frames_to_video("d", "o.mp4", 24, **kw)
    for rt in ("docker", "singularity"):
        assert P.openpose_command("i", "o", runtime=rt) == \
            J.openpose_command("i", "o", runtime=rt)
    with pytest.raises(ValueError):
        P.openpose_command("i", "o", runtime="podman")


def test_adam_bias_correction_is_optax_f32():
    """GroupAdam (the camera fit's and the fit's Adam) divides by optax's
    bias corrections: 1 - decay**count in f32. The double value, which it
    used before, is more than 1e-5 relative off; that moved the camera
    fit's loss history 1.5e-5 from JAX's within 50 steps."""
    import jax
    import jax.numpy as jnp
    import optax
    from nemo_tpu_torch.fit.optimizer import GroupAdam, bias_correction
    count = jnp.arange(1, 3001, dtype=jnp.int32)
    for decay in (0.9, 0.999):
        want = np.asarray(jax.jit(lambda c: 1 - decay ** c)(count))
        got = np.array([bias_correction(decay, k) for k in range(1, 3001)],
                       np.float32)
        assert np.array_equal(got, want)
        double = np.float32(1 - decay ** np.arange(1, 3001.0))
        if decay == 0.999:
            assert np.abs(double / want - 1).max() > 1e-5
    rng = np.random.RandomState(0)
    w0 = rng.randn(64).astype(np.float32)
    opt = optax.adam(1e-2)
    jw, state = jnp.asarray(w0), opt.init(jnp.asarray(w0))
    tw = torch.nn.Parameter(torch.tensor(w0))
    tadam = GroupAdam([tw], 1e-2)
    for _ in range(300):
        g = rng.randn(64).astype(np.float32)
        u, state = opt.update(jnp.asarray(g), state)
        jw = jw + u
        tw.grad = torch.tensor(g)
        tadam.step()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# joblib's file format without joblib (the CUDA machine has none)
# ---------------------------------------------------------------------------

def _pickle_objects():
    rng = np.random.RandomState(4)
    return {
        "tracklets": {1: {"pose": rng.randn(5, 72).astype(np.float32),
                          "frame_ids": np.arange(5),
                          "betas": rng.randn(5, 10)},
                      7: {"pose": np.zeros((0, 72), np.float32)}},
        "fortran_order": np.asfortranarray(rng.randn(4, 3)),
        "scalars": [np.float32(3.5), np.array(2.0), 7, "s", None],
        "object_array": np.array([{"a": 1}, None], dtype=object),
        "big_endian": np.arange(6, dtype=">f4").reshape(2, 3),
        "glamr": {"person_data": [{"smpl_pose": rng.randn(3, 69).astype(
            np.float32), "kp_2d": rng.rand(3, 25, 3)}]},
    }


@pytest.mark.parametrize("name", sorted(_pickle_objects()))
def test_joblib_format_without_joblib(tmp_path, monkeypatch, name):
    """utils.pickles writes joblib.dump's bytes, and reads joblib's files
    with joblib unimportable."""
    import joblib
    from nemo_tpu_torch.utils import pickles
    obj = _pickle_objects()[name]
    theirs, ours = str(tmp_path / "j.pkl"), str(tmp_path / "p.pkl")
    joblib.dump(obj, theirs)
    pickles.dump(obj, ours)
    assert open(theirs, "rb").read() == open(ours, "rb").read()
    want = joblib.load(theirs)
    monkeypatch.setitem(__import__("sys").modules, "joblib", None)
    _equal_tree(want, pickles.load(theirs))
    plain = str(tmp_path / "plain.pkl")
    with open(plain, "wb") as f:
        __import__("pickle").dump(obj, f)
    _equal_tree(want, pickles.load(plain))


def test_compressed_joblib_needs_joblib(tmp_path, monkeypatch):
    import joblib
    from nemo_tpu_torch.utils import pickles
    path = str(tmp_path / "c.pkl")
    joblib.dump({"x": np.arange(4.0)}, path, compress=3)
    _equal_tree({"x": np.arange(4.0)}, pickles.load(path))
    monkeypatch.setitem(__import__("sys").modules, "joblib", None)
    with pytest.raises(ImportError):
        pickles.load(path)
