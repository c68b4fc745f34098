"""VIBE's data layer in the port against nemo_tpu: the keypoint tables,
the sharded feed, the db builder, windowing and the 2D/3D mixed batch,
every dataset reader, the build_vibe_db CLI and extract_features.

The readers run on fixtures in each dataset's on-disk layout, written here
or by tests/test_vibe_readers.py's writers (its independent tf.Example
encoder, the PoseTrack tree). Both packages read the same files and give
the same db dicts, key for key and bit for bit: the readers are numpy on
the host in both. Exceptions, with their tolerances: H36M's moshed joints
through each package's smpl_forward (the port's K1 on its plain version
here), 1e-5 of the largest entry; ResNet-50 features (extract_features on
4 crops of 64 x 64, the raw He-init backbone), 1e-5 of the largest entry.
A db written
by either package reads back equal through joblib and through the port's
utils/pickles.
"""

import json
import os
import pickle

import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch
from scipy.io import savemat

from nemo_tpu.data import keypoints as jkp
from nemo_tpu.data import sharded as jsh
from nemo_tpu.data import vibe_db as jdb
from nemo_tpu.data import vibe_readers as jvr
from nemo_tpu_torch.data import keypoints as tkp
from nemo_tpu_torch.data import sharded as tsh
from nemo_tpu_torch.data import vibe_db as tdb
from nemo_tpu_torch.data import vibe_readers as tvr
from nemo_tpu_torch.utils import pickles
from test_vibe_readers import (_encode_example, _insta_example,
                               _posetrack_tree, _write_tfrecord)


def assert_same(a, b, what=""):
    """Equal nested dicts/lists of arrays: keys, dtypes, values."""
    if isinstance(a, dict):
        assert list(a) == list(b), (what, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)


# ---------------------------------------------------------------------------
# keypoint tables


def test_tables_equal():
    assert tkp.VOCAB == jkp.VOCAB
    assert tkp.POSETRACK_ORIGINAL_NAMES == jkp.POSETRACK_ORIGINAL_NAMES
    kp = np.random.RandomState(0).rand(3, 49, 3) * 200
    assert_same(tkp.keypoint_hflip(kp, 224), jkp.keypoint_hflip(kp, 224))


@pytest.mark.parametrize("src", sorted(jkp.VOCAB))
def test_convert_kps_every_pair(src):
    rng = np.random.RandomState(len(src))
    joints = rng.randn(2, 3, len(jkp.VOCAB[src]), 3).astype(np.float32)
    for dst in sorted(jkp.VOCAB):
        assert_same(tkp.conversion_index(src, dst),
                    jkp.conversion_index(src, dst), f"{src}->{dst}")
        assert tkp.get_perm_idxs(src, dst) == jkp.get_perm_idxs(src, dst)
        assert_same(tkp.convert_kps(joints, src, dst),
                    jkp.convert_kps(joints, src, dst), f"{src}->{dst}")


# ---------------------------------------------------------------------------
# sharded feed


def _rows(n=50, seed=0):
    rng = np.random.RandomState(seed)
    return {"features": rng.randn(n, 4, 8).astype(np.float32),
            "kp_2d": rng.randn(n, 4, 49, 3).astype(np.float32),
            "vid": np.arange(n, dtype=np.int64)}


def _same_dirs(a, b):
    with open(a / "index.json") as f, open(b / "index.json") as g:
        ia, ib = json.load(f), json.load(g)
    assert ia == ib
    for name in ia["shards"]:
        with np.load(a / name) as x, np.load(b / name) as y:
            assert_same(dict(x), dict(y), name)


def test_write_shards(tmp_path):
    rows = _rows()
    assert tsh.write_shards(rows, str(tmp_path / "t"), shard_size=7) == \
        jsh.write_shards(rows, str(tmp_path / "j"), shard_size=7) == 8
    _same_dirs(tmp_path / "t", tmp_path / "j")
    ds = tsh.ShardedDataset(str(tmp_path / "j"))
    assert len(ds) == 50 and ds.num_shards == 8
    assert list(ds.keys) == ["features", "kp_2d", "vid"]
    with pytest.raises(ValueError, match="leading dim"):
        tsh.write_shards({"a": np.zeros(3), "b": np.zeros(4)},
                         str(tmp_path / "x"))


@pytest.mark.parametrize("shuffle,epochs,batch",
                         [(True, 2, 6), (False, 1, 6), (True, None, 9)])
def test_batch_iterator_order(tmp_path, shuffle, epochs, batch):
    """JAX's batches in JAX's order: the seeded two-level shuffle, rows
    carried over shard boundaries, the short last batch dropped (forever
    with epochs=None: the first 15 batches)."""
    jsh.write_shards(_rows(), str(tmp_path), shard_size=7)
    its = [mod.batch_iterator(mod.ShardedDataset(str(tmp_path)), batch,
                              seed=3, epochs=epochs, shuffle=shuffle)
           for mod in (jsh, tsh)]
    n = 15 if epochs is None else None
    want = [b for _, b in zip(range(n or 10 ** 6), its[0])]
    got = [b for _, b in zip(range(n or 10 ** 6), its[1])]
    assert len(got) == len(want) == (n or epochs * (50 // batch))
    assert_same(got, want)
    assert all(b["vid"].shape == (batch,) for b in got)


# ---------------------------------------------------------------------------
# db builder, windows, the mixed feed


def test_builder_save_load_both_ways(tmp_path):
    dbs = []
    for mod in (jdb, tdb):
        rng = np.random.RandomState(1)
        b = mod.VibeDbBuilder()
        b.add_sequence("a", np.arange(5), rng.randn(5, 49, 3),
                       pose=rng.randn(5, 72), shape=rng.randn(10),
                       img_names=[f"{i}.jpg" for i in range(5)])
        b.add_sequence("b", np.arange(3), np.zeros((3, 49, 3)),
                       valid=np.array([1, 0, 1]))
        dbs.append(b)
    assert_same(dbs[1].build(), dbs[0].build())
    jdb_ = dbs[0].save(str(tmp_path / "j.pt"))
    tdb_ = dbs[1].save(str(tmp_path / "t.pt"))
    for path in ("j.pt", "t.pt"):
        assert_same(joblib.load(tmp_path / path), jdb_, path)
        assert_same(tdb.load_db(str(tmp_path / path)), tdb_, path)
        assert_same(pickles.load(str(tmp_path / path)), tdb_, path)
    with pytest.raises(ValueError, match="joints2D"):
        tdb.VibeDbBuilder().add_sequence("c", np.arange(2),
                                         np.zeros((2, 17, 3)))
    with pytest.raises(ValueError, match="empty"):
        tdb.VibeDbBuilder().build()


@pytest.mark.parametrize("stride", [None, 2, 5])
def test_make_windows(stride):
    vids = np.array(["a"] * 9 + ["b"] * 3 + ["c"] * 12 + ["a"] * 4)
    assert_same(tdb.make_windows(vids, 4, stride),
                jdb.make_windows(vids, 4, stride))
    assert_same(tdb.make_windows(vids[:3], 4), jdb.make_windows(vids[:3], 4))


def _b2d(n, seed):
    rng = np.random.default_rng(seed)
    return {"features": rng.standard_normal((n, 4, 16)).astype(np.float32),
            "kp_2d": rng.standard_normal((n, 4, 49, 3)).astype(np.float32)}


def _b3d(n, seed):
    b = _b2d(n, seed)
    rng = np.random.default_rng(seed + 100)
    b.update(kp_3d=rng.standard_normal((n, 4, 14, 3)).astype(np.float32),
             pose=rng.standard_normal((n, 4, 72)).astype(np.float32),
             betas=rng.standard_normal((n, 4, 10)).astype(np.float32))
    return b


def test_mixed_batches():
    for bs, ratio in ((32, 0.6), (32, 0.0), (8, 1.0), (5, 0.5)):
        assert tdb.split_2d3d_batch_sizes(bs, ratio) == \
            jdb.split_2d3d_batch_sizes(bs, ratio)
    assert tdb.split_2d3d_batch_sizes(32, 0.6) == (19, 13)
    for b2, b3 in ((_b2d(3, 0), _b3d(5, 1)), (None, _b3d(4, 2)),
                   (_b2d(4, 3), None)):
        assert_same(tdb.merge_2d3d_batch(b2, b3), jdb.merge_2d3d_batch(b2, b3))
    with pytest.raises(ValueError):
        tdb.merge_2d3d_batch(None, None)
    make2d = lambda: iter([_b2d(2, 4), _b2d(2, 5)])
    make3d = lambda: iter([_b3d(3, 6)] * 3)
    assert_same(list(tdb.mixed_2d3d_iterator(make2d, make3d, 7)),
                list(jdb.mixed_2d3d_iterator(make2d, make3d, 7)))
    assert_same(list(tdb.mixed_2d3d_iterator(None, make3d, 4)),
                list(jdb.mixed_2d3d_iterator(None, make3d, 4)))


# ---------------------------------------------------------------------------
# readers


def test_small_helpers():
    rng = np.random.RandomState(2)
    kp = rng.rand(6, 14, 3) * 300
    assert_same(tvr.bbox_from_kp2d(kp), jvr.bbox_from_kp2d(kp))
    assert_same(tvr.bbox_from_kp2d(kp[0]), jvr.bbox_from_kp2d(kp[0]))
    p2, p3 = rng.rand(4, 64) * 1000, rng.randn(4, 96) * 500
    assert_same(tvr.h36m_to_spin49(p2, p3), jvr.h36m_to_spin49(p2, p3))
    poses = 0.5 * rng.randn(4, 72)
    assert_same(tvr.mosh_slerp_upsample(poses), jvr.mosh_slerp_upsample(poses))
    assert_same(tvr.mosh_slerp_upsample(poses[:1], 3),
                jvr.mosh_slerp_upsample(poses[:1], 3))
    assert_same(tvr.flip_root_orient(poses), jvr.flip_root_orient(poses))
    args = (poses.astype(np.float32), rng.randn(4, 3).astype(np.float32),
            np.array([0.3, -0.2, 0.5]), np.array([1.0, 2.0, 3.0]))
    assert_same(tvr.apply_rigid_to_motion(*args),
                jvr.apply_rigid_to_motion(*args))
    j2d = np.concatenate([rng.rand(20, 49, 2) * 200,
                          rng.rand(20, 49, 1)], -1).astype(np.float32)
    j2d[5, :, 2] = 0        # no visible joints: the last params carry over
    assert_same(tvr.smooth_bbox_from_j2d(j2d), jvr.smooth_bbox_from_j2d(j2d))
    r6 = rng.randn(6)
    assert_same(tvr._rot6d_to_matrix_np(r6), jvr._rot6d_to_matrix_np(r6))


@pytest.mark.parametrize("unpacked", [False, True])
def test_tf_example_parser(tmp_path, unpacked):
    feats = {"meta/N": np.array([3], np.int64),
             "image/xys": np.arange(12, dtype=np.float32),
             "neg": np.array([-5, 7, 2 ** 40], np.int64),
             "blob": [b"abc", b"defg"]}
    path = str(tmp_path / "t.tfrecord")
    _write_tfrecord(path, [_encode_example(feats, unpacked)] * 2)
    recs = list(tvr.iter_tfrecord(path))
    assert recs == list(jvr.iter_tfrecord(path)) and len(recs) == 2
    assert_same(tvr.parse_tf_example(recs[0]), jvr.parse_tf_example(recs[0]))


def test_read_insta(tmp_path):
    rng = np.random.default_rng(2)
    split = tmp_path / "train"
    split.mkdir()
    _write_tfrecord(str(split / "a.tfrecord"),
                    [_encode_example(_insta_example(4, rng)[0]),
                     _encode_example(_insta_example(3, rng)[0])])
    _write_tfrecord(str(split / "b.tfrecord"),
                    [_encode_example(_insta_example(2, rng, phis=True)[0])])
    assert_same(tvr.read_insta(str(tmp_path)).build(),
                jvr.read_insta(str(tmp_path)).build())
    fn = lambda imgs, j2d: np.full((len(imgs), 2048), j2d.sum(), np.float32)
    path = str(split / "a.tfrecord")
    assert_same(tvr.read_insta_record(path, feature_fn=fn).build(),
                jvr.read_insta_record(path, feature_fn=fn).build())


def test_read_posetrack(tmp_path):
    folder = _posetrack_tree(tmp_path)
    assert_same(tvr.read_posetrack(folder, "train").build(),
                jvr.read_posetrack(folder, "train").build())


def test_read_mpii3d(tmp_path):
    rng = np.random.default_rng(5)
    F, n_vids = 10, 9
    for seq in (1, 2):
        annot2 = np.empty((n_vids, 1), object)
        annot3 = np.empty((n_vids, 1), object)
        for v in range(n_vids):
            a2 = rng.uniform(100, 1900, size=(F, 56))
            if v in (0, 3):
                a2[4, 8] = -50.0    # offscreen 'hip' splits the video
            annot2[v, 0] = a2
            annot3[v, 0] = rng.normal(0, 500, size=(F, 84))
        d = tmp_path / "S1" / f"Seq{seq}"
        os.makedirs(d)
        savemat(str(d / "annot.mat"), {"annot2": annot2, "annot3": annot3})
    kw = dict(user_list=[1, 2], seq_list=[1, 2])
    assert_same(tvr.read_mpii3d(str(tmp_path), **kw).build(),
                jvr.read_mpii3d(str(tmp_path), **kw).build())


def _amass_tree(root):
    rng = np.random.default_rng(6)
    for ds, subj, n in (("CMU", "01", 300), ("CMU", "02", 260),
                        ("KIT", "3", 500)):
        d = root / ds / subj
        os.makedirs(d, exist_ok=True)
        np.savez(d / f"{subj}_01_poses.npz", poses=rng.normal(size=(n, 156)),
                 trans=rng.normal(size=(n, 3)), betas=rng.normal(size=16),
                 mocap_framerate=np.array(100.0 if ds == "CMU" else 50.0))
    np.savez(root / "CMU" / "01" / "short_poses.npz",
             poses=np.zeros((100, 156)), trans=np.zeros((100, 3)),
             betas=np.zeros(16), mocap_framerate=np.array(100.0))
    np.savez(root / "CMU" / "01" / "xx_shape.npz", poses=np.zeros((2, 156)))


def test_read_amass(tmp_path):
    _amass_tree(tmp_path)
    assert_same(tvr.read_amass(str(tmp_path)), jvr.read_amass(str(tmp_path)))
    assert_same(tvr.read_amass(str(tmp_path), sequences=("SFU",)),
                jvr.read_amass(str(tmp_path), sequences=("SFU",)))


def _h36m_tree(root, F=30):
    rng = np.random.default_rng(8)
    base = root / "S1" / "MyPoseFeatures"
    os.makedirs(base / "D3_Positions_mono")
    os.makedirs(base / "D2_Positions")
    for name in ("Walking.54138969", "Eating 2.55011271", "_ALL.54138969"):
        np.savez(base / "D3_Positions_mono" / f"{name}.npz",
                 pose=rng.normal(0, 500, size=(F, 96)))
        np.savez(base / "D2_Positions" / f"{name}.npz",
                 pose=rng.uniform(0, 1000, size=(F, 64)))
    mosh = root / "mosh" / "neutrMosh" / "neutrSMPL_H3.6" / "S1"
    os.makedirs(mosh)
    with open(mosh / "Walking_cam0_aligned.pkl", "wb") as f:
        pickle.dump({"new_poses": 0.3 * rng.normal(size=(6, 72)),
                     "betas": rng.normal(size=10)}, f)


def test_read_h36m(tmp_path):
    _h36m_tree(tmp_path)
    assert_same(tvr.read_h36m(str(tmp_path), user_list=[1]).build(),
                jvr.read_h36m(str(tmp_path), user_list=[1]).build())
    kw = dict(user_list=[1], protocol_cameras=["55011271"], drop_tail=3)
    assert_same(tvr.read_h36m(str(tmp_path), **kw).build(),
                jvr.read_h36m(str(tmp_path), **kw).build())
    with pytest.raises(FileNotFoundError, match="cdflib"):
        tvr._default_cdf_pose(str(tmp_path / "missing.cdf"))


def test_read_h36m_smpl_joints(tmp_path):
    """Moshed joints from each package's smpl_forward (the port's FK
    through K1's plain version here), root-aligned to the GT hip."""
    from nemo_tpu.body import synthetic_smpl_model as jsyn
    from nemo_tpu.body.smpl import smpl_forward as jfwd
    from nemo_tpu_torch.body.assets import smpl_from_numpy
    from nemo_tpu_torch.body.smpl import smpl_forward as tfwd

    jsmpl = jsyn(num_vertices=96, seed=0)
    tsmpl = smpl_from_numpy(jsmpl)

    def jfn(pose, shape):
        return np.asarray(jfwd(jsmpl, jnp.asarray(shape[None]),
                               jnp.asarray(pose[None, 3:]),
                               jnp.asarray(pose[None, :3]),
                               pose2rot=True)[1][0])

    def tfn(pose, shape):
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)[None])
        return tfwd(tsmpl, t(shape), t(pose[3:]), t(pose[:3]),
                    pose2rot=True)[1][0].numpy()

    _h36m_tree(tmp_path, F=14)
    got = tvr.read_h36m(str(tmp_path), user_list=[1],
                        smpl_joints_fn=tfn).build()
    want = jvr.read_h36m(str(tmp_path), user_list=[1],
                         smpl_joints_fn=jfn).build()
    j_got, j_want = got.pop("joints3D"), want.pop("joints3D")
    assert_same(got, want)
    err = np.abs(j_got - j_want).max()
    assert err <= 1e-5 * np.abs(j_want).max(), err


def test_read_nemomocap(tmp_path):
    rng = np.random.default_rng(11)
    F = 6
    db_dir, mocap_root, cam_dir = (tmp_path / n for n in ("db", "mc", "cam"))
    for action, k in (("baseball_swing", 49), ("tennis_serve", 15),
                      ("golf_swing", 49)):
        vid = f"{action}.0.mp4"
        gt = db_dir / f"mymocap_{action}" / (vid + "_gt_new")
        os.makedirs(gt)
        for t in range(F):
            joblib.dump(rng.uniform(0, 500, size=(1, k, 2)).astype(
                np.float32), gt / f"{t + 1:06d}_keypoints.pkl")
        os.makedirs(mocap_root, exist_ok=True)
        joblib.dump({"fullpose": rng.normal(size=(F, 156)).astype(np.float32),
                     "betas": rng.normal(size=16).astype(np.float32),
                     "trans": rng.normal(size=(F, 3)).astype(np.float32)},
                    mocap_root / f"{action}.0.pkl")
    os.makedirs(cam_dir)
    for img in ("IMG_6287", "IMG_6289"):
        joblib.dump({"rot6d": rng.normal(size=6).astype(np.float32),
                     "tran": rng.normal(size=3).astype(np.float32),
                     "K": np.eye(3, dtype=np.float32) * 5000},
                    cam_dir / f"opt_cam_{img}_20230227.pt")
    fn = lambda p, b, t: np.tile(p[:3] + t, (49, 1)).astype(np.float32)
    for split in ("train", "val"):
        args = (str(db_dir), str(mocap_root), str(cam_dir), split)
        assert_same(tvr.read_nemomocap(*args, smpl_joints_fn=fn).build(),
                    jvr.read_nemomocap(*args, smpl_joints_fn=fn).build())
    assert_same(tvr.read_nemomocap(*args[:3]).build(),
                jvr.read_nemomocap(*args[:3]).build())


def _3dpw_tree(root):
    rng = np.random.default_rng(12)
    d = root / "sequenceFiles" / "train"
    os.makedirs(d)
    for name, people, F in (("courtyard_a_00", 2, 20), ("downtown_b", 1, 9)):
        p2d = rng.uniform(0, 1000, size=(people, F, 3, 18))
        p2d[:, :, 2] = rng.uniform(0, 1, size=(people, F, 18)) > 0.3
        data = {"poses": [0.2 * rng.normal(size=(F, 72))
                          for _ in range(people)],
                "betas": [rng.normal(size=300) for _ in range(people)],
                "poses2d": list(p2d)}
        if people > 1:
            data["campose_valid"] = [rng.uniform(size=F) > 0.2
                                     for _ in range(people)]
        with open(d / f"{name}.pkl", "wb") as f:
            pickle.dump(data, f, protocol=2)


def test_read_3dpw_and_penn_action(tmp_path):
    _3dpw_tree(tmp_path)
    assert_same(tdb.read_3dpw(str(tmp_path)).build(),
                jdb.read_3dpw(str(tmp_path)).build())
    labels = tmp_path / "penn" / "labels"
    os.makedirs(labels)
    rng = np.random.default_rng(13)
    for vid, F in (("0001", 20), ("0002", 7)):
        vis = np.ones((F, 13))
        vis[2, :] = 0           # a frame without a visible joint
        savemat(str(labels / f"{vid}.mat"),
                {"x": rng.uniform(10, 100, size=(F, 13)),
                 "y": rng.uniform(10, 100, size=(F, 13)), "visibility": vis})
    assert_same(tdb.read_penn_action(str(tmp_path / "penn")).build(),
                jdb.read_penn_action(str(tmp_path / "penn")).build())


# ---------------------------------------------------------------------------
# build_vibe_db


@pytest.mark.parametrize("dataset", ["3dpw", "amass"])
def test_build_vibe_db_cli(tmp_path, dataset, capsys):
    """Both CLIs on one raw tree: the db each writes reads back equal
    through joblib and utils/pickles, the shard directories are equal,
    and so are the lines they print."""
    from nemo_tpu.cli import build_vibe_db as jcli
    from nemo_tpu_torch.cli import build_vibe_db as tcli

    raw = tmp_path / "raw"
    (_3dpw_tree if dataset == "3dpw" else _amass_tree)(raw)
    outs = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        assert cli.main(["--dataset", dataset, "--dir", str(raw),
                         "--out", str(tmp_path / f"{name}.pt"),
                         "--shards_out", str(tmp_path / f"{name}_shards"),
                         "--seqlen", "8", "--shard_size", "3"]) == 0
        outs[name] = capsys.readouterr().out.replace(name, "X")
    assert outs["port"] == outs["jax"]
    want = joblib.load(tmp_path / "jax.pt")
    for path in ("jax.pt", "port.pt"):
        assert_same(joblib.load(tmp_path / path), want, path)
        assert_same(pickles.load(str(tmp_path / path)), want, path)
    _same_dirs(tmp_path / "port_shards", tmp_path / "jax_shards")
    assert len(tsh.ShardedDataset(str(tmp_path / "port_shards"))) > 0


# ---------------------------------------------------------------------------
# extract_features


def test_extract_features():
    """ResNet-50 features of 4 tracked crops (64 x 64 out of frames of
    80 x 96), the port's backbone on the CPU against JAX's on the same
    weights, within 1e-5 of the largest entry. The backbone is the raw
    He-init draw: batch norms calibrated on four crops (as
    test_torch_port_vibe_models does for the regressor's sake) divide by
    variances of 16 values a channel at the last stage and leave either
    package's float32 features 1.4e-4 from a float64 evaluation of the
    same network; the raw draw's are within 1e-6 of it."""
    import jax

    from nemo_tpu.models import hmr as jhmr
    from nemo_tpu_torch.models import hmr as thmr
    from nemo_tpu_torch.models import resnet as tresnet
    from nemo_tpu_torch.utils import asset_files as af

    rng = np.random.RandomState(3)
    frames = [(rng.rand(80, 96, 3) * 255).astype(np.uint8) for _ in range(4)]
    bboxes = np.array([[48, 40, 40, 50], [50, 42, 44, 52], [46, 38, 30, 60],
                       [44, 41, 60, 40]], np.float32)
    backbone = tresnet.init_resnet50(torch.Generator().manual_seed(0))
    jb, _ = jhmr.convert_torch_hmr(af.spin_state_dict(
        backbone, thmr.init_hmr_head(torch.Generator().manual_seed(1))))
    ported = tresnet.resnet50_from_jax(jb)
    got = tdb.extract_features(ported, frames, bboxes, batch_size=3,
                               out_res=64)
    want = jdb.extract_features(jax.tree.map(jnp.asarray, jb), frames,
                                bboxes, batch_size=3, out_res=64)
    assert got.shape == want.shape == (4, 2048)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
