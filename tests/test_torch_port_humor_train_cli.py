"""HuMoR training through the port's humor_tool on the CPU, against
nemo_tpu's: the AMASS training windows (amass_world_states and
amass_state_windows exact, canonicalize_windows within 1e-5,
load_amass_windows on a tree from the port's process-amass within 1e-5),
``train --device cpu`` from all three feeds (--synthetic with scheduled
sampling, --amass supervised, --shards) with the JAX CLI's JSONL keys and
npz names and shapes, a JAX-trained humor_params.npz through the port's
fit-amass and the port's through JAX's loader and rollout (within rtol
1e-5), ``train-state-prior`` from a seeded mixture and from --states, and
both parsers' flags and defaults.

The processed tree comes from a 120 fps synthetic walk (the JAX CLI
test's) on the 150-vertex synthetic body written as an SMPL .npz; the
HuMoR network is at the reference widths (HumorConfig's), on a few
windows of a few frames.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.cli import humor_tool as jtool
from nemo_tpu.data import amass_process as jamass
from nemo_tpu.models import humor as jh
from nemo_tpu.models import humor_fit as jfit
from nemo_tpu_torch import data as tdata
from nemo_tpu_torch.body.assets import synthetic_smpl_model
from nemo_tpu_torch.cli import humor_tool as ttool
from nemo_tpu_torch.data import amass_process as tamass
from nemo_tpu_torch.models import humor as th
from nemo_tpu_torch.models import humor_fit as tfit
from nemo_tpu_torch.utils import asset_files

torch.set_num_threads(2)


def _raw_walk(T=360, seed=0):
    """The JAX CLI test's swaying walk at 120 fps; process-amass keeps 71
    frames of 360."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, T)[:, None]
    poses = np.zeros((T, 156))
    poses[:, :3] = 0.2 * np.stack(
        [np.sin(t[:, 0]), np.cos(t[:, 0]), 0 * t[:, 0]], 1)
    poses[:, 3:66] = 0.15 * np.sin(t + rng.uniform(0, np.pi, (1, 63)))
    trans = np.stack([0.3 * t[:, 0], 0.1 * np.sin(t[:, 0]), np.zeros(T)], 1)
    return dict(poses=poses, trans=trans, betas=rng.standard_normal(16) * 0.3,
                gender=np.array("neutral"), mocap_framerate=np.array(120.0))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A processed AMASS tree (two training walks in CMU, one test walk in
    HumanEva) from the port's process-amass on the 150-vertex body."""
    root = tmp_path_factory.mktemp("amass")
    for ds, seeds in (("CMU", (0, 1)), ("HumanEva", (2,))):
        for s in seeds:
            d = root / "raw" / ds / f"S{s}"
            d.mkdir(parents=True)
            np.savez(d / "walk_poses.npz", **_raw_walk(seed=s))
    smpl = asset_files.write_smpl_npz(
        str(root / "SMPL_NEUTRAL.npz"), asset_files.smpl_file_arrays(
            synthetic_smpl_model(150, device="cpu")))
    proc = str(root / "proc")
    assert ttool.main(["process-amass", "--amass_root", str(root / "raw"),
                       "--out", proc, "--smpl_path", smpl,
                       "--device", "cpu"]) == 0
    return root, proc, smpl


def _seq(proc):
    path = os.path.join(proc, "CMU", "S0",
                        "walk_poses_71_frames_30_fps.npz")
    return dict(np.load(path, allow_pickle=True))


# ---------------------------------------------------------------------------
# the training windows


def test_world_states_and_windows_exact(tree):
    _, proc, _ = tree
    seq = _seq(proc)
    np.testing.assert_array_equal(tamass.amass_world_states(seq),
                                  jamass.amass_world_states(seq))
    for n, stride in ((11, 10), (5, 1), (200, 3)):
        got = tamass.amass_state_windows(seq, n, stride)
        np.testing.assert_array_equal(
            got, jamass.amass_state_windows(seq, n, stride))
    assert tamass.amass_state_windows(seq, 200, 3).shape == (0, 200, 207)


def test_canonicalize_windows(tree):
    _, proc, _ = tree
    w = tamass.amass_state_windows(_seq(proc), 11, 10)
    got = tamass.canonicalize_windows(w, device="cpu")
    want = jamass.canonicalize_windows(w)
    assert got.shape == w.shape == (7, 11, 207)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(
        want).max())


@pytest.mark.parametrize("split,max_windows,canon", [
    ("train", 0, True), ("all", 9, True), ("train", 0, False)])
def test_load_amass_windows(tree, split, max_windows, canon):
    _, proc, _ = tree
    got = tamass.load_amass_windows(proc, 6, split=split, stride=5,
                                    canonicalize=canon,
                                    max_windows=max_windows)
    want = jamass.load_amass_windows(proc, 6, split=split, stride=5,
                                     canonicalize=canon,
                                     max_windows=max_windows)
    assert got.shape == want.shape and got.shape[0] > 0
    if max_windows:
        assert got.shape[0] == max_windows
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(
        want).max())
    assert tdata.load_amass_windows is tamass.load_amass_windows


# ---------------------------------------------------------------------------
# train


TINY = ["--epochs", "2", "--batch_size", "4", "--seq_len", "3"]


@pytest.fixture(scope="module")
def jax_runs(tree, tmp_path_factory):
    """The JAX CLI's train runs the port's are held to: --synthetic with
    scheduled sampling and a milestone, and --amass supervised."""
    _, proc, _ = tree
    out = tmp_path_factory.mktemp("jax_train")
    runs = {"synthetic": ["--synthetic", "8", "--sched_samp_start", "0",
                          "--sched_samp_end", "1", "--sched_milestones",
                          "1"],
            "amass": ["--amass", proc, "--amass_stride", "10"]}
    for name, argv in runs.items():
        assert jtool.main(["train", "--out", str(out / name)] + TINY
                          + argv) == 0
    return out, runs


def _rows(d):
    with open(os.path.join(d, "train_stats.jsonl")) as f:
        return [json.loads(line) for line in f]


def _npz_layout(d):
    with np.load(os.path.join(d, "humor_params.npz")) as f:
        return {k: (f[k].shape, f[k].dtype) for k in f.files}


def _check_like_jax(port_dir, jax_dir):
    rows, jrows = _rows(port_dir), _rows(jax_dir)
    assert len(rows) == len(jrows) == 2
    assert [list(r) for r in rows] == [list(r) for r in jrows]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert all(r["update_skipped"] == 0.0 for r in rows)
    assert _npz_layout(port_dir) == _npz_layout(jax_dir)
    return rows


def test_train_synthetic_scheduled_cpu(jax_runs, tmp_path, capsys):
    jout, runs = jax_runs
    out = str(tmp_path / "port")
    assert ttool.main(["train", "--out", out, "--device", "cpu"] + TINY
                      + runs["synthetic"]) == 0
    rows = _check_like_jax(out, str(jout / "synthetic"))
    assert rows[1]["lr"] == pytest.approx(rows[0]["lr"] * 0.1, rel=1e-6)
    text = capsys.readouterr().out
    assert "[humor-train] epoch 1: loss=" in text and "params ->" in text


def test_train_amass_supervised_cpu(tree, jax_runs, tmp_path, capsys):
    _, proc, _ = tree
    jout, runs = jax_runs
    out = str(tmp_path / "port")
    assert ttool.main(["train", "--out", out, "--device", "cpu"] + TINY
                      + runs["amass"]) == 0
    _check_like_jax(out, str(jout / "amass"))
    assert "14 AMASS windows (train, T=4)" in capsys.readouterr().out


def test_train_shards_cpu(tree, jax_runs, tmp_path):
    """--shards: rows of (T+1)-frame windows under key 'states', written
    by data/sharded.write_shards."""
    jout, _ = jax_runs
    _, proc, _ = tree
    w = tamass.load_amass_windows(proc, 4, stride=10)
    tdata.write_shards({"states": w}, str(tmp_path / "shards"),
                       shard_size=5)
    out = str(tmp_path / "port")
    assert ttool.main(["train", "--out", out, "--device", "cpu",
                       "--shards", str(tmp_path / "shards")] + TINY) == 0
    _check_like_jax(out, str(jout / "amass"))


def test_train_empty_amass_tree(tmp_path, capsys):
    assert ttool.main(["train", "--out", str(tmp_path / "o"), "--amass",
                       str(tmp_path), "--device", "cpu"]) == 1
    assert "no windows found" in capsys.readouterr().out


def test_jax_params_into_port_fit_amass(tree, jax_runs, tmp_path):
    """A humor_params.npz trained by the JAX CLI loads through the port's
    _humor_params bit for bit and drives the port's fit-amass."""
    root, proc, smpl = tree
    jout, _ = jax_runs
    npz = str(jout / "synthetic" / "humor_params.npz")
    hp = ttool._humor_params(npz, th.HumorConfig(), 0, "cpu")
    with np.load(npz) as f:
        for name in f.files:
            m, k = name.split(".", 1)
            np.testing.assert_array_equal(hp[m][k].numpy(), f[name])
    out = str(tmp_path / "fit")
    assert ttool.main(["fit-amass", "--amass", proc, "--out", out,
                       "--seq_len", "8", "--obs", "joints", "--steps", "1",
                       "1", "1", "--smpl_path", smpl, "--humor_ckpt", npz,
                       "--no_eval", "--device", "cpu"]) == 0
    res = os.listdir(os.path.join(out, "results_out"))
    assert len(res) == 1


def test_port_params_into_jax_loader(tree, jax_runs, tmp_path):
    """The reverse: the port's humor_params.npz through the JAX CLI's
    _load_humor_params, bit for bit; JAX's rollout on it equals the
    port's on its own file within rtol 1e-5."""
    out = str(tmp_path / "port")
    assert ttool.main(["train", "--out", out, "--device", "cpu",
                       "--synthetic", "4", "--epochs", "1",
                       "--batch_size", "4", "--seq_len", "2"]) == 0
    npz = os.path.join(out, "humor_params.npz")
    jp = jtool._load_humor_params(npz, jh.HumorConfig(), None)
    tp = ttool._humor_params(npz, th.HumorConfig(), 0, "cpu")
    for m, sub in tp.items():
        for k, v in sub.items():
            np.testing.assert_array_equal(np.asarray(jp[m][k]), v.numpy())
    x0 = (np.random.default_rng(0).standard_normal((2, 207)) * 0.3).astype(
        np.float32)
    want = np.asarray(jh.humor_roll_out(jp, jh.HumorConfig(),
                                        jnp.asarray(x0), 3,
                                        use_mean=True)["states"])
    got = th.humor_roll_out(tp, th.HumorConfig(), torch.from_numpy(x0), 3,
                            use_mean=True)["states"].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_train_needs_a_card_unless_cpu(tmp_path):
    """--device defaults to cuda, which refuses to run without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttool.main(["train", "--out", str(tmp_path / "o"), "--synthetic",
                    "4"])


# ---------------------------------------------------------------------------
# train-state-prior and the parsers


@pytest.mark.parametrize("states", [False, True])
def test_train_state_prior_cpu(tmp_path, capsys, states):
    """The synthetic mixture from --seed, or a --states .npy: the fitted
    shapes printed as the JAX CLI prints them, prior_gmm.npz in float64,
    loading through both packages' load_init_motion_prior."""
    argv = ["--gmm_comps", "3", "--iters", "10", "--synthetic", "300"]
    if states:
        x = (np.random.default_rng(1).standard_normal((400, 138))).astype(
            np.float32)
        np.save(tmp_path / "s.npy", x)
        argv += ["--states", str(tmp_path / "s.npy")]
    texts = {}
    for name, mod, extra in (("port", ttool, ["--device", "cpu"]),
                             ("jax", jtool, [])):
        assert mod.main(["train-state-prior", "--out", str(tmp_path / name)]
                        + argv + extra) == 0
        texts[name] = capsys.readouterr().out.splitlines()
    assert texts["port"][:4] == texts["jax"][:4]
    assert texts["port"][1:4] == ["(3,)", "(3, 138)", "(3, 138, 138)"]
    assert texts["port"][4].startswith("[state-prior] mean log-lik ")
    path = str(tmp_path / "port" / "prior_gmm.npz")
    with np.load(path) as f:
        assert {k: f[k].dtype for k in f.files} == dict.fromkeys(
            ("weights", "means", "covariances"), np.float64)
    tp = tfit.load_init_motion_prior(path)
    jp = jfit.load_init_motion_prior(path)
    s = np.random.default_rng(2).standard_normal(138).astype(np.float32)
    a = float(tfit.init_state_gmm_nll(torch.from_numpy(s), tp))
    b = float(jfit.init_state_gmm_nll(jnp.asarray(s), jp))
    assert np.isfinite(a) and a == pytest.approx(b, rel=1e-5)


@pytest.mark.parametrize("cmd", ["train", "train-state-prior"])
def test_parser_flags_match_jax(cmd):
    """Every flag of the JAX subcommand, with its default, plus --device
    (default cuda)."""
    def flags(parser, extra):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return {a.dest: a.default for a in sub.choices[cmd]._actions
                if a.dest != "help"}
    port, jax_ = flags(ttool.build_parser(), 0), flags(jtool.build_parser(),
                                                       0)
    assert port.pop("device") == "cuda"
    assert port == jax_
