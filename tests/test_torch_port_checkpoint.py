"""Fit checkpoints and the CLI's resume and render outputs, on the CPU.

- A port checkpoint restores a fresh port fitter bit for bit (parameters,
  Adam moments and counts, plateau states, step and batch generator), so
  the resumed fit continues the same batch stream.
- A checkpoint that nemo_tpu's save_fit_state wrote loads into the port,
  and the port's next main steps on JAX's replayed batches match JAX's
  within ROADMAP's trajectory tolerance (rtol 1e-4 for 5 steps).
- ``--test --load_ckpt_path`` reproduces the first run's final eval, and
  on the JAX CLI's checkpoint the JAX run's final eval (rtol 1e-4).
- A tiny render run writes every file the JAX CLI writes, and without
  matplotlib names each figure it skips and still renders the meshes.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nemo_tpu import fit as jfit
from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.data import synthetic_problem as jax_synthetic_problem
from nemo_tpu.fit.loop import _sample_batch
from nemo_tpu.priors import synthetic_gmm_prior as jax_synthetic_gmm
from nemo_tpu.utils.checkpoint import (_flatten_with_paths,
                                       save_fit_state as jax_save_fit_state)
from nemo_tpu_torch import fit as tfit
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.priors.gmm import gmm_from_numpy
from nemo_tpu_torch.utils.checkpoint import (load_fit_state,
                                             load_saved_config,
                                             save_fit_state)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, F, B = 2, 12, 16


def _cfg(**over):
    return jfit.NemoConfig(**{**dict(
        model_version=2, h_dim=32, instance_code_size=4, phase_rbf_dim=8,
        rbf_kernel="quadratic", monotonic_network_n_nodes=4, batch_size=B,
        weight_gmm_loss=0.5, label_type="gt", lr_factor=0.5, n_steps=4,
        warmup_step=3, opt_cam_step=3), **over})


@pytest.fixture(scope="module")
def problem():
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    bundle, _ = jax_synthetic_problem(jm, num_views=V, num_frames=F, seed=0)
    gmm = jax_synthetic_gmm(4)
    return dict(jm=jm, bundle=bundle, gmm=gmm, tsmpl=smpl_from_numpy(jm),
                tgmm=gmm_from_numpy(gmm.means, gmm.precisions,
                                    gmm.nll_weights))


def _port_fitter(pb, cfg, **kw):
    tcfg = tfit.NemoConfig(**dataclasses.asdict(cfg))
    assets = tfit.build_assets(pb["bundle"], pb["tsmpl"], tcfg,
                               gmm=pb["tgmm"], device="cpu")
    return tfit.NemoFitter(tcfg, assets, seed=0, **kw)


def _state(f):
    """Everything a checkpoint holds, as comparable numpy/python values."""
    out = {f"p/{k}": v.detach().numpy().copy()
           for k, v in f.params.named_parameters()}
    for g, adam in f.optimizer.groups.items():
        out[f"count/{g}"] = adam.count
        for i, (m, v) in enumerate(zip(adam.m, adam.v)):
            out[f"m/{g}/{i}"] = m.numpy().copy()
            out[f"v/{g}/{i}"] = v.numpy().copy()
    for g, s in f.plateau.items():
        for field in s._fields:
            out[f"plateau/{g}/{field}"] = getattr(s, field).numpy().copy()
    out["step"] = f.step
    out["generator"] = f.generator.get_state().numpy().copy()
    return out


@pytest.mark.parametrize("opt_human,wd", [("adam", 0.0), ("adam", 1e-3)])
def test_port_round_trip_is_bit_exact(problem, tmp_path, opt_human, wd):
    cfg = _cfg(opt_human=opt_human, wd_human=wd)
    a = _port_fitter(problem, cfg)
    a.warmup(), a.opt_cam(), a.fit(3, chunk=3)
    save_fit_state(str(tmp_path), a, a.cfg)
    assert load_saved_config(str(tmp_path)) == dataclasses.asdict(a.cfg)
    b = _port_fitter(problem, cfg)
    assert load_fit_state(str(tmp_path), b)
    sa, sb = _state(a), _state(b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)
    ma, mb = a.fit(3, chunk=3), b.fit(3, chunk=3)
    for k in ma:
        np.testing.assert_array_equal(mb[k], ma[k], err_msg=k)


@pytest.mark.parametrize("opt_human", ["adam", "adamw"])
def test_jax_checkpoint_resumes_in_port(problem, tmp_path, opt_human):
    """JAX fits N main steps and saves; the port loads the checkpoint and
    takes JAX's next 5 batches. Weight decay puts Adam at index 1 of the
    optax chain for 'adam' and at 0 for 'adamw'."""
    N, M = 4, 5
    cfg = _cfg(opt_human=opt_human, wd_human=1e-3)
    jassets = jfit.build_assets(problem["bundle"], problem["jm"], cfg,
                                gmm=problem["gmm"])
    jf = jfit.NemoFitter(cfg, jassets, seed=0)
    jf.warmup(), jf.opt_cam(), jf.fit(N, chunk=N)
    jax_save_fit_state(str(tmp_path), jf.state, cfg)
    key, batches = jf.state.key, {}
    for i in range(M):          # fit/loop.py's main-stage key threading
        key, k1, _ = jax.random.split(key, 3)
        batches[N + i] = tuple(np.asarray(a) for a in
                               _sample_batch(k1, B, V, F))
    want = jf.fit(M, chunk=M)

    tf = _port_fitter(problem, cfg,
                      batch_source=lambda stage, i: batches[i])
    assert not load_fit_state(str(tmp_path), tf)   # no port generator state
    assert tf.step == N
    got = tf.fit(M, chunk=M)
    for k in ("total_loss", "kp_loss", "gmm_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for g, s in tf.plateau.items():
        assert float(s.scale) == float(jf.state.plateau[g].scale), g


def test_jax_checkpoint_params_and_moments_load(problem, tmp_path):
    """Every parameter, moment, count and plateau value of a JAX checkpoint
    arrives in the port unchanged."""
    cfg = _cfg(wd_human=1e-3)
    jassets = jfit.build_assets(problem["bundle"], problem["jm"], cfg,
                                gmm=problem["gmm"])
    jf = jfit.NemoFitter(cfg, jassets, seed=0)
    jf.warmup(), jf.opt_cam(), jf.fit(3, chunk=3)
    jax_save_fit_state(str(tmp_path), jf.state, cfg)
    tf = _port_fitter(problem, cfg)
    load_fit_state(str(tmp_path), tf)
    want = _flatten_with_paths(jf.state.params)
    for k, p in tf.params.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      want[k.replace(".", "/")], err_msg=k)
    opt = _flatten_with_paths(jf.state.opt_state)
    motion = tf.optimizer.groups["motion"]
    names = [n.replace(".", "/")
             for n, _ in tf.params.motion.named_parameters()]
    assert motion.count == int(opt["motion/1/.count"]) == 3 + 3
    for n, m, v in zip(names, motion.m, motion.v):
        np.testing.assert_array_equal(m.numpy(), opt[f"motion/1/.mu/{n}"])
        np.testing.assert_array_equal(v.numpy(), opt[f"motion/1/.nu/{n}"])
    cams = tf.optimizer.groups["cameras"]
    np.testing.assert_array_equal(cams.m[0].numpy(), opt["cameras/0/.mu"])
    plat = _flatten_with_paths(jf.state.plateau)
    for g, s in tf.plateau.items():
        assert float(s.best) == float(plat[f"{g}/.best"])
        assert int(s.num_bad) == int(plat[f"{g}/.num_bad"])


FLAGS = ["--synthetic_assets", "--model_version", "2", "--phase_rbf_dim", "8",
         "--rbf_kernel", "quadratic", "--h_dim", "16",
         "--monotonic_network_n_nodes", "4", "--instance_code_size", "4",
         "--batch_size", "16", "--n_steps", "4", "--warmup_step", "1",
         "--opt_cam_step", "1", "--save_every", "2", "--label_type", "gt",
         "--loss", "mse_robust", "--weight_gmm_loss", "0.5"]


def _final(run_dir):
    lines = [json.loads(x) for x in open(os.path.join(run_dir,
                                                      "metrics.jsonl"))]
    assert lines[-1]["phase"] == "final"
    return lines[-1]


def test_cli_test_mode_reproduces_final_eval(tmp_path, capsys):
    from nemo_tpu_torch.cli.fit import main
    assert main(FLAGS + ["--device", "cpu", "--out_dir",
                         str(tmp_path)]) == 0
    first = tmp_path / "000000"
    ckpt = first / "ckpt" / "sd_000004"
    assert (first / "ckpt" / "sd_000002" / "params.npz").is_file()
    # the model flags come back from the checkpoint's config
    assert main(["--synthetic_assets", "--device", "cpu", "--test",
                 "--load_ckpt_path", str(ckpt), "--out_dir",
                 str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "restored model config from checkpoint" in out
    assert "at step 4" in out
    second = tmp_path / "000001"
    assert _final(second)["kp_loss"] == _final(first)["kp_loss"]
    assert [json.loads(x)["phase"] for x in open(second / "metrics.jsonl")] \
        == ["final"]


def _tiny_bundle(path):
    """A 2-view, 8-frame synthetic problem at 120 x 160 pixels, with the
    VIBE slots the baseline rollout reads."""
    jm = jax_synthetic_smpl()
    bundle, _ = jax_synthetic_problem(jm, num_views=2, num_frames=8,
                                      img_hw=(120, 160), seed=0)
    rng = np.random.RandomState(0)
    bundle.vibe_orient = (0.1 * rng.randn(2, 8, 3)).astype(np.float32)
    bundle.vibe_betas = np.zeros((2, 10), np.float32)
    cam = np.tile(np.float32([0.5, 0.5 * 160 / 120, 0.0, 0.1]), (2, 8, 1))
    bundle.vibe_cam = cam
    bundle.save(path)


def _files(root):
    """Relative output paths, with an mp4 and its .frames fallback alike."""
    out = set()
    for d, _, names in os.walk(root):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), root)
            out.add(rel.replace(".mp4.frames", ".mp4[frames]"))
    return out


def test_cli_render_outputs_match_jax_cli(tmp_path):
    from nemo_tpu.cli.fit import main as jax_main
    bundle = str(tmp_path / "tiny.npz")
    _tiny_bundle(bundle)
    flags = FLAGS + ["--bundle", bundle, "--render_video", "4",
                     "--render_rollout_figure", "--render_every", "2"]
    assert jax_main(flags + ["--out_dir", str(tmp_path / "jax")]) == 0
    code = ("import sys, torch\n"
            "torch.set_num_threads(2)\n"
            "from nemo_tpu_torch.cli.fit import main\n"
            "rc = main(sys.argv[1:])\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
            " ('jax', 'jaxlib', 'optax', 'nemo_tpu'))\n"
            "assert not bad, bad\n"
            "sys.exit(rc)\n")
    out = subprocess.run(
        [sys.executable, "-c", code, *flags, "--device", "cpu", "--out_dir",
         str(tmp_path / "port")], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    jfiles = _files(tmp_path / "jax" / "000000")
    tfiles = _files(tmp_path / "port" / "000000")
    # the JAX checkpoint has key.npy, the port's generator.npy
    jfiles = {f for f in jfiles if not f.endswith("key.npy")}
    tfiles = {f for f in tfiles if not f.endswith("generator.npy")}
    assert tfiles == jfiles, (sorted(tfiles - jfiles), sorted(jfiles - tfiles))
    for name in ("mesh_rollout.mp4", "rollout_figure.png",
                 "comparison_view0.png", "vibe_rollout.png",
                 "rollout_000002.png", "phases.png", "overlay.png"):
        assert any(f.startswith(name) for f in tfiles), name
    # the JAX run's last checkpoint through the port's --test: its config
    # and parameters come back, and the batch stream restarts from --seed
    out = subprocess.run(
        [sys.executable, "-c", code, "--synthetic_assets", "--bundle",
         bundle, "--device", "cpu", "--test", "--load_ckpt_path",
         str(tmp_path / "jax" / "000000" / "ckpt" / "sd_000004"),
         "--out_dir", str(tmp_path / "port")], cwd=REPO,
        capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "restored model config from checkpoint" in out.stdout
    assert "restarts from --seed" in out.stdout
    np.testing.assert_allclose(
        _final(tmp_path / "port" / "000001")["kp_loss"],
        _final(tmp_path / "jax" / "000000")["kp_loss"], rtol=1e-4)


def test_cli_without_matplotlib_renders_meshes(tmp_path, monkeypatch, capsys):
    """Where matplotlib is missing (the GPU machine) the CLI names each
    matplotlib figure it skips and still writes the mesh renders."""
    import importlib.util
    from nemo_tpu_torch.cli.fit import main
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None
                        if name == "matplotlib" else find_spec(name, *a))
    bundle = str(tmp_path / "tiny.npz")
    _tiny_bundle(bundle)
    assert main(FLAGS + ["--bundle", bundle, "--render_video", "4",
                         "--render_rollout_figure", "--render_every", "2",
                         "--device", "cpu", "--out_dir",
                         str(tmp_path / "out")]) == 0
    out = capsys.readouterr().out
    run = tmp_path / "out" / "000000"
    files = _files(run)
    skipped = {line.rsplit(" ", 1)[-1] for line in out.splitlines()
               if "matplotlib is not installed: skipped" in line}
    for name in ("phases.png", "kp_loss.png", "rollout_000002.png",
                 "rollout.png", "eval_2d_grid.png", "overlay.mp4",
                 "overlay.png", "dynamic/v0_vel.png"):
        assert str(run / name) in skipped, name
        assert not any(f.startswith(name) for f in files), name
    for name in ("mesh_rollout.mp4", "rollout_figure.png",
                 "comparison_view0.png", "vibe_rollout.png",
                 "eval_3d_global.csv"):
        assert any(f.startswith(name) for f in files), name
