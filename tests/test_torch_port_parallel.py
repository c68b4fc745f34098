"""The port's data parallelism (parallel/) against nemo_tpu's dp mesh.

One module-scoped two-rank gloo run on the CPU (tests/torch_parallel_ranks.py,
two processes that import only torch and the port) computes, on inputs the
JAX side wrote here:

  (a) fit_loss and its gradient (V3 with every prior, the instance code
      and the 3D term) on a batch whose views split unevenly over the
      ranks, held against JAX's unsharded value and its make_mesh(8) value
      at rtol 1e-5, gradients within 1e-5 of each tensor's largest entry;
      per-rank means averaged (plain DDP) miss by far more;
  (b) NemoFitter(mesh=...) through all three stages on JAX's replayed
      batches against JAX's NemoFitter(mesh=make_mesh(8)): losses within
      1e-4 for the first 5 main steps and 1e-3 after (the twin's
      tolerances), the parameters bit for bit equal across the ranks;
  (c) train_vposer(mesh=...) with JAX's draws against JAX's train_vposer
      (tests/test_torch_port_vposer_train.py's tolerances: history 1e-4,
      parameters a tenth of Adam's rate), equal across the ranks;
  (d) as_sharded_arrays' rows.

(e) runs ``python -m nemo_tpu_torch.cli.fit --dp 2 --device cpu``, which
starts its two ranks itself: one set of outputs, its losses those of the
one-process fit; started from a folder outside the checkout, its ranks
import this checkout's package. The helpers of parallel.distributed are
held in one process as tests/test_parallel.py holds JAX's.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu import fit as jfit
from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.data import synthetic_problem as jax_synthetic_problem
from nemo_tpu.fit.loop import _sample_batch
from nemo_tpu.parallel import make_mesh as jax_make_mesh
from nemo_tpu.priors import init_vposer as jax_init_vposer
from nemo_tpu.priors import synthetic_gmm_prior as jax_synthetic_gmm
from nemo_tpu.priors import vposer as jvp
from nemo_tpu.priors import vposer_train as jvt
from nemo_tpu.utils.checkpoint import _flatten_with_paths
from nemo_tpu_torch.parallel import distributed
from nemo_tpu_torch.parallel.mesh import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMPL_FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor",
               "lbs_weights", "J_regressor_extra", "fused_ES", "fused_EP",
               "fused_EW", "posedirs_t", "lbs_weights_t", "parents",
               "vertex_joint_ids", "joint_map", "faces")
WARMUP, CAM, MAIN = 3, 3, 8
VPCFG = jvt.VPoserTrainConfig(batch_size=16,
                              keep_extra_loss_terms_until_epoch=1)
VP = jvp.VPoserConfig(num_neurons=64)
RANK_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
            "LOCAL_RANK")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _smpl_arrays(m, prefix):
    return {prefix + f: np.asarray(getattr(m, f)) for f in SMPL_FIELDS}


def _flat(prefix, tree):
    return {prefix + k: np.asarray(v)
            for k, v in _flatten_with_paths(tree).items()}


def _replay(seed, V, F, B):
    """JAX fitter's batch stream (fit/loop.py's key threading)."""
    key = jax.random.PRNGKey(seed)
    _, key = jax.random.split(key)
    out = {}
    for i in range(WARMUP):
        key, k1 = jax.random.split(key)
        vi, fi = _sample_batch(k1, B, V, F)
        out[f"b_warmup_vi/{i}"], out[f"b_warmup_fi/{i}"] = vi, fi
    for i in range(MAIN):
        key, k1, _ = jax.random.split(key, 3)
        vi, fi = _sample_batch(k1, B, V, F)
        out[f"b_main_vi/{i}"], out[f"b_main_fi/{i}"] = vi, fi
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_loss_and_grads(cfg, assets, params, vi, fi, mesh=None):
    fn = jax.jit(jax.value_and_grad(
        lambda p, v, f: jfit.fit_loss(p, cfg, assets, v, f, training=False),
        has_aux=True))
    vi, fi = jnp.asarray(vi), jnp.asarray(fi)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from nemo_tpu.parallel import replicate_tree
        params = replicate_tree(mesh, params)
        vi = jax.device_put(vi, NamedSharding(mesh, P("dp")))
        fi = jax.device_put(fi, NamedSharding(mesh, P("dp")))
    (loss, metrics), grads = fn(params, vi, fi)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            {k: np.asarray(v) for k, v in _flatten_with_paths(grads).items()})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("dp")
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    bundle, _ = jax_synthetic_problem(jm, num_views=2, num_frames=12, seed=0)
    bundle.save(str(wd / "bundle.npz"))
    gmm = jax_synthetic_gmm(4)
    vposer = jax_init_vposer(jax.random.PRNGKey(7))
    common = dict(h_dim=32, instance_code_size=4, phase_rbf_dim=8,
                  rbf_kernel="quadratic", monotonic_network_n_nodes=4,
                  batch_size=16, weight_vp_loss=10.0, weight_vp_z_loss=1.0,
                  weight_gmm_loss=0.5, label_type="gt")
    inp = {**_smpl_arrays(jm, "smpl/"),
           "gmm/means": np.asarray(gmm.means),
           "gmm/precisions": np.asarray(gmm.precisions),
           "gmm/nll_weights": np.asarray(gmm.nll_weights),
           **{f"vposer/{k}": np.asarray(v) for k, v in vposer.items()}}
    ref = {}

    # (a) one loss evaluation, V3 with every term
    cfg_a = jfit.NemoConfig(model_version=3, weight_instance_loss=0.1,
                            weight_3d_loss=0.1, **common)
    ja = jfit.build_assets(bundle, jm, cfg_a, gmm=gmm, vposer=vposer)
    pa = jfit.init_params(jax.random.PRNGKey(2), cfg_a, 2, ja.img_d0)
    rng = np.random.RandomState(3)
    pa = jax.tree_util.tree_map(lambda a: a + 0.05 * jnp.asarray(
        rng.randn(*a.shape).astype(np.float32)), pa)
    vi = np.array([0] * 7 + [1] + [0] * 2 + [1] * 6, np.int32)
    fi = np.random.RandomState(4).randint(0, 12, 16).astype(np.int32)
    inp.update(_flat("a_params/", pa), a_vi=vi, a_fi=fi)
    ref["a"] = _jax_loss_and_grads(cfg_a, ja, pa, vi, fi)
    ref["a_mesh"] = _jax_loss_and_grads(cfg_a, ja, pa, vi, fi,
                                        jax_make_mesh(8))

    # (b) the three stages on JAX's 8-device mesh
    cfg_b = jfit.NemoConfig(model_version=2, lr_factor=0.5, n_steps=MAIN,
                            warmup_step=WARMUP, opt_cam_step=CAM, **common)
    jb = jfit.build_assets(bundle, jm, cfg_b, gmm=gmm, vposer=vposer)
    fitter = jfit.NemoFitter(cfg_b, jb, seed=0, mesh=jax_make_mesh(8))
    inp.update(_flat("b_params/", fitter.state.params))
    ref["b"] = {"warmup": fitter.warmup(), "camera": fitter.opt_cam(),
                "main": fitter.fit(chunk=MAIN // 2)}
    inp.update(_replay(0, 2, 12, cfg_b.batch_size))

    # (c) VPoser training, JAX's draws
    jsmpl96 = jax_synthetic_smpl(num_vertices=96, seed=0)
    p = jvp.init_vposer(jax.random.PRNGKey(10), VP)
    data = (0.3 * np.random.RandomState(11).randn(56, 63)).astype(np.float32)
    jp, jhist = jvt.train_vposer(p, data, VPCFG, num_epochs=2, seed=3,
                                 smpl=jsmpl96)
    ref["c"] = ({k: np.asarray(v) for k, v in jp.items()}, jhist)
    key = jax.random.PRNGKey(3)
    for i in range(6):
        key, k = jax.random.split(key)
        inp[f"c_draw/{i}"] = np.asarray(jax.random.normal(
            k, (VPCFG.batch_size, VP.latent_dim)))
    inp.update(_smpl_arrays(jsmpl96, "c_smpl/"), c_data=data, c_n_draws=6,
               **{f"c_params/{k}": np.asarray(v) for k, v in p.items()})

    # (d) three batches of 8 rows
    inp["d_x"] = np.arange(24 * 3, dtype=np.float32).reshape(24, 3)
    inp["d_y"] = np.arange(24, dtype=np.int64)

    np.savez(str(wd / "inputs.npz"), **inp)
    for name, cfg in (("cfg_a", cfg_a), ("cfg_b", cfg_b)):
        json.dump(dataclasses.asdict(cfg), open(wd / f"{name}.json", "w"))
    json.dump({f.name: getattr(VPCFG, f.name)
               for f in dataclasses.fields(VPCFG)},
              open(wd / "cfg_c.json", "w"))

    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_parallel_ranks.py"),
         str(wd)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for q in procs:
            logs.append(q.communicate(timeout=400)[0])
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
    for q, log in zip(procs, logs):
        assert q.returncode == 0, log[-4000:]
    ranks = [np.load(str(wd / f"rank{r}.npz")) for r in range(2)]
    return dict(ref=ref, ranks=ranks, inp=inp)


def _prefixed(npz, prefix):
    return {k[len(prefix):]: npz[k] for k in npz.files
            if k.startswith(prefix)}


def test_ranks_import_no_jax(run):
    for r, out in enumerate(run["ranks"]):
        assert int(out["rank"]) == r
        assert out["jax_modules"].size == 0, out["jax_modules"]


@pytest.mark.parametrize("against", ["a", "a_mesh"])
def test_fit_loss_and_grads_global(run, against):
    loss_j, metrics_j, grads_j = run["ref"][against]
    for out in run["ranks"]:
        np.testing.assert_allclose(float(out["a_loss"]), loss_j, rtol=1e-5)
        got = _prefixed(out, "a_metric/")
        assert sorted(got) == sorted(metrics_j)
        for k, v in metrics_j.items():
            np.testing.assert_allclose(float(got[k]), v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        grads = _prefixed(out, "a_grad/")
        assert sorted(grads) == sorted(grads_j)
        for k, g in grads_j.items():
            scale = float(np.abs(g).max())
            np.testing.assert_allclose(grads[k], g, rtol=0,
                                       atol=1e-5 * scale + 1e-12,
                                       err_msg=k)


def test_plain_averaging_misses(run):
    """Per-rank means averaged are another function: the per-view average
    and the uneven split make the kp term differ by far more than the
    bound the global version meets."""
    loss_j, metrics_j, _ = run["ref"]["a"]
    out = run["ranks"][0]
    rel = abs(float(out["plain_loss"]) - loss_j) / abs(loss_j)
    assert rel > 1e-2, rel
    kp = float(out["plain_metric/kp_loss"])
    assert abs(kp - metrics_j["kp_loss"]) > 1e-2 * abs(metrics_j["kp_loss"])


def test_fitter_matches_jax_mesh(run):
    ref = run["ref"]["b"]
    for out in run["ranks"]:
        for stage, key in (("warmup", "warmup_loss"), ("camera", "cam_loss")):
            np.testing.assert_allclose(out[f"b_{stage}/{key}"],
                                       ref[stage][key], rtol=1e-4,
                                       err_msg=stage)
        for k in ("total_loss", "kp_loss", "vp_recon_loss", "gmm_loss"):
            got, want = out[f"b_main/{k}"], ref["main"][k]
            assert got.shape == (MAIN,)
            np.testing.assert_allclose(got[:5], want[:5], rtol=1e-4,
                                       err_msg=k)
            np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=k)


def test_fitter_params_equal_across_ranks(run):
    a, b = (_prefixed(o, "b_params/") for o in run["ranks"])
    assert sorted(a) == sorted(b) and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(run["ranks"][0]["b_scale"],
                                  run["ranks"][1]["b_scale"])


def test_train_vposer_mesh_matches_jax(run):
    jp, jhist = run["ref"]["c"]
    outs = run["ranks"]
    for out in outs:
        hist = _prefixed(out, "c_hist/")
        assert sorted(hist) == sorted(jhist)
        for k, v in jhist.items():
            np.testing.assert_allclose(hist[k], v, rtol=1e-4, err_msg=k)
        params = _prefixed(out, "c_params/")
        for k, v in jp.items():
            err = float(np.abs(params[k] - v).max())
            assert err <= 0.1 * VPCFG.lr, (k, err)
    a, b = (_prefixed(o, "c_params/") for o in outs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_as_sharded_arrays_rows(run):
    x, y = run["inp"]["d_x"], run["inp"]["d_y"]
    for r, out in enumerate(run["ranks"]):
        for i in range(3):
            rows = slice(8 * i + 4 * r, 8 * i + 4 * r + 4)
            np.testing.assert_array_equal(out[f"d_x/{i}"], x[rows])
            np.testing.assert_array_equal(out[f"d_y/{i}"], y[rows])


CLI_FLAGS = ["--synthetic_assets", "--model_version", "2", "--phase_rbf_dim",
             "8", "--rbf_kernel", "quadratic", "--h_dim", "16",
             "--monotonic_network_n_nodes", "4", "--instance_code_size", "4",
             "--batch_size", "16", "--n_steps", "2", "--warmup_step", "1",
             "--opt_cam_step", "1", "--save_every", "2", "--label_type",
             "gt", "--loss", "mse_robust", "--weight_gmm_loss", "0.5",
             "--device", "cpu"]


def test_cli_dp2_writes_one_set_of_outputs(tmp_path, monkeypatch):
    from nemo_tpu_torch.cli.fit import main
    for var in RANK_ENV:
        monkeypatch.delenv(var, raising=False)
    env = {k: v for k, v in os.environ.items() if k not in RANK_ENV}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "nemo_tpu_torch.cli.fit", *CLI_FLAGS, "--dp",
         "2", "--out_dir", str(tmp_path / "dp")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "data-parallel over 2 ranks (gloo" in proc.stdout
    assert proc.stdout.count("[fit] outputs in") == 1
    assert sorted(os.listdir(tmp_path / "dp")) == ["000000"]
    run_dir = tmp_path / "dp" / "000000"
    assert (run_dir / "ckpt" / "sd_000002" / "params.npz").is_file()
    phases = [json.loads(line)["phase"]
              for line in open(run_dir / "metrics.jsonl")]
    assert phases.count("final") == 1
    assert main(CLI_FLAGS + ["--out_dir", str(tmp_path / "one")]) == 0
    one, dp = (np.load(str(d / "000000" / "losses.npz"))
               for d in (tmp_path / "one", tmp_path / "dp"))
    assert sorted(one.files) == sorted(dp.files)
    for k in one.files:
        np.testing.assert_allclose(dp[k], one[k], rtol=1e-5, err_msg=k)


def test_cli_dp2_ranks_import_this_checkout(tmp_path, monkeypatch):
    """Started from a folder outside the checkout, with no PYTHONPATH and
    a stray nemo_tpu_torch package in that folder, the self-started ranks
    import the package their parent runs (the stray one raises)."""
    for var in RANK_ENV:
        monkeypatch.delenv(var, raising=False)
    stray = tmp_path / "nemo_tpu_torch"
    stray.mkdir()
    (stray / "__init__.py").write_text(
        "raise ImportError('stray nemo_tpu_torch of the working folder')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in RANK_ENV + ("PYTHONPATH",)}
    argv = CLI_FLAGS + ["--dp", "2", "--out_dir", str(tmp_path / "dp")]
    code = (f"import sys; sys.path.insert(0, {REPO!r}); "
            f"from nemo_tpu_torch.cli.fit import main; "
            f"sys.exit(main({argv!r}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "stray" not in proc.stderr
    assert proc.stdout.count("[fit] outputs in") == 1
    assert (tmp_path / "dp" / "000000" / "losses.npz").is_file()


def test_distributed_single_process_semantics(monkeypatch):
    for var in RANK_ENV:
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.is_primary()
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1
    assert distributed.local_batch_slice(512) == slice(0, 512)
    distributed.barrier()
    with pytest.raises(ValueError, match="not divisible"):
        Mesh(rank=0, size=2, device=torch.device("cpu")).rows(7)


def test_make_mesh_without_group(monkeypatch):
    from nemo_tpu_torch.parallel import (batch_sharding, make_mesh,
                                         replicate_tree, replicated,
                                         shard_batch)
    mesh = make_mesh()
    assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    (xs,) = shard_batch(mesh, x)
    np.testing.assert_array_equal(xs.numpy(), x)
    assert torch.equal(batch_sharding(mesh).place(x), torch.from_numpy(x))
    assert torch.equal(replicated(mesh).place(x), torch.from_numpy(x))
    tree = {"a": torch.ones(3), "b": [np.zeros(2, np.float32)]}
    out = replicate_tree(mesh, tree)
    assert torch.equal(out["a"], torch.ones(3))
    assert torch.is_tensor(out["b"][0])
    with pytest.raises(ValueError, match="make_mesh\\(2\\).*1 rank"):
        make_mesh(2)


def test_divisibility_guards():
    """batch_size not tiling the ranks is refused before any collective
    (full-batch fits are not: their grid runs whole where it does not
    tile), as are seeds not tiling them."""
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    from nemo_tpu_torch.parallel import fit_many_seeds
    smpl = synthetic_smpl_model(num_vertices=200, seed=0, device="cpu")
    bundle, _ = synthetic_problem(smpl, num_views=2, num_frames=4)
    mesh = Mesh(rank=0, size=8, device=torch.device("cpu"))
    from nemo_tpu_torch import fit as tfit
    cfg = tfit.NemoConfig(model_version=1, h_dim=16, batch_size=12,
                          label_type="gt", monotonic_network_n_nodes=4,
                          instance_code_size=2)
    assets = tfit.build_assets(bundle, smpl, cfg, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tfit.NemoFitter(cfg, assets, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        fit_many_seeds(cfg, assets, num_seeds=3, steps=1, mesh=mesh)
    full = dataclasses.replace(cfg, full_batch=True)
    mesh1 = Mesh(rank=0, size=1, device=torch.device("cpu"))
    tfit.NemoFitter(full, assets, mesh=mesh1)
