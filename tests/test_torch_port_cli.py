"""``python -m nemo_tpu_torch.cli.fit`` against ``nemo_tpu.cli.fit``.

A tiny synthetic fit through both CLIs with the same flags: the port (run in
a fresh interpreter on the CPU, which must never import jax) writes the same
files, and every eval CSV has the JAX CLI's header row and row count.
"""

import csv
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--synthetic_assets", "--model_version", "2", "--phase_rbf_dim", "8",
         "--rbf_kernel", "quadratic", "--h_dim", "16",
         "--monotonic_network_n_nodes", "4", "--instance_code_size", "4",
         "--batch_size", "16", "--n_steps", "2", "--warmup_step", "1",
         "--opt_cam_step", "1", "--save_every", "2", "--label_type", "gt",
         "--loss", "mse_robust", "--weight_gmm_loss", "0.5",
         "--weight_vp_loss", "1.0"]
CSVS = ("eval_2d.csv", "eval_3d.csv", "eval_3d_dynamic.csv",
        "eval_3d_global.csv")

_PORT_MAIN = (
    "import sys\n"
    "import torch\n"
    "torch.set_num_threads(2)\n"
    "from nemo_tpu_torch.cli.fit import main\n"
    "rc = main(sys.argv[1:])\n"
    "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
    " ('jax', 'jaxlib', 'optax', 'nemo_tpu'))\n"
    "assert not bad, bad\n"
    "sys.exit(rc)\n")


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _run_port(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", _PORT_MAIN, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600, **kw)


def test_cli_outputs_match_jax_cli(tmp_path):
    from nemo_tpu.cli.fit import main as jax_main
    assert jax_main(FLAGS + ["--out_dir", str(tmp_path / "jax")]) == 0
    out = _run_port(FLAGS + ["--device", "cpu", "--out_dir",
                             str(tmp_path / "port")])
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    jdir = tmp_path / "jax" / "000000"
    tdir = tmp_path / "port" / "000000"
    for name in ("config.json", "metrics.jsonl", "losses.npz") + CSVS:
        assert (tdir / name).is_file(), name
    for name in CSVS:
        j, t = _rows(jdir / name), _rows(tdir / name)
        assert t[0] == j[0], name
        assert len(t) == len(j), name
    phases = lambda d: [json.loads(line)["phase"]
                        for line in open(d / "metrics.jsonl")]
    assert phases(tdir) == phases(jdir)
    final_t = [json.loads(line) for line in open(tdir / "metrics.jsonl")][-1]
    final_j = [json.loads(line) for line in open(jdir / "metrics.jsonl")][-1]
    assert sorted(final_t) == sorted(final_j)


@pytest.mark.parametrize("extra", [
    ["--vposer_path", "vposer"], ["--dp", "2"], ["--gmm_path", "gmm"],
    ["--smpl_path", "smpl"], ["--weight_humor_loss", "1"], ["--skin_bf16"],
    ["--humor_fps", "25"], ["--humor_ckpt", "humor.pt"],
    ["--init-motion-prior", "gmm.npz"]])
def test_unported_flags_raise(tmp_path, extra):
    from nemo_tpu_torch.cli.fit import main
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(FLAGS + extra + ["--device", "cpu", "--out_dir",
                              str(tmp_path)])


def test_glamr_bundle_raises(tmp_path):
    """A bundle with GLAMR world data would need eval_3d_global's GLAMR
    columns, which are not ported: the CLI refuses it instead of writing a
    CSV without them."""
    import numpy as np
    from nemo_tpu_torch.cli.fit import main
    from nemo_tpu_torch.data.bundle import MultiViewBundle
    z = lambda *s: np.zeros(s, np.float32)
    path = str(tmp_path / "glamr.npz")
    MultiViewBundle(labels={"gt": z(1, 2, 25, 3)}, hmr_theta=z(1, 2, 69),
                    hmr_mask=z(1, 2, 1), img_hw=np.array([480, 640]),
                    baseline_poses={"glamr": z(1, 2, 70)},
                    glamr_orient=z(1, 2, 3), glamr_trans=z(1, 2, 3)).save(path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(FLAGS + ["--bundle", path, "--device", "cpu", "--out_dir",
                      str(tmp_path / "out")])


def test_cuda_device_without_a_card_raises(tmp_path):
    from nemo_tpu_torch.cli.fit import main
    with pytest.raises(RuntimeError, match="cuda"):
        main(FLAGS + ["--out_dir", str(tmp_path)])


def _recipe_flags():
    """The flag list of run_examples/custom-video-example.sh's fit command,
    with its shell variables filled in."""
    with open(os.path.join(REPO, "run_examples",
                           "custom-video-example.sh")) as f:
        lines = f.read().splitlines()
    start = lines.index("python -m nemo_tpu.cli.fit \\") + 1
    words = []
    for line in lines[start:]:
        if line.strip() == "done":
            break
        words += line.strip().rstrip("\\").split()
    subst = {'"$EXPS/bundle.npz"': "bundle.npz", '"$CFG"': "action.yml",
             '"$DATA/out/custom-${lr_human}"': "out/custom",
             '"${lr_human}"': "1e-3",
             "configs/default-v1.yml": os.path.join(REPO, "configs",
                                                    "default-v1.yml")}
    return [subst.get(w, w) for w in words]


def test_recipe_flags_parse_and_stop_at_real_assets(tmp_path):
    """The custom-video recipe's command line passes the port's argparse
    (as it passes the JAX CLI's) and stops only at the refusal of the real
    SMPL/VPoser/GMM assets, before any data is read."""
    from nemo_tpu.cli.fit import build_parser as jax_parser
    from nemo_tpu_torch.cli.fit import build_parser, main
    flags = _recipe_flags()
    assert "--db" in flags and "--nemo_cfg_path" in flags
    assert "--data_loader_type" in flags and "--full_batch" in flags
    jax_args = vars(jax_parser().parse_args(flags))
    args = vars(build_parser().parse_args(flags))
    assert set(jax_args) <= set(args)
    assert {k: args[k] for k in jax_args} == jax_args
    out = flags[flags.index("--out_dir") + 1]
    flags[flags.index("--out_dir") + 1] = str(tmp_path / out)
    with pytest.raises(NotImplementedError) as err:
        main(flags + ["--device", "cpu"])
    msg = str(err.value)
    assert "real assets" in msg and "ROADMAP" in msg
    assert "--dp" not in msg and "HuMoR" not in msg
    assert not (tmp_path / "out").exists()


V0_RATES = ["--model_version", "0", "--lr_pose", "3e-3", "--lr_orient",
            "2e-3", "--lr_trans", "4e-3"]


def test_v0_rates_reach_the_optimizer_groups():
    """--lr_pose/--lr_orient/--lr_trans give the port's NemoConfig and V0's
    pose, orient and trans optimizers the rates the JAX CLI gives its
    groups from the same command line."""
    from nemo_tpu.cli.fit import build_parser as jax_parser
    from nemo_tpu.fit import NemoConfig as JaxConfig
    from nemo_tpu.fit.optimizer import group_lrs as jax_group_lrs
    from nemo_tpu.utils import dataclass_from_namespace as jax_from_ns
    from nemo_tpu.utils import merge_config as jax_merge
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.cli.fit import build_parser
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    from nemo_tpu_torch.fit import NemoConfig, NemoFitter, build_assets
    from nemo_tpu_torch.utils.exp import (dataclass_from_namespace,
                                          merge_config)
    argv = FLAGS + V0_RATES
    cfg_j = jax_from_ns(JaxConfig, jax_merge(jax_parser(), argv))
    cfg = dataclass_from_namespace(NemoConfig, merge_config(build_parser(),
                                                            argv))
    want = {"poses": 3e-3, "orient": 2e-3, "trans": 4e-3}
    lrs_j = jax_group_lrs(cfg_j)
    assert {g: lrs_j[g] for g in want} == want
    smpl = synthetic_smpl_model(300, device="cpu")
    bundle, _ = synthetic_problem(smpl, num_views=2, num_frames=8)
    from nemo_tpu_torch.priors.gmm import synthetic_gmm_prior
    from nemo_tpu_torch.priors.vposer import init_vposer
    fitter = NemoFitter(cfg, build_assets(
        bundle, smpl, cfg, gmm=synthetic_gmm_prior(4), vposer=init_vposer(),
        device="cpu"))
    groups = fitter.optimizer.groups
    assert {g: groups[g].lr for g in want} == want
    assert {g: groups[g].lr for g in groups} == {
        g: lrs_j[g] for g in groups}
