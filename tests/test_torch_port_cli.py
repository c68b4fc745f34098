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
    ["--render_video", "1"], ["--dp", "2"], ["--full_batch"],
    ["--load_ckpt_path", "ckpt"], ["--smpl_path", "smpl"],
    ["--model_version", "3"]])
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
