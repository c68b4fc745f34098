"""The port's ``cli.fit_suite`` against ``nemo_tpu.cli.fit_suite``.

Two small bundles, two seeds each, through both suites with the same flags
(the port in a fresh interpreter on the CPU, which must never import jax).
"""

import json
import os

from nemo_tpu_torch.body.assets import synthetic_smpl_model
from nemo_tpu_torch.utils import asset_files
from test_torch_port_cli import SMALL, _run_port


def test_fit_suite_matches_jax_layout(tmp_path):
    """fit_suite on two bundles with --seeds 2 (the 150-vertex body from
    its file, no priors, no 3D ground truth): the same run directories and
    files as the JAX suite (the checkpoint directories' contents differ by
    design), and each action's best.txt names the seed run with the lowest
    final total_loss."""
    from nemo_tpu.body import synthetic_smpl_model as jax_smpl
    from nemo_tpu.cli.fit_suite import main as jax_suite
    from nemo_tpu.data import synthetic_problem as jax_problem
    bundles = []
    for seed, name in enumerate(("pitch", "swing")):
        b, _ = jax_problem(jax_smpl(num_vertices=150, seed=0), num_views=2,
                           num_frames=8, seed=seed)
        b.gt3d_pose = b.gt3d_trans = None
        bundles.append(str(tmp_path / f"{name}.npz"))
        b.save(bundles[-1])
    smpl = str(tmp_path / "SMPL_NEUTRAL.npz")
    asset_files.write_smpl_npz(smpl, asset_files.smpl_file_arrays(
        synthetic_smpl_model(150, seed=0, device="cpu")))
    flags = ["--bundles", *bundles, "--seeds", "2", *SMALL, "--smpl_path",
             smpl]
    assert jax_suite(flags + ["--out_dir", str(tmp_path / "jax")]) == 0
    out = _run_port(flags + ["--device", "cpu", "--out_dir",
                             str(tmp_path / "port")], module="fit_suite")
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]

    def layout(root):
        """Every file but the figures, a checkpoint as its directory."""
        paths = {os.path.relpath(os.path.join(d, f), root)
                 for d, _, files in os.walk(root) for f in files
                 if not f.endswith(".png")}
        return sorted({p if "/ckpt/" not in p else os.path.dirname(p)
                       for p in paths})

    assert layout(tmp_path / "port") == layout(tmp_path / "jax")
    for name in ("pitch", "swing"):
        root = tmp_path / "port" / name
        best_dir, best_loss = open(root / "best.txt").read().split()
        finals = {}
        for seed in (0, 1):
            run = root / f"seed{seed}"
            rec = [json.loads(line) for line in
                   open(run / "000000" / "metrics.jsonl")][-1]
            finals[str(run)] = rec["total_loss"]
        assert best_dir == min(finals, key=finals.get)
        assert float(best_loss) == finals[best_dir]
        jbest = open(tmp_path / "jax" / name / "best.txt").read().split()
        assert os.path.dirname(os.path.relpath(jbest[0], tmp_path / "jax")) \
            == os.path.dirname(os.path.relpath(best_dir, tmp_path / "port"))
