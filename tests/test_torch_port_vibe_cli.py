"""The port's VIBE CLIs against nemo_tpu's on the CPU: vibe_train on
--synthetic windows from JAX's initial state carried across, vibe_eval on
--synthetic sequences from one JAX checkpoint, and the --device default.

vibe_train fixes the 6890-vertex synthetic body and the 1024-wide GRU
discriminator; the run is cut to features 32, batches of 4 x 4 frames and
2 epochs of 2 steps. Tolerances: vibe_train's printed best metrics within
1e-4 relative plus their last printed digit (0.01 mm), its checkpoints'
keys, shapes, dtypes and Adam counts equal; vibe_eval's CSV metrics
within 5e-5 of each value.
"""

import jax
import numpy as np
import pytest
import torch

from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.models import vibe_train as jvt
from nemo_tpu.utils.checkpoint import _flatten_with_paths
from nemo_tpu_torch.models import vibe_train as tvt


def flat(state):
    return {k: _flatten_with_paths(v) for k, v in state.items()}



def _best_line(out):
    line = [l for l in out.splitlines() if l.startswith("[vibe-train] best")]
    return {kv.split("=")[0]: float(kv.split("=")[1])
            for kv in line[-1].split(":", 1)[1].split()}


def test_vibe_train_cli(tmp_path, monkeypatch, capsys):
    """Both vibe_train CLIs on --synthetic windows (the 6890-vertex body
    both fix, features 32, batch 4 x 4 frames, the 1024 GRU discriminator
    with 3-layer attention, 2 epochs of 2 steps), the port's initial state
    JAX's carried across: the printed best metrics within 1e-4 (they print
    two decimals), the checkpoints' keys, shapes and counts equal."""
    from nemo_tpu.cli import vibe_train as jcli
    from nemo_tpu_torch.cli import vibe_train as tcli

    y = tmp_path / "cfg.yaml"
    y.write_text("TRAIN:\n  BATCH_SIZE: 4\n  MOT_DISCR:\n"
                 "    FEATURE_POOL: attention\n    NUM_LAYERS: 2\n"
                 "    ATT:\n      LAYERS: 3\nDATASET:\n  SEQLEN: 4\n")
    argv = ["--cfg", str(y), "--synthetic", "8", "--epochs", "2",
            "--iters_per_epoch", "2", "--feat_size", "32"]

    def from_jax(generator, smpl, **kw):
        st, _ = jvt.init_vibe_train_state(
            jax.random.PRNGKey(0), jax_synthetic_smpl(), **kw)
        return tvt.vibe_train_state_from_jax(flat(st), smpl.device,
                                             kw["gen_lr"], kw["disc_lr"])

    assert jcli.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    want = _best_line(capsys.readouterr().out)
    monkeypatch.setattr(tvt, "init_vibe_train_state", from_jax)
    assert tcli.main(argv + ["--out", str(tmp_path / "port"),
                             "--device", "cpu"]) == 0
    got = _best_line(capsys.readouterr().out)
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]) + 0.01, \
            (k, got[k], want[k])
    for net in ("gen", "disc", "gen_opt", "disc_opt"):
        with np.load(tmp_path / "jax" / "vibe_train_state" / f"{net}.npz") \
                as a, np.load(tmp_path / "port" / "vibe_train_state" /
                              f"{net}.npz") as b:
            assert sorted(a.files) == sorted(b.files), net
            for k in a.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            if "opt" in net:
                assert int(a["0/.count"]) == int(b["0/.count"]) == 4


def test_vibe_eval_cli(tmp_path, capsys):
    """Both vibe_eval CLIs on --synthetic 2 4 with the same JAX checkpoint
    (features 2048, a 96-vertex body, the GT vertices through smpl_forward
    with pose2rot): the CSV metrics within 5e-5."""
    from nemo_tpu.cli import vibe_eval as jcli
    from nemo_tpu_torch.cli import vibe_eval as tcli

    st, _ = jvt.init_vibe_train_state(jax.random.PRNGKey(1),
                                      jax_synthetic_smpl(num_vertices=96))
    (tmp_path / "ck").mkdir()
    for k, v in flat(st).items():   # save_vibe_state's files, undeflated
        np.savez(tmp_path / "ck" / f"{k}.npz", **v)
    argv = ["--ckpt", str(tmp_path / "ck"), "--synthetic", "2", "4",
            "--batch_size", "2", "--num_vertices", "96"]
    rows = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        csv = str(tmp_path / f"{name}.csv")
        assert cli.main(argv + extra + ["--out_csv", csv]) == 0
        head, row = open(csv).read().strip().split("\n")
        rows[name] = dict(zip(head.split(","), map(float, row.split(","))))
    assert "MPJPE" in capsys.readouterr().out
    assert list(rows["port"]) == ["mpjpe", "pa-mpjpe", "accel", "accel_err",
                                  "pve"]
    for k, v in rows["jax"].items():
        assert abs(rows["port"][k] - v) <= 5e-5 * abs(v), (k, v)


def test_clis_need_a_card_unless_told():
    """--device defaults to cuda, which raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from nemo_tpu_torch.cli import vibe_eval, vibe_train
    with pytest.raises(RuntimeError, match="--device cpu"):
        vibe_train.main(["--out", "unused", "--synthetic", "4"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        vibe_eval.main(["--synthetic", "2", "4"])
