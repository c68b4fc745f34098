"""CLI: standalone VIBE evaluator — load a checkpoint, validate, evaluate
(port of nemo_tpu/cli/vibe_eval.py; the same flags, plus --device).

Equivalent surface to the reference's evaluation driver
(VIBE/eval.py:11-54 + lib/core/evaluate.py:37-152
``Evaluator``: build model -> load pretrained generator weights -> run the
test loader through validate() accumulating pred_j3d/target_j3d/pred_verts/
target_theta -> evaluate() printing MPJPE / PA-MPJPE / PVE / ACCEL /
ACCEL_ERR in mm).

The port evaluates feature-based sequence batches through ``vibe_predict``
(models/vibe_train.py) on --device, 'cuda' by default, and reports the same
metric set via ``evaluate_vibe``; the GT vertices come from
``smpl_forward`` (FK through kernel K1). A checkpoint of either package
loads. Dataset input is a packed npz (the offline-packer
convention used across this repo instead of the reference's on-line
DataLoaders):

  features (N, T, 2048) float32 — SPIN backbone features per sequence
  kp_3d    (N, T, 14, 3)        — GT common-14 joints
  theta    (N, T, 85) optional  — GT SMPL theta (cam3 + pose72 + betas10);
                                  enables the PVE column via a GT SMPL
                                  forward (compute_error_verts,
                                  lib/utils/eval_utils.py:25-66)

Usage:
  python -m nemo_tpu_torch.cli.vibe_eval --ckpt out/vibe/ckpt --db test.npz
  python -m nemo_tpu_torch.cli.vibe_eval --synthetic 8 16   # smoke run
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", type=str, default="",
                   help="vibe train checkpoint dir (save_vibe_state)")
    p.add_argument("--db", type=str, default="",
                   help="packed test-set npz (features/kp_3d[/theta])")
    p.add_argument("--synthetic", type=int, nargs=2, default=None,
                   metavar=("N", "T"),
                   help="generate a random N-sequence, T-frame test set")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_csv", type=str, default="")
    p.add_argument("--smpl_path", type=str, default="")
    p.add_argument("--num_vertices", type=int, default=431,
                   help="synthetic SMPL size when no --smpl_path")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p


def run_evaluator(gen, smpl, batches, log_fn=print) -> dict:
    """validate() + evaluate(): accumulate predictions over batches, then
    compute the metric dict (lib/core/evaluate.py:53-152), on the SMPL
    model's device.

    batches: iterable of dicts with 'features' (B, T, 2048), 'kp_3d'
    (B, T, 14, 3), optional 'theta' (B, T, 85)."""
    import torch

    from ..body.smpl import smpl_forward
    from ..models.vibe_train import evaluate_vibe, vibe_predict

    dev = smpl.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pred_j3d, target_j3d, pred_verts, target_theta = [], [], [], []
    with torch.no_grad():
        for i, batch in enumerate(batches):
            pred = vibe_predict(gen, smpl, t(batch["features"]))
            n_kp = pred["kp_3d"].shape[-2]
            pred_j3d.append(pred["kp_3d"].cpu().numpy().reshape(-1, n_kp, 3))
            target_j3d.append(np.asarray(batch["kp_3d"]).reshape(-1, n_kp, 3))
            if "theta" in batch:
                pred_verts.append(pred["verts"].cpu().numpy().reshape(
                    (-1,) + tuple(pred["verts"].shape[-2:])))
                target_theta.append(np.asarray(batch["theta"]).reshape(-1, 85))
            log_fn(f"[vibe_eval] batch {i + 1} done")

        pred_j3d = np.concatenate(pred_j3d)
        target_j3d = np.concatenate(target_j3d)
        log_fn(f"[vibe_eval] evaluating on {pred_j3d.shape[0]} poses...")

        tv = pv = None
        if target_theta:
            theta = np.concatenate(target_theta)
            pv = np.concatenate(pred_verts)
            # GT verts from GT theta — the reference's compute_error_verts
            # path (eval_utils.py:25-66): smpl(betas, pose) with zero transl
            gt_v, _ = smpl_forward(smpl, t(theta[:, 75:]), t(theta[:, 6:75]),
                                   t(theta[:, 3:6]), pose2rot=True)
            tv = gt_v.cpu().numpy()
    return evaluate_vibe(pred_j3d, target_j3d, pred_verts=pv,
                         target_verts=tv)


def _batched(db: dict, batch_size: int):
    n = db["features"].shape[0]
    for i in range(0, n, batch_size):
        yield {k: v[i:i + batch_size] for k, v in db.items()}


def main(argv=None) -> int:
    import torch

    from .. import resolve_device
    from ..models.vibe_train import init_vibe_train_state, load_vibe_state

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    if args.smpl_path:
        from ..body.assets import load_smpl
        smpl = load_smpl(args.smpl_path, device=device)
    else:
        from ..body.assets import synthetic_smpl_model
        smpl = synthetic_smpl_model(num_vertices=args.num_vertices, seed=0,
                                    device=device)

    state = init_vibe_train_state(torch.Generator().manual_seed(args.seed),
                                  smpl)
    if args.ckpt:
        state = load_vibe_state(args.ckpt, state)
        print(f"[vibe_eval] loaded checkpoint from {args.ckpt}")
    else:
        print("[vibe_eval] WARNING: no --ckpt; evaluating random init "
              "(the reference exits here, eval.py:33 — kept runnable for "
              "smoke tests)")

    if args.db:
        db = dict(np.load(args.db))
    elif args.synthetic:
        N, T = args.synthetic
        rng = np.random.RandomState(args.seed)
        db = {
            "features": rng.randn(N, T, 2048).astype(np.float32),
            "kp_3d": 0.2 * rng.randn(N, T, 14, 3).astype(np.float32),
            "theta": np.concatenate([
                np.zeros((N, T, 3), np.float32),
                0.2 * rng.randn(N, T, 72).astype(np.float32),
                0.1 * rng.randn(N, T, 10).astype(np.float32)], -1),
        }
    else:
        print("[vibe_eval] need --db or --synthetic", file=sys.stderr)
        return 2

    metrics = run_evaluator(state["gen"], smpl,
                            _batched(db, args.batch_size))
    # the reference's final log line (evaluate.py:149-151)
    print(" ".join(f"{k.upper()}: {v:.4f}," for k, v in metrics.items()))
    if args.out_csv:
        with open(args.out_csv, "w") as f:
            f.write(",".join(metrics) + "\n")
            f.write(",".join(f"{v:.6f}" for v in metrics.values()) + "\n")
        print(f"[vibe_eval] wrote {args.out_csv}")
    else:
        print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
