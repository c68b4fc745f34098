"""CLI: VIBE adversarial training driver (port of nemo_tpu/cli/vibe_train.py;
the same flags, plus --device).

Behavioral reference: VIBE/train.py:36-140 + lib/core/config.py:24-140 —
parse a yacs-style YAML config (TRAIN.*, LOSS.*, MODEL.TGRU.*,
TRAIN.MOT_DISCR.*, DATASET.*), assemble 2D/3D loaders at DATA_2D_RATIO,
build VIBE + MotionDiscriminator with VIBELoss, and run Trainer.fit.

Here the same config surface drives the port's trainer
(models/vibe_train.py) on --device, 'cuda' by default: mixed 2D/3D
sharded iterators (data/vibe_db.py:mixed_2d3d_iterator), one gen+disc
update per batch (the generator's SMPL pass through kernel K1, forward and
backward), per-epoch eval, train-state checkpointing in the JAX package's
layout. The initial weights draw from torch.Generator().manual_seed(seed).

Usage:
  python -m nemo_tpu_torch.cli.vibe_train --cfg cfg.yaml --out vibe_run \
      [--shards_2d DIR --shards_3d DIR --shards_eval DIR \
       --shards_motion DIR | --synthetic N] [--device cpu]

Shard rows are train-format windows: features (T, F), kp_2d (T, 49, 3);
3D shards add kp_3d (T, 14, 3), pose (T, 72), betas (T, 10); motion
shards hold pose_body (T, 69) AMASS sequences for the discriminator.
--synthetic N runs the full loop on a generated problem (smoke/bringup).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

import numpy as np

# reference config defaults (lib/core/config.py:24-140), flattened
CFG_DEFAULTS = {
    "TRAIN.BATCH_SIZE": 32,
    "TRAIN.DATA_2D_RATIO": 0.5,
    "TRAIN.END_EPOCH": 5,
    "TRAIN.NUM_ITERS_PER_EPOCH": 1000,
    "TRAIN.GEN_LR": 1e-4,
    "TRAIN.LR_PATIENCE": 5,
    "TRAIN.MOT_DISCR.LR": 1e-2,
    "TRAIN.MOT_DISCR.FEATURE_POOL": "concat",
    "TRAIN.MOT_DISCR.HIDDEN_SIZE": 1024,
    "TRAIN.MOT_DISCR.NUM_LAYERS": 1,
    "TRAIN.MOT_DISCR.ATT.SIZE": 1024,
    "TRAIN.MOT_DISCR.ATT.LAYERS": 1,
    "TRAIN.MOT_DISCR.ATT.DROPOUT": 0.1,
    "LOSS.KP_2D_W": 60.0,
    "LOSS.KP_3D_W": 30.0,
    "LOSS.SHAPE_W": 0.001,
    "LOSS.POSE_W": 1.0,
    "LOSS.D_MOTION_LOSS_W": 1.0,
    "DATASET.SEQLEN": 16,
    "SEED_VALUE": -1,
    "DEBUG_FREQ": 0,
}


def load_cfg(path: str) -> dict:
    """Flatten a yacs-style nested YAML into dotted keys over the
    reference defaults (config.py update_cfg/parse_args)."""
    cfg = dict(CFG_DEFAULTS)
    if path:
        import yaml
        with open(path) as f:
            nested = yaml.safe_load(f) or {}

        def walk(prefix, node):
            for k, v in node.items():
                key = f"{prefix}.{k}" if prefix else str(k)
                if isinstance(v, dict):
                    walk(key, v)
                else:
                    cfg[key] = v

        walk("", nested)
    return cfg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", type=str, default="",
                   help="yacs-style YAML (reference key hierarchy)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--shards_2d", type=str, default="")
    p.add_argument("--shards_3d", type=str, default="")
    p.add_argument("--shards_eval", type=str, default="")
    p.add_argument("--shards_motion", type=str, default="")
    p.add_argument("--synthetic", type=int, default=0,
                   help="run on N synthetic windows (smoke mode)")
    p.add_argument("--epochs", type=int, default=None,
                   help="override TRAIN.END_EPOCH")
    p.add_argument("--iters_per_epoch", type=int, default=None,
                   help="override TRAIN.NUM_ITERS_PER_EPOCH")
    p.add_argument("--seqlen", type=int, default=None)
    p.add_argument("--feat_size", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug_viz_every", type=int, default=0,
                   help="DEBUG-mode pred-vs-GT panels every N epochs")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions)")
    return p


def _synthetic_batch(rng, B, T, feat):
    return {
        "features": rng.standard_normal((B, T, feat)).astype(np.float32),
        "kp_2d": rng.standard_normal((B, T, 49, 3)).astype(np.float32),
        "kp_3d": 0.2 * rng.standard_normal((B, T, 14, 3))
        .astype(np.float32),
        "pose": 0.2 * rng.standard_normal((B, T, 72)).astype(np.float32),
        "betas": 0.1 * rng.standard_normal((B, T, 10)).astype(np.float32),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load_cfg(args.cfg)
    epochs = args.epochs if args.epochs is not None \
        else int(cfg["TRAIN.END_EPOCH"])
    iters = args.iters_per_epoch if args.iters_per_epoch is not None \
        else int(cfg["TRAIN.NUM_ITERS_PER_EPOCH"])
    seqlen = args.seqlen if args.seqlen is not None \
        else int(cfg["DATASET.SEQLEN"])
    batch_size = int(cfg["TRAIN.BATCH_SIZE"])

    import torch

    from .. import resolve_device
    from ..body.assets import synthetic_smpl_model
    from ..data.vibe_db import mixed_2d3d_iterator, split_2d3d_batch_sizes
    from ..models.vibe_train import (VibeLossWeights, init_vibe_train_state,
                                     make_vibe_train_step, save_vibe_state,
                                     vibe_trainer_fit)

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    smpl = synthetic_smpl_model(device=device)
    w = VibeLossWeights(
        kp_2d=float(cfg["LOSS.KP_2D_W"]),
        kp_3d=float(cfg["LOSS.KP_3D_W"]),
        shape=float(cfg["LOSS.SHAPE_W"]),
        pose=float(cfg["LOSS.POSE_W"]),
        adv=float(cfg["LOSS.D_MOTION_LOSS_W"]),
        disc_motion_lr=float(cfg["TRAIN.MOT_DISCR.LR"]))
    state = init_vibe_train_state(
        torch.Generator().manual_seed(args.seed), smpl,
        gen_lr=float(cfg["TRAIN.GEN_LR"]),
        disc_lr=float(cfg["TRAIN.MOT_DISCR.LR"]),
        feat_size=args.feat_size,
        feature_pool=str(cfg["TRAIN.MOT_DISCR.FEATURE_POOL"]),
        disc_num_layers=int(cfg["TRAIN.MOT_DISCR.NUM_LAYERS"]),
        attention_size=int(cfg["TRAIN.MOT_DISCR.ATT.SIZE"]),
        attention_layers=int(cfg["TRAIN.MOT_DISCR.ATT.LAYERS"]))
    step = make_vibe_train_step(smpl, w)

    b2d, b3d = split_2d3d_batch_sizes(batch_size,
                                      float(cfg["TRAIN.DATA_2D_RATIO"]))

    if args.synthetic:
        rng = np.random.default_rng(args.seed)
        n_iters = min(iters, max(1, args.synthetic // batch_size))

        def train_batches():
            for _ in range(n_iters):
                b = _synthetic_batch(rng, batch_size, seqlen,
                                     args.feat_size)
                yield {k: np.asarray(v) for k, v in b.items()}

        def valid_batches():
            b = _synthetic_batch(np.random.default_rng(999), batch_size,
                                 seqlen, args.feat_size)
            yield b

        real_motion_batches = None
    else:
        from ..data.sharded import ShardedDataset, batch_iterator

        def shard_feed(root, bs):
            if not root:
                return None
            ds = ShardedDataset(root)

            def make():
                it = batch_iterator(ds, bs, seed=args.seed)
                for _ in range(iters):
                    yield next(it)

            return make

        feed2d = shard_feed(args.shards_2d, max(b2d, 1))
        feed3d = shard_feed(args.shards_3d, max(b3d, 1))
        if feed2d is None and feed3d is None:
            print("error: need --shards_2d/--shards_3d or --synthetic",
                  file=sys.stderr)
            return 2

        def train_batches():
            return mixed_2d3d_iterator(feed2d, feed3d, iters)

        feed_eval = shard_feed(args.shards_eval, batch_size)
        valid_batches = feed_eval

        feed_motion = shard_feed(args.shards_motion, batch_size)
        real_motion_batches = (
            None if feed_motion is None
            else lambda: (b["pose_body"] for b in feed_motion()))

    state, best = vibe_trainer_fit(
        state, step, smpl, train_batches, valid_batches,
        real_motion_batches, epochs=epochs,
        lr_patience=int(cfg["TRAIN.LR_PATIENCE"]),
        debug_viz_every=args.debug_viz_every, debug_viz_dir=args.out)

    ckpt = osp.join(args.out, "vibe_train_state")
    save_vibe_state(ckpt, state)  # dir of gen/disc/gen_opt/disc_opt npz
    print(f"[vibe-train] best: " + " ".join(
        f"{k}={v:.2f}" for k, v in best.items()))
    print(f"[vibe-train] state -> {ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
