"""Build a VIBE training database (and sharded training set) from a raw
dataset directory (port of nemo_tpu/cli/build_vibe_db.py; the same flags).

The CLI twin of running the reference's per-dataset builders
(VIBE/lib/data_utils/{threedpw,penn_action,mpii3d,posetrack,insta,amass,
h36m,nemomocap}_utils.py as __main__, which joblib-dump vibe_db/*_db.pt):

  python -m nemo_tpu_torch.cli.build_vibe_db --dataset 3dpw --dir 3dpw \
      --out vibe_db/3dpw_train_db.pt --shards_out shards/3dpw --seqlen 16

AMASS writes the motion-discriminator db ({theta, trans, vid_name});
every other dataset goes through VibeDbBuilder -> canonical db dict ->
optional sharded windows for models/vibe_train.py. It runs on the host;
the db is written in joblib's format without joblib (utils/pickles).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True,
                   choices=["3dpw", "penn_action", "mpii3d", "posetrack",
                            "insta", "amass", "h36m", "nemomocap"])
    p.add_argument("--dir", required=True, help="dataset root directory")
    p.add_argument("--split", default="train")
    p.add_argument("--out", default="", help="joblib db output path")
    p.add_argument("--shards_out", default="",
                   help="also window + write data/sharded.py shards")
    p.add_argument("--seqlen", type=int, default=16)
    p.add_argument("--stride", type=int, default=0,
                   help="window stride (0 = seqlen, non-overlapping)")
    p.add_argument("--shard_size", type=int, default=512)
    # nemomocap layout roots (nemomocap_utils.py:45-71)
    p.add_argument("--mocap_root", default="")
    p.add_argument("--cam_dir", default="")
    return p


def main(argv=None) -> int:
    from ..data import vibe_readers as vr
    from ..data.vibe_db import VibeDbBuilder, db_to_shards, read_3dpw, \
        read_penn_action

    args = build_parser().parse_args(argv)

    if args.dataset == "amass":
        db = vr.read_amass(args.dir)
        if args.out:
            from ..utils import pickles
            pickles.dump(db, args.out)
        print(f"[vibe_db] amass: {db['theta'].shape[0]} frames, "
              f"{len(set(db['vid_name']))} clips")
        if args.shards_out:
            from ..data.sharded import write_shards
            from ..data.vibe_db import make_windows
            win = make_windows(db["vid_name"], args.seqlen,
                               args.stride or None)
            write_shards({"theta": db["theta"][win]}, args.shards_out,
                         shard_size=args.shard_size)
            print(f"[vibe_db] {len(win)} windows -> {args.shards_out}")
        return 0

    builders = {
        "3dpw": lambda: read_3dpw(args.dir, args.split),
        "penn_action": lambda: read_penn_action(args.dir),
        "mpii3d": lambda: vr.read_mpii3d(args.dir),
        "posetrack": lambda: vr.read_posetrack(args.dir, args.split),
        "insta": lambda: vr.read_insta(args.dir, args.split),
        "h36m": lambda: vr.read_h36m(args.dir),
        "nemomocap": lambda: vr.read_nemomocap(
            args.dir, args.mocap_root or args.dir,
            args.cam_dir or args.dir, args.split),
    }
    builder: VibeDbBuilder = builders[args.dataset]()
    db = builder.save(args.out) if args.out else builder.build()
    n_seqs = len(set(db["vid_name"]))
    print(f"[vibe_db] {args.dataset}/{args.split}: "
          f"{db['vid_name'].shape[0]} frames, {n_seqs} sequences"
          + (f" -> {args.out}" if args.out else ""))
    if args.shards_out:
        n, _ = db_to_shards(db, args.shards_out, seqlen=args.seqlen,
                            stride=args.stride or None,
                            shard_size=args.shard_size)
        print(f"[vibe_db] {n} windows -> {args.shards_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
