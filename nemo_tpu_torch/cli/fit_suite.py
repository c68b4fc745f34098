"""CLI: fit a suite of actions (the reference's 5-action NeMo-MoCap sweep).

The port's counterpart of ``python -m nemo_tpu.cli.fit_suite``: each action's
bundle is fitted in turn by ``nemo_tpu_torch.cli.fit`` on one card, once per
seed; every flag other than --bundles, --out_dir and --seeds goes to the fit
unchanged. With --seeds N > 1 each action's runs go to
<out_dir>/<action>/seed<k>/ and <out_dir>/<action>/best.txt names the run
with the lowest final total_loss (its directory, then the loss).

Usage:
  python -m nemo_tpu_torch.cli.fit_suite --bundles a.npz b.npz c.npz \\
      --default_config configs/default-v2.yml --out_dir out/suite \\
      --smpl_path software/smpl ...
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys


def _final_total_loss(run_root: str) -> float:
    """The final total_loss of the latest run directory under run_root
    (inf when there is none)."""
    runs = sorted(d for d in os.listdir(run_root)
                  if osp.isdir(osp.join(run_root, d)))
    if not runs:
        return float("inf")
    final = float("inf")
    try:
        with open(osp.join(run_root, runs[-1], "metrics.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("phase") == "final":
                    final = float(rec.get("total_loss", final))
    except OSError:
        pass
    return final


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--bundles", nargs="+", required=True)
    parser.add_argument("--out_dir", type=str, default="out/suite")
    parser.add_argument("--seeds", type=int, default=1,
                        help=">1 fits each action once per seed and records "
                             "the best run by final total loss in best.txt; "
                             "same-shape main-stage-only sweeps can instead "
                             "use nemo_tpu_torch.parallel.fit_many_seeds, "
                             "which steps the seeds in lockstep on one card")
    args, passthrough = parser.parse_known_args(argv)

    from .fit import main as fit_main

    for bundle in args.bundles:
        name = osp.splitext(osp.basename(bundle))[0]
        best = (float("inf"), None)
        for seed in range(args.seeds):
            out = osp.join(args.out_dir, name) if args.seeds == 1 else \
                osp.join(args.out_dir, name, f"seed{seed}")
            print(f"\n=== action: {name} seed: {seed} ===")
            rc = fit_main(["--bundle", bundle, "--out_dir", out,
                           "--seed", str(seed)] + passthrough)
            if rc != 0:
                return rc
            loss = _final_total_loss(out)
            if loss < best[0]:
                best = (loss, out)
        if args.seeds > 1:
            print(f"[suite] {name}: best seed run {best[1]} "
                  f"(total_loss {best[0]:.4f})")
            with open(osp.join(args.out_dir, name, "best.txt"), "w") as f:
                f.write(f"{best[1]}\n{best[0]}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
