"""Read a cell's compared numbers on many seeds in one process: the
program's, the control's (the reference one precision lower in the
program's place) and each planted fault's, every one against the
reference. The limits in workloads/<cell>.json are set from these
readings; the benchmark's own runs never run this.

    python3 portbench/controls.py --workload <cell> --seeds 1,2,3 \
        [--out out/controls_<cell>.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    from portbench.harness.cell import cell_spec
    from portbench.harness.readers import load_module
    if args.device == "cuda" and not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    spec = cell_spec(args.workload)
    wl = spec["workload"]
    mod = load_module("drivers", wl["driver"])
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = mod.Driver(spec["config"], spec["traffic"], seed,
                         torch.device(args.device), wl["limits"])
        got = drv.readings()
        row = {"seed": seed, "seconds": time.perf_counter() - t0,
               **{kind: {n: v for n, v, _ in vals}
                  for kind, vals in got.items()}}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del drv
        if args.device == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
