#!/usr/bin/env python
"""`--dp N` over NCCL on N cards against the one-process fit of the same
seed: python -m nemo_tpu_torch.cli.fit at chip_smoke.py's path Q
configuration (the reference NemoV2, batch 512, h_dim 1000, 8 views x 120
frames, 5/5/10 steps), once in one process, once with --dp N (the CLI
starts its N ranks, rank r on cuda:r), and once more in one process. It
prints each run's exit code, host seconds and the CLI's stage timers, the
run directories written (one a run: only rank 0 writes), and each main-stage
step's total_loss relative to the first one-process run.

    python scripts/torch_dp_check.py --dp 4

Needs N CUDA devices on one host.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dp", type=int, default=4)
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    from nemo_tpu_torch.ops import _build
    if torch.cuda.device_count() < args.dp:
        print(f"needs {args.dp} cards, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 1
    _build.library()
    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    smpl = synthetic_smpl_model(6890, seed=0, device=dev)
    bundle, _ = synthetic_problem(smpl, num_views=8, num_frames=120,
                                  img_hw=cs.IMG_HW, seed=0)
    res = {}
    with tempfile.TemporaryDirectory() as d:
        bundle.save(os.path.join(d, "bundle.npz"))
        for name, extra in (("one", []), (f"dp{args.dp}", ["--dp",
                                                          str(args.dp)]),
                            ("one_again", [])):
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", "nemo_tpu_torch.cli.fit",
                 *cs.q_argv(d, name), *extra], capture_output=True,
                text=True, timeout=600, cwd=ROOT,
                env=dict(os.environ, PYTHONPATH=ROOT))
            dt = time.perf_counter() - t0
            lines = [ln for ln in p.stdout.splitlines()
                     if "timer" in ln or "data-parallel" in ln
                     or "final" in ln]
            print(f"[{name}] rc {p.returncode} {dt:.1f} s: "
                  + " | ".join(lines), flush=True)
            if p.returncode:
                print(p.stdout[-3000:], p.stderr[-5000:])
                return 1
            run = os.path.join(d, name)
            print(f"[{name}] run directories {sorted(os.listdir(run))}")
            res[name] = np.load(os.path.join(run, "000000", "losses.npz"))[
                "total_loss"]
    for name in list(res)[1:]:
        rel = np.abs(res[name] - res["one"]) / np.abs(res["one"])
        print(f"[{name} vs one] total_loss relative by main step "
              f"{[float(f'{x:.2e}') for x in rel]}")
    print(json.dumps({k: v.tolist() for k, v in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
