#!/usr/bin/env python
"""K2's fused and forward-only modes of one checkout, timed on one GPU.

    python scripts/torch_v2v_times.py [--root DIR] [--batches 512 960]
        [--reps 20] [--label NAME]

Imports ``nemo_tpu_torch`` and ``chip_smoke`` from DIR (default: the
checkout this script lies in), builds its kernels there, and for each batch
B draws both sides' pose features and transforms with chip_smoke.py's
skin_side_inputs on the synthetic 6890-vertex SMPL (seed B; the rec side
offset by +-10 m), holds the fused mode's total against the plain
version's (rtol 1e-5), and times ``lbs.v2v_l1_cuda`` with grad=True and grad=False: the
median of ``--reps`` CUDA-event timings of one call each after 3 warm-up
calls. To compare two commits on one card, unpack the other with
``git archive`` into a directory that .gitignore lists and run, in one
call, this script with --root set to each in turn: parent, change, change,
parent.

Prints one JSON line per (mode, batch), then the nvidia-smi line (name,
power limit). Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=REPO)
    p.add_argument("--batches", type=int, nargs="+", default=[512, 960])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("torch_v2v_times: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import median_ms, skin_side_inputs
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.ops import lbs
    import nemo_tpu_torch
    if not os.path.abspath(nemo_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"nemo_tpu_torch came from {nemo_tpu_torch.__file__}"
                           f", not from {root}")
    device = torch.device("cuda", 0)
    smpl = synthetic_smpl_model(6890, seed=0, device=device)
    vsh = smpl.v_template.t().contiguous()
    for B in args.batches:
        gen = torch.Generator().manual_seed(B)
        pf_o, A_o = skin_side_inputs(smpl, B, gen, device)
        pf_r, A_r = skin_side_inputs(smpl, B, gen, device, offset=10.0)
        a = (pf_o, A_o, vsh, smpl.posedirs_t, smpl.lbs_weights_t, pf_r, A_r)
        tot_k, _ = lbs.v2v_l1_cuda(*a, grad=True)
        tot_p, _ = lbs.v2v_l1_plain(*a, grad=False)
        rel = float((tot_k - tot_p).abs() / tot_p.abs())
        if not rel <= 1e-5:
            raise AssertionError(f"B={B}: total off by {rel:.3e} (rtol 1e-5)")
        for mode, grad in (("fused", True), ("forward_only", False)):
            ms = median_ms(lambda: lbs.v2v_l1_cuda(*a, grad=grad),
                           reps=args.reps)
            print(json.dumps({"label": args.label or root, "mode": mode,
                              "B": B, "V": 6890, "ms": ms,
                              "total_rel_err": rel, "reps": args.reps}),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
