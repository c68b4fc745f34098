#!/usr/bin/env python
"""K2 and K3b of one checkout, timed on one GPU, with digests of K2's outputs.

    python scripts/torch_v2v_times.py [--root DIR] [--batches 512 960]
        [--reps 20] [--label NAME]

Imports ``nemo_tpu_torch`` and ``chip_smoke`` from DIR (default: the
checkout this script lies in) and builds its kernels there.

- K2: for each batch B, draws both sides' pose features and transforms with
  chip_smoke.py's skin_side_inputs on the synthetic 6890-vertex SMPL (seed
  B; the rec side offset by +-10 m), holds the fused mode's total against
  the plain version's (rtol 1e-5), and times ``lbs.v2v_l1_cuda`` with
  grad=True and grad=False. Each line carries the sha256 of the mode's
  outputs on these seeded inputs (fused: the total, gpf, gA and gvsh;
  forward-only: the total), so two checkouts whose K2 computes the same
  bits print the same digests.
- K3b: at (512, 6890) and at path A's (960, 1024) (chip_smoke.py's 1024
  vertex subset), pf and A as above (seed B + V), a N(0,1) cotangent and
  the posed vertices computed by the plain einsum; holds
  ``lbs.skin_bwd_cuda`` against ``lbs.skin_bwd_plain`` (1e-4 of each
  gradient's largest entry) and times it recomputing vp and reading it.

A time is the median of ``--reps`` CUDA-event timings of one call each
after 3 warm-up calls. To compare two commits on one card, unpack the other
with ``git archive`` into a directory that .gitignore lists and run, in one
call, this script with --root set to each in turn: parent, change, change,
parent.

Prints one JSON line per (kernel, mode, shape), then the nvidia-smi line
(name, power limit). Needs a CUDA device.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K3B_SHAPES = ((512, 6890), (960, 1024))


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


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
    from nemo_tpu_torch.body.smpl import subset_skin_tables
    from nemo_tpu_torch.ops import lbs
    import nemo_tpu_torch
    if not os.path.abspath(nemo_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"nemo_tpu_torch came from {nemo_tpu_torch.__file__}"
                           f", not from {root}")
    device = torch.device("cuda", 0)
    smpl = synthetic_smpl_model(6890, seed=0, device=device)
    vsh = smpl.v_template.t().contiguous()
    label = args.label or root

    def emit(**rec):
        print(json.dumps({"label": label, **rec, "reps": args.reps}),
              flush=True)

    for B in args.batches:
        gen = torch.Generator().manual_seed(B)
        pf_o, A_o = skin_side_inputs(smpl, B, gen, device)
        pf_r, A_r = skin_side_inputs(smpl, B, gen, device, offset=10.0)
        a = (pf_o, A_o, vsh, smpl.posedirs_t, smpl.lbs_weights_t, pf_r, A_r)
        tot_k, grads = lbs.v2v_l1_cuda(*a, grad=True)
        tot_f, _ = lbs.v2v_l1_cuda(*a, grad=False)
        tot_p, _ = lbs.v2v_l1_plain(*a, grad=False)
        rel = float((tot_k - tot_p).abs() / tot_p.abs())
        if not rel <= 1e-5:
            raise AssertionError(f"B={B}: total off by {rel:.3e} (rtol 1e-5)")
        sha = {"fused": digest(tot_k, *grads), "forward_only": digest(tot_f)}
        for mode, grad in (("fused", True), ("forward_only", False)):
            ms = median_ms(lambda: lbs.v2v_l1_cuda(*a, grad=grad),
                           reps=args.reps)
            emit(kernel="K2", mode=mode, B=B, V=6890, ms=ms,
                 total_rel_err=rel, sha256=sha[mode])

    for B, V in K3B_SHAPES:
        gen = torch.Generator().manual_seed(B + V)
        pf, A = skin_side_inputs(smpl, B, gen, device)
        if V == smpl.num_vertices:
            s = (pf, A, vsh, smpl.posedirs_t, smpl.lbs_weights_t)
        else:
            vidx, pd_s, W_s = subset_skin_tables(smpl, V)
            s = (pf, A, vsh[:, vidx].contiguous(), pd_s, W_s)
        g = torch.randn((B, 3, V), generator=gen).to(device)
        vp = (torch.einsum('bp,pkv->bkv', pf, s[3]) + s[2]).contiguous()
        for mode, stored in (("recompute", None), ("stored_vp", vp)):
            got = lbs.skin_bwd_cuda(*s, g, vp=stored)
            want = lbs.skin_bwd_plain(*s, g, vp=stored)
            rel = max(float((x - y).abs().max() / y.abs().max())
                      for x, y in zip(got, want))
            if not rel <= 1e-4:
                raise AssertionError(f"K3b {mode} at ({B}, {V}): off by "
                                     f"{rel:.3e} of a gradient's largest "
                                     f"entry (1e-4)")
            ms = median_ms(lambda: lbs.skin_bwd_cuda(*s, g, vp=stored),
                           reps=args.reps)
            emit(kernel="K3b", mode=mode, B=B, V=V, ms=ms, max_rel_err=rel)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
