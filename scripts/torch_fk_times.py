#!/usr/bin/env python
"""K1 (the kinematic-chain kernels) of one checkout on one GPU: times a
call, digests of the outputs, and launches a main-stage step.

    python scripts/torch_fk_times.py [--root DIR] [--label NAME]
        [--batches 512 960] [--trees smpl] [--reps 20] [--profile]

Imports ``nemo_tpu_torch`` from DIR (default: the checkout this script
lies in) and builds its kernels there; chip_smoke.py, whose helpers do
the measuring, comes from this script's checkout, so two checkouts are
measured by the same rules.

- K1f and K1b (``fk.fk_fwd_cuda``, ``fk.fk_bwd_cuda``) at each batch B on
  each of ``--trees`` (SMPL's 24 joints in 9 levels; ``chain``, 24 joints
  in 24 levels; ``star``, 24 joints in 2 levels: together they part the
  device time into a cost a level and the rest), chip_smoke.py's random
  rotations, offsets of 0.3 N(0, 1) and N(0, 1) cotangents (seed B),
  held against the plain versions (1e-5 forward, 1e-4 backward). Each
  line has ``ms``, the median of ``--reps`` CUDA-event timings of one
  call each (the wrapper's host work inside), ``loop_ms``, one call's
  share of ``--reps`` calls run back to back (scripts/torch_v2v_times.py's
  loop_ms: the device time only while the kernel outlasts the host's work
  a call), ``bound_ms`` (the bytes moved at 3.35 TB/s; the f32 operations
  at 67 TFLOP/s take less) and the sha256 of the outputs, so two
  checkouts that compute the same bits print the same digests.
- ``--profile`` adds ``device_ms``, the kernel's device time a launch
  (chip_smoke.py's ``profiled_ms``: torch.profiler, the mean over --reps
  launches from a trace that holds all of them; null where none did), and
  ``floor_ms``, the
  same for an empty kernel on K1's grid (``fk.fk_empty_cuda``; null where
  the checkout has none): the launch floor beside the bound.
- Launches a step: the reference configuration
  (chip_smoke.py's slice 1) and path A (the custom-video configuration
  with the opt-in 1024-vertex v2v subset), each after one warm main step,
  the K1f and K1b launches of one main step (the launch counters reset
  just before, read just after) and, with ``--profile``, their device time
  a main step (torch.profiler over 5 main steps).

To compare two commits on one card, unpack the other with ``git archive``
into a directory that .gitignore lists and run, in one call, this script
with --root set to each in turn: parent, change, change, parent.

Prints one JSON line per measurement, then the nvidia-smi line (name,
power limit). Needs a CUDA device.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=REPO)
    p.add_argument("--label", default="")
    p.add_argument("--batches", type=int, nargs="+", default=[512, 960])
    p.add_argument("--trees", nargs="+", default=["smpl"],
                   choices=["smpl", "chain", "star"])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--profile", action="store_true")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    sys.path.insert(0, REPO)
    import chip_smoke as cs     # this checkout's measuring rules
    sys.path.insert(0, root)    # --root's package and kernels
    import torch
    if not torch.cuda.is_available():
        print("torch_fk_times: needs a CUDA device", file=sys.stderr)
        return 1
    import nemo_tpu_torch
    from torch_v2v_times import digest, loop_ms
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.body.constants import SMPL_PARENTS
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    from nemo_tpu_torch.ops import fk, launch_counts, reset_launches
    if not os.path.abspath(nemo_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"nemo_tpu_torch came from {nemo_tpu_torch.__file__}"
                           f", not from {root}")
    device = torch.device("cuda", 0)
    trees = {"smpl": tuple(int(q) for q in SMPL_PARENTS),
             "chain": (-1,) + tuple(range(23)), "star": (-1,) + (0,) * 23}
    label = args.label or root
    empty = getattr(fk, "fk_empty_cuda", None)

    for tree, B in ((tree, B) for tree in args.trees for B in args.batches):
        parents = trees[tree]
        gen = torch.Generator().manual_seed(B)
        R = cs.random_rotations(B, 24, gen, device)
        t = (0.3 * torch.randn((B, 24, 3), generator=gen)).to(device)
        gR = torch.randn((B, 24, 3, 3), generator=gen).to(device)
        gt = torch.randn((B, 24, 3), generator=gen).to(device)
        Rg, tg = fk.fk_fwd_cuda(R, t, parents)
        Rp, tp = fk.fk_fwd_plain(R, t, parents)
        err_f = max(float((Rg - Rp).abs().max()), float((tg - tp).abs().max()))
        got = fk.fk_bwd_cuda(R, t, Rg, gR, gt, parents)
        want = fk.fk_bwd_plain(R, t, Rp, gR, gt, parents)
        err_b = max(float((a - b).abs().max()) for a, b in zip(got, want))
        if not (err_f <= 1e-5 and err_b <= 1e-4):
            raise AssertionError(f"K1 on {tree} at B={B}: errors {err_f}, "
                                 f"{err_b}")
        for kernel, key, fn, err, outs, ins in (
                ("K1f", "fk_fwd", lambda: fk.fk_fwd_cuda(R, t, parents), err_f,
                 (Rg, tg), (R, t)),
                ("K1b", "fk_bwd",
                 lambda: fk.fk_bwd_cuda(R, t, Rg, gR, gt, parents), err_b,
                 got, (R, t, Rg, gR, gt))):
            rec = {"label": label, "kernel": kernel, "tree": tree, "B": B,
                   "sha256": digest(*outs),
                   "ms": cs.median_ms(fn, reps=args.reps),
                   "loop_ms": loop_ms(fn, args.reps),
                   "bound_ms": 1e3 * cs.nbytes(*ins, *outs)
                   / cs.PEAK_HBM_BYTES,
                   "max_abs_err": err, "reps": args.reps}
            if args.profile:
                k = key + "_kernel"
                rec["device_ms"] = cs.profiled_ms(fn, (k,), args.reps)[k]
                rec["floor_ms"] = None if empty is None else cs.profiled_ms(
                    lambda: empty(B, 24, key == "fk_bwd", device),
                    ("fk_empty_kernel",), args.reps)["fk_empty_kernel"]
            print(json.dumps(rec), flush=True)

    smpl = synthetic_smpl_model(6890, seed=0, device=device)
    bundle, _ = synthetic_problem(smpl, num_views=8, num_frames=120,
                                  img_hw=cs.IMG_HW, seed=0)
    for name, cfg in (("reference", cs.reference_config()),
                      ("path A", cs.custom_video_config(vp_v2v_n_verts=1024))):
        fitter = cs.make_fitter(device, smpl, bundle, cfg)
        fitter.main_step()
        torch.cuda.synchronize()
        reset_launches()
        fitter.main_step()
        torch.cuda.synchronize()
        counts = launch_counts()
        rec = {"label": label, "config": name, "main_step_launches": {
            k: counts[k] for k in ("fk_fwd", "fk_bwd")}}
        if args.profile:
            rec["main_step_device_ms"] = {}
            for k in ("fk_fwd", "fk_bwd"):
                ms = cs.profiled_ms(fitter.main_step, (k + "_kernel",), 5,
                                    counts[k])[k + "_kernel"]
                rec["main_step_device_ms"][k] = None if ms is None \
                    else ms * counts[k]
        print(json.dumps(rec), flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
