#!/usr/bin/env python
"""K1 (the kinematic-chain kernels) on one GPU: device time a call, and
launches a main-stage step.

    python scripts/torch_fk_times.py [--batches 512 960] [--reps 20]

- K1f and K1b (``fk.fk_fwd_cuda``, ``fk.fk_bwd_cuda``) at each batch B on
  chip_smoke.py's random rotations and N(0, 1) offsets and cotangents
  (seed B), held against the plain versions (1e-5 forward, 1e-4
  backward). Each line has ``ms``, the median of ``--reps`` CUDA-event
  timings of one call each (the wrapper's host work inside), and
  ``device_ms``, one call's share of ``--reps`` calls run back to back
  (scripts/torch_v2v_times.py's loop_ms).
- Launches a step: the reference configuration (chip_smoke.py's slice 1)
  and path A (the custom-video configuration with the opt-in 1024-vertex
  v2v subset), each after one warm main step, the K1f and K1b launches of
  one main step (the launch counters reset just before, read just after).

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
    p.add_argument("--batches", type=int, nargs="+", default=[512, 960])
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch
    if not torch.cuda.is_available():
        print("torch_fk_times: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch_v2v_times import loop_ms
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.body.constants import SMPL_PARENTS
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    from nemo_tpu_torch.ops import fk, launch_counts, reset_launches
    device = torch.device("cuda", 0)
    parents = tuple(int(q) for q in SMPL_PARENTS)

    for B in args.batches:
        gen = torch.Generator().manual_seed(B)
        R = cs.random_rotations(B, 24, gen, device)
        t = torch.randn((B, 24, 3), generator=gen).to(device)
        gR = torch.randn((B, 24, 3, 3), generator=gen).to(device)
        gt = torch.randn((B, 24, 3), generator=gen).to(device)
        Rg, tg = fk.fk_fwd_cuda(R, t, parents)
        Rp, tp = fk.fk_fwd_plain(R, t, parents)
        err_f = max(float((Rg - Rp).abs().max()), float((tg - tp).abs().max()))
        got = fk.fk_bwd_cuda(R, t, Rg, gR, gt, parents)
        want = fk.fk_bwd_plain(R, t, Rp, gR, gt, parents)
        err_b = max(float((a - b).abs().max()) for a, b in zip(got, want))
        if not (err_f <= 1e-5 and err_b <= 1e-4):
            raise AssertionError(f"K1 at B={B}: errors {err_f}, {err_b}")
        for kernel, fn, err in (
                ("K1f", lambda: fk.fk_fwd_cuda(R, t, parents), err_f),
                ("K1b", lambda: fk.fk_bwd_cuda(R, t, Rg, gR, gt, parents),
                 err_b)):
            print(json.dumps({"kernel": kernel, "B": B,
                              "ms": cs.median_ms(fn, reps=args.reps),
                              "device_ms": loop_ms(fn, args.reps),
                              "max_abs_err": err, "reps": args.reps}),
                  flush=True)

    smpl = synthetic_smpl_model(6890, seed=0, device=device)
    bundle, _ = synthetic_problem(smpl, num_views=8, num_frames=120,
                                  img_hw=cs.IMG_HW, seed=0)
    for name, cfg in (("reference", cs.reference_config()),
                      ("path A", cs.custom_video_config(
                          vp_v2v_n_verts=1024))):
        fitter = cs.make_fitter(device, smpl, bundle, cfg)
        fitter.main_step()
        torch.cuda.synchronize()
        reset_launches()
        fitter.main_step()
        torch.cuda.synchronize()
        counts = launch_counts()
        print(json.dumps({"config": name, "main_step_launches": {
            k: counts[k] for k in ("fk_fwd", "fk_bwd")}}), flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
