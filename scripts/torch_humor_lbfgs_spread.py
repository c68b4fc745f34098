#!/usr/bin/env python
"""How the L-BFGS HuMoR fit (chip_smoke.py path N3) varies from run to
run on the card, and why: humor_motion_fit(optimizer="lbfgs") at path
N3's steps (chip_smoke.N_HUMOR_STEPS) on path K's fit-prox --rgbd window
(the 6890-vertex body, 4096 scan points, K4 once a loss evaluation),
repeated from the same inputs.

It prints, for each fit, every linesearch as "value before -> value at
the accepted step (stepsize)", and whether stage 2 ended below where it
began (the N3 check: the loss before its last step under the loss
before its first). Fits run first in PyTorch's default CUDA mode, then
under chip_smoke.deterministic_cuda(). At each stage's start it
evaluates the loss and its gradient six times in each mode and prints
how far they part (the largest entry's distance over the gradient's
largest entry). With --cpu_steps it runs stage 2's first L-BFGS steps
on the CPU from the card's stage-1 result, the same f32 arithmetic in
one fixed order, to show whether the stall is the card's.

    python scripts/torch_humor_lbfgs_spread.py --reps 12 --det_reps 3 \\
        --cpu_steps 1

Needs a CUDA device; the CPU steps take minutes each at this size.
"""

import argparse
import dataclasses
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=12,
                    help="fits in PyTorch's default CUDA mode")
    ap.add_argument("--det_reps", type=int, default=3,
                    help="fits under deterministic algorithms")
    ap.add_argument("--cpu_steps", type=int, default=0,
                    help="stage-2 L-BFGS steps on the CPU (0: none)")
    args = ap.parse_args()
    # deterministic_cuda() needs cuBLAS's workspace named before the first
    # product; this is the H100's default
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    import chip_smoke as cs
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.fit import lbfgs
    from nemo_tpu_torch.models import humor_fit
    from nemo_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    _build.library()
    print(f"[spread] {cs.nvidia_smi_line()}; torch {torch.__version__}")
    smpl = synthetic_smpl_model(6890, seed=0, device=device)

    searches = []
    real_search = lbfgs.zoom_linesearch

    def logged_search(vg, params, updates, value, grad, stats=None):
        step, new_value, new_grad, finite = real_search(
            vg, params, updates, value, grad, stats)
        searches.append((float(value), float(new_value), float(step)))
        return step, new_value, new_grad, finite

    stages = []
    real_opt = humor_fit._run_opt

    def recording_opt(loss_fn, params0, steps, lr, optimizer="adam",
                      stats=None):
        stages.append((loss_fn, params0))
        return real_opt(loss_fn, params0, steps, lr, optimizer, stats)

    def spread(loss_fn, params, n=6):
        values, grads = [], []
        for _ in range(n):
            v, g = lbfgs.value_and_grad(loss_fn, params)
            values.append(float(v))
            grads.append(torch.cat([g[k].reshape(-1) for k in sorted(g)]))
        big = float(grads[0].abs().max())
        return (max(values) - min(values),
                max(float((g - grads[0]).abs().max()) for g in grads) / big)

    lbfgs.zoom_linesearch = logged_search
    humor_fit._run_opt = recording_opt
    with tempfile.TemporaryDirectory() as d:
        files, _ = cs.write_asset_files(d, smpl)
        _, _, (px_a, px_k) = cs.path_k(device, smpl, files, d)
        s1, s2, s3 = cs.N_HUMOR_STEPS
        cfg = dataclasses.replace(px_k["cfg"], optimizer="lbfgs",
                                  steps_stage1=s1, steps_stage2=s2,
                                  steps_stage3=s3)

        def fit(tag):
            del searches[:], stages[:]
            t0 = time.perf_counter()
            out = humor_fit.humor_motion_fit(*px_a, **dict(px_k, cfg=cfg))
            torch.cuda.synchronize()
            l2 = out["stage2_loss"].cpu()
            finite = all(bool(torch.isfinite(v).all()) for v in out.values())
            print(f"[spread] {tag}: {time.perf_counter() - t0:.1f} s, finite "
                  f"{finite}, stage 2 descended {bool(l2[-1] < l2[0])} "
                  f"({float(l2[0] - l2[-1]):.4f}); " + " | ".join(
                      f"{a:.4f} -> {b:.4f} ({s:.3g})"
                      for a, b, s in searches), flush=True)
            return list(searches)

        runs = [fit(f"default fit {r}") for r in range(args.reps)]
        starts = list(stages)
        for i, (fn, p) in enumerate(starts):
            dv, dg = spread(fn, p)
            print(f"[spread] default mode, stage {i + 1}'s start: loss "
                  f"spread {dv:.4g}, gradient spread {dg:.3g} of its "
                  f"largest entry")
        with cs.deterministic_cuda():
            for i, (fn, p) in enumerate(starts):
                dv, dg = spread(fn, p)
                print(f"[spread] deterministic, stage {i + 1}'s start: "
                      f"loss spread {dv:.4g}, gradient spread {dg:.3g} of "
                      f"its largest entry")
            det = [fit(f"deterministic fit {r}")
                   for r in range(args.det_reps)]
        print(f"[spread] default fits that repeat the first: "
              f"{sum(r == runs[0] for r in runs)} of {len(runs)}; "
              f"deterministic fits that repeat the first: "
              f"{sum(r == det[0] for r in det)} of {len(det)}")

        if args.cpu_steps:
            cpu = torch.device("cpu")
            mv = lambda t: t.to(cpu) if torch.is_tensor(t) else t
            kp = humor_fit.KeypointObs(mv(px_a[3]), mv(px_a[6]), torch.full(
                (), float(px_k["focal_length"])))
            obs = {n: mv(v) for n, v in px_k["obs3d"].items()}
            smpl_c = px_a[0].to(cpu)
            p2 = {k: mv(v) for k, v in starts[1][1].items()}
            del searches[:]
            t0 = time.perf_counter()
            lbfgs.lbfgs_run(lambda p: humor_fit.stage2_loss(
                smpl_c, cfg, p, obs, kp, None, mv(px_a[5])), p2,
                args.cpu_steps)
            print(f"[spread] CPU stage 2 from the card's stage-1 result, "
                  f"{torch.get_num_threads()} threads, "
                  f"{time.perf_counter() - t0:.1f} s: " + " | ".join(
                      f"{a:.4f} -> {b:.4f} ({s:.3g})"
                      for a, b, s in searches), flush=True)
    lbfgs.zoom_linesearch = real_search
    humor_fit._run_opt = real_opt


if __name__ == "__main__":
    main()
