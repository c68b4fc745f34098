#!/usr/bin/env python
"""How far f32 summation order moves a HuMoR training gradient:
humor_full_loss with the three SMPL terms (chip_smoke.py path O2's
inputs), its gradients in every network tensor at several torch thread
counts in float32 and at one in float64.

The inputs are path O2's: 512 transitions of humor_tool train's seeded
synthetic windows (seed 0, 10 transitions), a seeded posterior draw and
betas, the 6890-vertex synthetic body; the weights init_humor's from
generator seed 0 (path O2 runs O1's trained ones). For each float32 run
the script prints the loss's and each gradient tensor's largest distance
from the float64 run, relative to the tensor's largest entry, worst
first; how many columns of the worst tensor part by more than 1e-6; the
ReLU gates (chip_smoke.humor_pre_relu) that the run takes otherwise than
float64, with the farthest such GroupNorm output from 0; and the worst
gradient again with those transitions left out.

    python scripts/torch_humor_grad_spread.py --threads 1 2 8
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import dataclasses

    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.body.smpl import _TENSOR_FIELDS
    from nemo_tpu_torch.cli.humor_tool import _synthetic_windows
    from nemo_tpu_torch.models import humor as hm
    from nemo_tpu_torch.models import humor_loss as hl

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 8])
    args = ap.parse_args()
    B, T = args.batch, 10
    w = _synthetic_windows(np.random.default_rng(0), 4096, T, 207)
    w = w[-B // T - 1:]
    past = w[:, :-1].reshape(-1, 207)[:B]
    tgt = w[:, 1:].reshape(-1, 207)[:B]
    gen = torch.Generator().manual_seed(12)
    eps = torch.randn((B, 48), generator=gen)
    betas = 0.3 * torch.randn((B, 10), generator=gen)
    params = hm.init_humor(torch.Generator().manual_seed(0),
                           hm.HumorConfig())
    lcfg = hl.HumorLossConfig(kl_loss=4e-4, smpl_joint_loss=1.0,
                              smpl_mesh_loss=1.0,
                              smpl_joint_consistency_loss=1.0)
    smpl = synthetic_smpl_model(6890, seed=0)
    names = [f"{m}.{k}" for m, k in hm.humor_leaves(params)]

    import chip_smoke

    def run(dtype, threads, rows=None):
        torch.set_num_threads(threads)
        p = {m: {k: v.to(dtype).clone().requires_grad_(True)
                 for k, v in sub.items()} for m, sub in params.items()}
        sm = smpl if dtype == torch.float32 else dataclasses.replace(
            smpl, **{f: getattr(smpl, f).double() for f in _TENSOR_FIELDS
                     if getattr(smpl, f).is_floating_point()})
        a = [torch.as_tensor(x, dtype=dtype) for x in (past, tgt, eps,
                                                        betas)]
        pre = chip_smoke.humor_pre_relu(p, hm.HumorConfig(), *a[:3])
        if rows is not None:
            a = [x[rows] for x in a]
        loss, _ = hl.humor_full_loss(p, hm.HumorConfig(), lcfg, a[0], a[1],
                                     a[2], 0, smpl_fn=hl.smpl_terms_fn(sm),
                                     betas=a[3])
        grads = torch.autograd.grad(loss, [p[m][k] for m, k in
                                           hm.humor_leaves(p)])
        return float(loss), [g.double() for g in grads], pre

    ref = run(torch.float64, max(args.threads))
    for th in args.threads:
        loss, grads, pre = run(torch.float32, th)
        errs = sorted(((float((g - r).abs().max() / r.abs().max()), n, i)
                       for i, (g, r, n) in enumerate(zip(grads, ref[1],
                                                         names))),
                      reverse=True)
        e, n, i = errs[0]
        cols = int(((grads[i] - ref[1][i]).abs().reshape(
            grads[i].shape[0], -1).max(0).values
            > 1e-6 * ref[1][i].abs().max()).sum())
        flips, far = set(), 0.0
        for key, a in pre.items():
            flip = (a > 0) != (ref[2][key] > 0)
            if flip.any():
                flips.update(torch.nonzero(flip.any(1)).flatten().tolist())
                far = max(far, float(a[flip].abs().max()))
        kept = torch.tensor([i for i in range(B) if i not in flips])
        _, g_kept, _ = run(torch.float32, th, kept)
        _, r_kept, _ = run(torch.float64, max(args.threads), kept)
        kept_err = max(float((g - r).abs().max() / r.abs().max())
                       for g, r in zip(g_kept, r_kept))
        print(f"float32 at {th} threads vs float64: loss "
              f"{abs(loss - ref[0]) / abs(ref[0]):.2e} relative; gradients "
              "worst " + "; ".join(f"{nm} {x:.2e}" for x, nm, _ in errs[:4])
              + f"; {cols} columns of {n} past 1e-6; ReLU gates taken "
              f"otherwise than float64 in transitions {sorted(flips)} "
              f"(farthest from 0 at {far:.2e}); without them the worst "
              f"gradient {kept_err:.2e}")


if __name__ == "__main__":
    main()
