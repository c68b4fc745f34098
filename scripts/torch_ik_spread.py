#!/usr/bin/env python
"""How far f32 summation order moves an IK fit: ik_fit by Adam on the CPU
at two torch thread counts, from the same targets.

The targets are chip_smoke.py path N1's: B targets posed from a seeded
VPoser draw (generator seed 2, z ~ 0.5 N(0, 1), translation ~ 0.3 N(0, 1))
through the synthetic body. For each of --steps, the fit runs once at each
thread count; the script prints the largest relative gap between the two
loss histories over the first 10, 20 and all steps, and how many rows'
fitted joints part by more than 1e-3 m.

    python scripts/torch_ik_spread.py --steps 10 100
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.body.smpl import smpl_forward
    from nemo_tpu_torch.geometry import batch_rodrigues
    from nemo_tpu_torch.priors import IKConfig, ik_fit
    from nemo_tpu_torch.priors.vposer import init_vposer, vposer_decode

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--vertices", type=int, default=6890)
    ap.add_argument("--steps", type=int, nargs="+", default=[10, 100])
    ap.add_argument("--threads", type=int, nargs=2, default=[1, 4])
    args = ap.parse_args()
    B = args.batch
    smpl = synthetic_smpl_model(args.vertices, seed=0)
    vp = init_vposer(generator=torch.Generator().manual_seed(2))
    rng = np.random.RandomState(0)
    z = torch.tensor(0.5 * rng.randn(B, 32), dtype=torch.float32)
    trans = torch.tensor(0.3 * rng.randn(B, 3), dtype=torch.float32)
    with torch.no_grad():
        pose63 = vposer_decode(vp, z)["pose_body"].reshape(B, 63)
        rot = batch_rodrigues(torch.cat([pose63, pose63.new_zeros((B, 6))],
                                        1).reshape(B, 23, 3))
        _, target = smpl_forward(
            smpl, pose63.new_zeros((1, 10)), rot,
            batch_rodrigues(pose63.new_zeros((B, 1, 3))),
            want_vertices=False, transl=trans)
    for steps in args.steps:
        fits = []
        for threads in args.threads:
            torch.set_num_threads(threads)
            fits.append(ik_fit(smpl, vp, target,
                               cfg=IKConfig(num_steps=steps)))
        a, b = fits
        gap = (np.abs(a["loss"].numpy() - b["loss"].numpy())
               / np.abs(a["loss"].numpy()))
        rows = (a["joints"] - b["joints"]).abs().amax(dim=(1, 2))
        print(f"{steps} Adam steps, threads {args.threads}: loss gap "
              f"{gap[:10].max():.2e} over the first 10, "
              f"{gap[:20].max():.2e} over 20, {gap.max():.2e} over all; "
              f"{int((rows > 1e-3).sum())} of {B} rows' joints part by "
              f"more than 1e-3 m (largest {float(rows.max()):.3e} m)")


if __name__ == "__main__":
    main()
