"""CLI: HuMoR 3D fitting on AMASS, on the device named by ``--device``.

Port of nemo_tpu/cli/humor_tool.py's ``process-amass`` (raw AMASS ->
per-sequence npz, humor/scripts/process_amass_data.py) and ``fit-amass``
(observations -> 3-stage HuMoR fit with the 3D energies -> result dirs +
the eval CSV family, run_fitting.py data_type=AMASS + eval_fitting_3d.py),
with the JAX CLI's flags and defaults plus ``--device`` (default ``cuda``;
the CPU runs the plain PyTorch versions of the kernels and must be asked
for). The other subcommands (train, train-state-prior, fit-eval, fit-rgb,
fit-prox, viz-fit), real SMPL files (``--smpl_path``) and HuMoR checkpoints
(``--humor_ckpt``) are still to port (ROADMAP.md Queue 1, Slice 6).

Usage:
  python -m nemo_tpu_torch.cli.humor_tool process-amass --amass_root raw/ \\
      --out processed/ [--datasets HumanEva] [--cleanup_backup removed/]
  python -m nemo_tpu_torch.cli.humor_tool fit-amass --amass processed/ \\
      --out fit/ --obs joints verts points [--seq_len 60 --steps 30 70 70]
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp
import sys

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument("--device", type=str, default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "PyTorch versions)")

    fa = sub.add_parser(
        "fit-amass",
        help="3D fitting on processed AMASS: noisy/partial observations "
             "(amass_fit_observations) -> 3-stage HuMoR fit with the "
             "obs3d energies -> result dirs + eval CSV family "
             "(run_fitting.py data_type=AMASS + eval_fitting_3d.py)")
    fa.add_argument("--amass", type=str, required=True,
                    help="processed AMASS root (process-amass output) or "
                         "a single sequence npz")
    fa.add_argument("--out", type=str, required=True)
    fa.add_argument("--split", type=str, default="test",
                    choices=["train", "val", "test", "all"])
    fa.add_argument("--seq_len", type=int, default=60)
    fa.add_argument("--max_seqs", type=int, default=0)
    fa.add_argument("--obs", type=str, nargs="+", default=["verts"],
                    choices=["joints", "verts", "points"],
                    help="observation modalities (--amass-use-*)")
    fa.add_argument("--root_only", action="store_true", default=False)
    fa.add_argument("--noise_std", type=float, default=0.0)
    fa.add_argument("--make_partial", action="store_true", default=False)
    fa.add_argument("--partial_height", type=float, default=0.9)
    fa.add_argument("--drop_middle", action="store_true", default=False)
    fa.add_argument("--num_samp_pts", type=int, default=512)
    fa.add_argument("--smpl_path", type=str, default="")
    fa.add_argument("--humor_ckpt", type=str, default="")
    fa.add_argument("--init_motion_prior", type=str, default="")
    fa.add_argument("--latent_size", type=int, default=48)
    fa.add_argument("--steps", type=int, nargs=3, default=[30, 70, 70],
                    metavar=("S1", "S2", "S3"))
    fa.add_argument("--lr", type=float, default=1e-2)
    fa.add_argument("--seed", type=int, default=0)
    fa.add_argument("--no_eval", action="store_true", default=False,
                    help="skip the eval_fitting_3d CSV pass")
    device_arg(fa)

    pa = sub.add_parser(
        "process-amass",
        help="raw AMASS -> per-sequence training npz "
             "(humor/scripts/process_amass_data.py)")
    pa.add_argument("--amass_root", type=str, required=True)
    pa.add_argument("--out", type=str, required=True)
    pa.add_argument("--datasets", type=str, nargs="*", default=[],
                    help="subset of AMASS dataset dirs (default: all)")
    pa.add_argument("--smpl_path", type=str, default="")
    pa.add_argument("--synthetic_assets", action="store_true", default=False)
    pa.add_argument("--cleanup_backup", type=str, default="",
                    help="after processing, move treadmill/skating clips "
                         "to this backup dir (cleanup_amass_data.py)")
    device_arg(pa)
    return p


def _smpl_model(smpl_path: str, device):
    from ..body.assets import synthetic_smpl_model
    if smpl_path:
        raise NotImplementedError(
            "--smpl_path: the real SMPL loaders are not ported yet "
            "(ROADMAP.md Queue 1, Slice 1 item 2); omit it for the synthetic "
            "model")
    return synthetic_smpl_model(device=device)


def _humor_params(path: str, cfg, seed: int, device):
    """HuMoR parameters: random ones from init_humor with a generator seeded
    by ``seed`` when path is empty (the JAX CLI's default)."""
    from ..models.humor import init_humor
    if path:
        raise NotImplementedError(
            "--humor_ckpt: loading HuMoR checkpoint files is not ported yet "
            "(ROADMAP.md Queue 1, Slice 6); omit it for random weights")
    return init_humor(torch.Generator().manual_seed(seed), cfg, device=device)


def _fit_config(args):
    """The fit_amass_keypts.cfg weight columns (stage-3 values where the
    term is stage-3-only), as the JAX CLI sets them."""
    from ..models.humor_fit import MotionOptConfig
    return MotionOptConfig(
        steps_stage1=args.steps[0], steps_stage2=args.steps[1],
        steps_stage3=args.steps[2], lr=args.lr,
        joints3d_weight=1.0 if "joints" in args.obs else 0.0,
        verts3d_weight=1.0 if "verts" in args.obs else 0.0,
        points3d_weight=1.0 if "points" in args.obs else 0.0,
        joints3d_smooth_weight=0.1,
        shape_prior_weight=1.67e-4,
        motion_prior_weight=5e-4,
        init_motion_prior_weight=5e-4,
        joint_consistency_weight=1.0, bone_length_weight=10.0,
        contact_vel_weight=1.0, contact_height_weight=1.0,
        floor_reg_weight=0.0)


def cmd_fit_amass(args) -> int:
    from .. import resolve_device
    from ..body.smpl import smpl_forward
    from ..data.amass_process import (KEYPT_VERTS, amass_fit_observations,
                                      amass_split_dirs)
    from ..models.humor import HumorConfig
    from ..models.humor_fit import humor_motion_fit, load_init_motion_prior
    from ..models.humor_fit_eval import (eval_fitting_results_dirs,
                                         save_fitting_results)

    device = resolve_device(args.device)
    model = _smpl_model(args.smpl_path, device)
    V = model.num_vertices
    keypt = np.asarray([v for v in KEYPT_VERTS if v < V])

    if osp.isfile(args.amass):
        seq_paths = [args.amass]
    else:
        seq_paths = []
        for d in amass_split_dirs(args.amass, args.split):
            seq_paths += sorted(glob.glob(osp.join(d, "*/*.npz")))
    if args.max_seqs:
        seq_paths = seq_paths[:args.max_seqs]
    if not seq_paths:
        print("[fit-amass] no processed sequences found under", args.amass)
        return 1

    hcfg = HumorConfig(latent_size=args.latent_size)
    hp = _humor_params(args.humor_ckpt, hcfg, args.seed, device)
    init_prior = (load_init_motion_prior(args.init_motion_prior, device)
                  if args.init_motion_prior else None)
    cfg = _fit_config(args)

    res_root = osp.join(args.out, "results_out")
    n_fit = 0
    for i, path in enumerate(seq_paths):
        seq = dict(np.load(path, allow_pickle=True))
        if np.asarray(seq["trans"]).shape[0] < args.seq_len:
            continue
        obs, gt = amass_fit_observations(
            seq, model, seq_len=args.seq_len,
            return_joints="joints" in args.obs,
            return_verts="verts" in args.obs,
            return_points="points" in args.obs,
            noise_std=args.noise_std, make_partial=args.make_partial,
            partial_height=args.partial_height,
            drop_middle=args.drop_middle, num_samp_pts=args.num_samp_pts,
            root_only=args.root_only, seed=args.seed + i)
        obs3d = {k: torch.as_tensor(v, device=device) for k, v in obs.items()}
        if "verts3d" in obs3d:
            obs3d["verts3d_inds"] = keypt
        T = args.seq_len
        init_pose = np.zeros((T, 72), np.float32)
        init_pose[:, :3] = gt["root_orient"]   # like the reference, fits
        #                                        start from the observed root
        fit = humor_motion_fit(model, hp, hcfg, None,
                               torch.as_tensor(init_pose, device=device),
                               cfg=cfg, init_motion_prior=init_prior,
                               obs3d=obs3d)
        pose = fit["pose"].cpu().numpy()
        name = osp.splitext(osp.basename(path))[0]
        parent = osp.basename(osp.dirname(path))
        seq_name = f"{parent}_{name}_{i}"
        stage3 = {"betas": fit["betas"].cpu().numpy().reshape(-1),
                  "trans": fit["trans"].cpu().numpy(),
                  "root_orient": pose[:, :3], "pose_body": pose[:, 3:66]}
        gt_save = {"betas": gt["betas"][:10], "trans": gt["trans"],
                   "root_orient": gt["root_orient"],
                   "pose_body": gt["pose_body"],
                   "contacts": gt.get("contacts")}
        save_fitting_results(
            osp.join(res_root, seq_name), stage3,
            gt={k: v for k, v in gt_save.items() if v is not None},
            observations=obs,
            optim_bm=args.smpl_path or "synthetic",
            gt_bm=args.smpl_path or "synthetic")
        n_fit += 1
        print(f"[fit-amass] {seq_name}: stage3 loss "
              f"{float(fit['stage3_loss'][-1]):.4f}")
    print(f"[fit-amass] fitted {n_fit} sequences -> {res_root}")
    if n_fit == 0:
        return 1

    if not args.no_eval:
        def smpl_fn(trans, root_orient, pose_body, betas):
            n = trans.shape[0]
            body = np.zeros((n, 69), np.float32)
            body[:, :63] = pose_body
            t = lambda a: torch.tensor(np.asarray(a, np.float32),
                                       device=device)
            with torch.no_grad():
                verts, _, fk = smpl_forward(
                    model, t(np.asarray(betas)[:, :10]), t(body),
                    t(root_orient), pose2rot=True, transl=t(trans),
                    want_fk_joints=True)
            return fk.cpu().numpy(), verts.cpu().numpy()

        eval_dir = osp.join(args.out, "eval_out")
        seqs = eval_fitting_results_dirs(res_root, eval_dir, smpl_fn)
        print(f"[fit-amass] evaluated {len(seqs)} sequences -> {eval_dir}")
    return 0


def cmd_process_amass(args) -> int:
    from .. import resolve_device
    from ..data.amass_process import cleanup_amass_data, process_amass_dir

    model = _smpl_model(args.smpl_path, resolve_device(args.device))
    written = process_amass_dir(args.amass_root, args.out, model,
                                datasets=args.datasets or None)
    print(f"[process-amass] wrote {len(written)} sequences -> {args.out}")
    if args.cleanup_backup:
        moved = cleanup_amass_data(args.out, args.cleanup_backup)
        print(f"[process-amass] cleanup moved {len(moved)} clips "
              f"-> {args.cleanup_backup}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "process-amass":
        return cmd_process_amass(args)
    return cmd_fit_amass(args)


if __name__ == "__main__":
    sys.exit(main())
