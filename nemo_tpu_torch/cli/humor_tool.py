"""CLI: HuMoR training, its init-state prior, and fitting on AMASS, RGB
video and PROX, on the device named by ``--device``.

Port of nemo_tpu/cli/humor_tool.py's eight subcommands, with the JAX CLI's
flags and defaults plus ``--device`` (default ``cuda``; the CPU runs the
plain PyTorch versions of the kernels and must be asked for):

  * ``train``: the HuMoR CVAE (train_humor.py) on ``--synthetic`` N
    random-walk windows, ``--shards`` (data/sharded.py, key 'states',
    (B, T+1, 207) aligned-local windows) or ``--amass`` (a process-amass
    tree, windows assembled and canonicalized per
    --amass_split/--amass_stride); supervised, or scheduled sampling with
    --sched_samp_start/--sched_samp_end; writes train_stats.jsonl (one row
    an epoch: each stat's mean, epoch, sec) and humor_params.npz (flat
    'module.key' float32 arrays, what ``--humor_ckpt`` reads in either
    package);
  * ``train-state-prior``: the init-state GMM by EM
    (train_state_prior.py) on a ``--states`` .npy of (N, 138) states or a
    synthetic mixture from ``--seed``; writes prior_gmm.npz (what
    ``--init_motion_prior`` reads in either package);
  * ``process-amass``: raw AMASS -> per-sequence npz
    (humor/scripts/process_amass_data.py);
  * ``fit-amass``: observations -> 3-stage HuMoR fit with the 3D energies
    -> result dirs + the eval CSV family (run_fitting.py data_type=AMASS +
    eval_fitting_3d.py);
  * ``fit-rgb``: OpenPose keypoints of one video -> the 3-stage fit per
    overlapping subsequence -> stitched final_results with the motion in
    the prior's frame (run_fitting.py data_type=RGB);
  * ``fit-prox``: PROX recordings, RGB keypoints and with ``--rgbd`` the
    depth point clouds (K4 on every step) -> result dirs + eval CSVs
    (data_type=PROX-RGB / PROX-RGBD, fit_prox.cfg / fit_proxd.cfg);
  * ``viz-fit``: result dirs -> mesh overlay frames (K5s on the card) with
    the observed 2D joints and the prior-frame view (viz_fitting_rgb.py);
  * ``fit-eval``: result dirs -> the eval CSV family, with ``--stages``
    the per-stage files too (eval_fitting_3d.py).

``--smpl_path`` names an SMPL .npz (the smplx tools' layout);
``--humor_ckpt`` a ``train`` .npz of flat 'module.key' arrays or a HuMoR
torch checkpoint, random weights from ``--seed`` when it is empty. As in
the JAX CLI, ``train`` passes no contact labels and no body model, so its
contact BCE and SMPL terms do not run (ROADMAP.md Queue 3).

Usage:
  python -m nemo_tpu_torch.cli.humor_tool train --synthetic 2048 \
      --epochs 3 --batch_size 64 --out run/ [--sched_samp_start 1 \
      --sched_samp_end 3] [--amass processed/ | --shards shards/]
  python -m nemo_tpu_torch.cli.humor_tool train-state-prior \
      [--states states.npy] --gmm_comps 12 --out prior/
  python -m nemo_tpu_torch.cli.humor_tool process-amass --amass_root raw/ \\
      --out processed/ [--datasets HumanEva] [--cleanup_backup removed/]
  python -m nemo_tpu_torch.cli.humor_tool fit-amass --amass processed/ \\
      --out fit/ --obs joints verts points [--seq_len 60 --steps 30 70 70]
  python -m nemo_tpu_torch.cli.humor_tool fit-rgb --joints2d keypoints/ \\
      --out rgb/ [--img_dir frames/ --seq_len 60 --overlap_len 10]
  python -m nemo_tpu_torch.cli.humor_tool viz-fit \\
      --results rgb/results_out --out viz/ --final_only --prior_frame --obs_2d
  python -m nemo_tpu_torch.cli.humor_tool fit-prox --prox PROX/ --quant \\
      --rgbd --out prox/ [--max_pts 4096 --seq_len 60]
  python -m nemo_tpu_torch.cli.humor_tool fit-eval \\
      --results prox/results_out --out eval/ [--stages]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import os.path as osp
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument("--device", type=str, default="cuda",
                        help="cuda (the kernels) or cpu (their plain "
                             "PyTorch versions)")

    t = sub.add_parser("train", help="train the HuMoR CVAE")
    t.add_argument("--shards", type=str, default="",
                   help="sharded dataset dir with 'states' (B, T+1, 207)")
    t.add_argument("--amass", type=str, default="",
                   help="processed AMASS root (process-amass output); "
                        "windows assembled per --amass_split/--amass_stride")
    t.add_argument("--amass_split", type=str, default="train",
                   choices=["train", "val", "test", "all"])
    t.add_argument("--amass_stride", type=int, default=10)
    t.add_argument("--amass_max_windows", type=int, default=0)
    t.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic sequences instead of shards")
    t.add_argument("--seq_len", type=int, default=6,
                   help="transitions per window (synthetic mode)")
    t.add_argument("--epochs", type=int, default=2)
    t.add_argument("--batch_size", type=int, default=64)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--decay", type=float, default=0.0)
    t.add_argument("--sched_milestones", type=int, nargs="*", default=[])
    t.add_argument("--sched_decay", type=float, default=0.1)
    t.add_argument("--sched_samp_start", type=int, default=None)
    t.add_argument("--sched_samp_end", type=int, default=None)
    t.add_argument("--kl_loss", type=float, default=4e-4)
    t.add_argument("--kl_loss_anneal_start", type=int, default=0)
    t.add_argument("--kl_loss_anneal_end", type=int, default=0)
    t.add_argument("--kl_loss_cycle_len", type=int, default=-1)
    t.add_argument("--contacts_loss", type=float, default=0.01)
    t.add_argument("--contacts_vel_loss", type=float, default=0.0)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--out", type=str, required=True)
    device_arg(t)

    sp = sub.add_parser("train-state-prior",
                        help="fit the init-state GMM (EM)")
    sp.add_argument("--states", type=str, default="",
                    help=".npy of (N, 138) init states; synthetic if empty")
    sp.add_argument("--synthetic", type=int, default=4000)
    sp.add_argument("--gmm_comps", type=int, default=12)
    sp.add_argument("--iters", type=int, default=100)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--out", type=str, required=True)
    device_arg(sp)

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

    e = sub.add_parser("fit-eval",
                       help="quant eval of fitting result dirs -> CSVs")
    e.add_argument("--results", type=str, required=True)
    e.add_argument("--out", type=str, required=True)
    e.add_argument("--smpl_path", type=str, default="")
    e.add_argument("--synthetic_assets", action="store_true", default=False)
    e.add_argument("--stages", action="store_true", default=False,
                   help="also evaluate stage*_results.npz like "
                        "--quant-stages")
    device_arg(e)

    fr = sub.add_parser(
        "fit-rgb",
        help="RGB video fitting: OpenPose keypoints -> 3-stage "
             "HuMoR MotionOptimizer per overlapping subsequence -> "
             "stitched final_results (run_fitting.py data_type=RGB)")
    fr.add_argument("--joints2d", type=str, required=True,
                    help="dir of OpenPose *_keypoints.json")
    fr.add_argument("--out", type=str, required=True)
    fr.add_argument("--img_dir", type=str, default="")
    fr.add_argument("--masks", type=str, default="")
    fr.add_argument("--mask_joints", action="store_true", default=False)
    fr.add_argument("--planercnn", type=str, default="")
    fr.add_argument("--intrinsics", type=str, default="",
                    help="json 3x3 camera matrix; default: the reference's "
                         "DEFAULT_FOCAL_LEN at the image center")
    fr.add_argument("--im_dim", type=int, nargs=2, default=[1920, 1080])
    fr.add_argument("--seq_len", type=int, default=60)
    fr.add_argument("--overlap_len", type=int, default=10)
    fr.add_argument("--smpl_path", type=str, default="")
    fr.add_argument("--humor_ckpt", type=str, default="",
                    help="humor params (.npz from `train` or torch ckpt); "
                         "default: random init (smoke/debug)")
    fr.add_argument("--init_motion_prior", type=str, default="",
                    help="dir with prior_gmm.npz")
    fr.add_argument("--latent_size", type=int, default=48)
    fr.add_argument("--steps", type=int, nargs=3, default=[30, 80, 70],
                    metavar=("S1", "S2", "S3"))
    fr.add_argument("--lr", type=float, default=1e-2)
    fr.add_argument("--cam_t", type=float, nargs=3, default=[0.0, 0.0, 2.5])
    fr.add_argument("--seed", type=int, default=0)
    device_arg(fr)

    vz = sub.add_parser(
        "viz-fit",
        help="Render fitting result dirs: camera-view mesh overlay video "
             "per sequence (+ observed 2D joints, + canonical prior-frame "
             "view), the fitting/viz_fitting_rgb.py surface")
    vz.add_argument("--results", type=str, required=True,
                    help="results_out dir (per-seq dirs / final_results)")
    vz.add_argument("--out", type=str, required=True)
    vz.add_argument("--final_only", action="store_true", default=False,
                    help="only visualize final_results (--viz-final-only)")
    vz.add_argument("--obs_2d", action="store_true", default=False,
                    help="draw observed joints2d over the frames "
                         "(--viz-obs-2d)")
    vz.add_argument("--prior_frame", action="store_true", default=False,
                    help="also render the *_prior.npz canonical-frame "
                         "motion (--viz-prior-frame)")
    vz.add_argument("--im_dim", type=int, nargs=2, default=[1280, 720],
                    metavar=("W", "H"),
                    help="render size (--viz-render-width/height)")
    vz.add_argument("--fps", type=float, default=30.0)
    vz.add_argument("--every", type=int, default=1)
    vz.add_argument("--max_seqs", type=int, default=0)
    vz.add_argument("--smpl_path", type=str, default="")
    vz.add_argument("--method", type=str, default="auto",
                    choices=["auto", "raster", "splat"])
    vz.add_argument("--no_bg", action="store_true", default=False,
                    help="white background instead of the video frames "
                         "(--viz-no-bg)")
    device_arg(vz)

    fp = sub.add_parser(
        "fit-prox",
        help="PROX fitting: RGB keypoints (+ optional RGB-D depth "
             "point clouds) -> 3-stage HuMoR fit per subsequence -> "
             "result dirs + eval CSVs (run_fitting.py data_type="
             "PROX-RGB/PROX-RGBD, fit_prox.cfg / fit_proxd.cfg)")
    fp.add_argument("--prox", type=str, required=True,
                    help="PROX root (qualitative/ or quantitative/ inside)")
    fp.add_argument("--out", type=str, required=True)
    fp.add_argument("--quant", action="store_true", default=False)
    fp.add_argument("--split", type=str, default="train")
    fp.add_argument("--recording", type=str, default="")
    fp.add_argument("--seq_len", type=int, default=60)
    fp.add_argument("--max_seqs", type=int, default=0)
    fp.add_argument("--rgbd", action="store_true", default=False,
                    help="use depth point clouds (PROX-RGBD / fit_proxd)")
    fp.add_argument("--mask_joints", action="store_true", default=False)
    fp.add_argument("--max_pts", type=int, default=4096)
    fp.add_argument("--smpl_path", type=str, default="")
    fp.add_argument("--humor_ckpt", type=str, default="")
    fp.add_argument("--init_motion_prior", type=str, default="")
    fp.add_argument("--latent_size", type=int, default=48)
    fp.add_argument("--steps", type=int, nargs=3, default=[30, 70, 70],
                    metavar=("S1", "S2", "S3"))
    fp.add_argument("--lr", type=float, default=1e-2)
    fp.add_argument("--seed", type=int, default=0)
    fp.add_argument("--no_eval", action="store_true", default=False)
    device_arg(fp)

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


def _synthetic_windows(rng, n, t, state_dim):
    """Smooth random walks as stand-in aligned-local state windows."""
    x0 = rng.standard_normal((n, 1, state_dim)) * 0.3
    steps = rng.standard_normal((n, t, state_dim)) * 0.05
    return np.cumsum(np.concatenate([x0, steps], axis=1),
                     axis=1).astype(np.float32)


def _epoch_feed(args, device):
    """(epoch -> iterator of (B, T+1, 207) numpy windows), or None when the
    --amass tree holds no window: --shards, --amass or --synthetic, each
    batched and shuffled as the JAX CLI does."""
    from ..models.humor import STATE_DIM
    if args.shards:
        from ..data.sharded import ShardedDataset, batch_iterator
        ds = ShardedDataset(args.shards)
        n_batches = max(1, len(ds) // args.batch_size)

        def epoch_batches(epoch):
            it = batch_iterator(ds, args.batch_size, seed=epoch)
            for _ in range(n_batches):
                yield next(it)["states"]
        return epoch_batches
    if args.amass:
        from ..data.amass_process import load_amass_windows
        windows = load_amass_windows(
            args.amass, args.seq_len + 1, split=args.amass_split,
            stride=args.amass_stride, canonicalize=True,
            max_windows=args.amass_max_windows, device=device)
        if windows.shape[0] == 0:
            print("[humor_tool] no windows found under", args.amass)
            return None
        print(f"[humor_tool] {windows.shape[0]} AMASS windows "
              f"({args.amass_split}, T={args.seq_len + 1})")
    else:
        rng = np.random.default_rng(args.seed)
        windows = _synthetic_windows(rng, args.synthetic or 2048,
                                     args.seq_len, STATE_DIM)
    n = windows.shape[0]
    n_batches = max(1, n // args.batch_size)

    def epoch_batches(epoch):
        order = np.random.default_rng(epoch).permutation(n)
        for i in range(n_batches):
            yield windows[order[i * args.batch_size:
                                (i + 1) * args.batch_size]]
    return epoch_batches


def cmd_train(args) -> int:
    from .. import resolve_device
    from ..models.humor import HumorConfig, init_humor
    from ..models.humor_loss import (HumorLossConfig,
                                     make_humor_full_train_step,
                                     stats_to_host)

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    cfg = HumorConfig()
    lcfg = HumorLossConfig(
        kl_loss=args.kl_loss,
        kl_loss_anneal_start=args.kl_loss_anneal_start,
        kl_loss_anneal_end=args.kl_loss_anneal_end,
        kl_loss_cycle_len=args.kl_loss_cycle_len,
        contacts_loss=args.contacts_loss,
        contacts_vel_loss=args.contacts_vel_loss)
    use_ss = args.sched_samp_start is not None \
        and args.sched_samp_end is not None

    # the weights as _humor_params draws them; the steps' draws from a
    # generator on the device
    params = init_humor(torch.Generator().manual_seed(args.seed), cfg,
                        device=device)
    init, step = make_humor_full_train_step(
        cfg, lcfg, lr=args.lr, weight_decay=args.decay,
        sched_milestones=tuple(args.sched_milestones),
        sched_decay=args.sched_decay,
        sched_samp_start=args.sched_samp_start,
        sched_samp_end=args.sched_samp_end,
        generator=torch.Generator(device=device).manual_seed(args.seed))
    opt = init(params)
    epoch_batches = _epoch_feed(args, device)
    if epoch_batches is None:
        return 1

    log_path = osp.join(args.out, "train_stats.jsonl")
    with open(log_path, "w") as logf:
        for epoch in range(args.epochs):
            t0 = time.time()
            agg, cnt = {}, 0
            for win in epoch_batches(epoch):
                win = torch.as_tensor(win, dtype=torch.float32,
                                      device=device)
                if use_ss:
                    x_past, x_t = win[:, :-1], win[:, 1:]
                else:  # fully-supervised per-transition batching
                    x_past = win[:, :-1].reshape(-1, win.shape[-1])
                    x_t = win[:, 1:].reshape(-1, win.shape[-1])
                params, opt, stats = step(params, opt, x_past, x_t, epoch)
                for k, v in stats_to_host(stats).items():
                    agg[k] = agg.get(k, 0.0) + v
                cnt += 1
            row = {k: agg[k] / cnt for k in sorted(agg)}
            row.update(epoch=epoch, sec=round(time.time() - t0, 2))
            logf.write(json.dumps(row) + "\n")
            logf.flush()
            print(f"[humor-train] epoch {epoch}: "
                  f"loss={row.get('loss', float('nan')):.4f} "
                  f"kl={row.get('kl_loss', float('nan')):.4f} "
                  f"lr={row.get('lr', float('nan')):.2e} "
                  f"skipped={row.get('update_skipped', 0.0):.2f}")

    ckpt = osp.join(args.out, "humor_params.npz")
    np.savez(ckpt, **{f"{m}.{k}": v.detach().cpu().numpy()
                      for m, sub in params.items() for k, v in sub.items()})
    print(f"[humor-train] params -> {ckpt}, stats -> {log_path}")
    return 0


def cmd_train_state_prior(args) -> int:
    from .. import resolve_device
    from ..models.humor_state_prior import (fit_state_prior_gmm,
                                            save_state_prior_gmm)

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    if args.states:
        states = np.load(args.states)
    else:
        rng = np.random.default_rng(args.seed)
        centers = rng.standard_normal((args.gmm_comps, 138)) * 2.0
        comp = rng.integers(0, args.gmm_comps, args.synthetic)
        states = (centers[comp]
                  + rng.standard_normal((args.synthetic, 138)) * 0.3)
    print(f"[state-prior] fitting GMM({args.gmm_comps}) to "
          f"{states.shape} states...")
    gmm, ll = fit_state_prior_gmm(
        np.asarray(states, np.float32), n_components=args.gmm_comps,
        n_iter=args.iters,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    out = osp.join(args.out, "prior_gmm.npz")
    save_state_prior_gmm(out, gmm)
    # the reference prints the fitted shapes (train_state_prior.py:118-121)
    for k in ("weights", "means", "covariances"):
        print(tuple(gmm[k].shape))
    print(f"[state-prior] mean log-lik {float(ll[-1]):.4f} -> {out}")
    return 0


def _smpl_model(smpl_path: str, device):
    """The SMPL .npz that smpl_path names, else the synthetic model."""
    from ..body.assets import load_smpl_npz, synthetic_smpl_model
    if smpl_path:
        return load_smpl_npz(smpl_path, device=device)
    return synthetic_smpl_model(device=device)


def _humor_params(path: str, cfg, seed: int, device):
    """HuMoR parameters from a ``train`` .npz (flat 'module.key' arrays), a
    torch checkpoint (load_humor), or, when path is empty, random ones from
    init_humor with a generator seeded by ``seed`` (the JAX CLI's default)."""
    from ..models.humor import humor_from_numpy, init_humor, load_humor
    if not path:
        return init_humor(torch.Generator().manual_seed(seed), cfg,
                          device=device)
    if path.endswith(".npz"):
        tree = {}
        with np.load(path) as flat:
            for name in flat.files:
                m, k = name.split(".", 1)
                tree.setdefault(m, {})[k] = flat[name]
        return humor_from_numpy(tree, device)
    return load_humor(path, cfg, device=device)


def _smpl_eval_fn(model, device):
    """smpl_fn(trans, root_orient, pose_body, betas) -> (fk joints (T, 24,
    3), vertices (T, V, 3)) as numpy, the body the eval walks rebuild from
    a result file (10 betas, the 21 body joints; hands zero)."""
    from ..body.smpl import smpl_forward

    def smpl_fn(trans, root_orient, pose_body, betas):
        n = trans.shape[0]
        body = np.zeros((n, 69), np.float32)
        body[:, :63] = pose_body
        t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        with torch.no_grad():
            verts, _, fk = smpl_forward(
                model, t(np.asarray(betas)[:, :10]), t(body),
                t(root_orient), pose2rot=True, transl=t(trans),
                want_fk_joints=True)
        return fk.cpu().numpy(), verts.cpu().numpy()
    return smpl_fn


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
        name = osp.splitext(osp.basename(path))[0]
        parent = osp.basename(osp.dirname(path))
        seq_name = f"{parent}_{name}_{i}"
        stage3 = _stage3_payload(fit)
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
        eval_dir = osp.join(args.out, "eval_out")
        seqs = eval_fitting_results_dirs(res_root, eval_dir,
                                         _smpl_eval_fn(model, device))
        print(f"[fit-amass] evaluated {len(seqs)} sequences -> {eval_dir}")
    return 0


def cmd_fit_eval(args) -> int:
    from .. import resolve_device
    from ..models.humor_fit_eval import eval_fitting_results_dirs

    device = resolve_device(args.device)
    model = _smpl_model(args.smpl_path, device)
    seqs = eval_fitting_results_dirs(args.results, args.out,
                                     _smpl_eval_fn(model, device),
                                     eval_stages=args.stages)
    print(f"[fit-eval] evaluated {len(seqs)} sequences -> {args.out}")
    return 0


def _smpl_joints_fn(model, device):
    """smpl_joints_fn(pose_body, betas, root_orient, trans) -> the 22
    SMPL-tree joints as numpy, for stitch_rgb_results (arrays or CPU
    tensors in). The stitched betas differ between subsequences, so this
    takes smpl_forward's per-row-betas path (_smpl_eval_fn's; the FK
    joints are the same as the joints-only path's). The JAX CLI asks for
    the joints-only path, which takes shared betas only, and raises here
    (ROADMAP.md Queue 3)."""
    smpl_fn = _smpl_eval_fn(model, device)

    def smpl_joints_fn(pose_body, betas, root_orient, trans):
        f = lambda a: np.asarray(a, np.float32)
        return smpl_fn(f(trans), f(root_orient), f(pose_body),
                       f(betas))[0][:, :22]
    return smpl_joints_fn


def _stage3_payload(fit) -> dict:
    """The stage3_results.npz fields of a humor_motion_fit result."""
    pose = fit["pose"].cpu().numpy()
    return {"betas": fit["betas"].cpu().numpy().reshape(-1),
            "trans": fit["trans"].cpu().numpy(),
            "root_orient": pose[:, :3], "pose_body": pose[:, 3:66]}


def cmd_fit_rgb(args) -> int:
    from .. import resolve_device
    from ..data.humor_rgb import DEFAULT_FOCAL_LEN, load_rgb_video_observations
    from ..models.humor import HumorConfig
    from ..models.humor_fit import (MotionOptConfig, humor_motion_fit,
                                    load_init_motion_prior)
    from ..models.humor_fit_eval import (save_fitting_results,
                                         stitch_rgb_results)

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    W, H = args.im_dim
    if args.intrinsics:
        with open(args.intrinsics) as f:
            cam_mat = np.array(json.load(f))
    else:
        # DEFAULT_FOCAL_LEN at the image center (run_fitting.py:169-172)
        cam_mat = np.array([[DEFAULT_FOCAL_LEN[0], 0.0, W / 2.0],
                            [0.0, DEFAULT_FOCAL_LEN[1], H / 2.0],
                            [0.0, 0.0, 1.0]])

    vid_name = osp.basename(osp.normpath(args.joints2d))
    obs_list = load_rgb_video_observations(
        args.joints2d, cam_mat, seq_len=args.seq_len,
        overlap_len=args.overlap_len,
        img_path=args.img_dir or None, masks_path=args.masks or None,
        mask_joints=args.mask_joints,
        planercnn_path=args.planercnn or None, video_name=vid_name)
    if not obs_list:
        print("[fit-rgb] no keypoint frames found under", args.joints2d)
        return 1
    print(f"[fit-rgb] {len(obs_list)} subsequences of "
          f"{obs_list[0]['joints2d'].shape[0]} frames")

    model = _smpl_model(args.smpl_path, device)
    hcfg = HumorConfig(latent_size=args.latent_size)
    hp = _humor_params(args.humor_ckpt, hcfg, args.seed, device)
    init_prior = (load_init_motion_prior(args.init_motion_prior, device)
                  if args.init_motion_prior else None)
    cfg = MotionOptConfig(steps_stage1=args.steps[0],
                          steps_stage2=args.steps[1],
                          steps_stage3=args.steps[2], lr=args.lr)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    focal = float(cam_mat[0, 0])
    center = f32([cam_mat[0, 2], cam_mat[1, 2]])
    cam_t = f32(args.cam_t)

    res_root = osp.join(args.out, "results_out")
    res_dirs, intervals = [], []
    for obs in obs_list:
        T = obs["joints2d"].shape[0]
        fit = humor_motion_fit(
            model, hp, hcfg, f32(obs["joints2d"]),
            torch.zeros((T, 72), device=device), cam_t, center,
            focal_length=focal, cfg=cfg, init_motion_prior=init_prior,
            obs3d={"floor_plane": f32(obs["floor_plane"])})
        stage3 = _stage3_payload(fit)
        stage3["floor_plane"] = np.asarray(obs["floor_plane"], np.float64)
        observations = {"joints2d": np.asarray(obs["joints2d"])}
        if "img_paths" in obs:
            observations["img_paths"] = np.asarray(obs["img_paths"])
        rd = osp.join(res_root, obs["name"])
        save_fitting_results(
            rd, stage3, gt={"cam_mtx": cam_mat},
            observations=observations,
            optim_bm=args.smpl_path or "synthetic",
            gt_bm=args.smpl_path or "synthetic")
        res_dirs.append(rd)
        intervals.append(obs["seq_interval"])
        print(f"[fit-rgb] {obs['name']}: "
              f"stage3 loss {float(fit['stage3_loss'][-1]):.4f} -> {rd}")

    final = stitch_rgb_results(intervals, res_dirs, res_root,
                               smpl_joints_fn=_smpl_joints_fn(model, device))
    print(f"[fit-rgb] stitched -> {final}")
    return 0


def _draw_pts2d(img: np.ndarray, pts: np.ndarray, color=(1.0, 0.2, 0.2),
                r: int = 3) -> None:
    """Stamp confident 2D keypoints into an (H, W, 3) float image in place
    (the viz-obs-2d overlay, viz_fitting_rgb.py)."""
    H, W, _ = img.shape
    for p in np.asarray(pts).reshape(-1, pts.shape[-1]):
        x, y = p[0], p[1]
        conf = p[2] if pts.shape[-1] > 2 else 1.0
        if conf <= 0 or not np.isfinite([x, y]).all():
            continue
        xi, yi = int(round(float(x))), int(round(float(y)))
        if 0 <= xi < W and 0 <= yi < H:
            img[max(0, yi - r):yi + r + 1,
                max(0, xi - r):xi + r + 1] = color


def cmd_viz_fit(args) -> int:
    import shutil

    from .. import resolve_device
    from ..data.humor_rgb import DEFAULT_FOCAL_LEN
    from ..data.video import frames_to_video
    from ..geometry.camera import Camera
    from ..models.humor_fit_eval import (GT_RES_NAME, OBS_NAME,
                                         PRED_RES_NAME,
                                         load_fitting_results)
    from ..render.mesh import render_mesh_overlay
    from ..render.video import _load_frame, _write_png

    device = resolve_device(args.device)
    model = _smpl_model(args.smpl_path, device)
    smpl_fn = _smpl_eval_fn(model, device)
    W, H = args.im_dim
    have_ffmpeg = shutil.which("ffmpeg") is not None

    def verts_of(res):
        T = np.asarray(res["trans"]).shape[0]
        betas = np.asarray(res["betas"], np.float32)
        if betas.ndim == 1:
            betas = np.broadcast_to(betas[None], (T, betas.shape[0]))
        return smpl_fn(res["trans"], res["root_orient"], res["pose_body"],
                       betas)[1]

    def render_seq(verts, cam, name, obs=None, img_paths=None):
        frame_dir = osp.join(args.out, name + ".frames")
        os.makedirs(frame_dir, exist_ok=True)
        T = verts.shape[0]
        out_idx = 0
        for t in range(0, T, max(args.every, 1)):
            bg = None
            if img_paths is not None and not args.no_bg:
                bg = _load_frame(str(img_paths[t]), (H, W))
            frame = render_mesh_overlay(verts[t], model.faces, cam, bg,
                                        (H, W), method=args.method,
                                        device=device)
            if args.obs_2d and obs is not None and "joints2d" in obs:
                _draw_pts2d(frame, np.asarray(obs["joints2d"][t]))
            _write_png(osp.join(frame_dir, "%06d.png" % out_idx), frame)
            out_idx += 1
        if have_ffmpeg:
            frames_to_video(frame_dir, osp.join(args.out, name + ".mp4"),
                            fps=args.fps / max(args.every, 1))
        print(f"[viz-fit] {name}: {out_idx} frames -> {frame_dir}")

    dirs = sorted(d for d in os.listdir(args.results)
                  if not d.startswith(".")
                  and osp.isdir(osp.join(args.results, d)))
    if args.final_only:
        dirs = [d for d in dirs if d == "final_results"]
    if args.max_seqs:
        dirs = dirs[:args.max_seqs]
    os.makedirs(args.out, exist_ok=True)
    n = 0
    for seq in dirs:
        rd = osp.join(args.results, seq)
        pred = load_fitting_results(rd, PRED_RES_NAME)
        if pred is None or not all(
                np.isfinite(np.asarray(pred[k])).all()
                for k in ("trans", "root_orient", "pose_body", "betas")):
            print(f"[viz-fit] skipping {seq} (missing/NaN prediction)")
            continue
        gt = load_fitting_results(rd, GT_RES_NAME)
        obs = load_fitting_results(rd, OBS_NAME)
        if gt is not None and "cam_mtx" in gt:
            m = np.asarray(gt["cam_mtx"], np.float64)
            focal, center = float(m[0, 0]), (float(m[0, 2]),
                                             float(m[1, 2]))
        else:
            focal, center = DEFAULT_FOCAL_LEN[0], (W / 2.0, H / 2.0)
        # float32 fields, as the JAX CLI's jnp camera holds them
        cam = Camera(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                     np.float32(focal), np.asarray(center, np.float32))
        img_paths = (list(obs["img_paths"])
                     if obs is not None and "img_paths" in obs else None)
        render_seq(verts_of(pred), cam, seq, obs=obs, img_paths=img_paths)
        n += 1

        if args.prior_frame:
            prior = load_fitting_results(rd, PRED_RES_NAME + "_prior")
            if prior is not None:
                pv = verts_of(prior)
                # z-up canonical frame: look from the front, centered on
                # the motion (the viz-prior-frame view)
                c = pv.reshape(-1, 3).mean(0)
                ext = float(np.abs(pv - c).max())
                R = np.array([[1.0, 0.0, 0.0],
                              [0.0, 0.0, -1.0],
                              [0.0, 1.0, 0.0]], np.float32)
                t = -R @ c + np.array([0.0, 0.0, 4.0 * ext])
                cam_p = Camera(R, t.astype(np.float32),
                               np.float32(0.9 * max(W, H)),
                               np.asarray((W / 2.0, H / 2.0), np.float32))
                render_seq(pv, cam_p, seq + "_prior")
    print(f"[viz-fit] visualized {n} result dirs -> {args.out}")
    return 0 if n else 1


def cmd_fit_prox(args) -> int:
    from .. import resolve_device
    from ..data.humor_rgb import (DEFAULT_FOCAL_LEN, load_prox_calibration,
                                  load_prox_depth_points,
                                  load_prox_observations)
    from ..data.images import read_mask
    from ..models.humor import HumorConfig
    from ..models.humor_fit import (MotionOptConfig, humor_motion_fit,
                                    load_init_motion_prior)
    from ..models.humor_fit_eval import (eval_fitting_results_dirs,
                                         save_fitting_results)

    device = resolve_device(args.device)
    obs_list = load_prox_observations(
        args.prox, quant=args.quant, split=args.split,
        seq_len=args.seq_len, recording=args.recording or None,
        mask_joints=args.mask_joints, load_floor_plane=True,
        return_fitting=args.quant)
    if args.max_seqs:
        obs_list = obs_list[:args.max_seqs]
    if not obs_list:
        print("[fit-prox] no subsequences found under", args.prox)
        return 1

    calib = None
    if args.rgbd:
        data_dir = osp.join(args.prox,
                            "quantitative" if args.quant else "qualitative")
        calib = load_prox_calibration(osp.join(data_dir, "calibration"))

    model = _smpl_model(args.smpl_path, device)
    hcfg = HumorConfig(latent_size=args.latent_size)
    hp = _humor_params(args.humor_ckpt, hcfg, args.seed, device)
    init_prior = (load_init_motion_prior(args.init_motion_prior, device)
                  if args.init_motion_prior else None)
    # fit_proxd.cfg / fit_prox.cfg weight columns: RGB-D runs the
    # point-cloud chamfer at 1.0 next to joint2d 0.001
    cfg = MotionOptConfig(
        steps_stage1=args.steps[0], steps_stage2=args.steps[1],
        steps_stage3=args.steps[2], lr=args.lr,
        points3d_weight=1.0 if args.rgbd else 0.0,
        kp2d_weight=0.001 if args.rgbd else 1.0,
        joints3d_smooth_weight=100.0,
        shape_prior_weight=0.034,
        motion_prior_weight=0.075, init_motion_prior_weight=0.075,
        joint_consistency_weight=100.0, bone_length_weight=2000.0,
        contact_vel_weight=100.0, contact_height_weight=10.0,
        floor_reg_weight=1.0 if args.rgbd else 0.0)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)

    res_root = osp.join(args.out, "results_out")
    n_fit = 0
    for obs in obs_list:
        T = obs["joints2d"].shape[0]
        cam_mat = obs.get("cam_matx")
        if cam_mat is None:
            cam_mat = np.array([[DEFAULT_FOCAL_LEN[0], 0.0, 960.0],
                                [0.0, DEFAULT_FOCAL_LEN[1], 540.0],
                                [0.0, 0.0, 1.0]])
        obs3d = {}
        if "floor_plane" in obs:
            obs3d["floor_plane"] = f32(obs["floor_plane"])
        if args.rgbd and calib is not None:
            masks = [read_mask(p) for p in obs["mask_paths"]]
            pts = load_prox_depth_points(obs["depth_paths"], masks, calib,
                                         max_pts=args.max_pts)
            obs3d["points3d"] = f32(pts)
        fit = humor_motion_fit(
            model, hp, hcfg, f32(obs["joints2d"]),
            torch.zeros((T, 72), device=device), f32([0.0, 0.0, 2.5]),
            f32([cam_mat[0, 2], cam_mat[1, 2]]),
            focal_length=float(cam_mat[0, 0]), cfg=cfg,
            init_motion_prior=init_prior, obs3d=obs3d or None)
        stage3 = _stage3_payload(fit)
        if "floor" in fit:
            stage3["floor_plane"] = fit["floor"].cpu().numpy().astype(
                np.float64)
        gt = None
        if args.quant and "gt_trans" in obs:
            gt = {"trans": obs["gt_trans"],
                  "root_orient": obs["gt_root_orient"],
                  "pose_body": obs["gt_pose_body"],
                  "betas": np.asarray(obs["gt_betas"])[..., :10]}
        observations = {"joints2d": np.asarray(obs["joints2d"]),
                        "img_paths": np.asarray(obs["img_paths"])}
        if "points3d" in obs3d:
            observations["points3d"] = obs3d["points3d"].cpu().numpy()
        save_fitting_results(
            osp.join(res_root, obs["name"]), stage3, gt=gt,
            observations=observations,
            optim_bm=args.smpl_path or "synthetic",
            gt_bm=args.smpl_path or "synthetic")
        n_fit += 1
        print(f"[fit-prox] {obs['name']}: stage3 loss "
              f"{float(fit['stage3_loss'][-1]):.4f}")
    print(f"[fit-prox] fitted {n_fit} subsequences -> {res_root}")

    if args.quant and not args.no_eval:
        eval_dir = osp.join(args.out, "eval_out")
        seqs = eval_fitting_results_dirs(res_root, eval_dir,
                                         _smpl_eval_fn(model, device))
        print(f"[fit-prox] evaluated {len(seqs)} sequences -> {eval_dir}")
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
    return {"train": cmd_train, "train-state-prior": cmd_train_state_prior,
            "fit-eval": cmd_fit_eval, "fit-rgb": cmd_fit_rgb,
            "viz-fit": cmd_viz_fit, "fit-prox": cmd_fit_prox,
            "fit-amass": cmd_fit_amass,
            "process-amass": cmd_process_amass}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
