"""CLI: fit a neural motion field to a multi-view action (PyTorch port).

The port's counterpart of ``python -m nemo_tpu.cli.fit``: the same flags,
config merge and stage schedule (warmup -> camera stage -> main fit), then
the eval CSVs, on the device named by ``--device`` (default ``cuda``).

Usage:
  python -m nemo_tpu_torch.cli.fit --synthetic_assets --model_version 2 \
      --phase_rbf_dim 16 --rbf_kernel quadratic --h_dim 64 \
      --monotonic_network_n_nodes 8 --instance_code_size 4 --batch_size 64 \
      --n_steps 100 --warmup_step 20 --opt_cam_step 30 --save_every 50 \
      --label_type gt --loss mse_robust --weight_gmm_loss 0.5 \
      --out_dir out/verify_fit_torch

Every model version (--model_version 0..4) runs, with --full_batch,
--weight_3d_loss, --weight_instance_loss, --code_noise and --vp_v2v_n_verts.
Writes config.json, metrics.jsonl, losses.npz, eval_2d.csv, eval_3d.csv,
eval_3d_dynamic.csv and eval_3d_global.csv under out_dir/<NNNNNN>/.
Real SMPL/VPoser/GMM assets, checkpoints and resume, rendering, --dp and
--weight_humor_loss are still to port (ROADMAP.md Queue 1) and raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as osp
import sys

import numpy as np
import torch

_ROADMAP = "still to port: see ROADMAP.md, Queue 1"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (kernels) or 'cpu' (plain PyTorch versions)")
    p.add_argument("--bundle", type=str, default="")
    p.add_argument("--default_config", type=str, default="")
    p.add_argument("--out_dir", type=str, default="out/multi_view/default")
    p.add_argument("--load_ckpt_path", type=str, default="")
    p.add_argument("--test", action="store_true", default=False)
    p.add_argument("--smpl_path", type=str, default="")
    p.add_argument("--j_regressor_extra", type=str, default="")
    p.add_argument("--vposer_path", type=str, default="")
    p.add_argument("--gmm_path", type=str, default="")
    p.add_argument("--synthetic_assets", action="store_true", default=False)
    p.add_argument("--model_version", type=int, default=2)
    p.add_argument("--h_dim", type=int, default=500)
    p.add_argument("--instance_code_size", type=int, default=10)
    p.add_argument("--code_noise", type=float, default=0)
    p.add_argument("--phase_rbf_dim", type=int, default=0)
    p.add_argument("--rbf_kernel", type=str, default="linear")
    p.add_argument("--monotonic_network_n_nodes", type=int, default=10)
    p.add_argument("--phase_init", type=str, default="rand",
                   choices=["linear", "rand"])
    p.add_argument("--n_steps", type=int, default=100)
    p.add_argument("--warmup_step", type=int, default=200)
    p.add_argument("--opt_cam_step", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--lr_camera", type=float, default=1.0)
    p.add_argument("--lr_human", type=float, default=1e-2)
    p.add_argument("--lr_instance", type=float, default=1e-2)
    p.add_argument("--lr_phase", type=float, default=1e-2)
    p.add_argument("--lr_factor", type=float, default=1e-1)
    p.add_argument("--opt_human", type=str, default="adam",
                   choices=["adam", "adamw"])
    p.add_argument("--wd_human", type=float, default=0)
    p.add_argument("--loss", type=str, default="mse",
                   choices=["rmse", "rmse_resized", "mse", "rmse_robust",
                            "mse_robust", "mse_robust_resized"])
    p.add_argument("--weight_vp_loss", type=float, default=0)
    p.add_argument("--weight_vp_z_loss", type=float, default=0)
    p.add_argument("--vp_v2v_n_verts", type=int, default=0)
    p.add_argument("--weight_gmm_loss", type=float, default=1e-2)
    p.add_argument("--weight_instance_loss", type=float, default=0)
    p.add_argument("--weight_3d_loss", type=float, default=0)
    p.add_argument("--weight_humor_loss", type=float, default=0)
    p.add_argument("--full_batch", action="store_true", default=False)
    p.add_argument("--eval_full_batch", type=int, default=1)
    p.add_argument("--dp", type=int, default=0)
    p.add_argument("--label_type", type=str, default="gt",
                   choices=["gt", "op", "intersection"])
    p.add_argument("--label_intersection_threshold", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--render_video", type=int, default=0)
    p.add_argument("--render_rollout_figure", action="store_true",
                   default=False)
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--render_every", type=int, default=0)
    return p


def _reject_unported(args) -> None:
    unported = {
        "--load_ckpt_path / --test (resume)": args.load_ckpt_path or args.test,
        "--smpl_path / --vposer_path / --gmm_path / --j_regressor_extra "
        "(real assets)": (args.smpl_path or args.vposer_path or args.gmm_path
                          or args.j_regressor_extra),
        "--render_video / --render_rollout_figure / --render_every":
            args.render_video or args.render_rollout_figure
            or args.render_every,
        "--dp": args.dp,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"{'; '.join(bad)}: {_ROADMAP}")


def main(argv=None) -> int:
    from .. import resolve_device
    from ..body.assets import synthetic_smpl_model
    from ..data.bundle import MultiViewBundle
    from ..data.synthetic import synthetic_problem
    from ..eval.metrics import eval_2d, eval_3d, eval_3d_global, write_csv
    from ..fit.assemble import build_assets
    from ..fit.loop import NemoFitter
    from ..fit.model import NemoConfig, predict, project_to_views
    from ..priors.gmm import synthetic_gmm_prior
    from ..priors.vposer import init_vposer
    from ..utils.exp import (MetricWriter, Timer, create_latest_child_dir,
                             dataclass_from_namespace, merge_config)

    args = merge_config(build_parser(), argv)
    _reject_unported(args)
    device = resolve_device(args.device)
    cfg = dataclass_from_namespace(NemoConfig, args)
    out_dir = create_latest_child_dir(args.out_dir)
    with open(osp.join(out_dir, "config.json"), "w") as f:
        json.dump({"args": vars(args), "cfg": dataclasses.asdict(cfg)}, f,
                  indent=2, default=str)

    with Timer("Data loading"):
        smpl = synthetic_smpl_model(device=device)
        if args.bundle:
            bundle = MultiViewBundle.load(args.bundle)
        else:
            print("[fit] no --bundle given; generating a synthetic problem")
            bundle, _ = synthetic_problem(smpl, num_views=4, num_frames=60)
        if (bundle.glamr_orient is not None and bundle.glamr_trans is not None
                and "glamr" in (bundle.baseline_poses or {})):
            raise NotImplementedError(
                f"the GLAMR columns of eval_3d_global are {_ROADMAP}")

    with Timer("Model init"):
        gmm = synthetic_gmm_prior(8) \
            if args.synthetic_assets and cfg.weight_gmm_loss else None
        vposer = init_vposer(generator=torch.Generator().manual_seed(0)) \
            if args.synthetic_assets and (cfg.weight_vp_loss
                                          or cfg.weight_vp_z_loss) else None
        assets = build_assets(bundle, smpl, cfg, gmm=gmm, vposer=vposer,
                              device=device)
        fitter = NemoFitter(cfg, assets, seed=args.seed)

    metrics_log = MetricWriter(osp.join(out_dir, "metrics.jsonl"))
    full = bool(args.eval_full_batch)
    metrics_log.write({"phase": "init", **fitter.eval_loss(full=full)})
    with Timer("Warmup"):
        wm = fitter.warmup()
        if wm:
            metrics_log.write({"phase": "warmup_done",
                               "loss": float(wm["warmup_loss"][-1])})
    with Timer("Camera opt"):
        cm = fitter.opt_cam()
        if cm:
            key = "cam_loss" if "cam_loss" in cm else "total_loss"  # V4
            metrics_log.write({"phase": "opt_cam_done",
                               "loss": float(cm[key][-1])})
        metrics_log.write({"phase": "cam_eval", **fitter.eval_loss(full=full)})

    def on_chunk(f, step, chunk_metrics):
        metrics_log.write({"phase": "fit", "step": step,
                           **{k: float(v[-1])
                              for k, v in chunk_metrics.items()}})
        print(f"[fit] step {step}: "
              f"total={float(chunk_metrics['total_loss'][-1]):.4f} "
              f"kp={float(chunk_metrics['kp_loss'][-1]):.4f}")

    with Timer("Main fit"):
        all_metrics = fitter.fit(chunk=args.save_every, on_chunk=on_chunk)
    np.savez(osp.join(out_dir, "losses.npz"), **all_metrics)

    final = fitter.eval_loss()
    metrics_log.write({"phase": "final", **final})
    print("[fit] final:", {k: round(v, 4) for k, v in final.items()})

    V, F = assets.num_views, assets.num_frames
    vi = torch.arange(V, device=device).repeat_interleave(F)
    fi = torch.arange(F, device=device).repeat(V)
    with torch.no_grad():
        preds = predict(fitter.params, cfg, assets, vi, fi)
        pts2d = project_to_views(fitter.params, cfg, assets, preds["j"], vi)
    pts2d = pts2d.cpu().numpy().reshape(V, F, 25, 2)

    if "gt" in bundle.labels:
        label_order = [k for k in ("op", "vibe", "vs", "pare")
                       if k in bundle.labels]
        write_csv(eval_2d(pts2d, {k: bundle.labels[k] for k in label_order},
                          bundle.labels["gt"], bundle.bbox_diag("gt")),
                  osp.join(out_dir, "eval_2d.csv"))
    if bundle.gt3d_pose is not None:
        pred_pose = preds["poses"].cpu().numpy().reshape(V, F, 69)
        baselines = {"vibe": bundle.hmr_theta}
        for bname in ("vs", "pare", "glamr"):
            if bname in (bundle.baseline_poses or {}):
                baselines[bname] = bundle.baseline_poses[bname][..., :69]
        write_csv(eval_3d(assets.smpl, pred_pose, bundle.gt3d_pose,
                          baselines), osp.join(out_dir, "eval_3d.csv"))
        write_csv(eval_3d(assets.smpl, pred_pose, bundle.gt3d_pose,
                          baselines, dynamic_only=True,
                          framerate_multiplier=bundle.framerate_multiplier),
                  osp.join(out_dir, "eval_3d_dynamic.csv"))
        if bundle.gt3d_trans is not None:
            pred_j, pred_v = [], []
            with torch.no_grad():
                for v in range(V):
                    pv = predict(fitter.params, cfg, assets,
                                 torch.full((F,), v, device=device),
                                 torch.arange(F, device=device),
                                 want_vertices=True)
                    pred_j.append(pv["j"].cpu().numpy())
                    pred_v.append(pv["v"].cpu().numpy())
            write_csv(eval_3d_global(assets.smpl, np.stack(pred_j),
                                     np.stack(pred_v), bundle.gt3d_pose,
                                     bundle.gt3d_trans),
                      osp.join(out_dir, "eval_3d_global.csv"))

    metrics_log.close()
    print(f"[fit] outputs in {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
