"""CLI: fit a neural motion field to a multi-view action (PyTorch port).

The port's counterpart of ``python -m nemo_tpu.cli.fit``: the same flags,
config merge and stage schedule (warmup -> camera stage -> main fit with a
checkpoint every --save_every steps), then the eval CSVs and the render
outputs, on the device named by ``--device`` (default ``cuda``).

Usage:
  python -m nemo_tpu_torch.cli.fit --synthetic_assets --model_version 2 \\
      --phase_rbf_dim 16 --rbf_kernel quadratic --h_dim 64 \\
      --monotonic_network_n_nodes 8 --instance_code_size 4 --batch_size 64 \\
      --n_steps 100 --warmup_step 20 --opt_cam_step 30 --save_every 50 \\
      --label_type gt --loss mse_robust --weight_gmm_loss 0.5 \\
      --render_video 4 --render_rollout_figure --out_dir out/verify_fit_torch
  # evaluate and render a saved fit without fitting again:
  python -m nemo_tpu_torch.cli.fit --synthetic_assets --test \\
      --load_ckpt_path out/verify_fit_torch/000000/ckpt/sd_000100 ...

  # the NeMo-MoCap recipe on the real assets (run_examples/
  # nemomocap-example.sh):
  python -m nemo_tpu_torch.cli.fit --bundle bundles/baseball_pitch.npz \
      --default_config configs/default-v2.yml --smpl_path software/smpl \
      --j_regressor_extra software/spin_data/J_regressor_extra.npy \
      --vposer_path software/V02_05 \
      --gmm_path software/spin_data/gmm_08.pkl --render_video 1 \
      --out_dir out/mocap/baseball_pitch

Every model version (--model_version 0..4) runs, with --full_batch,
--weight_3d_loss, --weight_instance_loss, --code_noise, --vp_v2v_n_verts and
the custom entry's HuMoR dynamics term (--weight_humor_loss, --humor_fps,
--humor_ckpt); --motion_mlp fused runs the MotionNet through the fused MLP
kernels (K6). --smpl_path (a .pkl or .npz file, or a directory holding
one), --j_regressor_extra, --vposer_path and --gmm_path load the real
assets; a named file that does not load raises. --synthetic_assets builds
the synthetic body and random priors where no file is named.
Writes config.json, metrics.jsonl, ckpt/sd_NNNNNN/, losses.npz, the eval
CSVs and, with --render_video / --render_rollout_figure / --render_every,
the mesh renders (mesh_rollout.mp4 or its .frames directory,
rollout_figure.png, comparison_view0.png, vibe_rollout.png) and the
matplotlib figures, under out_dir/<NNNNNN>/. The mesh renders need neither
matplotlib nor PIL; where matplotlib is missing the CLI skips its figures
and names each file it skipped. Every flag of the JAX CLI parses. Real
SMPL/VPoser/GMM assets, --dp, --skin_bf16 and the HuMoR prior
(--weight_humor_loss, --humor_fps, --humor_ckpt, --init-motion-prior) are
still to port (ROADMAP.md Queue 1) and raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os.path as osp
import sys

import numpy as np
import torch

from ..modules.networks import MLP_MODES



def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (kernels) or 'cpu' (plain PyTorch versions)")
    p.add_argument("--motion_mlp", type=str, default="plain",
                   choices=MLP_MODES,
                   help="the MotionNet's MLP: plain matmuls, or fused "
                        "through the K6 kernels (the JAX package's "
                        "NEMO_TPU_NET_FUSED=1)")
    p.add_argument("--bundle", type=str, default="")
    p.add_argument("--nemo_cfg_path", type=str, default="",
                   help="per-action YAML (exp_dir + video names); read by "
                        "the preprocessing CLI, not by the fit")
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
    # V0's per-network learning rates (neural_motion_model.py:3180-3199)
    p.add_argument("--lr_pose", type=float, default=1e-2)
    p.add_argument("--lr_orient", type=float, default=1e-2)
    p.add_argument("--lr_trans", type=float, default=1e-2)
    p.add_argument("--weight_vp_loss", type=float, default=0)
    p.add_argument("--weight_vp_z_loss", type=float, default=0)
    p.add_argument("--vp_v2v_n_verts", type=int, default=0)
    p.add_argument("--skin_bf16", action="store_true", default=False,
                   help="bf16 skinning tables: refused, still to port")
    p.add_argument("--weight_gmm_loss", type=float, default=1e-2)
    p.add_argument("--weight_instance_loss", type=float, default=0)
    p.add_argument("--weight_3d_loss", type=float, default=0)
    p.add_argument("--weight_humor_loss", type=float, default=0)
    p.add_argument("--humor_fps", type=float, default=30.0)
    p.add_argument("--humor_ckpt", type=str, default="")
    p.add_argument("--init-motion-prior", dest="init_motion_prior",
                   type=str, default="")
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
    # accepted and ignored, as the JAX CLI does, for drop-in compatibility
    # with the reference entry's command lines: the data-layer flags belong
    # to the preprocessing CLI, the others are dead in the reference too
    for flag, kw in (("--data_loader_type", dict(type=str, default="")),
                     ("--db", dict(action="store_true", default=False)),
                     ("--n_frames", dict(type=int, default=-1)),
                     ("--start_phase", dict(type=float, default=0.0)),
                     ("--sequence_ids", dict(type=str, default="")),
                     ("--run_hmr", dict(action="store_true", default=False)),
                     ("--use_adam", dict(action="store_true", default=False)),
                     ("--optimize_flip", dict(action="store_true",
                                              default=False)),
                     ("--render_each_frame", dict(action="store_true",
                                                  default=False)),
                     ("--user", dict(type=str, default=""))):
        p.add_argument(flag, help=argparse.SUPPRESS, **kw)
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--render_every", type=int, default=0)
    return p


def _reject_unported(args) -> None:
    unported = {
        "--dp (data parallelism; see ROADMAP.md, Queue 1, item 6.4)":
            args.dp,
        "--skin_bf16 (bf16 skinning tables; see ROADMAP.md, Queue 2, part "
        "A, item 1)": args.skin_bf16,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"still to port: {'; '.join(bad)}")


def load_assets(args, bundle, cfg, device):
    """The SMPL model, priors and HuMoR weights the flags name, packed with
    the bundle into NemoAssets on ``device``. A named file always wins over
    --synthetic_assets (the JAX CLI takes the synthetic body when both
    --smpl_path and --synthetic_assets are given; the port never swaps a
    named file for a synthetic stand-in). Without --smpl_path the body is
    the synthetic one; a prior with neither a path nor --synthetic_assets
    is left out (None)."""
    from ..fit.assemble import build_assets
    from ..priors.gmm import load_gmm_prior, synthetic_gmm_prior
    from ..priors.vposer import init_vposer, load_vposer

    if args.smpl_path:
        from ..body.assets import load_smpl
        smpl = load_smpl(args.smpl_path, args.j_regressor_extra or None,
                         device=device)
    else:
        from ..body.assets import synthetic_smpl_model
        smpl = synthetic_smpl_model(device=device)

    gmm = None
    if args.gmm_path:
        gmm = load_gmm_prior(args.gmm_path)
    elif args.synthetic_assets and cfg.weight_gmm_loss:
        gmm = synthetic_gmm_prior(8)

    vposer = None
    if args.vposer_path:
        vposer = load_vposer(args.vposer_path)
    elif args.synthetic_assets and (cfg.weight_vp_loss or
                                    cfg.weight_vp_z_loss):
        vposer = init_vposer(generator=torch.Generator().manual_seed(0))

    humor = None
    if cfg.weight_humor_loss:
        from ..models.humor import init_humor, load_humor
        if args.humor_ckpt:
            humor = load_humor(args.humor_ckpt)
        elif args.synthetic_assets:
            humor = init_humor(torch.Generator().manual_seed(1))

    return build_assets(bundle, smpl, cfg, gmm=gmm, vposer=vposer,
                        device=device, motion_mlp=args.motion_mlp,
                        humor=humor)


def _figure(paths, draw, *args, **kw) -> None:
    """Draw a matplotlib figure (writing paths), or name each path skipped
    where matplotlib is missing."""
    if importlib.util.find_spec("matplotlib") is not None:
        draw(*args, **kw)
        return
    for path in [paths] if isinstance(paths, str) else paths:
        print(f"[fit] matplotlib is not installed: skipped {path}")


def _restore_config(cfg, args, argv):
    """The config a checkpoint was saved with; flags the user typed win."""
    from ..fit.model import NemoConfig
    from ..utils.checkpoint import load_saved_config
    from ..utils.exp import explicit_cli_keys
    saved = load_saved_config(args.load_ckpt_path)
    if not saved:
        return cfg
    fields = NemoConfig.__dataclass_fields__
    merged = {k: v for k, v in saved.items() if k in fields}
    for k in explicit_cli_keys(argv):
        if k in fields:
            merged[k] = getattr(args, k)
    print("[fit] restored model config from checkpoint")
    return NemoConfig(**{**dataclasses.asdict(cfg), **merged})


def main(argv=None) -> int:
    from .. import resolve_device
    from ..body.assets import synthetic_smpl_model
    from ..data.bundle import MultiViewBundle
    from ..data.synthetic import synthetic_problem
    from ..eval.metrics import (eval_2d, eval_3d, eval_3d_global,
                                smpl_grid_forward, write_csv)
    from ..fit.loop import NemoFitter
    from ..fit.model import NemoConfig, predict, project_to_views
    from ..render import keypoints as kp_render
    from ..utils.checkpoint import load_fit_state, save_fit_state
    from ..utils.exp import (MetricWriter, Timer, create_latest_child_dir,
                             dataclass_from_namespace, merge_config)

    args = merge_config(build_parser(), argv)
    _reject_unported(args)
    device = resolve_device(args.device)
    cfg = dataclass_from_namespace(NemoConfig, args)
    if args.load_ckpt_path:
        cfg = _restore_config(cfg, args, argv)
    out_dir = create_latest_child_dir(args.out_dir)
    with open(osp.join(out_dir, "config.json"), "w") as f:
        json.dump({"args": vars(args), "cfg": dataclasses.asdict(cfg)}, f,
                  indent=2, default=str)

    with Timer("Data loading"):
        if args.bundle:
            bundle = MultiViewBundle.load(args.bundle)
        else:
            print("[fit] no --bundle given; generating a synthetic problem")
            bundle, _ = synthetic_problem(synthetic_smpl_model(device=device),
                                          num_views=4, num_frames=60)

    with Timer("Model init"):
        assets = load_assets(args, bundle, cfg, device)
        fitter = NemoFitter(cfg, assets, seed=args.seed)

    if args.load_ckpt_path:
        rng = load_fit_state(args.load_ckpt_path, fitter)
        print(f"[fit] resumed from {args.load_ckpt_path} at step "
              f"{fitter.step}")
        if not rng:
            print("[fit] the checkpoint holds no batch generator state for "
                  f"this device: the batch stream restarts from --seed "
                  f"{args.seed}")

    V, F = assets.num_views, assets.num_frames
    vi_grid = torch.arange(V, device=device).repeat_interleave(F)
    fi_grid = torch.arange(F, device=device).repeat(V)

    @torch.no_grad()
    def grid_keypoints(f):
        pr = predict(f.params, cfg, assets, vi_grid, fi_grid)
        p2 = project_to_views(f.params, cfg, assets, pr["j"], vi_grid)
        return pr, p2.cpu().numpy().reshape(V, F, 25, 2)

    metrics_log = MetricWriter(osp.join(out_dir, "metrics.jsonl"))
    if not args.test:
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
            metrics_log.write({"phase": "cam_eval",
                               **fitter.eval_loss(full=full)})

        def on_chunk(f, step, chunk_metrics):
            if step % args.save_every == 0 or step >= cfg.n_steps:
                save_fit_state(osp.join(out_dir, "ckpt", f"sd_{step:06d}"), f,
                               cfg)
            if args.render_every > 0 and step % args.render_every == 0:
                path = osp.join(out_dir, f"rollout_{step:06d}.png")
                _figure(path, lambda: kp_render.render_keypoint_rollout(
                    path, grid_keypoints(f)[1], bundle))
            metrics_log.write({"phase": "fit", "step": step,
                               **{k: float(v[-1])
                                  for k, v in chunk_metrics.items()}})
            print(f"[fit] step {step}: "
                  f"total={float(chunk_metrics['total_loss'][-1]):.4f} "
                  f"kp={float(chunk_metrics['kp_loss'][-1]):.4f}")

        chunk = args.save_every if args.render_every <= 0 else \
            math.gcd(args.save_every, args.render_every)
        with Timer("Main fit"):
            all_metrics = fitter.fit(chunk=chunk, on_chunk=on_chunk)
        np.savez(osp.join(out_dir, "losses.npz"), **all_metrics)
        _figure([osp.join(out_dir, f"{k}.png") for k in all_metrics],
                kp_render.render_loss_curves, out_dir, all_metrics)

    _figure(osp.join(out_dir, "phases.png"), kp_render.render_phase_plot,
            osp.join(out_dir, "phases.png"), fitter.params.phase, V)

    final = fitter.eval_loss()
    metrics_log.write({"phase": "final", **final})
    print("[fit] final:", {k: round(v, 4) for k, v in final.items()})

    preds, pts2d = grid_keypoints(fitter)
    full_mesh_verts = None   # per-view full-mesh forwards, reused by renders

    def view_meshes():
        with torch.no_grad():
            return [predict(fitter.params, cfg, assets,
                            torch.full((F,), v, device=device),
                            torch.arange(F, device=device),
                            want_vertices=True) for v in range(V)]

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
        if args.render_video:
            def velocity_plots():
                _, j49 = smpl_grid_forward(
                    assets.smpl, bundle.gt3d_pose[..., 3:].reshape(V * F, 69))
                kp_render.render_dynamic_velocity_plots(
                    osp.join(out_dir, "dynamic"),
                    j49.reshape(V, F, 49, 3)[..., :15, :],
                    bundle.framerate_multiplier)
            _figure([osp.join(out_dir, "dynamic", f"v{v}_vel{s}.png")
                     for v in range(V) for s in ("", "_stats")],
                    velocity_plots)
        if bundle.gt3d_trans is not None:
            pv = view_meshes()
            full_mesh_verts = [p["v"].cpu().numpy() for p in pv]
            glamr_kwargs = {}
            if (bundle.glamr_orient is not None
                    and bundle.glamr_trans is not None
                    and "glamr" in (bundle.baseline_poses or {})):
                glamr_kwargs = {
                    "glamr_pose": np.concatenate(
                        [bundle.glamr_orient,
                         bundle.baseline_poses["glamr"][..., :69]], -1),
                    "glamr_trans": bundle.glamr_trans}
            stats_g, aligned = eval_3d_global(
                assets.smpl, np.stack([p["j"].cpu().numpy() for p in pv]),
                np.stack(full_mesh_verts), bundle.gt3d_pose,
                bundle.gt3d_trans,
                pred_trans=preds["trans"].cpu().numpy().reshape(V, F, 3),
                want_aligned=True, **glamr_kwargs)
            write_csv(stats_g, osp.join(out_dir, "eval_3d_global.csv"))
            from ..render.figures import render_global_overlay
            _figure(osp.join(out_dir, "overlay.png"), render_global_overlay,
                    osp.join(out_dir, "overlay.png"), aligned["gt-t"][0],
                    aligned["pred-t"][0], aligned.get("glamr-t", [None])[0])

    if args.render_video or args.render_rollout_figure:
        _render_outputs(args, out_dir, fitter, bundle, pts2d, full_mesh_verts
                        if full_mesh_verts is not None else
                        [p["v"].cpu().numpy() for p in view_meshes()])

    metrics_log.close()
    print(f"[fit] outputs in {out_dir}")
    return 0


def _render_outputs(args, out_dir, fitter, bundle, pts2d, mesh_verts) -> None:
    """The keypoint figures and overlay video (with --render_video) and the
    mesh renders through the learned cameras."""
    from ..geometry.camera import camera_from_params_np
    from ..render import (baseline_persons_from_bundle,
                          render_baseline_rollout,
                          render_comparison_figure, render_eval_grid,
                          render_keypoint_rollout, render_mesh_video,
                          render_overlay_video, render_rollout_figure)
    cfg, assets, device = fitter.cfg, fitter.assets, fitter.device
    V, F = assets.num_views, assets.num_frames
    if args.render_video:
        path = osp.join(out_dir, "rollout.png")
        _figure(path, render_keypoint_rollout, path, pts2d, bundle)
        path = osp.join(out_dir, "eval_2d_grid.png")
        _figure(path, render_eval_grid, path, pts2d, bundle, cfg.label_type)
        path = osp.join(out_dir, "overlay.mp4")
        _figure(path, lambda: print(
            "[fit] overlay video: "
            f"{render_overlay_video(path, pts2d, bundle, cfg.label_type)}"))
    faces = assets.smpl.faces
    if faces is None:
        print("[fit] no mesh faces in the SMPL model; skipping mesh rollout")
        return
    cam9 = fitter.params.cameras.detach().cpu().numpy()
    cams = [camera_from_params_np(cam9[v], assets.img_d0, assets.img_d1,
                                  cfg.focal_length) for v in range(V)]
    verts = np.stack(mesh_verts)
    if args.render_video:
        every = max(1, F // max(args.render_video, 1)) \
            if args.render_video > 1 else 1
        out = render_mesh_video(osp.join(out_dir, "mesh_rollout.mp4"), verts,
                                faces, cams, bundle, every=every,
                                device=device)
        print(f"[fit] mesh rollout: {out}")
    render_rollout_figure(osp.join(out_dir, "rollout_figure.png"), verts,
                          faces, cams, bundle, num_frames=min(8, F),
                          device=device)
    render_comparison_figure(osp.join(out_dir, "comparison_view0.png"), 0,
                             mesh_verts[0], faces, cams[0], bundle,
                             num_frames=min(6, F), device=device)
    persons = baseline_persons_from_bundle(bundle)
    if persons is not None:
        render_baseline_rollout(osp.join(out_dir, "vibe_rollout.png"),
                                assets.smpl, persons, bundle,
                                num_frames=min(8, F), device=device)


if __name__ == "__main__":
    sys.exit(main())
