"""CLI: export a fitted motion to a portable npz/JSON payload (port of
nemo_tpu/cli/export.py).

The reference's only motion-export path is the Blender FBX script
(VIBE/lib/utils/fbx_output.py:92-340), which keys per-frame
SMPL rotations + a pelvis translation onto an armature. bpy is out of scope
here; this is the bpy-free equivalent of that payload — everything a
downstream animation/retarget tool needs to reconstruct the motion:

  pose      (V, F, 72) float32 — axis-angle per frame: global orient [:3]
            (the rotation fbx_output keys on the Pelvis bone) + 23 body
            joints [3:] in SMPL order (bone_name_from_index,
            fbx_output.py:37-64)
  trans     (V, F, 3)  float32 — root translation per frame (the Pelvis
            `location` channel, fbx_output.py:126-131; phase-0-anchored
            like the fit's trans head)
  betas     (10,)      float32 — the shared learned shape
  cameras   (V, 9)     float32 — raw learned camera params
  cam_rotation (V, 3, 3), cam_translation (V, 3), cam_focal (V,),
  cam_center (V, 2)    — the decomposed per-view perspective cameras
  fps       ()         float32 — playback rate (fbx_output's fps_target)
  framerate_multiplier (V,) — raw-frames-per-resampled-frame, when known
  joints15  (V, F, 15, 3) float32 — reconstruction check: SMPL joints with
            betas/orient/trans applied (lets a consumer verify its own
            SMPL forward against ours)

The (V, F) leading axes are the fit's per-view phase-warped sequences: NeMo
learns one canonical motion but each view renders it through its own
monotonic phase warp, so per-view pose grids are the faithful export.

The grid is predicted once on --device ('cuda' by default: K1f, and K6f
when the run was fitted with --motion_mlp fused; 'cpu' must be asked for).
The checkpoint may come from either package's fit (utils/checkpoint.py
reads the JAX layout). The MotionNet and skinning modes (the fit CLI's
--motion_mlp, --net_precision, --skin_bf16, --skin_io_bf16) are the ones
the port's fit CLI recorded in the run's config.json (two directories above
the checkpoint), else the fit CLI's defaults.

Reconstruction recipe (round-tripped by
tests/test_torch_port_doctor_export.py):
  verts, joints = smpl_forward(model, betas[None], pose[..., 3:],
                               pose[..., :3], pose2rot=True, transl=trans)

Usage:
  python -m nemo_tpu_torch.cli.export --load_ckpt_path out/.../ckpt/sd_000500 \
      --synthetic_assets --out motion.npz [--json] [--fps 30] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import os.path as osp
import sys

import numpy as np
import torch

# the fit CLI's flags that pick the network and skinning modes, with its
# defaults
_MODE_FLAGS = {"motion_mlp": "plain", "net_precision": "highest",
               "skin_bf16": False, "skin_io_bf16": False}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--load_ckpt_path", type=str, required=True,
                   help="fit checkpoint dir (out/.../ckpt/sd_NNNNNN)")
    p.add_argument("--bundle", type=str, default="",
                   help="packed .npz action bundle; a synthetic problem "
                        "matching the checkpoint is generated if omitted")
    p.add_argument("--out", type=str, default="motion.npz")
    p.add_argument("--json", action="store_true", default=False,
                   help="also write a .json sidecar with the same payload")
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--smpl_path", type=str, default="")
    p.add_argument("--j_regressor_extra", type=str, default="")
    p.add_argument("--vposer_path", type=str, default="")
    p.add_argument("--gmm_path", type=str, default="")
    p.add_argument("--humor_ckpt", type=str, default="")
    p.add_argument("--synthetic_assets", action="store_true", default=False)
    p.add_argument("--num_views", type=int, default=4,
                   help="synthetic-problem topology when no --bundle")
    p.add_argument("--num_frames", type=int, default=60)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (kernels) or 'cpu' (plain PyTorch versions)")
    return p


def _set_run_modes(args) -> None:
    """The fit's mode flags on args, for load_assets: the run's config.json
    (the fit CLI writes it two directories above
    out_dir/<run>/ckpt/sd_NNNNNN), else the fit CLI's defaults."""
    run_cfg = osp.join(osp.dirname(osp.dirname(
        osp.abspath(args.load_ckpt_path))), "config.json")
    recorded = {}
    if osp.exists(run_cfg):
        with open(run_cfg) as f:
            recorded = json.load(f).get("args", {})
    for k, default in _MODE_FLAGS.items():
        setattr(args, k, recorded.get(k, default))


@torch.no_grad()
def export_motion(params, cfg, assets, fps: float = 30.0,
                  framerate_multiplier=None) -> dict:
    """Assemble the portable motion payload from fitted params.

    Runs the full (view, frame) prediction grid once on the assets' device
    (predict(), fit/model.py) and decomposes the learned cameras
    (geometry/camera.py:camera_from_params_np)."""
    from ..fit.model import predict
    from ..geometry.camera import camera_from_params_np

    V, F = assets.num_views, assets.num_frames
    dev = assets.device
    vi = torch.arange(V, device=dev).repeat_interleave(F)
    fi = torch.arange(F, device=dev).repeat(V)
    pr = predict(params, cfg, assets, vi, fi)

    pose = torch.cat([pr["orient_aa"], pr["poses"]], dim=-1).reshape(
        V, F, 72).cpu().numpy().astype(np.float32)
    trans = pr["trans"].reshape(V, F, 3).cpu().numpy().astype(np.float32)
    j15 = pr["j49"][:, :15].reshape(V, F, 15, 3).cpu().numpy()

    cam9 = params.cameras.detach().cpu().numpy().astype(np.float32)
    cam = camera_from_params_np(cam9, assets.img_d0, assets.img_d1,
                                cfg.focal_length)
    payload = {
        "pose": pose,
        "trans": trans,
        "betas": params.betas.detach().cpu().numpy().astype(
            np.float32).reshape(-1)[:10],
        "cameras": cam9,
        "cam_rotation": np.asarray(cam.rotation, np.float32),
        "cam_translation": np.asarray(cam.translation, np.float32),
        "cam_focal": np.asarray(cam.focal_length, np.float32),
        "cam_center": np.asarray(cam.center, np.float32),
        "fps": np.float32(fps),
        "joints15": j15.astype(np.float32),
    }
    if framerate_multiplier is not None:
        payload["framerate_multiplier"] = np.asarray(
            framerate_multiplier, np.float32)
    return payload


def save_motion(path: str, payload: dict, also_json: bool = False) -> None:
    d = osp.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez_compressed(path, **payload)
    if also_json:
        with open(osp.splitext(path)[0] + ".json", "w") as f:
            json.dump({k: np.asarray(v).tolist() for k, v in payload.items()},
                      f)


def load_motion(path: str) -> dict:
    """Reload an exported motion (npz or json) as numpy arrays."""
    if path.endswith(".json"):
        with open(path) as f:
            return {k: np.asarray(v, np.float32)
                    for k, v in json.load(f).items()}
    return dict(np.load(path))


def main(argv=None) -> int:
    from .. import resolve_device
    from ..body.assets import synthetic_smpl_model
    from ..data import MultiViewBundle, synthetic_problem
    from ..fit import NemoConfig, NemoFitter
    from ..utils.checkpoint import load_fit_state, load_saved_config
    from .fit import load_assets

    args = build_parser().parse_args(argv)
    _set_run_modes(args)
    device = resolve_device(args.device)

    cfg = NemoConfig()
    saved = load_saved_config(args.load_ckpt_path)
    if saved:
        fields = NemoConfig.__dataclass_fields__
        cfg = NemoConfig(**{**dataclasses.asdict(cfg),
                            **{k: v for k, v in saved.items() if k in fields}})
        print("[export] restored model config from checkpoint")

    if args.bundle:
        bundle = MultiViewBundle.load(args.bundle)
    else:
        bundle, _ = synthetic_problem(synthetic_smpl_model(device=device),
                                      num_views=args.num_views,
                                      num_frames=args.num_frames)

    assets = load_assets(args, bundle, cfg, device)
    fitter = NemoFitter(cfg, assets, seed=0)
    load_fit_state(args.load_ckpt_path, fitter)
    print(f"[export] loaded step-{fitter.step} checkpoint "
          f"(motion_mlp {args.motion_mlp}, net_precision "
          f"{args.net_precision}, device {device})")

    payload = export_motion(fitter.params, cfg, assets, fps=args.fps,
                            framerate_multiplier=bundle.framerate_multiplier)
    save_motion(args.out, payload, also_json=args.json)
    print(f"[export] wrote {args.out}"
          + (f" (+ {osp.splitext(args.out)[0]}.json)" if args.json else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
