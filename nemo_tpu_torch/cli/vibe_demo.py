"""CLI: VIBE demo pipeline — frames + detections -> vibe_output.pkl (port
of nemo_tpu/cli/vibe_demo.py; the same flags, plus --device).

Equivalent surface to VIBE/demo2.py and custom_video/VIBE_custom/demo.py:
track people across frames, crop each tracklet, run the VIBE model
(features -> GRU -> SPIN regressor -> SMPL), and dump the per-person dict
the NeMo data layer consumes. Person DETECTION is an external model in the
reference too (YOLO inside MPT); here detections come from a .npy/.json
file or from OpenPose keypoints.

Tracking and crops run on the host; ResNet-50, the GRU, the regressor and
SMPL (FK through kernel K1) on --device, 'cuda' by default; TemporalSMPLify
(--run_smplify) runs its L-BFGS there too, and --render_out rasterizes the
overlay there (kernel K5 on the card). The pickle is written in joblib's
format without joblib (utils/pickles), so joblib.load and the port's
data/vibe.py reader both read it.

Usage:
  python -m nemo_tpu_torch.cli.vibe_demo --frames_dir vid.frames \\
      --openpose_dir vid.frames.op --spin_ckpt spin_model.pth.tar \\
      --out vibe_output.pkl
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import sys
import tempfile

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--openpose_dir", type=str, default="",
                   help="derive person detections from OpenPose JSONs")
    p.add_argument("--detections", type=str, default="",
                   help=".npy (F, N, 4) bbox detections per frame")
    p.add_argument("--spin_ckpt", type=str, default="",
                   help="SPIN/VIBE torch checkpoint; random weights if "
                        "omitted (pipeline smoke mode)")
    p.add_argument("--smpl_path", type=str, default="")
    p.add_argument("--tracking_method", choices=["bbox", "pose"],
                   default="bbox",
                   help="bbox: greedy-IoU tracking over detections "
                        "(VIBE/demo2.py's MPT path); pose: group STAF-"
                        "tracked OpenPose person_ids into tracklets with "
                        "keypoint-extent bboxes (VIBE/demo.py:83-146 + "
                        "lib/utils/pose_tracker.py); needs --openpose_dir")
    p.add_argument("--min_track_len", type=int, default=25)
    p.add_argument("--max_frames", type=int, default=-1)
    p.add_argument("--out_res", type=int, default=224,
                   help="crop resolution fed to the backbone (224 in the "
                        "reference; smaller for smoke runs)")
    p.add_argument("--render_out", type=str, default="",
                   help="also render the tracked SMPL over every frame "
                        "(VIBE/demo2.py renders unless --no_render); "
                        "writes an mp4, or a .frames dir without ffmpeg")
    p.add_argument("--run_smplify", action="store_true",
                   help="refine each track with TemporalSMPLify "
                        "(VIBE/demo2.py:209-245); needs --openpose_dir "
                        "for the detected keypoints")
    p.add_argument("--smplify_iters", type=int, default=1,
                   help="outer LBFGS rounds (demo_utils.py opt_steps=1)")
    p.add_argument("--smplify_max_iter", type=int, default=20,
                   help="linesearch steps per round (LBFGS max_iter)")
    p.add_argument("--gmm_path", type=str, default="",
                   help="SPIN-format GMM prior pkl for SMPLify; "
                        "synthetic prior if omitted")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "PyTorch versions)")
    return p


def load_frames(frames_dir: str, max_frames: int):
    """The directory's .png/.jpg frames in name order, uint8 RGB."""
    from ..data.images import read_rgb
    names = sorted(n for n in os.listdir(frames_dir)
                   if n.lower().endswith((".png", ".jpg", ".jpeg")))
    if max_frames > 0:
        names = names[:max_frames]
    return [read_rgb(osp.join(frames_dir, n)) for n in names]


def detections_from_openpose(op_dir: str, num_frames: int):
    from ..data.crops import bbox_from_keypoints
    from ..data.openpose import load_openpose_dir
    kps = load_openpose_dir(op_dir, num_frames)
    dets = []
    for f in range(kps.shape[0]):
        if kps[f, :, 2].sum() == 0:
            dets.append(np.zeros((0, 4), np.float32))
            continue
        cx, cy, size = bbox_from_keypoints(kps[f])
        dets.append(np.array([[cx - size / 2, cy - size / 2,
                               cx + size / 2, cy + size / 2]], np.float32))
    return dets


def person_overlay(p: dict, smpl, img_hw):
    """One tracked person's mesh as render_demo_video draws it: (verts
    (T, V, 3), translations (T, 3), the camera's intrinsics as a Camera at
    the origin), on the SMPL model's device. Per-frame betas, as the
    reference demo renders (demo2.py:299-304 builds verts from each
    frame's own theta); orig_cam rides the exact weak->perspective twin
    (geometry/camera.py:camera_from_weak_persp), whose intrinsics are the
    same in every frame."""
    from ..body.smpl import smpl_forward
    from ..geometry.camera import Camera, camera_from_weak_persp

    dev = smpl.device
    pose = torch.as_tensor(np.asarray(p["pose"], np.float32),
                           device=dev)                      # (T, 72)
    betas = torch.as_tensor(np.asarray(p["betas"], np.float32)
                            .reshape(-1, 10), device=dev)
    cams = camera_from_weak_persp(np.asarray(p["orig_cam"]), *img_hw)
    trans = torch.as_tensor(np.asarray(cams.translation), device=dev)
    with torch.no_grad():
        verts, _ = smpl_forward(smpl, betas, pose[:, 3:], pose[:, :3],
                                pose2rot=True)              # (T, V, 3)
    cam0 = Camera(rotation=np.eye(3, dtype=np.float32),
                  translation=np.zeros(3, np.float32),
                  focal_length=float(cams.focal_length[0]),
                  center=np.asarray(cams.center[0]))
    return verts, trans, cam0


def render_demo_video(frames, people, smpl, out_path: str,
                      chunk: int = 8) -> str:
    """Render each tracked person's predicted SMPL over its covered
    frames — the reference demo's default output video (VIBE/demo2.py:
    262-315 through lib/utils/renderer.py's WeakPerspectiveCamera).

    Each person's mesh comes from person_overlay; frames go through one
    panel function chunk at a time (one rasterizer launch a chunk on the
    card), on the SMPL model's device. People composite sequentially per
    frame (the reference also renders person-over-person)."""
    from ..data.video import frames_to_video
    from ..render.mesh import composite_panel, make_mesh_panel_fn
    from ..render.video import _write_png

    dev = smpl.device
    H, W = frames[0].shape[:2]
    canvas = [np.asarray(f, np.float32) / 255.0 for f in frames]
    eye = torch.eye(3, device=dev).expand(chunk, 3, 3)
    for pid, p in people.items():
        fids = np.asarray(p["frame_ids"], np.int64)
        verts, trans, cam0 = person_overlay(p, smpl, (H, W))
        panel_fn = make_mesh_panel_fn(smpl.faces, [cam0] * chunk, (H, W),
                                      device=dev)
        T = len(fids)
        for s in range(0, T, chunk):
            idx = np.arange(s, min(s + chunk, T))
            pad = torch.as_tensor(np.pad(idx, (0, chunk - len(idx)),
                                         mode="edge"), device=dev)
            with torch.no_grad():
                imgs, masks = panel_fn(verts[pad], eye, trans[pad])
            imgs, masks = imgs.cpu().numpy(), masks.cpu().numpy()
            for k, t in enumerate(idx):
                f = int(fids[t])
                canvas[f] = composite_panel(imgs[k], masks[k], canvas[f],
                                            (H, W))
    with tempfile.TemporaryDirectory() as tmp:
        for i, img in enumerate(canvas):
            _write_png(osp.join(tmp, f"{i:06d}.png"), img)
        try:
            frames_to_video(tmp, out_path)
            if not osp.exists(out_path):
                raise OSError("ffmpeg produced no output")
            return out_path
        except Exception:
            fallback = out_path + ".frames"
            os.makedirs(fallback, exist_ok=True)
            for name in os.listdir(tmp):
                shutil.copy(osp.join(tmp, name), fallback)
            return fallback


def crop_keypoints(p: dict, op_kps: np.ndarray, crop_size: float = 224.0
                   ) -> np.ndarray:
    """A track's detected keypoints as SMPLify reads them: (T, 49, 3) in
    crop pixel coordinates, OpenPose BODY_25 in the first 25 slots of the
    SPIN-49 vocabulary (kp_utils.py:243-270), through the same smoothed
    bbox_cs the crops used. Pose tracking attached the track's OWN
    detections ('joints2d'), which the reference's SMPLify consumes
    (demo.py:182-184); else the frame's first OpenPose person."""
    fids = np.asarray(p["frame_ids"], np.int64)
    cs = np.asarray(p["bbox_cs"], np.float32)            # (T, 3)
    if "joints2d" in p:
        kp = np.asarray(p["joints2d"], np.float32).copy()
    else:
        kp = op_kps[fids].astype(np.float32).copy()      # (T, 25, 3)
    # image -> crop pixel coords (inverse of crop_to_image_coords)
    half = cs[:, 2:3] / 2.0
    kp[..., 0] = (kp[..., 0] - (cs[:, 0:1] - half)) * (crop_size
                                                        / cs[:, 2:3])
    kp[..., 1] = (kp[..., 1] - (cs[:, 1:2] - half)) * (crop_size
                                                        / cs[:, 2:3])
    kp49 = np.zeros((kp.shape[0], 49, 3), np.float32)
    kp49[:, :25] = kp
    return kp49


def refine_with_smplify(people, op_kps, smpl, gmm, img_hw,
                        opt_steps: int, max_iter: int,
                        crop_size: float = 224.0):
    """TemporalSMPLify refinement pass over every track
    (VIBE/demo2.py:209-245 + lib/utils/demo_utils.py:91-167), on the SMPL
    model's device.

    The keypoints are crop_keypoints'. Per-frame parameters are replaced only where the refined
    reprojection loss improves (demo2.py:229-238). Prints each track's
    L-BFGS host reads (one a linesearch iteration) by stage."""
    from ..data.tracker import convert_crop_cam_to_orig_img
    from ..priors.temporal_smplify import run_temporal_smplify

    dev = smpl.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    n_updated = n_total = 0
    for pid, p in people.items():
        cs = np.asarray(p["bbox_cs"], np.float32)        # (T, 3)
        stats: dict = {}
        out, update = run_temporal_smplify(
            smpl, gmm, t(p["pose"]), t(p["betas"]), t(p["pred_cam"]),
            t(crop_keypoints(p, op_kps, crop_size)), opt_steps=opt_steps,
            max_iter=max_iter, stats=stats)
        print(f"[vibe_demo] TemporalSMPLify track {pid}: "
              + "; ".join(f"{stage} stage {s.get('host_reads', 0)} "
                          f"linesearch host reads, {s.get('loss_evals', 0)}"
                          f" loss evaluations"
                          for stage, s in stats.items()))
        upd = update.cpu().numpy()
        pose = np.asarray(p["pose"]).copy()
        betas = np.asarray(p["betas"]).copy()
        pred_cam = np.asarray(p["pred_cam"]).copy()
        pose[upd] = out["pose"].cpu().numpy()[upd]
        betas[upd] = out["betas"].cpu().numpy()[None]
        pred_cam[upd] = out["weak_cam"].cpu().numpy()[upd]
        p["pose"], p["betas"], p["pred_cam"] = pose, betas, pred_cam
        p["orig_cam"] = convert_crop_cam_to_orig_img(
            pred_cam, cs, img_hw[1], img_hw[0])
        n_updated += int(upd.sum())
        n_total += len(upd)
        p["smplify_update"] = upd
    print(f"[vibe_demo] TemporalSMPLify updated {n_updated}/{n_total} "
          f"frames")
    return people


def main(argv=None) -> int:
    from .. import resolve_device
    from ..data.tracker import run_vibe_on_tracks, track_bboxes
    from ..models import (init_gru, init_hmr_head, init_resnet50,
                          load_spin_checkpoint)
    from ..utils import pickles

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    frames = load_frames(args.frames_dir, args.max_frames)
    print(f"[vibe_demo] {len(frames)} frames")

    if args.tracking_method == "pose":
        # the reference's STAF pose-tracking branch (VIBE/demo.py:83-86,
        # 129-146): tracklets come keyed by OpenPose person_id, bboxes
        # derive from the keypoint extents, and the detections ride along
        if not args.openpose_dir:
            raise SystemExit("--tracking_method pose needs --openpose_dir")
        from ..data.openpose import read_posetrack_keypoints
        from ..data.tracker import tracks_from_posetrack
        tracks = tracks_from_posetrack(
            read_posetrack_keypoints(args.openpose_dir, len(frames)))
    else:
        if args.detections:
            raw = np.load(args.detections, allow_pickle=True)
            dets = [np.asarray(d).reshape(-1, 4) for d in raw]
        elif args.openpose_dir:
            dets = detections_from_openpose(args.openpose_dir, len(frames))
        else:
            raise SystemExit("need --detections or --openpose_dir")
        tracks = track_bboxes(dets)
    print(f"[vibe_demo] {len(tracks)} tracks")

    if args.smpl_path:
        from ..body.assets import load_smpl
        smpl = load_smpl(args.smpl_path, device=device)
    else:
        from ..body.assets import synthetic_smpl_model
        smpl = synthetic_smpl_model(device=device)

    if args.spin_ckpt:
        backbone, head, gru = load_spin_checkpoint(args.spin_ckpt)
    else:
        print("[vibe_demo] no checkpoint: random weights (smoke mode)")
        backbone = init_resnet50(torch.Generator().manual_seed(0))
        head = init_hmr_head(torch.Generator().manual_seed(1))
        gru = init_gru(torch.Generator().manual_seed(2))
    backbone, head, gru = (m.to(device) for m in (backbone, head, gru))

    out = run_vibe_on_tracks(frames, tracks, backbone, gru, head, smpl,
                             min_track_len=args.min_track_len,
                             out_res=args.out_res)
    if args.run_smplify:
        if not args.openpose_dir:
            # the reference warns + skips when pose tracking is absent
            # (demo2.py:240-243)
            print("[vibe_demo] WARNING: --run_smplify needs "
                  "--openpose_dir keypoints; skipping refinement")
        elif out:
            from ..data.openpose import load_openpose_dir
            from ..priors.gmm import load_gmm_prior, synthetic_gmm_prior
            gmm = (load_gmm_prior(args.gmm_path, device) if args.gmm_path
                   else synthetic_gmm_prior().to(device))
            op_kps = load_openpose_dir(args.openpose_dir, len(frames))
            out = refine_with_smplify(
                out, np.asarray(op_kps), smpl, gmm,
                frames[0].shape[:2], args.smplify_iters,
                args.smplify_max_iter)
    pickles.dump(out, args.out)
    print(f"[vibe_demo] wrote {args.out} "
          f"({len(out)} people, keys: pose/betas/orig_cam/"
          f"joints2d_img_coord/frame_ids/bboxes)")
    if args.render_out and out:
        if smpl.faces is None:
            print("[vibe_demo] --render_out skipped: model has no faces")
        else:
            dst = render_demo_video(frames, out, smpl, args.render_out)
            print(f"[vibe_demo] rendered {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
