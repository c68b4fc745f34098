"""CLI: pack raw per-view data (OpenPose JSONs, VIBE pickles, GT pickles)
into a fit-ready npz bundle (port of nemo_tpu/cli/preprocess.py; host-only
file conversion, it touches no device).

Replaces the reference's fit-time data layer (nemo/multi_view_sequence.py:
MultiViewSequence / PennActionMultiViewSequence / DemoMultiViewSequence)
with an offline packer: the three loader classes collapse into one schema,
and the fit loop never touches Python I/O.

Usage:
  python -m nemo_tpu_torch.cli.preprocess --nemo_cfg_path action.yml \
      --out bundle.npz [--n_frames 120]

The per-action YAML is the reference's format: exp_dir + videos.names; for
each view <name> the packer looks for:
  <exp_dir>/<name>.frames.op/      OpenPose JSONs     (required)
  <exp_dir>/<name>_vibe/vibe_output.pkl  VIBE init    (optional)
  <exp_dir>/<name>_gt_2d.npy       GT 2D (F, 25, 3)   (optional)
  mocap GT via --mocap_pkl (fullpose/trans arrays)    (optional)

The OpenPose JSONs go through the C++ batch parser (ops/native.py) when its
library builds, else through the json module. The line printed before the
bundle's names which parser read how many views.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

import numpy as np


def _vibe_render_kwargs(render_views, F: int, start_phase: float) -> dict:
    """Bundle kwargs for the VIBE baseline-render slots.

    render_views: per-view vibe_render_arrays() dicts (None when a view has
    no VIBE person or no orig_cam). All-or-nothing like the 'vibe' label:
    the rollout figure needs every row.
    """
    from ..data import resample_to_common_frames
    if not render_views or any(r is None for r in render_views):
        return {}
    return {
        "vibe_orient": resample_to_common_frames(
            [r["orient"] for r in render_views], F,
            start_phase).astype(np.float32),
        "vibe_betas": np.stack([r["betas"] for r in render_views]
                               ).astype(np.float32),
        "vibe_cam": resample_to_common_frames(
            [r["orig_cam"] for r in render_views], F,
            start_phase).astype(np.float32),
    }


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nemo_cfg_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--n_frames", type=int, default=-1,
                   help="common frame count (-1 = min over views)")
    p.add_argument("--start_phase", type=float, default=0.0)
    p.add_argument("--img_h", type=float, default=0, help="0 = infer")
    p.add_argument("--img_w", type=float, default=0)
    p.add_argument("--mocap_pkl", type=str, default="")
    p.add_argument("--gt_cam_paths", type=str, default="",
                   help="comma-separated opt_cam .npy paths (one per view)")
    p.add_argument("--spin_npys", type=str, default="",
                   help="comma-separated per-view SPIN theta .npy paths "
                        "(F, 69|72|85) -> the V0 warmup's spin_theta slot "
                        "(neural_motion_model.py:3216-3227)")
    p.add_argument("--penn_mats", type=str, default="",
                   help="comma-separated Penn Action labels/NNNN.mat paths "
                        "(one per view) -> 'gt' 2D labels via the 13->25 "
                        "L/R-swapped mapping")
    p.add_argument("--penn_root", type=str, default="",
                   help="Penn Action root for seq_names-style action YAMLs "
                        "(PennActionMultiViewSequence layout: frames/NNNN, "
                        "labels/NNNN.mat, openpose/NNNN, "
                        "vibe_results/NNNN/vibe_output.pkl)")
    # 3D baseline slots for eval_3d columns (comma-separated, one per view;
    # the reference's vs/pare/glamr loaders, multi_view_sequence.py:336-392)
    p.add_argument("--vs_pkls", type=str, default="",
                   help="VIBE+SMPLify vibe_output.pkl paths")
    p.add_argument("--pare_pkls", type=str, default="",
                   help="PARE pare_output.pkl paths (rotmat poses)")
    p.add_argument("--glamr_pkls", type=str, default="",
                   help="GLAMR grecon *_seed1.pkl paths")
    return p


def _report_parser() -> None:
    from ..data import PARSER_CALLS
    print("[preprocess] OpenPose parser: " + ", ".join(
        f"{k} {n} view(s)" for k, n in PARSER_CALLS.items()))


def pack_penn(args, cfg) -> int:
    """Pack a seq_names-style Penn Action YAML.

    Mirrors PennActionMultiViewSequence (multi_view_sequence.py:511-640):
    layout <root>/{frames,labels,openpose,vibe_results}/NNNN, sequences
    where VIBE returned an empty dict are skipped (:526-537), the common
    frame count is min(n_frames, min_views_frames - round(min*start) - 1)
    (:541-550), and GT 2D comes from the 13->25 L/R-swapped mapping.
    """
    from ..data import (MultiViewBundle, load_openpose_dir,
                        load_penn_sequence, load_vibe_pickle,
                        person_joints2d, reset_parser_calls,
                        resample_to_common_frames, vibe_render_arrays,
                        vibe_to_theta)
    from ..data.bundle import resample_indices
    from ..utils import pickles

    reset_parser_calls()
    root = args.penn_root or cfg.get("root", "")
    if not root:
        raise ValueError("seq_names YAML needs --penn_root (the reference's "
                         "PENN_ACTION_ROOT)")

    seq_ids, vibe_raws = [], []
    for sid in cfg["seq_names"]:
        raw = pickles.load(osp.join(root, "vibe_results", sid,
                                   "vibe_output.pkl"))
        if raw == {}:
            print(f"[preprocess] VIBE failed for {sid}, skipping...")
            continue
        seq_ids.append(sid)
        vibe_raws.append(raw)

    lens = []
    for sid in seq_ids:
        fdir = osp.join(root, "frames", sid)
        lens.append(len([f for f in os.listdir(fdir)
                         if f.lower().endswith((".jpg", ".png"))]))
    min_frames = min(lens)
    start_min = np.round(min_frames * args.start_phase)
    F = int(min(args.n_frames if args.n_frames > 0 else np.inf,
                min_frames - start_min - 1))

    op_views, gt_views, theta_views, j2d_views, frame_views = \
        [], [], [], [], []
    render_views = []
    for v, sid in enumerate(seq_ids):
        gt_views.append(load_penn_sequence(
            osp.join(root, "labels", f"{sid}.mat")))
        op_views.append(load_openpose_dir(osp.join(root, "openpose", sid)))
        person = load_vibe_pickle(vibe_raws[v], lens[v], gt_2d=gt_views[v])
        if person is not None:
            theta_views.append(vibe_to_theta(person))
            j2d_views.append(person_joints2d(person))
            render_views.append(vibe_render_arrays(person))
        else:
            theta_views.append(np.zeros((lens[v], 70), np.float32))
            j2d_views.append(None)
            render_views.append(None)
        fdir = osp.join(root, "frames", sid)
        frame_views.append(sorted(
            osp.join(fdir, f) for f in os.listdir(fdir)
            if f.lower().endswith((".jpg", ".png"))))

    labels = {
        "op": resample_to_common_frames(op_views, F,
                                        args.start_phase).astype(np.float32),
        "gt": resample_to_common_frames(gt_views, F,
                                        args.start_phase).astype(np.float32),
    }
    if all(j is not None for j in j2d_views):
        labels["vibe"] = resample_to_common_frames(
            j2d_views, F, args.start_phase).astype(np.float32)
    theta_all = resample_to_common_frames(theta_views, F, args.start_phase)

    if args.img_h and args.img_w:
        img_hw = np.array([args.img_h, args.img_w], np.float32)
    else:
        mx = labels["gt"][..., :2].reshape(-1, 2).max(0)
        img_hw = np.array([np.ceil(mx[1] * 1.05), np.ceil(mx[0] * 1.05)],
                          np.float32)

    kwargs = {}
    if all(len(f) for f in frame_views):
        kwargs["frame_paths"] = np.stack([
            np.asarray(f)[resample_indices(len(f), F, args.start_phase)]
            for f in frame_views])
    kwargs.update(_vibe_render_kwargs(render_views, F, args.start_phase))

    bundle = MultiViewBundle(
        labels=labels,
        hmr_theta=theta_all[..., :69].astype(np.float32),
        hmr_mask=theta_all[..., 69:70].astype(np.float32),
        img_hw=img_hw,
        framerate_multiplier=np.asarray(
            [l / max(F, 1) for l in lens], np.float32),
        name=osp.splitext(osp.basename(args.nemo_cfg_path))[0],
        **kwargs)
    _report_parser()
    bundle.save(args.out)
    print(f"[preprocess] wrote {args.out} "
          f"({len(seq_ids)} penn sequences, F={F})")
    return 0


def main(argv=None) -> int:
    from ..data import (MultiViewBundle, load_openpose_dir,
                        load_vibe_pickle, reset_parser_calls,
                        resample_to_common_frames, vibe_to_theta)
    from ..utils import load_action_config

    args = build_parser().parse_args(argv)
    cfg = load_action_config(args.nemo_cfg_path)
    if "seq_names" in cfg and "videos" not in cfg:
        return pack_penn(args, cfg)
    exp_dir = cfg["exp_dir"]
    names = cfg["videos"]["names"]
    reset_parser_calls()

    op_per_view, gt_per_view, theta_per_view, frames_per_view = [], [], [], []
    j2d_per_view, render_per_view = [], []
    for name in names:
        base = osp.join(exp_dir, name)
        # optional extracted frames (video_to_frames output) for eval overlays
        fdir = base + ".frames"
        if osp.isdir(fdir):
            frames_per_view.append(sorted(
                osp.join(fdir, f) for f in os.listdir(fdir)
                if f.lower().endswith((".png", ".jpg", ".jpeg"))))
        else:
            frames_per_view.append(None)
        op_dir = None
        for cand in (base + ".frames.op", base + ".op",
                     base + "_openpose"):
            if osp.isdir(cand):
                op_dir = cand
                break
        if op_dir is None:
            raise FileNotFoundError(f"no OpenPose dir for view {name}")
        op = load_openpose_dir(op_dir)
        op_per_view.append(op)

        # GT 2D: packed .npy, or the reference's on-disk layout — a
        # `<view>_gt_new/` dir of per-frame joblib pkls
        # (multi_view_sequence.py:336-344)
        gt_path = base + "_gt_2d.npy"
        gt_dir = base + "_gt_new"
        if osp.exists(gt_path):
            gt_per_view.append(np.load(gt_path))
        elif osp.isdir(gt_dir):
            from ..data import load_gt2d_pkl_dir
            gt_per_view.append(load_gt2d_pkl_dir(gt_dir))
        else:
            gt_per_view.append(None)

        vibe_path = None
        for cand in (osp.join(exp_dir, name + "_vibe", "vibe_output.pkl"),
                     osp.join(exp_dir, "vibe", name, "vibe_output.pkl")):
            if osp.exists(cand):
                vibe_path = cand
                break
        if vibe_path:
            person = load_vibe_pickle(vibe_path, op.shape[0], gt_2d=op)
        else:
            person = None
        if person is not None:
            from ..data import person_joints2d, vibe_render_arrays
            theta_per_view.append(vibe_to_theta(person))
            j2d_per_view.append(person_joints2d(person))
            render_per_view.append(vibe_render_arrays(person))
        else:
            theta_per_view.append(np.zeros((op.shape[0], 70), np.float32))
            j2d_per_view.append(None)
            render_per_view.append(None)

    lens = [o.shape[0] for o in op_per_view]
    F = min(lens) if args.n_frames <= 0 else min(args.n_frames, min(lens))
    print(f"[preprocess] views={len(names)} frames/view={lens} -> F={F}")

    op_all = resample_to_common_frames(op_per_view, F, args.start_phase)
    theta_all = resample_to_common_frames(theta_per_view, F, args.start_phase)

    labels = {"op": op_all.astype(np.float32)}
    if all(j is not None for j in j2d_per_view):
        # VIBE image-space 2D tracks: the always-collated 'vibe' label that
        # feeds eval_2d's recon_error_2d-vibe / pck-vibe columns
        # (multi_view_sequence.py:442-443, neural_motion_model.py:558-560)
        labels["vibe"] = resample_to_common_frames(
            j2d_per_view, F, args.start_phase).astype(np.float32)
    if args.penn_mats:
        # Penn Action GT labels (PennActionMultiViewSequence's source)
        from ..data import load_penn_sequence
        penn = [load_penn_sequence(p) for p in args.penn_mats.split(",")]
        labels["gt"] = resample_to_common_frames(
            penn, F, args.start_phase).astype(np.float32)
    elif all(g is not None for g in gt_per_view):
        labels["gt"] = resample_to_common_frames(
            gt_per_view, F, args.start_phase).astype(np.float32)

    if args.img_h and args.img_w:
        img_hw = np.array([args.img_h, args.img_w], np.float32)
    else:
        # infer from keypoint extents
        mx = op_all[..., :2].reshape(-1, 2).max(0)
        img_hw = np.array([np.ceil(mx[1] * 1.05), np.ceil(mx[0] * 1.05)],
                          np.float32)

    kwargs = {}
    kwargs.update(_vibe_render_kwargs(render_per_view, F, args.start_phase))
    if args.spin_npys:
        # accept raw body pose (69), full pose (72 -> drop orient), or the
        # SPIN 85-d theta (cam 3 + pose 72 + betas 10 -> body cols 6:75)
        spin = []
        for p in args.spin_npys.split(","):
            arr = np.load(p).astype(np.float32)
            if arr.shape[-1] == 85:
                arr = arr[:, 6:75]
            elif arr.shape[-1] == 72:
                arr = arr[:, 3:]
            if arr.shape[-1] != 69:
                raise ValueError(f"bad SPIN theta width in {p}: {arr.shape}")
            spin.append(arr)
        kwargs["spin_theta"] = resample_to_common_frames(
            spin, F, args.start_phase)
    if args.mocap_pkl:
        from ..utils import pickles
        mocap = pickles.load(args.mocap_pkl)
        # MoSh fullpose is SMPL-H: keep root + 21 body joints, zero the
        # 2 hand slots (multi_view_sequence.py:397-400 pads :66 with 6 zeros)
        body = np.asarray(mocap["fullpose"], np.float32)[:, :66]
        pose = np.concatenate(
            [body, np.zeros((body.shape[0], 6), np.float32)], axis=1)
        trans = np.asarray(mocap["trans"], np.float32)
        kwargs["gt3d_pose"] = resample_to_common_frames(
            [pose] * len(names), F, args.start_phase)
        kwargs["gt3d_trans"] = resample_to_common_frames(
            [trans] * len(names), F, args.start_phase)
    if args.gt_cam_paths:
        # per-view camera files: packed .npy (9,) vectors, or the
        # reference's torch `opt_cam_IMG_*.pt` (learned_cameras, focal) /
        # joblib {'rot6d','tran','K'} payloads
        # (multi_view_sequence.py:402-409, nemomocap_utils.py:205-211)
        from ..data import load_gt_camera_pt
        cams = []
        for p in args.gt_cam_paths.split(","):
            if p.endswith(".npy"):
                cams.append(np.load(p).reshape(-1)[:9])
            else:
                cam9, _focal = load_gt_camera_pt(p)
                cams.append(cam9)
        kwargs["gt_cameras"] = np.stack(cams).astype(np.float32)
    if all(f is not None and len(f) for f in frames_per_view):
        from ..data.bundle import resample_indices
        kwargs["frame_paths"] = np.stack([
            np.asarray(f)[resample_indices(len(f), F, args.start_phase)]
            for f in frames_per_view])

    baseline_poses = {}
    for kind, arg in (("vs", args.vs_pkls), ("pare", args.pare_pkls),
                      ("glamr", args.glamr_pkls)):
        if not arg:
            continue
        from ..data import load_baseline_arrays
        per_view, j2d_views = [], []
        orient_views, trans_views = [], []
        for v, p in enumerate(arg.split(",")):
            arrays = load_baseline_arrays(p, lens[v], kind,
                                          gt_2d=op_per_view[v])
            if arrays is None:
                arrays = {"theta": np.zeros((lens[v], 70), np.float32),
                          "joints2d": None, "orient": None, "trans": None}
            per_view.append(arrays["theta"])
            j2d_views.append(arrays["joints2d"])
            orient_views.append(arrays["orient"])
            trans_views.append(arrays["trans"])
        baseline_poses[kind] = resample_to_common_frames(
            per_view, F, args.start_phase).astype(np.float32)
        if kind in ("vs", "pare") and all(
                j is not None for j in j2d_views):
            # vs/pare 2D labels -> recon_error_2d-vs/-pare columns
            # (neural_motion_model.py:677-707, include_vs/include_pare)
            labels[kind] = resample_to_common_frames(
                j2d_views, F, args.start_phase).astype(np.float32)
        if kind == "glamr" and all(o is not None for o in orient_views) \
                and all(t is not None for t in trans_views):
            # GLAMR world baseline for eval_3d_global's glamr columns
            kwargs["glamr_orient"] = resample_to_common_frames(
                orient_views, F, args.start_phase).astype(np.float32)
            kwargs["glamr_trans"] = resample_to_common_frames(
                trans_views, F, args.start_phase).astype(np.float32)
    if baseline_poses:
        kwargs["baseline_poses"] = baseline_poses

    # raw-frames-per-resampled-frame, n_seq_frames / num_frames
    # (multi_view_sequence.py:300) — scales per-frame GT displacement to
    # raw-video-rate velocity in the dynamic-frame mask
    fm = np.asarray([l / max(F, 1) for l in lens], np.float32)
    bundle = MultiViewBundle(
        labels=labels,
        hmr_theta=theta_all[..., :69].astype(np.float32),
        hmr_mask=theta_all[..., 69:70].astype(np.float32),
        img_hw=img_hw,
        framerate_multiplier=fm,
        name=osp.splitext(osp.basename(args.nemo_cfg_path))[0],
        **kwargs)
    _report_parser()
    bundle.save(args.out)
    print(f"[preprocess] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
