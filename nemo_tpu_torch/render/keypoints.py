"""Host-side matplotlib figures: keypoint overlays, phase warps, curves.

Port of nemo_tpu/render/keypoints.py. matplotlib is imported when a
figure is drawn, never at import time: a machine without it can import
this module and render meshes. The per-joint keypoint frames need no
matplotlib: they are written by the standard-library PNG writer.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

# BODY_25 skeleton edges (OpenPose convention)
OP25_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (1, 8),
    (8, 9), (9, 10), (10, 11), (8, 12), (12, 13), (13, 14), (0, 15),
    (15, 17), (0, 16), (16, 18), (14, 21), (14, 19), (19, 20), (11, 24),
    (11, 22), (22, 23),
]


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def draw_skeleton(ax, pts25: np.ndarray, color: str = "C0",
                  conf: Optional[np.ndarray] = None) -> None:
    ok = np.ones(len(pts25), bool) if conf is None else (conf[..., 0] > 0.5)
    for a, b in OP25_EDGES:
        if ok[a] and ok[b]:
            ax.plot([pts25[a, 0], pts25[b, 0]], [pts25[a, 1], pts25[b, 1]],
                    c=color, lw=1)
    ax.scatter(pts25[ok, 0], pts25[ok, 1], c=color, s=4)


def render_keypoint_rollout(path: str, pts2d_pred: np.ndarray, bundle,
                            num_frames: int = 5, num_views: int = 3) -> None:
    """Grid of [GT, OP, pred] skeletons of view 0 over sampled frames."""
    plt = _plt()
    Fidx = np.linspace(0, bundle.num_frames - 1, num_frames).astype(int)
    gt = bundle.labels.get("gt")
    op = bundle.labels.get("op")
    fig, axs = plt.subplots(3, num_frames, figsize=(3 * num_frames, 9))
    v = 0
    for col, f in enumerate(Fidx):
        rows = [("gt", gt), ("op", op), ("pred", None)]
        for row, (name, data) in enumerate(rows):
            ax = axs[row, col] if num_frames > 1 else axs[row]
            ax.set_xticks([]), ax.set_yticks([])
            ax.invert_yaxis()
            if name == "pred":
                draw_skeleton(ax, pts2d_pred[v, f], "C2")
            elif data is not None:
                draw_skeleton(ax, data[v, f, :, :2], "C0", data[v, f, :, 2:])
            if col == 0:
                ax.set_ylabel(name)
    fig.savefig(path, bbox_inches="tight", dpi=80)
    plt.close(fig)


def render_eval_grid(path: str, pts2d_pred: np.ndarray, bundle,
                     label_type: str = "gt", num_frames: int = 6,
                     max_views: int = 4) -> None:
    """views x frames grid of predicted against labelled skeletons over the
    video frames (a blank canvas of the bundle's size without frames)."""
    plt = _plt()
    V = min(bundle.num_views, max_views)
    Fidx = np.linspace(0, bundle.num_frames - 1, num_frames).astype(int)
    try:
        label = bundle.label(label_type)
    except KeyError:
        label = next(iter(bundle.labels.values()))
    H, W = int(bundle.img_hw[0]), int(bundle.img_hw[1])
    fig, axs = plt.subplots(V, num_frames, figsize=(2.2 * num_frames, 2.2 * V),
                            squeeze=False)
    for v in range(V):
        for col, f in enumerate(Fidx):
            ax = axs[v, col]
            ax.set_xticks([]), ax.set_yticks([])
            img = None
            if bundle.frame_paths is not None:
                try:
                    img = plt.imread(str(bundle.frame_paths[v, f]))
                except Exception:
                    img = None
            ax.imshow(img if img is not None
                      else np.ones((H, W, 3), np.float32))
            draw_skeleton(ax, label[v, f, :, :2], "C0", label[v, f, :, 2:])
            draw_skeleton(ax, pts2d_pred[v, f], "C2")
            ax.set_xlim(0, W), ax.set_ylim(H, 0)
            if col == 0:
                ax.set_ylabel(f"view {v}")
    fig.savefig(path, bbox_inches="tight", dpi=80)
    plt.close(fig)


@torch.no_grad()
def render_phase_plot(path: str, phase, num_views: int) -> None:
    """The learned monotonic warps over [0, 1], one curve a view; phase is
    the fitter's MonotonicNets."""
    from ..modules.networks import apply_monotonic_single
    plt = _plt()
    x = torch.linspace(0, 1, 100)[:, None]
    shifts, scales = phase.shifts.detach().cpu(), phase.scales.detach().cpu()
    fig = plt.figure()
    for v in range(num_views):
        y = apply_monotonic_single(shifts[v], scales[v], x)
        plt.plot(x[:, 0].numpy(), y[:, 0].numpy(), label=str(v))
    plt.legend(), plt.xlim(0, 1), plt.ylim(0, 1)
    plt.xlabel("raw phase"), plt.ylabel("warped phase")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


# matplotlib's default colour cycle, C0-C9 ('tab10'), as RGB in [0, 1]
TAB10 = np.array([[0x1f, 0x77, 0xb4], [0xff, 0x7f, 0x0e], [0x2c, 0xa0, 0x2c],
                  [0xd6, 0x27, 0x28], [0x94, 0x67, 0xbd], [0x8c, 0x56, 0x4b],
                  [0xe3, 0x77, 0xc2], [0x7f, 0x7f, 0x7f], [0xbc, 0xbd, 0x22],
                  [0x17, 0xbe, 0xcf]], np.float32) / 255.0


def render_per_joint_keypoint_frames(cache_dir: str, pts2d: np.ndarray,
                                     bundle, num_frames: int = 4,
                                     num_views: int = -1,
                                     conf_threshold: float = 0.5) -> int:
    """Per-joint keypoint inspection frames: for each sampled (view,
    frame) and each joint with confidence above conf_threshold, the frame
    (white without frame paths) with one square dot of colour C{joint %
    10} at the joint, written as ``{ridx:03d}_{cidx:03d}_{joint}.png``
    into cache_dir by the standard-library PNG writer (no matplotlib).
    pts2d: (V, F, 25, 3) keypoints and confidence. Returns the number of
    images written."""
    from ..body.constants import JOINT_NAMES
    from ..eval.metrics import eval_frame_indices
    from .figures import _bundle_frame
    from .video import _write_png
    V, F = pts2d.shape[:2]
    nrow = V if num_views < 0 else min(V, num_views)
    H, W = int(bundle.img_d0), int(bundle.img_d1)
    r = max(2, min(H, W) // 60)
    os.makedirs(cache_dir, exist_ok=True)
    n = 0
    for ridx in range(nrow):
        for cidx, f in enumerate(eval_frame_indices(F, num_frames)):
            im = _bundle_frame(bundle, ridx, int(f))
            if im is None:
                im = np.ones((H, W, 3), np.float32)
            for j in range(pts2d.shape[2]):
                kp = pts2d[ridx, int(f), j]
                if kp[-1] <= conf_threshold:
                    continue
                out = np.asarray(im, np.float32).copy()
                y0, x0 = int(round(kp[1])), int(round(kp[0]))
                out[max(y0 - r, 0):min(y0 + r + 1, H),
                    max(x0 - r, 0):min(x0 + r + 1, W)] = TAB10[j % 10]
                name = JOINT_NAMES[j] if j < len(JOINT_NAMES) else str(j)
                _write_png(os.path.join(
                    cache_dir, f"{ridx:03d}_{cidx:03d}_{name}.png"), out)
                n += 1
    return n


def render_dynamic_velocity_plots(out_dir: str, gt_joints15: np.ndarray,
                                  framerate_multiplier=None,
                                  fps: float = 30.0) -> None:
    """Per-view GT joint-speed curves: v{v}_vel.png (the 15 joints) and
    v{v}_vel_stats.png (max, mean, right wrist), speeds scaled by
    fps * framerate_multiplier. gt_joints15: (V, F, 15, 3)."""
    from ..body.constants import JOINT_NAMES
    plt = _plt()
    V = gt_joints15.shape[0]
    fm = (np.ones(V) if framerate_multiplier is None
          else np.asarray(framerate_multiplier, np.float64).reshape(-1))
    os.makedirs(out_dir, exist_ok=True)
    for v in range(V):
        diff = gt_joints15[v, 1:] - gt_joints15[v, :-1]
        vel = np.sqrt((diff ** 2).sum(-1)) * (fps * fm[v])
        x = np.arange(vel.shape[0])
        fig = plt.figure()
        for j in range(15):
            plt.plot(x, vel[:, j], label=JOINT_NAMES[j])
        plt.xlabel("Frame"), plt.ylabel("Vel"), plt.legend()
        fig.savefig(os.path.join(out_dir, f"v{v}_vel.png"))
        plt.close(fig)
        fig = plt.figure()
        rwrist = JOINT_NAMES.index("OP RWrist")
        for y, label in ((vel.max(1), "max"), (vel.mean(1), "mean"),
                         (vel[:, rwrist], "rwrist")):
            plt.plot(x, y, label=label)
        plt.xlabel("Frame"), plt.ylabel("Vel"), plt.legend()
        fig.savefig(os.path.join(out_dir, f"v{v}_vel_stats.png"))
        plt.close(fig)


def render_vibe_debug_panel(path: str, pred_kp2d: np.ndarray,
                            gt_kp2d: np.ndarray, max_frames: int = 8,
                            crop_size: int = 224) -> None:
    """Pred-vs-GT skeleton panel for VIBE training's debug mode
    (VIBE/lib/utils/vis.py:324 batch_visualize_vid_preds): feature-based
    training has no frames, so each of the first max_frames panels plots
    both OP25 skeletons in crop coordinates (kp * size/2 + size/2,
    vis.py:381). pred_kp2d: (T, 49, 2) normalized SPIN keypoints; gt_kp2d:
    (T, 49, 3) with confidence."""
    plt = _plt()
    T = min(max_frames, pred_kp2d.shape[0])

    def unnorm(kp):
        return kp * (crop_size / 2.0) + crop_size / 2.0

    fig, axes = plt.subplots(1, T, figsize=(2.2 * T, 2.6), squeeze=False)
    for t in range(T):
        ax = axes[0, t]
        gt = gt_kp2d[t]
        draw_skeleton(ax, unnorm(gt[:25, :2]), color="C2",
                      conf=gt[:25, 2:3])
        draw_skeleton(ax, unnorm(pred_kp2d[t, :25, :2]), color="C3")
        ax.set_xlim(0, crop_size), ax.set_ylim(crop_size, 0)
        ax.set_xticks([]), ax.set_yticks([])
        ax.set_title(f"t={t}", fontsize=8)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=80)
    plt.close(fig)


def render_loss_curves(out_dir: str, losses: dict) -> None:
    """One PNG per loss channel, out_dir/{name}.png."""
    plt = _plt()
    for name, values in losses.items():
        fig = plt.figure()
        plt.plot(np.arange(len(values)), np.asarray(values))
        plt.xlabel("step"), plt.ylabel(name)
        fig.savefig(os.path.join(out_dir, f"{name}.png"), bbox_inches="tight")
        plt.close(fig)
