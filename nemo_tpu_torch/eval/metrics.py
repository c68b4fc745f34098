"""Evaluation metrics: MPJPE / MPVPE / PA-MPJPE / PCK / 2D RMSE.

Port of nemo_tpu/eval/metrics.py: the SMPL grids run through the port's
``smpl_forward`` (batched over the whole (view, frame) grid), the final
reductions are float64 numpy on the host, and the CSV columns are exactly
the JAX package's (and the reference's).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..body.smpl import SMPLModel, smpl_forward
from ..geometry.procrustes import reconstruction_error_np, rigid_transform_np


@torch.no_grad()
def smpl_grid_forward(model: SMPLModel, body_pose_aa: np.ndarray,
                      want_vertices: bool = True, chunk: int = 512
                      ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """SMPL over (N, 69) axis-angle body poses with identity global orient
    and zero betas: (vertices (N, V, 3) or None, joints49 (N, 49, 3))."""
    dev = model.device
    betas = torch.zeros((1, 10), device=dev)
    verts_out, joints_out = [], []
    for i in range(0, body_pose_aa.shape[0], chunk):
        p = torch.as_tensor(np.asarray(body_pose_aa[i:i + chunk], np.float32),
                            device=dev).reshape(-1, 69)
        v, j = smpl_forward(model, betas, p, torch.zeros((p.shape[0], 3),
                                                         device=dev),
                            pose2rot=True, want_vertices=want_vertices)
        joints_out.append(j.cpu().numpy())
        if want_vertices:
            verts_out.append(v.cpu().numpy())
    joints = np.concatenate(joints_out)
    return (np.concatenate(verts_out) if want_vertices else None), joints


def dynamic_frame_mask(gt_joints15: np.ndarray,
                       framerate_multiplier: float = 1.0, fps: float = 30.0,
                       vel_threshold: float = 2.0) -> np.ndarray:
    """Contiguous span from the first to the last frame whose max GT joint
    speed reaches vel_threshold m/s (reference :1082-1116)."""
    F = gt_joints15.shape[0]
    diff = gt_joints15[1:] - gt_joints15[:-1]
    vel = np.sqrt((diff ** 2).sum(-1)) * (fps * framerate_multiplier)
    mask = np.zeros(F)
    inds = np.where(vel.max(1) >= vel_threshold)[0]
    if len(inds):
        mask[inds.min():inds.max()] = 1
    return mask


def eval_3d(model: SMPLModel, pred_pose: np.ndarray, gt_pose: np.ndarray,
            baselines: Optional[Dict[str, np.ndarray]] = None,
            dynamic_only: bool = False,
            framerate_multiplier: Optional[np.ndarray] = None
            ) -> Dict[str, list]:
    """Per-view MPJPE / MPVPE / PA-MPJPE table over all frames (reference
    eval_3d)."""
    V, F = pred_pose.shape[:2]
    baselines = baselines or {}

    def grid(poses69):
        v, j = smpl_grid_forward(model, poses69.reshape(V * F, 69))
        return v.reshape(V, F, -1, 3), j.reshape(V, F, 49, 3)[..., :15, :]

    v_gt, j_gt = grid(gt_pose[..., 3:])
    v_pred, j_pred = grid(pred_pose)
    base_grids = {k: grid(p) for k, p in baselines.items()}
    if dynamic_only:
        fr = (framerate_multiplier if framerate_multiplier is not None
              else np.ones(V))
        masks = np.stack([dynamic_frame_mask(j_gt[v], fr[v])
                          for v in range(V)])
    else:
        masks = np.ones((V, F))

    stats: Dict[str, list] = {}

    def add(name, v_cmp, j_cmp):
        for v in range(V):
            sel = masks[v] > 0
            mpvpe = 1000 * reconstruction_error_np(v_gt[v][sel],
                                                   v_cmp[v][sel], pa=False)
            mpjpe = 1000 * reconstruction_error_np(j_gt[v][sel],
                                                   j_cmp[v][sel], pa=False)
            stats.setdefault(f"mpjpe-{name}", []).append(float(mpjpe))
            stats.setdefault(f"mpvpe-{name}", []).append(float(mpvpe))
            pj = 1000 * reconstruction_error_np(j_gt[v][sel], j_cmp[v][sel],
                                                pa=True)
            stats.setdefault(f"pa_mpjpe-{name}", []).append(float(pj))

    add("ours", v_pred, j_pred)
    for k, (vb, jb) in base_grids.items():
        add(k, vb, jb)
    return stats


def rmse_2d(pred: np.ndarray, gt: np.ndarray, conf: np.ndarray) -> float:
    """eval_2d's gated rmse, mean over ALL entries (reference :631-636)."""
    gate = (conf > 0.5).astype(np.float64)
    rmse = gate * np.sqrt(1e-6 + ((pred - gt) ** 2).sum(-1, keepdims=True))
    return float(rmse.mean())


def pck_2d(pred: np.ndarray, gt: np.ndarray, conf: np.ndarray,
           bbox_diag: np.ndarray, thresh: float = 0.05) -> float:
    """PCK @ thresh x bbox diagonal, in percent."""
    gate = (conf > 0.5).astype(np.float64)
    rmse = np.sqrt(1e-6 + ((pred - gt) ** 2).sum(-1, keepdims=True))
    count = (gate * (rmse < thresh * bbox_diag[..., None, None])).sum()
    return float(100.0 * count / max(gate.sum(), 1))


def eval_2d(points2d_pred: np.ndarray, labels: Dict[str, np.ndarray],
            gt_label: np.ndarray, bbox_diag: np.ndarray) -> Dict[str, list]:
    """Per-view 2D table on the first 15 joints over all frames (reference
    eval_2d)."""
    V = points2d_pred.shape[0]
    stats: Dict[str, list] = {}

    def add(name, pts):
        for v in range(V):
            p = pts[v][:, :15, :2]
            g = gt_label[v][:, :15, :2]
            c = gt_label[v][:, :15, 2:]
            stats.setdefault(f"recon_error_2d-{name}", []).append(
                rmse_2d(p, g, c))
            stats.setdefault(f"pck-{name}", []).append(
                pck_2d(p, g, c, bbox_diag[v]))

    add("ours", points2d_pred)
    for k, pts in labels.items():
        add(k, pts)
    return stats


@torch.no_grad()
def world_grid_forward(model: SMPLModel, pose72: np.ndarray,
                       trans: np.ndarray, n_joints: int = 15
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """World-frame SMPL over a (V, F) grid of full poses + translations."""
    dev = model.device
    betas = torch.zeros((1, 10), device=dev)
    vs, js = [], []
    for v in range(pose72.shape[0]):
        p = torch.as_tensor(np.asarray(pose72[v], np.float32), device=dev)
        t = torch.as_tensor(np.asarray(trans[v], np.float32), device=dev)
        vv, jj = smpl_forward(model, betas, p[:, 3:], p[:, :3], pose2rot=True,
                              want_vertices=True, transl=t)
        vs.append(vv.cpu().numpy())
        js.append(jj.cpu().numpy()[:, :n_joints])
    return np.stack(vs), np.stack(js)


def eval_3d_global(model: SMPLModel, pred_j: np.ndarray, pred_v: np.ndarray,
                   gt_pose: np.ndarray, gt_trans: np.ndarray
                   ) -> Dict[str, list]:
    """Global-frame MPJPE / MPVPE after a per-view all-frames rigid
    (Kabsch) alignment of the predicted vertices to GT (reference
    eval_3d_global + rigid_transform_to_gt). The GLAMR baseline columns are
    still to port."""
    v_gt, j_gt = world_grid_forward(model, np.asarray(gt_pose),
                                    np.asarray(gt_trans))
    v_cmp = np.asarray(pred_v)
    j_cmp = np.asarray(pred_j)[..., :15, :]
    stats: Dict[str, list] = {"mpjpe-ours": [], "mpvpe-ours": []}
    for v in range(v_gt.shape[0]):
        R, t = rigid_transform_np(v_cmp[v].reshape(-1, 3),
                                  v_gt[v].reshape(-1, 3))
        vv = (v_cmp[v].reshape(-1, 3) @ R.T + t).reshape(v_gt[v].shape)
        vj = (j_cmp[v].reshape(-1, 3) @ R.T + t).reshape(j_gt[v].shape)
        stats["mpjpe-ours"].append(float(
            1000 * reconstruction_error_np(j_gt[v], vj, pa=False)))
        stats["mpvpe-ours"].append(float(
            1000 * reconstruction_error_np(v_gt[v], vv, pa=False)))
    return stats


def write_csv(stats: Dict[str, list], path: str) -> None:
    """pandas-compatible CSV (index column first, like df.to_csv)."""
    import csv
    import os
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cols = list(stats.keys())
    n = len(next(iter(stats.values()))) if stats else 0
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + cols)
        for i in range(n):
            w.writerow([i] + [stats[c][i] for c in cols])
