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


def eval_frame_indices(F: int, num_frames: int = -1) -> np.ndarray:
    """The reference's eval frame sampling: ncol = min(F, num_frames) when
    num_frames > 0 else F; frame = round(cidx / ncol * F)."""
    ncol = F if num_frames <= 0 else min(F, num_frames)
    return np.minimum(np.round(np.arange(ncol) / ncol * F).astype(np.int64),
                      F - 1)


def eval_view_indices(V: int, num_views: int = -1,
                      view_idxs=()) -> np.ndarray:
    """View selection: explicit view_idxs, else the first min(V, num_views)
    (all V when num_views <= 0)."""
    if len(view_idxs):
        return np.asarray(view_idxs, np.int64)
    return np.arange(V if num_views <= 0 else min(V, num_views))


def eval_3d(model: SMPLModel, pred_pose: np.ndarray, gt_pose: np.ndarray,
            baselines: Optional[Dict[str, np.ndarray]] = None,
            baseline_masks: Optional[Dict[str, np.ndarray]] = None,
            dynamic_only: bool = False,
            framerate_multiplier: Optional[np.ndarray] = None,
            pa: bool = True, num_frames: int = -1, num_views: int = -1,
            view_idxs=()) -> Dict[str, list]:
    """Per-view MPJPE / MPVPE table (reference eval_3d), with PA-MPJPE
    columns when pa.

    pred_pose (V, F, 69) and baselines {name: (V, F, 69)} body poses; gt_pose
    (V, F, 72), its joints from gt_pose[..., 3:] with identity global
    orient. dynamic_only restricts the frames to the GT high-velocity span
    (the mask is computed over all frames, then applied to the sampled
    ones). num_frames / num_views / view_idxs: the reference's subsampling
    (frame = round(cidx / ncol * F)). baseline_masks is accepted and
    unused, as in the JAX package.
    """
    V, F = pred_pose.shape[:2]
    baselines = baselines or {}
    views = eval_view_indices(V, num_views, view_idxs)
    fidx = eval_frame_indices(F, num_frames)

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
        for v in views:
            sel = fidx[masks[v][fidx] > 0]
            mpvpe = 1000 * reconstruction_error_np(v_gt[v][sel],
                                                   v_cmp[v][sel], pa=False)
            mpjpe = 1000 * reconstruction_error_np(j_gt[v][sel],
                                                   j_cmp[v][sel], pa=False)
            stats.setdefault(f"mpjpe-{name}", []).append(float(mpjpe))
            stats.setdefault(f"mpvpe-{name}", []).append(float(mpvpe))
            if pa:
                pj = 1000 * reconstruction_error_np(j_gt[v][sel],
                                                    j_cmp[v][sel], pa=True)
                stats.setdefault(f"pa_mpjpe-{name}", []).append(float(pj))

    add("ours", v_pred, j_pred)
    for k, (vb, jb) in base_grids.items():
        add(k, vb, jb)
    return stats


def eval_3d_pa(model: SMPLModel, pred_pose: np.ndarray, gt_pose: np.ndarray
               ) -> Dict[str, list]:
    """PA-MPJPE per view over all frames (the joints-only SMPL path)."""
    V, F = pred_pose.shape[:2]
    _, j_gt = smpl_grid_forward(model, gt_pose[..., 3:].reshape(V * F, 69),
                                want_vertices=False)
    _, j_pred = smpl_grid_forward(model, pred_pose.reshape(V * F, 69),
                                  want_vertices=False)
    j_gt = j_gt.reshape(V, F, 49, 3)[..., :15, :]
    j_pred = j_pred.reshape(V, F, 49, 3)[..., :15, :]
    return {"pa_mpjpe-ours": [
        float(1000 * reconstruction_error_np(j_gt[v], j_pred[v], pa=True))
        for v in range(V)]}


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
            gt_label: np.ndarray, bbox_diag: np.ndarray,
            num_frames: int = -1, num_views: int = -1,
            view_idxs=()) -> Dict[str, list]:
    """Per-view 2D table on the first 15 joints (reference eval_2d), with
    eval_3d's subsampling."""
    V, F = points2d_pred.shape[:2]
    views = eval_view_indices(V, num_views, view_idxs)
    fidx = eval_frame_indices(F, num_frames)
    stats: Dict[str, list] = {}

    def add(name, pts):
        for v in views:
            p = pts[v][fidx][:, :15, :2]
            g = gt_label[v][fidx][:, :15, :2]
            c = gt_label[v][fidx][:, :15, 2:]
            stats.setdefault(f"recon_error_2d-{name}", []).append(
                rmse_2d(p, g, c))
            stats.setdefault(f"pck-{name}", []).append(
                pck_2d(p, g, c, bbox_diag[v][fidx]))

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
                   gt_pose: np.ndarray, gt_trans: np.ndarray,
                   glamr_pose: Optional[np.ndarray] = None,
                   glamr_trans: Optional[np.ndarray] = None,
                   pred_trans: Optional[np.ndarray] = None,
                   want_aligned: bool = False, num_frames: int = -1,
                   num_views: int = -1, view_idxs=()):
    """Global-frame MPJPE / MPVPE after a per-view all-frames rigid
    (Kabsch, no scale) alignment of the vertices to GT (reference
    eval_3d_global + rigid_transform_to_gt).

    pred_j (V, F, >=15, 3) and pred_v (V, F, V_mesh, 3) are world-frame
    predictions; gt_pose (V, F, 72) with the orient in [:3], gt_trans
    (V, F, 3). glamr_pose / glamr_trans, the GLAMR world baseline in the
    same layout, add its mpjpe-glamr / mpvpe-glamr columns, aligned the same
    way. num_frames / num_views / view_idxs subsample as eval_3d does.

    want_aligned=True also returns the selected views' aligned root
    translations: {'gt-t', 'pred-t' (with pred_trans), 'glamr-t' (with the
    GLAMR baseline)}, for the overlay.png plot.
    """
    V, F = gt_pose.shape[:2]
    views = eval_view_indices(V, num_views, view_idxs)
    fidx = eval_frame_indices(F, num_frames)

    def sub(a):
        return None if a is None else np.asarray(a)[:, fidx]

    gt_trans = sub(gt_trans)
    v_gt, j_gt = world_grid_forward(model, sub(gt_pose), gt_trans)
    stats: Dict[str, list] = {"mpjpe-ours": [], "mpvpe-ours": []}
    aligned = {"gt-t": gt_trans[views]}
    comparisons = [("ours", sub(pred_v), sub(pred_j)[..., :15, :],
                    sub(pred_trans))]
    if glamr_pose is not None and glamr_trans is not None:
        v_gl, j_gl = world_grid_forward(model, sub(glamr_pose),
                                        sub(glamr_trans))
        comparisons.append(("glamr", v_gl, j_gl, sub(glamr_trans)))
        stats["mpjpe-glamr"] = []
        stats["mpvpe-glamr"] = []

    for name, v_cmp, j_cmp, t_cmp in comparisons:
        t_out = []
        for v in views:
            R, t = rigid_transform_np(v_cmp[v].reshape(-1, 3),
                                      v_gt[v].reshape(-1, 3))
            align = lambda X: X.reshape(-1, 3) @ R.T + t
            vv = align(v_cmp[v]).reshape(v_gt[v].shape)
            vj = align(j_cmp[v]).reshape(j_gt[v].shape)
            stats[f"mpjpe-{name}"].append(float(
                1000 * reconstruction_error_np(j_gt[v], vj, pa=False)))
            stats[f"mpvpe-{name}"].append(float(
                1000 * reconstruction_error_np(v_gt[v], vv, pa=False)))
            if t_cmp is not None:
                t_out.append(align(t_cmp[v]))
        if t_cmp is not None:
            aligned["pred-t" if name == "ours" else f"{name}-t"] = \
                np.stack(t_out)
    if want_aligned:
        return stats, aligned
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
