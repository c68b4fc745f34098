"""Synthetic multi-view problem (port of nemo_tpu/data/synthetic.py).

A ground-truth SMPL motion observed by known cameras with per-view monotone
time warps. The motion, cameras and warps are the same numpy recipe as the
JAX package's; the 2D keypoints come from the port's ``smpl_forward``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..body import constants
from ..body.smpl import SMPLModel, smpl_forward
from ..geometry.camera import camera_from_params, project
from ..geometry.rotations import batch_rodrigues
from .bundle import MultiViewBundle


def smooth_motion(num_frames: int, seed: int = 0, amplitude: float = 0.35,
                  n_harmonics: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """(fullpose_aa (F, 24, 3), trans (F, 3)): low-frequency Fourier
    series per channel, translation anchored at 0 on frame 0."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0.0, 1.0, num_frames)[:, None]
    k = np.arange(1, n_harmonics + 1)[None, :]

    def series(channels, amp):
        a = rng.randn(channels, n_harmonics) * amp / k
        b = rng.randn(channels, n_harmonics) * amp / k
        base = rng.randn(channels) * amp * 0.5
        ang = 2 * np.pi * t * k
        return base[None] + np.sin(ang) @ a.T + (np.cos(ang) - 1.0) @ b.T

    pose = series(72, amplitude).reshape(num_frames, 24, 3)
    trans = series(3, 0.3)
    trans = trans - trans[:1]
    return pose.astype(np.float32), trans.astype(np.float32)


def make_cameras(num_views: int, depth: float = 10.0, seed: int = 0
                 ) -> np.ndarray:
    """Ring of cameras looking at the origin, as 9-param encodings (V, 9)."""
    rng = np.random.RandomState(seed + 100)
    params = np.zeros((num_views, 9), np.float32)
    for v in range(num_views):
        yaw = 2 * np.pi * v / num_views + 0.1 * rng.randn()
        Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)],
                       [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]], np.float32)
        params[v, :3] = [0.1 * rng.randn(), 0.1 * rng.randn(),
                         depth + rng.randn()]
        params[v, 3:] = Ry[:, :2].reshape(6)
    return params


def monotone_warp(phases: np.ndarray, strength: float, seed: int
                  ) -> np.ndarray:
    """A random monotone [0, 1] -> [0, 1] warp."""
    rng = np.random.RandomState(seed)
    a = np.abs(rng.randn(4)) + 0.2
    centers = rng.uniform(0, 1, 4)
    widths = rng.uniform(0.1, 0.4, 4)
    grid = np.linspace(0, 1, 512)
    dens = np.zeros_like(grid)
    for ai, ci, wi in zip(a, centers, widths):
        dens += ai * np.exp(-((grid - ci) / wi) ** 2)
    dens = 1.0 + strength * (dens / dens.mean() - 1.0)
    cdf = np.cumsum(dens)
    cdf = (cdf - cdf[0]) / (cdf[-1] - cdf[0])
    return np.interp(phases, grid, cdf).astype(np.float32)


@torch.no_grad()
def synthetic_problem(model: SMPLModel, num_views: int = 4,
                      num_frames: int = 60,
                      img_hw: Tuple[int, int] = (1000, 1900),
                      noise_px: float = 0.0, warp_strength: float = 0.5,
                      conf_dropout: float = 0.0, seed: int = 0):
    """(bundle, truth): exact projections of the warped motion through each
    view's camera (+ optional pixel noise and confidence dropout)."""
    rng = np.random.RandomState(seed)
    pose, trans = smooth_motion(num_frames, seed=seed)
    cams9 = make_cameras(num_views, seed=seed)
    betas = np.zeros((1, 10), np.float32)
    base_phase = np.linspace(0, 1, num_frames)
    proj_idx = np.asarray(constants.PROJ_JOINT_IDX_V0)

    warps = [monotone_warp(base_phase, warp_strength, seed * 31 + v)
             for v in range(num_views)]
    tidx = np.minimum((np.stack(warps) * num_frames).astype(np.int64),
                      num_frames - 1)
    pose_vf = pose[tidx]
    trans_vf = trans[tidx]

    dev = model.device
    VF = num_views * num_frames
    rot = batch_rodrigues(torch.as_tensor(pose_vf, device=dev).reshape(
        VF, 24, 3))
    _, joints49 = smpl_forward(model, torch.as_tensor(betas, device=dev),
                               rot[:, 1:], rot[:, :1], want_vertices=False)
    j = joints49[:, torch.as_tensor(proj_idx, device=dev)] + torch.as_tensor(
        trans_vf, device=dev).reshape(VF, 1, 3)
    cam = camera_from_params(torch.as_tensor(cams9, device=dev), img_hw[0],
                             img_hw[1])
    cam_b = type(cam)(*(x.repeat_interleave(num_frames, dim=0) for x in cam))
    pts2d = project(j, cam_b).reshape(num_views, num_frames, 25, 2)
    pts2d = pts2d.cpu().numpy()

    if noise_px > 0:
        pts2d = pts2d + noise_px * rng.randn(*pts2d.shape).astype(np.float32)
    conf = np.ones((num_views, num_frames, 25, 1), np.float32)
    if conf_dropout > 0:
        conf *= (rng.rand(*conf.shape) > conf_dropout)
    labels = np.concatenate([pts2d, conf], -1).astype(np.float32)
    hmr_theta = pose_vf[:, :, 1:].reshape(num_views, num_frames, 69)

    def at_warp(arr, w):
        return arr[np.minimum((w * num_frames).astype(np.int64),
                              num_frames - 1)]

    bundle = MultiViewBundle(
        labels={"gt": labels, "op": labels.copy()},
        hmr_theta=hmr_theta,
        hmr_mask=np.ones((num_views, num_frames, 1), np.float32),
        img_hw=np.asarray(img_hw, np.float32),
        gt3d_pose=np.stack([at_warp(pose, w).reshape(num_frames, 72)
                            for w in warps]),
        gt3d_trans=np.stack([at_warp(trans, w) for w in warps]),
        gt_cameras=cams9,
        gt_betas=betas,
        name=f"synthetic_v{num_views}_f{num_frames}_s{seed}",
    )
    truth = {"pose": pose, "trans": trans, "cams9": cams9,
             "warps": np.stack(warps), "betas": betas}
    return bundle, truth
