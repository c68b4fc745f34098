"""Temporal smoothing for tracker boxes and VIBE outputs (port of
nemo_tpu/data/smoothing.py; host numpy and scipy, the same code).

Behavioral reference: VIBE/lib/utils/smooth_bbox.py (median + gaussian
filtering of [cx, cy, scale] params, :108-121) and
VIBE/lib/utils/smooth_pose.py + one_euro_filter.py (One-Euro filtering of
the predicted pose sequence, demo2.py:252-258). The reference smooths on the
host with scipy/numpy; these outputs feed preprocessing, not the jit path,
so host numpy is the right tool here too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def smooth_bbox_params(bbox_params: np.ndarray, kernel_size: int = 11,
                       sigma: float = 8.0) -> np.ndarray:
    """Median then gaussian filtering of (N, 3) [cx, cy, size] tracks
    (smooth_bbox.py:108-121)."""
    from scipy.ndimage import gaussian_filter1d
    from scipy.signal import medfilt

    n = bbox_params.shape[0]
    k = min(kernel_size, n if n % 2 == 1 else n - 1)
    if k < 3:
        return bbox_params.astype(np.float32)
    med = np.stack([medfilt(c, k) for c in bbox_params.T], axis=1)
    return np.stack([gaussian_filter1d(c, sigma) for c in med.T],
                    axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# One-Euro filter (standard formulation; one_euro_filter.py semantics)
# ---------------------------------------------------------------------------

def _alpha(cutoff: np.ndarray, dt: np.ndarray) -> np.ndarray:
    tau = 1.0 / (2.0 * np.pi * cutoff)
    return 1.0 / (1.0 + tau / dt)


class OneEuroFilter:
    """Vectorized One-Euro filter over arrays of any shape.

    min_cutoff trades slow-speed jitter; beta trades speed lag — the same
    two knobs the VIBE demo exposes (demo2.py:253-256, defaults 0.004/0.7
    via smooth_pose.py:24).
    """

    def __init__(self, t0: np.ndarray, x0: np.ndarray,
                 min_cutoff: float = 0.004, beta: float = 0.7,
                 d_cutoff: float = 1.0):
        self.min_cutoff = float(min_cutoff)
        self.beta = float(beta)
        self.d_cutoff = float(d_cutoff)
        self.t_prev = np.asarray(t0, np.float64)
        self.x_prev = np.asarray(x0, np.float64)
        self.dx_prev = np.zeros_like(self.x_prev)

    def __call__(self, t: np.ndarray, x: np.ndarray) -> np.ndarray:
        t = np.asarray(t, np.float64)
        x = np.asarray(x, np.float64)
        dt = np.maximum(t - self.t_prev, 1e-9)
        a_d = _alpha(np.full_like(x, self.d_cutoff), dt)
        dx = (x - self.x_prev) / dt
        dx_hat = a_d * dx + (1 - a_d) * self.dx_prev
        cutoff = self.min_cutoff + self.beta * np.abs(dx_hat)
        a = _alpha(cutoff, dt)
        x_hat = a * x + (1 - a) * self.x_prev
        self.t_prev, self.x_prev, self.dx_prev = t, x_hat, dx_hat
        return x_hat


def smooth_pose_sequence(pose: np.ndarray, min_cutoff: float = 0.004,
                         beta: float = 0.7) -> np.ndarray:
    """One-Euro-filter a (F, ...) pose sequence (smooth_pose.py:24-60).

    The reference filters the per-frame SMPL pose (rotation) parameters and
    re-runs SMPL on the result; this returns the filtered parameters — run
    the body model downstream as needed.
    """
    pose = np.asarray(pose)
    out = np.zeros_like(pose)
    out[0] = pose[0]
    f = OneEuroFilter(np.zeros_like(pose[0], dtype=np.float64), pose[0],
                      min_cutoff=min_cutoff, beta=beta)
    for i in range(1, pose.shape[0]):
        out[i] = f(np.full(pose[0].shape, i, np.float64), pose[i])
    return out.astype(pose.dtype)
