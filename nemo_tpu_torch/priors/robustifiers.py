"""Robust error functions: the Geman-McClure robustifier and SMPLify's
angle prior (port of nemo_tpu/priors/robustifiers.py)."""

from __future__ import annotations

import torch

from .. import device_index


def gmof(residual: torch.Tensor, rho: float = 100.0,
         sqrt: bool = False) -> torch.Tensor:
    """rho^2 r^2 / (r^2 + rho^2). With sqrt=True, r^2 is first replaced by
    the per-point Euclidean norm over the last axis (trailing dim 1); the
    1e-12 shift keeps its gradient finite at zero residual."""
    sq = residual ** 2
    if sqrt:
        sq = torch.sqrt(sq.sum(dim=-1, keepdim=True) + 1e-12)
    return rho ** 2 * sq / (sq + rho ** 2)


_ANGLE_IDX = (55 - 3, 58 - 3, 12 - 3, 15 - 3)


def angle_prior(pose: torch.Tensor) -> torch.Tensor:
    """Unnatural knee/elbow bending penalty (hmr/smplify/losses.py:19-24):
    exp(sign * pose[:, idx])^2, sign (1, -1, -1, -1), for pose (B, 69)
    without the global rotation. Returns (B, 4)."""
    v = pose[:, device_index(_ANGLE_IDX, pose.device)]
    return torch.exp(torch.cat([v[:, :1], -v[:, 1:]], dim=1)) ** 2
