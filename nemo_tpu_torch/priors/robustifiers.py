"""Geman-McClure robustifier (port of nemo_tpu/priors/robustifiers.py)."""

from __future__ import annotations

import torch


def gmof(residual: torch.Tensor, rho: float = 100.0,
         sqrt: bool = False) -> torch.Tensor:
    """rho^2 r^2 / (r^2 + rho^2). With sqrt=True, r^2 is first replaced by
    the per-point Euclidean norm over the last axis (trailing dim 1); the
    1e-12 shift keeps its gradient finite at zero residual."""
    sq = residual ** 2
    if sqrt:
        sq = torch.sqrt(sq.sum(dim=-1, keepdim=True) + 1e-12)
    return rho ** 2 * sq / (sq + rho ** 2)
