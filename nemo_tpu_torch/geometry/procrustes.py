"""Procrustes / rigid alignment and reconstruction error.

Port of nemo_tpu/geometry/procrustes.py: batched torch versions on the
tensors' device (``similarity_transform``, ``rigid_transform``,
``apply_rigid_transform``, ``reconstruction_error``; one batched SVD), and
the float64 numpy versions the eval CSVs use in both packages, exactly as
the reference's pose_utils does (f32 SVD is good to about 1e-2 where a
point set is nearly degenerate).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _reflection_fix(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """diag(1, 1, sign(det(V U^T))): R = V D U^T has det +1."""
    D = torch.eye(3, dtype=U.dtype, device=U.device).expand(
        U.shape).clone()
    D[..., 2, 2] = torch.sign(torch.linalg.det(V @ U.transpose(-1, -2)))
    return D


def similarity_transform(S1: torch.Tensor, S2: torch.Tensor
                         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                        torch.Tensor,
                                                        torch.Tensor]]:
    """Orthogonal Procrustes with scale: (s, R, t) mapping (..., N, 3)
    points S1 onto S2. Returns (S1_hat, (scale, R, t)), S1_hat = s S1 R^T
    + t."""
    X1, X2 = S1.transpose(-1, -2), S2.transpose(-1, -2)
    mu1 = X1.mean(dim=-1, keepdim=True)
    mu2 = X2.mean(dim=-1, keepdim=True)
    X1c, X2c = X1 - mu1, X2 - mu2
    var1 = torch.sum(X1c ** 2, dim=(-1, -2))
    K = X1c @ X2c.transpose(-1, -2)
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(-1, -2)
    R = V @ _reflection_fix(U, V) @ U.transpose(-1, -2)
    scale = (R @ K).diagonal(dim1=-2, dim2=-1).sum(-1) / var1
    t = mu2 - scale[..., None, None] * (R @ mu1)
    S1_hat = scale[..., None, None] * (R @ X1) + t
    return S1_hat.transpose(-1, -2), (scale, R, t[..., 0])


def rigid_transform(A: torch.Tensor, B: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kabsch: the rigid (R, t), no scale, with B ~= A R^T + t; (..., N, 3)
    inputs."""
    Am = A - A.mean(dim=-2, keepdim=True)
    Bm = B - B.mean(dim=-2, keepdim=True)
    U, _, Vh = torch.linalg.svd(Am.transpose(-1, -2) @ Bm)
    V = Vh.transpose(-1, -2)
    R = V @ _reflection_fix(U, V) @ U.transpose(-1, -2)
    t = B.mean(dim=-2) - torch.einsum('...ij,...j->...i', R, A.mean(dim=-2))
    return R, t


def apply_rigid_transform(points: torch.Tensor, R: torch.Tensor,
                          t: torch.Tensor) -> torch.Tensor:
    """(R, t) applied to (..., N, 3) points."""
    return torch.einsum('...ij,...nj->...ni', R, points) + t[..., None, :]


def reconstruction_error(S1: torch.Tensor, S2: torch.Tensor, pa: bool = True,
                         reduction: str = 'mean') -> torch.Tensor:
    """Mean per-point Euclidean error of (..., N, 3) sets, Procrustes-
    aligned with pa; reduction 'mean' or 'sum' over the batch, else per
    sample."""
    S1_hat = similarity_transform(S1, S2)[0] if pa else S1
    re = torch.sqrt(torch.sum((S1_hat - S2) ** 2, dim=-1)).mean(dim=-1)
    if reduction == 'mean':
        return re.mean()
    if reduction == 'sum':
        return re.sum()
    return re


def similarity_transform_np(S1: np.ndarray, S2: np.ndarray):
    """Batched orthogonal Procrustes (s, R, t) mapping S1 -> S2, (..., N, 3)
    points; returns (S1_hat, (scale, R, t))."""
    S1 = np.asarray(S1, dtype=np.float64)
    S2 = np.asarray(S2, dtype=np.float64)
    X1 = np.swapaxes(S1, -1, -2)
    X2 = np.swapaxes(S2, -1, -2)
    mu1 = X1.mean(axis=-1, keepdims=True)
    mu2 = X2.mean(axis=-1, keepdims=True)
    X1c, X2c = X1 - mu1, X2 - mu2
    var1 = np.sum(X1c ** 2, axis=(-1, -2))
    K = X1c @ np.swapaxes(X2c, -1, -2)
    U, _s, Vh = np.linalg.svd(K)
    V = np.swapaxes(Vh, -1, -2)
    det = np.linalg.det(U @ np.swapaxes(V, -1, -2))
    Z = np.broadcast_to(np.eye(3), K.shape).copy()
    Z[..., 2, 2] = np.sign(det)
    R = V @ Z @ np.swapaxes(U, -1, -2)
    scale = np.trace(R @ K, axis1=-2, axis2=-1) / var1
    t = mu2 - scale[..., None, None] * (R @ mu1)
    S1_hat = scale[..., None, None] * (R @ X1) + t
    return np.swapaxes(S1_hat, -1, -2), (scale, R, np.squeeze(t, axis=-1))


def rigid_transform_np(A: np.ndarray, B: np.ndarray):
    """Kabsch rigid (R, t), no scale, with B ~= A @ R.T + t; (N, 3) inputs."""
    A = np.asarray(A, dtype=np.float64).T
    B = np.asarray(B, dtype=np.float64).T
    cA = A.mean(axis=1, keepdims=True)
    cB = B.mean(axis=1, keepdims=True)
    H = (A - cA) @ (B - cB).T
    U, _s, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        Vt = Vt.copy()
        Vt[2, :] *= -1
        R = Vt.T @ U.T
    t = (-R @ cA + cB)[:, 0]
    return R, t


def reconstruction_error_np(S1: np.ndarray, S2: np.ndarray, pa: bool = True,
                            reduction: str = 'mean') -> np.ndarray:
    """Mean per-point Euclidean error, optionally Procrustes-aligned."""
    S1 = np.asarray(S1, dtype=np.float64)
    S2 = np.asarray(S2, dtype=np.float64)
    S1_hat = similarity_transform_np(S1, S2)[0] if pa else S1
    re = np.sqrt(((S1_hat - S2) ** 2).sum(axis=-1)).mean(axis=-1)
    if reduction == 'mean':
        return re.mean()
    if reduction == 'sum':
        return re.sum()
    return re
