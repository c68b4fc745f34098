"""float64 numpy Procrustes / rigid alignment for the eval path.

Numpy twins of nemo_tpu/geometry/procrustes.py's host-side functions
(``similarity_transform_np``, ``rigid_transform_np``,
``reconstruction_error_np``): the eval CSVs are computed in host float64 in
both packages, exactly as the reference's pose_utils does.
"""

from __future__ import annotations

import numpy as np


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
