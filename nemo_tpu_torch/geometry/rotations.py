"""Rotation representation conversions on torch tensors.

Port of nemo_tpu/geometry/rotations.py. Every function is branchless and
keeps the JAX version's epsilon shifts, so the identity rotation maps to the
zero axis-angle vector with finite gradients. That matters from the first
step: MotionNet's rotation head starts at the identity 6D bias, so step 0 of
every fit sits exactly there, where a plain ``torch.norm`` or an unguarded
sqrt would give NaN gradients.

Every function works on the last axes only; leading batch axes broadcast.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = True,
               eps: float = _EPS) -> torch.Tensor:
    """Norm with a non-NaN gradient at zero (sqrt of eps-shifted sumsq)."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def _normalize(x: torch.Tensor, dim: int = -1,
               eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), like torch.nn.functional.normalize."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation (..., 6), read as a (3, 2) column pair -> (..., 3, 3)
    Gram-Schmidt frame [b1, b2, b1 x b2]."""
    x = x.reshape(x.shape[:-1] + (3, 2))
    a1 = x[..., 0]
    a2 = x[..., 1]
    b1 = _normalize(a1)
    b2 = _normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """First two columns, row-major: the inverse of rot6d_to_rotmat."""
    return R[..., :2].reshape(R.shape[:-2] + (6,))


def batch_rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3), Rodrigues form,
    with the reference's angle = ||aa + 1e-8|| (never 0)."""
    angle = _safe_norm(aa + 1e-8, eps=0.0)
    axis = aa / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry,
                     rz, zeros, -rx,
                     -ry, rx, zeros], dim=-1).reshape(aa.shape[:-1] + (3, 3))
    ident = torch.eye(3, dtype=aa.dtype, device=aa.device)
    # K @ K == a a^T - (a.a) I for K = skew(a); closed form as in the JAX
    # version, which keeps the rounding of the two sides alike.
    outer = axis[..., :, None] * axis[..., None, :]
    sq = torch.sum(axis * axis, dim=-1)[..., None, None]
    KK = outer - sq * ident
    return ident + sin * K + (1.0 - cos) * KK


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) quaternion -> rotation matrix."""
    q = quat / _safe_norm(quat, eps=1e-16)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    R = torch.stack([
        ww + xx - yy - zz, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, ww - xx + yy - zz, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, ww - xx - yy + zz,
    ], dim=-1)
    return R.reshape(quat.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rotation matrix -> (w, x, y, z) quaternion, branchless four-case
    selection with guarded denominators."""
    Rt = R.transpose(-1, -2)
    r00, r01, r02 = Rt[..., 0, 0], Rt[..., 0, 1], Rt[..., 0, 2]
    r10, r11, r12 = Rt[..., 1, 0], Rt[..., 1, 1], Rt[..., 1, 2]
    r20, r21, r22 = Rt[..., 2, 0], Rt[..., 2, 1], Rt[..., 2, 2]

    t0 = 1 + r00 - r11 - r22
    q0 = torch.stack([r12 - r21, t0, r01 + r10, r20 + r02], dim=-1)
    t1 = 1 - r00 + r11 - r22
    q1 = torch.stack([r20 - r02, r01 + r10, t1, r12 + r21], dim=-1)
    t2 = 1 - r00 - r11 + r22
    q2 = torch.stack([r01 - r10, r20 + r02, r12 + r21, t2], dim=-1)
    t3 = 1 + r00 + r11 + r22
    q3 = torch.stack([t3, r12 - r21, r20 - r02, r01 - r10], dim=-1)

    mask_d2 = (r22 < eps)[..., None]
    mask_d0_d1 = (r00 > r11)[..., None]
    mask_d0_nd1 = (r00 < -r11)[..., None]
    c0 = mask_d2 & mask_d0_d1
    c1 = mask_d2 & ~mask_d0_d1
    c2 = ~mask_d2 & mask_d0_nd1
    q = torch.where(c0, q0, torch.where(c1, q1, torch.where(c2, q2, q3)))
    t = torch.where(c0, t0[..., None], torch.where(
        c1, t1[..., None], torch.where(c2, t2[..., None], t3[..., None])))
    return q * (0.5 / torch.sqrt(torch.clamp(t, min=eps)))


def quat_to_aa(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion -> axis-angle with the double-where guard: the identity
    quaternion maps to 0 and the dead branch never feeds sqrt a 0."""
    q1, q2, q3 = quat[..., 1], quat[..., 2], quat[..., 3]
    sin_sq = q1 * q1 + q2 * q2 + q3 * q3
    safe = sin_sq > 0.0
    sin_sq_safe = torch.where(safe, sin_sq, torch.ones_like(sin_sq))
    sin_theta = torch.sqrt(sin_sq_safe)
    cos_theta = quat[..., 0]
    two_theta = 2.0 * torch.where(cos_theta < 0.0,
                                  torch.atan2(-sin_theta, -cos_theta),
                                  torch.atan2(sin_theta, cos_theta))
    k = torch.where(safe, two_theta / sin_theta,
                    torch.full_like(sin_theta, 2.0))
    return torch.stack([q1 * k, q2 * k, q3 * k], dim=-1)


def rotmat_to_aa(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle; identity maps exactly to zero."""
    aa = quat_to_aa(rotmat_to_quat(R))
    return torch.where(torch.isnan(aa), torch.zeros_like(aa), aa)


def aa_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> (w, x, y, z) quaternion."""
    angle = _safe_norm(aa + 1e-8, eps=0.0)
    normalized = aa / angle
    half = angle * 0.5
    return torch.cat([torch.cos(half), torch.sin(half) * normalized], dim=-1)
