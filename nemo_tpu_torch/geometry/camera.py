"""Camera models: perspective projection and NeMo's learned camera.

Port of nemo_tpu/geometry/camera.py. The learned camera is 9 parameters per
view: translation (3) then a 6D rotation (6); intrinsics are fixed (f = 5000,
principal point at the image centre, in the reference's swapped-axis
convention).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .rotations import rot6d_to_rotmat

FOCAL_LENGTH = 5000.0


class Camera(NamedTuple):
    """A batch of perspective cameras (leading axes broadcast)."""
    rotation: torch.Tensor      # (..., 3, 3)
    translation: torch.Tensor   # (..., 3)
    focal_length: torch.Tensor  # (...,)
    center: torch.Tensor        # (..., 2)


def camera_from_params(params9: torch.Tensor, img_d0: float, img_d1: float,
                       focal_length: float = FOCAL_LENGTH) -> Camera:
    """Camera from the 9-parameter encoding; center = (D0 // 2, D1 // 2)
    exactly as the reference (D0 is the image height)."""
    rot = rot6d_to_rotmat(params9[..., 3:])
    trans = params9[..., :3]
    batch_shape = params9.shape[:-1]
    # torch.full, not torch.tensor: no host-to-device copy (which would
    # wait for the stream) inside a fit step
    full = lambda v: torch.full(batch_shape, v, dtype=params9.dtype,
                                device=params9.device)
    center = torch.stack([full(img_d0 // 2), full(img_d1 // 2)], dim=-1)
    f = full(focal_length)
    return Camera(rotation=rot, translation=trans, focal_length=f,
                  center=center)


def init_camera_params(num_views: int, img_d0: float,
                       focal_length: float = FOCAL_LENGTH,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """1e-4 * N(0, 1), +1 on indices 3 and 6 (near-identity 6D rotation),
    depth 2f / D0 on index 2."""
    p = 1e-4 * torch.randn(num_views, 9, generator=generator,
                           dtype=torch.float32)
    p[:, 3] += 1.0
    p[:, 6] += 1.0
    p[:, 2] += 2.0 * focal_length / (img_d0 * 1 + 1e-9)
    return p


def perspective_projection(points: torch.Tensor, rotation: torch.Tensor,
                           translation: torch.Tensor, focal_length,
                           camera_center, eps: float = 1e-9) -> torch.Tensor:
    """Project (..., N, 3) points to (..., N, 2) pixels. The divide is
    epsilon-guarded so a point crossing the camera plane gives no NaN."""
    pts = torch.einsum('...ij,...kj->...ki', rotation, points)
    pts = pts + translation[..., None, :]
    z = pts[..., 2:3]
    z = torch.where(z.abs() < eps,
                    torch.where(z < 0, torch.full_like(z, -eps),
                                torch.full_like(z, eps)), z)
    xy = pts[..., :2] / z
    f = torch.as_tensor(focal_length, dtype=pts.dtype,
                        device=pts.device)[..., None, None]
    return f * xy + torch.as_tensor(camera_center, dtype=pts.dtype,
                                    device=pts.device)[..., None, :]


def project(points: torch.Tensor, camera: Camera) -> torch.Tensor:
    """Project through a Camera tuple."""
    return perspective_projection(points, camera.rotation, camera.translation,
                                  camera.focal_length, camera.center)


def apply_extrinsics(points: torch.Tensor, rotation: torch.Tensor,
                     translation: torch.Tensor, inverse: bool = False
                     ) -> torch.Tensor:
    """World -> camera (R p + t), or camera -> world with inverse=True
    (R^T (p - t): the rotation is orthonormal). points (..., N, 3),
    rotation (..., 3, 3), translation (..., 3)."""
    if not inverse:
        pts = torch.einsum('...ij,...kj->...ki', rotation, points)
        return pts + translation[..., None, :]
    pts = points - translation[..., None, :]
    return torch.einsum('...ji,...kj->...ki', rotation, pts)


def estimate_translation(S: torch.Tensor, joints_2d: torch.Tensor,
                         joints_conf: torch.Tensor,
                         focal_length: float = 5000.0,
                         img_size: float = 224.0) -> torch.Tensor:
    """The camera translation t that best fits project(S + t) to joints_2d
    in weighted least squares, for a fixed intrinsic camera (HMR's
    estimate_translation, one batched 3x3 solve of the normal equations;
    the weights are sqrt(max(conf, 0)) on each joint's two rows). S (..., N,
    3), joints_2d (..., N, 2), joints_conf (..., N) -> (..., 3)."""
    f = focal_length
    cx = cy = img_size / 2.0
    w = torch.sqrt(torch.clamp_min(joints_conf, 0.0))
    X, Y, Z = S[..., 0], S[..., 1], S[..., 2]
    u, v = joints_2d[..., 0], joints_2d[..., 1]
    # per joint:  [f, 0, cx - u] t = (u - cx) Z - f X
    #             [0, f, cy - v] t = (v - cy) Z - f Y
    a1 = torch.stack([torch.full_like(u, f), torch.zeros_like(u), cx - u],
                     dim=-1)
    a2 = torch.stack([torch.zeros_like(v), torch.full_like(v, f), cy - v],
                     dim=-1)
    b1 = (u - cx) * Z - f * X
    b2 = (v - cy) * Z - f * Y
    A = torch.cat([a1, a2], dim=-2)
    b = torch.cat([b1, b2], dim=-1)
    W = torch.cat([w, w], dim=-1)
    Aw = A * W[..., None]
    bw = b * W
    AtA = torch.einsum('...ni,...nj->...ij', Aw, Aw)
    Atb = torch.einsum('...ni,...n->...i', Aw, bw)
    return torch.linalg.solve(AtA, Atb[..., None])[..., 0]


def camera_from_params_np(params9, img_d0: float, img_d1: float,
                          focal_length: float = FOCAL_LENGTH) -> Camera:
    """Numpy twin of camera_from_params for host-side render prep: the same
    9-parameter encoding and principal-point convention, numpy fields."""
    import numpy as np
    from .rotations import rot6d_to_rotmat_np
    params9 = np.asarray(params9, np.float32)
    batch_shape = params9.shape[:-1]
    center = np.broadcast_to(
        np.array([img_d0 // 2, img_d1 // 2], np.float32), batch_shape + (2,))
    f = np.broadcast_to(np.float32(focal_length), batch_shape)
    return Camera(rotation=rot6d_to_rotmat_np(params9[..., 3:]),
                  translation=params9[..., :3], focal_length=f, center=center)


def camera_from_weak_persp(cam4, img_h: float, img_w: float,
                           focal_length: float = FOCAL_LENGTH) -> Camera:
    """VIBE's weak-perspective orig_cam (sx, sy, tx, ty) as the equivalent
    perspective Camera: identity rotation, translation (tx, ty,
    2f / (W sx)), principal point (W/2, H/2). Numpy fields, for host-side
    render prep; center[0] is the width axis, as render_mesh_overlay
    reads it."""
    import numpy as np
    cam4 = np.asarray(cam4, np.float32)
    sx, tx, ty = cam4[..., 0], cam4[..., 2], cam4[..., 3]
    tz = 2.0 * np.float32(focal_length) / (np.float32(img_w) * sx + 1e-9)
    trans = np.stack([tx, ty, tz], axis=-1)
    batch_shape = cam4.shape[:-1]
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), batch_shape + (3, 3))
    center = np.broadcast_to(
        np.array([img_w / 2.0, img_h / 2.0], np.float32), batch_shape + (2,))
    f = np.broadcast_to(np.float32(focal_length), batch_shape)
    return Camera(rotation=eye, translation=trans, focal_length=f,
                  center=center)
