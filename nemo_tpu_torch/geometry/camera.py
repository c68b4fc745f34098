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
