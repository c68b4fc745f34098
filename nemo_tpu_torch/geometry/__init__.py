"""Rotations, cameras and Procrustes alignment (port of nemo_tpu.geometry)."""

from .rotations import (
    aa_to_quat,
    batch_rodrigues,
    euler_to_quat,
    euler_to_rotmat,
    quat_to_aa,
    quat_to_rotmat,
    rot6d_to_aa,
    rot6d_to_rotmat,
    rotmat_to_aa,
    rotmat_to_quat,
    rotmat_to_rot6d,
)
from .camera import (
    FOCAL_LENGTH,
    Camera,
    apply_extrinsics,
    camera_from_params,
    estimate_translation,
    init_camera_params,
    perspective_projection,
    project,
)
from .procrustes import (
    apply_rigid_transform,
    reconstruction_error,
    reconstruction_error_np,
    rigid_transform,
    rigid_transform_np,
    similarity_transform,
    similarity_transform_np,
)

__all__ = [
    "aa_to_quat", "batch_rodrigues", "euler_to_quat", "euler_to_rotmat",
    "quat_to_aa", "quat_to_rotmat", "rot6d_to_aa", "rot6d_to_rotmat",
    "rotmat_to_aa", "rotmat_to_quat", "rotmat_to_rot6d",
    "FOCAL_LENGTH", "Camera", "apply_extrinsics", "camera_from_params",
    "estimate_translation", "init_camera_params", "perspective_projection",
    "project",
    "apply_rigid_transform", "reconstruction_error", "reconstruction_error_np",
    "rigid_transform", "rigid_transform_np", "similarity_transform",
    "similarity_transform_np",
]
