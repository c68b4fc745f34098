"""Penn Action adapter: 13-joint .mat labels -> OpenPose-25 layout (port of
nemo_tpu/data/penn_action.py; numpy only).

Behavioral reference: hmr/penn_action.py:42-94 — Penn's left/right naming is
mirrored relative to image space, so each Penn 'left_*' joint feeds the OP
'R*' slot and vice versa; the 12 unmapped OP joints stay zero (confidence 0).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..body.constants import JOINT_NAMES

_OP25 = JOINT_NAMES[:25]

PENN_JOINTS = [
    "head", "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle",
]

# OP slot <- Penn joint, with the L/R swap (Penn's L/R is mirrored).
_OP_FROM_PENN = {
    "OP Nose": "head",
    "OP LShoulder": "right_shoulder", "OP RShoulder": "left_shoulder",
    "OP LElbow": "right_elbow", "OP RElbow": "left_elbow",
    "OP LWrist": "right_wrist", "OP RWrist": "left_wrist",
    "OP LHip": "right_hip", "OP RHip": "left_hip",
    "OP LKnee": "right_knee", "OP RKnee": "left_knee",
    "OP LAnkle": "right_ankle", "OP RAnkle": "left_ankle",
}


def penn_gt_to_op(labels: Dict[str, np.ndarray]) -> np.ndarray:
    """A whole sequence: {'x', 'y', 'visibility': (T, 13)} -> (T, 25, 3)."""
    x = np.asarray(labels["x"], np.float32)
    y = np.asarray(labels["y"], np.float32)
    v = np.asarray(labels["visibility"], np.float32)
    out = np.zeros((x.shape[0], 25, 3), np.float32)
    for op_name, penn_name in _OP_FROM_PENN.items():
        oi = _OP25.index(op_name)
        pi = PENN_JOINTS.index(penn_name)
        out[:, oi, 0] = x[:, pi]
        out[:, oi, 1] = y[:, pi]
        out[:, oi, 2] = v[:, pi]
    return out


def load_penn_sequence(mat_path: str) -> np.ndarray:
    """One Penn Action labels/NNNN.mat in OP-25 layout (T, 25, 3)."""
    from scipy.io import loadmat
    data = loadmat(mat_path)
    return penn_gt_to_op({k: data[k] for k in ("x", "y", "visibility")})
