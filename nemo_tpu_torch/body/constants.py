"""Joint vocabulary for the 49-joint superset (25 OpenPose + 24 GT joints).

Data tables matching the NeMo reference's constants.py:14-111 (the public
SPIN joint conventions); a verbatim numpy re-home of
nemo_tpu/body/constants.py. Stored compactly as (name, smpl_index) pairs; the SMPL
index refers to the 54-joint concatenation produced by smpl_forward
(24 kinematic + 21 selected vertices + 9 extra regressed).
"""

from __future__ import annotations

import numpy as np

FOCAL_LENGTH = 5000.0
IMG_RES = 224

IMG_NORM_MEAN = (0.485, 0.456, 0.406)
IMG_NORM_STD = (0.229, 0.224, 0.225)

# (joint name, index into the 54-joint SMPL superset)
_JOINTS = [
    # 25 OpenPose BODY_25 joints
    ("OP Nose", 24), ("OP Neck", 12), ("OP RShoulder", 17),
    ("OP RElbow", 19), ("OP RWrist", 21), ("OP LShoulder", 16),
    ("OP LElbow", 18), ("OP LWrist", 20), ("OP MidHip", 0),
    ("OP RHip", 2), ("OP RKnee", 5), ("OP RAnkle", 8),
    ("OP LHip", 1), ("OP LKnee", 4), ("OP LAnkle", 7),
    ("OP REye", 25), ("OP LEye", 26), ("OP REar", 27),
    ("OP LEar", 28), ("OP LBigToe", 29), ("OP LSmallToe", 30),
    ("OP LHeel", 31), ("OP RBigToe", 32), ("OP RSmallToe", 33),
    ("OP RHeel", 34),
    # 24 ground-truth joints (dataset superset)
    ("Right Ankle", 8), ("Right Knee", 5), ("Right Hip", 45),
    ("Left Hip", 46), ("Left Knee", 4), ("Left Ankle", 7),
    ("Right Wrist", 21), ("Right Elbow", 19), ("Right Shoulder", 17),
    ("Left Shoulder", 16), ("Left Elbow", 18), ("Left Wrist", 20),
    ("Neck (LSP)", 47), ("Top of Head (LSP)", 48),
    ("Pelvis (MPII)", 49), ("Thorax (MPII)", 50),
    ("Spine (H36M)", 51), ("Jaw (H36M)", 52), ("Head (H36M)", 53),
    ("Nose", 24), ("Left Eye", 26), ("Right Eye", 25),
    ("Left Ear", 28), ("Right Ear", 27),
]

JOINT_NAMES = [n for n, _ in _JOINTS]
JOINT_IDS = {n: i for i, (n, _) in enumerate(_JOINTS)}
JOINT_MAP = np.array([i for _, i in _JOINTS], dtype=np.int64)  # (49,)

# SMPL kinematic tree (parent of each of the 24 joints).
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9,
     12, 13, 14, 16, 17, 18, 19, 20, 21], dtype=np.int64)

# Mesh vertex ids appended as joints by smplx's VertexJointSelector
# (face 5, feet 6, hand tips 10) — the standard SMPL vertex keypoints.
VERTEX_JOINT_IDS = np.array([
    332, 6260, 2800, 4071, 583,              # nose, reye, leye, rear, lear
    3216, 3226, 3387, 6617, 6624, 6787,       # L/R big toe, small toe, heel
    2746, 2319, 2445, 2556, 2673,             # left thumb/index/middle/ring/pinky
    6191, 5782, 5905, 6016, 6133,             # right hand tips
], dtype=np.int64)

# Joint selectors (constants.py:92-98).
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
H36M_TO_J14 = H36M_TO_J17[:14]
J24_TO_J17 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 18, 14, 16, 17]
J24_TO_J14 = J24_TO_J17[:14]

# Flip permutations (constants.py:100-111).
SMPL_JOINTS_FLIP_PERM = [0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13,
                         15, 17, 16, 19, 18, 21, 20, 23, 22]
SMPL_POSE_FLIP_PERM = []
for _i in SMPL_JOINTS_FLIP_PERM:
    SMPL_POSE_FLIP_PERM.extend((3 * _i, 3 * _i + 1, 3 * _i + 2))
J24_FLIP_PERM = [5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 15, 16,
                 17, 18, 19, 21, 20, 23, 22]
OP25_FLIP_PERM = [0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11, 16, 15,
                  18, 17, 22, 23, 24, 19, 20, 21]
J49_FLIP_PERM = OP25_FLIP_PERM + [25 + i for i in J24_FLIP_PERM]

# Joint-index selection used when projecting predictions to 2D:
# NemoV0-V3 substitute joint 38 ('Top of Head (LSP)') for OP Nose and keep
# OP joints 1..24 (neural_motion_model.py:3061-3062); V4 takes the straight
# 25 OP joints (:3997). Index lists into the 49-joint output.
PROJ_JOINT_IDX_V0 = [38] + list(range(1, 25))
PROJ_JOINT_IDX_V4 = list(range(0, 25))
