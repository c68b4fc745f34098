"""Keypoint-vocabulary conversion between dataset joint formats (port of
nemo_tpu/data/keypoints.py).

Behavioral reference: VIBE/lib/data_utils/kp_utils.py:52-672 — the public
joint-name conventions of each dataset (SPIN-49, H36M-17, MPII3D-28,
COCO-17, PoseTrack-17, Penn Action-13, Insta-25, MPII-16, 3DPW-14, AICH-14,
SMPL-24, common-14, STAF-21) and `convert_kps`, which maps joints from one
vocabulary to another by shared names, zero-filling the rest.

Data tables + a precomputed gather, pure numpy (host-side packers):
  * `VOCAB[fmt]` — tuple of joint names (a public data convention),
  * `conversion_index(src, dst)` — (len(dst),) int64 index, -1 = missing,
  * `convert_kps(joints, src, dst)` — one vectorized take + mask instead of
    the reference's per-joint Python loop (kp_utils.py:52-62).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# Joint-name vocabulary per dataset format (kp_utils.py get_*_joint_names).
VOCAB: Dict[str, Tuple[str, ...]] = {
    # SPIN 49-joint superset (kp_utils.py:243-295): 25 OpenPose + 24 GT.
    "spin": (
        "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
        "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
        "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
        "OP REye", "OP LEye", "OP REar", "OP LEar", "OP LBigToe",
        "OP LSmallToe", "OP LHeel", "OP RBigToe", "OP RSmallToe", "OP RHeel",
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "rwrist",
        "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist", "neck",
        "headtop", "hip", "thorax", "Spine (H36M)", "Jaw (H36M)",
        "Head (H36M)", "nose", "leye", "reye", "lear", "rear",
    ),
    # STAF tracker output (kp_utils.py:219-241).
    "staf": (
        "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
        "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
        "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
        "OP REye", "OP LEye", "OP REar", "OP LEar", "Neck (LSP)",
        "Top of Head (LSP)",
    ),
    # H36M 17 (kp_utils.py:297-316).
    "h36m": (
        "hip", "lhip", "lknee", "lankle", "rhip", "rknee", "rankle",
        "Spine (H36M)", "neck", "Head (H36M)", "headtop", "lshoulder",
        "lelbow", "lwrist", "rshoulder", "relbow", "rwrist",
    ),
    # MPI-INF-3DHP 28-joint train annotation (kp_utils.py:94-127).
    "mpii3d": (
        "spine3", "spine4", "spine2", "Spine (H36M)", "hip", "neck",
        "Head (H36M)", "headtop", "left_clavicle", "lshoulder", "lelbow",
        "lwrist", "left_hand", "right_clavicle", "rshoulder", "relbow",
        "rwrist", "right_hand", "lhip", "lknee", "lankle", "left_foot",
        "left_toe", "rhip", "rknee", "rankle", "right_foot", "right_toe",
    ),
    # MPI-INF-3DHP 17-joint test annotation (kp_utils.py:73-91).
    "mpii3d_test": (
        "headtop", "neck", "rshoulder", "relbow", "rwrist", "lshoulder",
        "lelbow", "lwrist", "rhip", "rknee", "rankle", "lhip", "lknee",
        "lankle", "hip", "Spine (H36M)", "Head (H36M)",
    ),
    # InstaVariety 25 (kp_utils.py:128-154).
    "insta": (
        "OP RHeel", "OP RKnee", "OP RHip", "OP LHip", "OP LKnee", "OP LHeel",
        "OP RWrist", "OP RElbow", "OP RShoulder", "OP LShoulder", "OP LElbow",
        "OP LWrist", "OP Neck", "headtop", "OP Nose", "OP LEye", "OP REye",
        "OP LEar", "OP REar", "OP LBigToe", "OP RBigToe", "OP LSmallToe",
        "OP RSmallToe", "OP LAnkle", "OP RAnkle",
    ),
    # PoseTrack 17 (kp_utils.py:346-352).
    "posetrack": (
        "nose", "neck", "headtop", "lear", "rear", "lshoulder", "rshoulder",
        "lelbow", "relbow", "lwrist", "rwrist", "lhip", "rhip", "lknee",
        "rknee", "lankle", "rankle",
    ),
    # Penn Action 13 (kp_utils.py:364-380).
    "pennaction": (
        "headtop", "lshoulder", "rshoulder", "lelbow", "relbow", "lwrist",
        "rwrist", "lhip", "rhip", "lknee", "rknee", "lankle", "rankle",
    ),
    # "common" 14-joint eval set (kp_utils.py:382-399).
    "common": (
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "rwrist",
        "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist", "neck",
        "headtop",
    ),
    # COCO 17 (kp_utils.py:421-440).
    "coco": (
        "nose", "leye", "reye", "lear", "rear", "lshoulder", "rshoulder",
        "lelbow", "relbow", "lwrist", "rwrist", "lhip", "rhip", "lknee",
        "rknee", "lankle", "rankle",
    ),
    # MPII 16 (kp_utils.py:466-484).
    "mpii": (
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "hip",
        "thorax", "neck", "headtop", "rwrist", "relbow", "rshoulder",
        "lshoulder", "lelbow", "lwrist",
    ),
    # AI Challenger 14 (kp_utils.py:510-526).
    "aich": (
        "rshoulder", "relbow", "rwrist", "lshoulder", "lelbow", "lwrist",
        "rhip", "rknee", "rankle", "lhip", "lknee", "lankle", "headtop",
        "neck",
    ),
    # 3DPW 14 2D annotation order (kp_utils.py:548-564).
    "3dpw": (
        "nose", "thorax", "rshoulder", "relbow", "rwrist", "lshoulder",
        "lelbow", "lwrist", "rhip", "rknee", "rankle", "lhip", "lknee",
        "lankle",
    ),
    # SMPL+COCO 19 (kp_utils.py:572-592).
    "smplcoco": (
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "rwrist",
        "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist", "neck",
        "headtop", "nose", "leye", "reye", "lear", "rear",
    ),
    # SMPL 24 kinematic joints (kp_utils.py:616-642).
    "smpl": (
        "hips", "leftUpLeg", "rightUpLeg", "spine", "leftLeg", "rightLeg",
        "spine1", "leftFoot", "rightFoot", "spine2", "leftToeBase",
        "rightToeBase", "neck", "leftShoulder", "rightShoulder", "head",
        "leftArm", "rightArm", "leftForeArm", "rightForeArm", "leftHand",
        "rightHand", "leftHandIndex1", "rightHandIndex1",
    ),
}

# PoseTrack's on-disk names -> the canonical names above
# (kp_utils.py:355-361 get_posetrack_original_kp_names).
POSETRACK_ORIGINAL_NAMES = (
    "nose", "head_bottom", "head_top", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle",
)

def conversion_index(src: str, dst: str) -> np.ndarray:
    """(len(dst),) int64 gather index from src order; -1 where dst has a
    joint src lacks. Name-matching semantics of kp_utils.py:52-62."""
    src_names, dst_names = VOCAB[src], VOCAB[dst]
    pos = {n: i for i, n in enumerate(src_names)}
    return np.array([pos.get(n, -1) for n in dst_names], np.int64)


def convert_kps(joints: np.ndarray, src: str, dst: str) -> np.ndarray:
    """Map (..., len(src), C) keypoints to the dst vocabulary, zero-filling
    joints absent from src (convert_kps, kp_utils.py:52-62) — implemented
    as one gather + mask over the trailing joint axis."""
    joints = np.asarray(joints)
    idx = conversion_index(src, dst)
    out = np.take(joints, np.maximum(idx, 0), axis=-2)
    out = np.where((idx >= 0)[..., None], out, 0.0)
    return out.astype(joints.dtype, copy=False)


def get_perm_idxs(src: str, dst: str) -> list:
    """Indices of dst joints inside src, skipping missing ones
    (kp_utils.py:65-69) — used to subset confidences/weights."""
    idx = conversion_index(src, dst)
    return [int(i) for i in idx if i >= 0]


def keypoint_hflip(kp: np.ndarray, img_width: float) -> np.ndarray:
    """Mirror x about the image (kp_utils.py:42-49), non-mutating."""
    kp = np.array(kp, copy=True)
    kp[..., 0] = (img_width - 1.0) - kp[..., 0]
    return kp
