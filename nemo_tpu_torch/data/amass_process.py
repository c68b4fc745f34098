"""Raw AMASS -> processed sequences, and the 3D fitting observations.

Port of nemo_tpu/data/amass_process.py (behavioral reference:
humor/humor/scripts/process_amass_data.py, cleanup_amass_data.py,
humor/humor/datasets/amass_discrete_dataset.py and amass_fit_dataset.py)
for what ``humor_tool process-amass``, ``train --amass`` and ``fit-amass``
run: per-sequence processing (trim, SMPL forward for joints and keypoint
vertices, floor height and contacts, terrain discard, central-difference
velocities, 30 fps downsample, alignment rotations), the directory walk and
clean-up, the split tables, the HuMoR trainer's windows
(``amass_world_states``, ``amass_state_windows``, ``canonicalize_windows``,
``load_amass_windows``), surface sampling and ``amass_fit_observations``.

Everything is the JAX package's numpy, copied (the port imports nothing of
nemo_tpu), except the SMPL forwards, which run the port's ``smpl_forward``
on the model's device, SPLIT_FRAME_LIMIT frames a call, and
``canonicalize_windows``, one batched call of the port's frame transforms
on the device it is given.
"""

import glob
import os
import os.path as osp
import shutil
from typing import Optional

import numpy as np
import torch

from ..body.smpl import smpl_forward

# --- processing options (process_amass_data.py:26-66) -----------------------

OUT_FPS = 30
SPLIT_FRAME_LIMIT = 2000
NUM_BETAS = 16
DISCARD_SHORTER_THAN = 1.0  # seconds

FLOOR_VEL_THRESH = 0.005
FLOOR_HEIGHT_OFFSET = 0.01
CONTACT_VEL_THRESH = 0.005
CONTACT_TOE_HEIGHT_THRESH = 0.04
CONTACT_ANKLE_HEIGHT_THRESH = 0.08
TERRAIN_HEIGHT_THRESH = 0.04
ROOT_HEIGHT_THRESH = 0.04
CLUSTER_SIZE_THRESH = 0.25

# HuMoR's AMASS splits (process_amass_data.py:38-45)
ALL_DATASETS = [
    'ACCAD', 'BMLmovi', 'BioMotionLab_NTroje', 'BMLhandball', 'CMU',
    'DanceDB', 'DFaust_67', 'EKUT', 'Eyes_Japan_Dataset', 'HumanEva',
    'KIT', 'MPI_HDM05', 'MPI_Limits', 'MPI_mosh', 'SFU', 'SSM_synced',
    'TCD_handMocap', 'TotalCapture', 'Transitions_mocap']
TRAIN_DATASETS = ['CMU', 'MPI_Limits', 'TotalCapture', 'Eyes_Japan_Dataset',
                  'KIT', 'BioMotionLab_NTroje', 'BMLmovi', 'EKUT', 'ACCAD']
TEST_DATASETS = ['Transitions_mocap', 'HumanEva']
VAL_DATASETS = ['MPI_HDM05', 'SFU', 'MPI_mosh']

# SMPL joint vocabulary (humor/body_model/utils.py:5-9)
SMPL_JOINTS = {
    'hips': 0, 'leftUpLeg': 1, 'rightUpLeg': 2, 'spine': 3, 'leftLeg': 4,
    'rightLeg': 5, 'spine1': 6, 'leftFoot': 7, 'rightFoot': 8, 'spine2': 9,
    'leftToeBase': 10, 'rightToeBase': 11, 'neck': 12, 'leftShoulder': 13,
    'rightShoulder': 14, 'head': 15, 'leftArm': 16, 'rightArm': 17,
    'leftForeArm': 18, 'rightForeArm': 19, 'leftHand': 20, 'rightHand': 21}
NUM_JOINTS = len(SMPL_JOINTS)  # 22

# virtual-marker keypoint vertices (humor/body_model/utils.py:17-19)
KEYPT_VERTS = [
    4404, 920, 3076, 3169, 823, 4310, 1010, 1085, 4495, 4569, 6615, 3217,
    3313, 6713, 6785, 3383, 6607, 3207, 1241, 1508, 4797, 4122, 1618, 1569,
    5135, 5040, 5691, 5636, 5404, 2230, 2173, 2108, 134, 3645, 6543, 3123,
    3024, 4194, 1306, 182, 3694, 4294, 744]


# --- small host-side numerics (numpy; exact reference math) ------------------

def np_rodrigues(aa: np.ndarray) -> np.ndarray:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3). Closed-form
    Rodrigues, the numpy twin of utils/transforms.py:batch_rodrigues."""
    aa = np.asarray(aa, np.float64)
    shp = aa.shape[:-1]
    a = aa.reshape(-1, 3)
    ang = np.linalg.norm(a, axis=1, keepdims=True) + 1e-8
    ax = a / ang
    c, s = np.cos(ang)[:, :, None], np.sin(ang)[:, :, None]
    K = np.zeros((a.shape[0], 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -ax[:, 2], ax[:, 1]
    K[:, 1, 0], K[:, 1, 2] = ax[:, 2], -ax[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -ax[:, 1], ax[:, 0]
    eye = np.eye(3)[None]
    R = eye * c + s * K + (1 - c) * (ax[:, :, None] * ax[:, None, :])
    return R.reshape(shp + (3, 3))


def estimate_velocity(data_seq: np.ndarray, h: float) -> np.ndarray:
    """Second-order central difference over the middle T-2 steps
    (process_amass_data.py:312-318)."""
    return (data_seq[2:] - data_seq[:-2]) / (2 * h)


def estimate_angular_velocity(rot_seq: np.ndarray, h: float) -> np.ndarray:
    """Angular velocity vectors of a (T, ..., 3, 3) rotation sequence from
    the skew part of dR/dt R^T (process_amass_data.py:320-339)."""
    dRdt = estimate_velocity(rot_seq, h)
    R = rot_seq[1:-1]
    w_mat = np.matmul(dRdt, np.swapaxes(R, -1, -2))
    w_x = (-w_mat[..., 1, 2] + w_mat[..., 2, 1]) / 2.0
    w_y = (w_mat[..., 0, 2] - w_mat[..., 2, 0]) / 2.0
    w_z = (-w_mat[..., 0, 1] + w_mat[..., 1, 0]) / 2.0
    return np.stack([w_x, w_y, w_z], axis=-1)


def compute_align_from_right(body_right: np.ndarray):
    """Heading-removal rotation (around +z) that aligns the body-right
    vector with world +x (process_amass_data.py:299-307). Returns
    (mats (T, 3, 3), axis-angles (T, 3)). NOTE: mutates body_right[:, 2]
    to 0 exactly like the reference (callers pass throwaway arrays)."""
    ang = np.arccos(np.clip(
        body_right[:, 0] / (np.linalg.norm(body_right[:, :2], axis=1)
                            + 1e-8), -1.0, 1.0))
    body_right[:, 2] = 0.0
    axis = np.cross(body_right, np.array([[1.0, 0.0, 0.0]]))
    aa = (axis / (np.linalg.norm(axis, axis=1)[:, None] + 1e-8)
          ) * ang[:, None]
    return np_rodrigues(aa), aa


def compute_align_mats(root_orient: np.ndarray) -> np.ndarray:
    """World->aligned rotations from root orientation axis-angles (T, 3):
    body right is -R[:, :, 0] (process_amass_data.py:272-284)."""
    R = np_rodrigues(root_orient.reshape(-1, 3))
    mat, _ = compute_align_from_right(-R[:, :, 0].copy())
    return mat


def compute_joint_align_mats(joint_seq: np.ndarray) -> np.ndarray:
    """World->aligned rotations from joints (T, J, 3): right = rightUpLeg -
    leftUpLeg (process_amass_data.py:286-297)."""
    right = (joint_seq[:, SMPL_JOINTS['rightUpLeg']]
             - joint_seq[:, SMPL_JOINTS['leftUpLeg']])
    right = right / np.linalg.norm(right, axis=1)[:, None]
    mat, _ = compute_align_from_right(right)
    return mat


def dbscan_1d(x: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """Exact DBSCAN labels for 1-D points (the reference runs
    sklearn.cluster.DBSCAN(eps=0.005, min_samples=3) on foot heights,
    process_amass_data.py:158; this is the same algorithm specialized to
    one dimension: sort, count eps-neighbors, chain core points)."""
    x = np.asarray(x, np.float64).reshape(-1)
    n = x.shape[0]
    order = np.argsort(x, kind="stable")
    xs = x[order]
    # neighbor counts via two-pointer over the sorted axis
    left = np.searchsorted(xs, xs - eps, side="left")
    right = np.searchsorted(xs, xs + eps, side="right")
    is_core = (right - left) >= min_samples
    labels_sorted = np.full(n, -1, dtype=np.int64)
    cur = -1
    prev_core = -1  # index (in sorted order) of previous core point
    for i in range(n):
        if not is_core[i]:
            continue
        if prev_core >= 0 and xs[i] - xs[prev_core] <= eps:
            labels_sorted[i] = labels_sorted[prev_core]
        else:
            cur += 1
            labels_sorted[i] = cur
        prev_core = i
    # border points: non-core within eps of any core; ties go to the
    # first core point that reaches them in index order (sklearn semantics:
    # assigned to the cluster of the first core neighbor found). In 1-D the
    # nearest core on the left comes first in scan order when it exists.
    core_idx = np.nonzero(is_core)[0]
    if core_idx.size:
        for i in range(n):
            if labels_sorted[i] >= 0 or is_core[i]:
                continue
            # nearest cores left/right in sorted order
            pos = np.searchsorted(core_idx, i)
            cand = []
            if pos > 0:
                cand.append(core_idx[pos - 1])
            if pos < core_idx.size:
                cand.append(core_idx[pos])
            cand = [c for c in cand if abs(xs[c] - xs[i]) <= eps]
            if cand:
                # sklearn assigns border points in original index order to
                # the first core that claims them; with 1-D data the closer
                # core is the claimer for all but pathological ties.
                c = min(cand, key=lambda j: abs(xs[j] - xs[i]))
                labels_sorted[i] = labels_sorted[c]
    labels = np.full(n, -1, dtype=np.int64)
    labels[order] = labels_sorted
    return labels


def detect_joint_contact(body_joint_seq: np.ndarray, joint_name: str,
                         floor_height: float, vel_thresh: float,
                         height_thresh: float) -> np.ndarray:
    """Velocity+height contact test for one joint
    (process_amass_data.py:257-269)."""
    seq = body_joint_seq[:, SMPL_JOINTS[joint_name], :]
    vel = np.linalg.norm(seq[1:] - seq[:-1], axis=1)
    vel = np.append(vel, vel[-1])
    contact = vel < vel_thresh
    heights = seq[:, 2] - floor_height
    return np.logical_and(contact, heights < height_thresh)


def determine_floor_height_and_contacts(body_joint_seq: np.ndarray,
                                        fps: float):
    """Floor height from DBSCAN-clustered static-foot heights + per-joint
    contact flags + terrain-interaction discard heuristic
    (process_amass_data.py:93-255).

    Input: (T, 22, 3) world joints, z up. Returns
    (offset_floor_height, contacts (T, 22), discard_seq).
    """
    num_frames = body_joint_seq.shape[0]
    root_seq = body_joint_seq[:, SMPL_JOINTS['hips'], :]
    left_toe_seq = body_joint_seq[:, SMPL_JOINTS['leftToeBase'], :]
    right_toe_seq = body_joint_seq[:, SMPL_JOINTS['rightToeBase'], :]
    left_toe_vel = np.linalg.norm(left_toe_seq[1:] - left_toe_seq[:-1],
                                  axis=1)
    left_toe_vel = np.append(left_toe_vel, left_toe_vel[-1])
    right_toe_vel = np.linalg.norm(right_toe_seq[1:] - right_toe_seq[:-1],
                                   axis=1)
    right_toe_vel = np.append(right_toe_vel, right_toe_vel[-1])

    left_toe_heights = left_toe_seq[:, 2]
    right_toe_heights = right_toe_seq[:, 2]
    root_heights = root_seq[:, 2]

    all_inds = np.arange(left_toe_heights.shape[0])
    left_static = left_toe_vel < FLOOR_VEL_THRESH
    right_static = right_toe_vel < FLOOR_VEL_THRESH
    all_static_foot_heights = np.append(left_toe_heights[left_static],
                                        right_toe_heights[right_static])
    all_static_inds = np.append(all_inds[left_static],
                                all_inds[right_static])

    discard_seq = False
    if all_static_foot_heights.shape[0] > 0:
        labels = dbscan_1d(all_static_foot_heights, eps=0.005, min_samples=3)
        cluster_heights, cluster_root_heights, cluster_sizes = [], [], []
        min_median = min_root_median = float('inf')
        for cur_label in np.unique(labels):
            cur_clust = all_static_foot_heights[labels == cur_label]
            cur_clust_inds = np.unique(all_static_inds[labels == cur_label])
            cur_median = np.median(cur_clust)
            cluster_heights.append(cur_median)
            cluster_sizes.append(cur_clust.shape[0])
            cur_root_median = np.median(root_heights[cur_clust_inds])
            cluster_root_heights.append(cur_root_median)
            if cur_median < min_median:
                min_median = cur_median
                min_root_median = cur_root_median
        floor_height = min_median
        offset_floor_height = floor_height - FLOOR_HEIGHT_OFFSET
        # terrain heuristic (:197-207)
        for c_root, c_height, c_size in zip(cluster_root_heights,
                                            cluster_heights, cluster_sizes):
            if (c_root > min_root_median + ROOT_HEIGHT_THRESH
                    and c_height > min_median + TERRAIN_HEIGHT_THRESH
                    and c_size > int(CLUSTER_SIZE_THRESH * fps)):
                discard_seq = True
                break
    else:
        floor_height = offset_floor_height = 0.0

    # heel/toe contacts vs the UNOFFSET floor height (:210-236)
    left_heel_seq = body_joint_seq[:, SMPL_JOINTS['leftFoot'], :]
    right_heel_seq = body_joint_seq[:, SMPL_JOINTS['rightFoot'], :]
    left_heel_vel = np.linalg.norm(left_heel_seq[1:] - left_heel_seq[:-1],
                                   axis=1)
    left_heel_vel = np.append(left_heel_vel, left_heel_vel[-1])
    right_heel_vel = np.linalg.norm(right_heel_seq[1:] - right_heel_seq[:-1],
                                    axis=1)
    right_heel_vel = np.append(right_heel_vel, right_heel_vel[-1])

    left_heel_contact = np.logical_and(
        left_heel_vel < CONTACT_VEL_THRESH,
        left_heel_seq[:, 2] - floor_height < CONTACT_ANKLE_HEIGHT_THRESH)
    right_heel_contact = np.logical_and(
        right_heel_vel < CONTACT_VEL_THRESH,
        right_heel_seq[:, 2] - floor_height < CONTACT_ANKLE_HEIGHT_THRESH)
    left_toe_contact = np.logical_and(
        left_toe_vel < CONTACT_VEL_THRESH,
        left_toe_heights - floor_height < CONTACT_TOE_HEIGHT_THRESH)
    right_toe_contact = np.logical_and(
        right_toe_vel < CONTACT_VEL_THRESH,
        right_toe_heights - floor_height < CONTACT_TOE_HEIGHT_THRESH)

    contacts = np.zeros((num_frames, NUM_JOINTS))
    contacts[:, SMPL_JOINTS['leftFoot']] = left_heel_contact
    contacts[:, SMPL_JOINTS['leftToeBase']] = left_toe_contact
    contacts[:, SMPL_JOINTS['rightFoot']] = right_heel_contact
    contacts[:, SMPL_JOINTS['rightToeBase']] = right_toe_contact
    for name in ('leftHand', 'rightHand'):
        contacts[:, SMPL_JOINTS[name]] = detect_joint_contact(
            body_joint_seq, name, floor_height, CONTACT_VEL_THRESH,
            CONTACT_ANKLE_HEIGHT_THRESH)
    for name in ('leftLeg', 'rightLeg'):
        contacts[:, SMPL_JOINTS[name]] = detect_joint_contact(
            body_joint_seq, name, floor_height, CONTACT_VEL_THRESH,
            CONTACT_ANKLE_HEIGHT_THRESH)

    return offset_floor_height, contacts, discard_seq


# --- SMPL forward on the model's device ------------------------------------

def _posed(model, pose_body, root_orient, betas, trans, want_fk: bool):
    """The port's smpl_forward on numpy inputs (per-frame betas): pose_body
    aa (B, 63), root aa (B, 3), betas (B, nb), trans (B, 3)."""
    dev = model.device
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    aa69 = np.concatenate([np.asarray(pose_body, np.float32),
                           np.zeros((pose_body.shape[0], 6), np.float32)],
                          axis=1)
    with torch.no_grad():
        return smpl_forward(model, t(betas), t(aa69), t(root_orient),
                            pose2rot=True, want_vertices=True,
                            transl=t(trans), want_fk_joints=want_fk)


def smpl_joint_vert_seq(model, pose_body, root_orient, betas, trans,
                        chunk: int = SPLIT_FRAME_LIMIT):
    """Full-sequence SMPL forward in SPLIT_FRAME_LIMIT chunks
    (process_amass_data.py:393-416): (joints22 (T, 22, 3), keypoint verts
    (T, K, 3)) as float32 numpy. betas: (nb,) shared over frames."""
    V = model.v_template.shape[0]
    keypt = [v for v in KEYPT_VERTS if v < V]
    nb = model.shapedirs.shape[-1]
    b = np.zeros(nb, np.float32)
    k = min(nb, betas.shape[0], NUM_BETAS)
    b[:k] = betas[:k]
    joints, verts = [], []
    T = pose_body.shape[0]
    for s in range(0, T, chunk):
        e = min(T, s + chunk)
        v, _, fk = _posed(model, pose_body[s:e], root_orient[s:e],
                          np.repeat(b[None], e - s, axis=0), trans[s:e],
                          want_fk=True)
        joints.append(fk[:, :NUM_JOINTS].cpu().numpy())
        verts.append(v[:, keypt].cpu().numpy())
    return np.concatenate(joints, 0), np.concatenate(verts, 0)


def _full_verts(model, pose_body, root_orient, betas, trans) -> np.ndarray:
    """The full vertex set (T, V, 3) as numpy: the AMASSFitDataset
    body-model forward used for surface sampling
    (amass_fit_dataset.py:100-107)."""
    v, _ = _posed(model, pose_body, root_orient, betas, trans, want_fk=False)
    return v.cpu().numpy()


# --- per-sequence processing -------------------------------------------------

def process_amass_seq(raw: dict, model, out_fps: int = OUT_FPS,
                      save_keypt_verts: bool = True,
                      save_hand_pose: bool = False,
                      discard_terrain: bool = True,
                      log_fn=lambda s: None):
    """Process one raw AMASS dict (poses (T, >=66), trans, betas, gender,
    mocap_framerate) into the reference's per-sequence npz field dict
    (process_amass_data.py:342-556). Returns None when discarded (too
    short / terrain interaction)."""
    fps = float(raw['mocap_framerate'])
    poses = np.asarray(raw['poses'], np.float64)
    num_frames = poses.shape[0]
    trans = np.asarray(raw['trans'], np.float64).copy()
    root_orient = poses[:, :3]
    pose_body = poses[:, 3:66]
    pose_hand = poses[:, 66:]
    betas = np.asarray(raw['betas'], np.float64)
    gender = np.array(raw.get('gender', 'neutral'), ndmin=1)[0]
    gender = (gender.decode('utf-8') if isinstance(gender, bytes)
              else str(gender))

    # keep middle 80% (:375-380)
    s, e = int(0.1 * num_frames), int(0.9 * num_frames)
    trans, root_orient = trans[s:e], root_orient[s:e]
    pose_body, pose_hand = pose_body[s:e], pose_hand[s:e]
    num_frames = trans.shape[0]

    if num_frames < DISCARD_SHORTER_THAN * fps:
        log_fn(f"sequence shorter than {DISCARD_SHORTER_THAN}s, discarding")
        return None

    joint_seq, vtx_seq = smpl_joint_vert_seq(
        model, pose_body, root_orient, betas, trans)
    joint_seq = joint_seq.astype(np.float64)
    vtx_seq = vtx_seq.astype(np.float64)

    floor_height, contacts, discard_seq = \
        determine_floor_height_and_contacts(joint_seq, fps)
    if discard_seq and discard_terrain:
        log_fn("terrain interaction detected, discarding")
        return None
    log_fn(f"floor height: {floor_height:f}")
    trans[:, 2] -= floor_height
    joint_seq[:, :, 2] -= floor_height
    vtx_seq[:, :, 2] -= floor_height

    joints_world2aligned_rot = compute_joint_align_mats(joint_seq)

    # velocities at the raw frame rate (:437-460)
    h = 1.0 / fps
    joint_vel_seq = estimate_velocity(joint_seq, h)
    vtx_vel_seq = estimate_velocity(vtx_seq, h)
    trans_vel_seq = estimate_velocity(trans, h)
    root_orient_mat = np_rodrigues(root_orient).reshape(num_frames, 3, 3)
    root_orient_vel_seq = estimate_angular_velocity(root_orient_mat, h)
    pose_body_mat = np_rodrigues(
        pose_body.reshape(num_frames, NUM_JOINTS - 1, 3))
    pose_body_vel_seq = estimate_angular_velocity(pose_body_mat, h)
    joint_orient_vel_seq = -estimate_angular_velocity(
        joints_world2aligned_rot, h)[:, 2]

    # drop edge frames so velocities line up (:462-472)
    num_frames -= 2
    contacts = contacts[1:-1]
    trans, root_orient = trans[1:-1], root_orient[1:-1]
    pose_body, pose_hand = pose_body[1:-1], pose_hand[1:-1]
    joint_seq, vtx_seq = joint_seq[1:-1], vtx_seq[1:-1]

    # downsample (:474-508)
    if out_fps != fps:
        if out_fps > fps:
            log_fn("cannot supersample data, saving at data rate")
        else:
            fps_ratio = float(out_fps) / fps
            new_num_frames = int(fps_ratio * num_frames)
            idx = np.linspace(0, num_frames - 1, num=new_num_frames,
                              dtype=int)
            fps, num_frames = out_fps, new_num_frames
            contacts, trans = contacts[idx], trans[idx]
            root_orient, pose_body = root_orient[idx], pose_body[idx]
            pose_hand = pose_hand[idx]
            joint_seq, vtx_seq = joint_seq[idx], vtx_seq[idx]
            joint_vel_seq, vtx_vel_seq = joint_vel_seq[idx], vtx_vel_seq[idx]
            trans_vel_seq = trans_vel_seq[idx]
            root_orient_vel_seq = root_orient_vel_seq[idx]
            pose_body_vel_seq = pose_body_vel_seq[idx]
            joint_orient_vel_seq = joint_orient_vel_seq[idx]

    world2aligned_rot = compute_align_mats(root_orient)

    return dict(
        fps=fps, gender=str(gender), floor_height=floor_height,
        contacts=contacts, trans=trans, root_orient=root_orient,
        pose_body=pose_body,
        pose_hand=(pose_hand if save_hand_pose else None),
        betas=betas, joints=joint_seq,
        mojo_verts=(vtx_seq if save_keypt_verts else None),
        joints_vel=joint_vel_seq,
        mojo_verts_vel=(vtx_vel_seq if save_keypt_verts else None),
        trans_vel=trans_vel_seq, root_orient_vel=root_orient_vel_seq,
        joint_orient_vel_seq=joint_orient_vel_seq,
        pose_body_vel=pose_body_vel_seq,
        world2aligned_rot=world2aligned_rot)


def process_amass_dir(amass_root: str, out_root: str, model,
                      datasets=None, log_fn=print):
    """Directory walk: <amass_root>/<dataset>/<subject>/*_poses.npz ->
    mirrored processed npz with the reference's `_%d_frames_%d_fps` suffix
    and already-processed skip (process_amass_data.py:560-625). Returns the
    list of written paths."""
    datasets = list(datasets) if datasets else ALL_DATASETS
    os.makedirs(out_root, exist_ok=True)
    written = []
    for name in datasets:
        data_dir = osp.join(amass_root, name)
        if not osp.isdir(data_dir):
            log_fn(f"could not find dataset {name} in raw AMASS data")
            continue
        out_dir = osp.join(out_root, name)
        os.makedirs(out_dir, exist_ok=True)
        for in_path in sorted(glob.glob(osp.join(data_dir, '*/*_poses.npz'))):
            subject = osp.basename(osp.dirname(in_path))
            os.makedirs(osp.join(out_dir, subject), exist_ok=True)
            out_base = osp.join(out_dir, subject, osp.basename(in_path))[:-4]
            if glob.glob(out_base + '*.npz'):
                log_fn(f"already processed, skipping: {in_path}")
                continue
            raw = dict(np.load(in_path, allow_pickle=True))
            # mislabeled-framerate corrections (:361-364)
            if 'BMLhandball' in in_path:
                raw['mocap_framerate'] = 240
            if ('20160930_50032' in in_path) or ('20161014_50033' in in_path):
                raw['mocap_framerate'] = 59
            out = process_amass_seq(raw, model, log_fn=log_fn)
            if out is None:
                continue
            path = out_base + '_%d_frames_%d_fps.npz' % (
                out['trans'].shape[0], int(out['fps']))
            np.savez(path, **{k: (v if v is not None else np.array([]))
                              for k, v in out.items()})
            written.append(path)
            log_fn(f"wrote {path}")
    return written


def cleanup_amass_data(data_root: str, backup_root: str, log_fn=print):
    """Move known-bad clips out of a processed tree: BioMotionLab_NTroje
    treadmill_/normal_ clips and MPI_HDM05 dg/HDM_dg_07-01* inline skating
    (cleanup_amass_data.py:17-78). Returns the moved paths."""
    moved = []
    ntroje = osp.join(data_root, 'BioMotionLab_NTroje')
    if osp.isdir(ntroje):
        for subj in sorted(os.listdir(ntroje)):
            subj_dir = osp.join(ntroje, subj)
            if not osp.isdir(subj_dir):
                continue
            for f in sorted(glob.glob(subj_dir + '/*.npz')):
                name = osp.basename(f)
                parts = name.split('_')
                if len(parts) > 1 and parts[1] in ('treadmill', 'normal'):
                    bk = osp.join(backup_root, 'BioMotionLab_NTroje', subj)
                    os.makedirs(bk, exist_ok=True)
                    shutil.move(f, osp.join(bk, name))
                    moved.append(f)
    else:
        log_fn("could not find BioMotionLab_NTroje data, skipping")
    hdm05 = osp.join(data_root, 'MPI_HDM05', 'dg')
    if osp.isdir(hdm05):
        for f in sorted(glob.glob(hdm05 + '/HDM_dg_07-01*')):
            bk = osp.join(backup_root, 'MPI_HDM05', 'dg')
            os.makedirs(bk, exist_ok=True)
            shutil.move(f, osp.join(bk, osp.basename(f)))
            moved.append(f)
    else:
        log_fn("could not find MPI_HDM05 dg subject, skipping")
    return moved


# --- window assembly for the HuMoR trainer -----------------------------------

def amass_world_states(seq: dict) -> np.ndarray:
    """Pack a processed sequence's per-frame world states into the 207-dim
    HuMoR state grid (models/humor.py STATE_FIELDS: trans 3 | trans_vel 3 |
    root_orient 3 | root_orient_vel 3 | pose_body 63 | joints 66 |
    joints_vel 66)."""
    T = np.asarray(seq['trans']).shape[0]
    return np.concatenate([
        np.asarray(seq['trans'], np.float32),
        np.asarray(seq['trans_vel'], np.float32),
        np.asarray(seq['root_orient'], np.float32),
        np.asarray(seq['root_orient_vel'], np.float32),
        np.asarray(seq['pose_body'], np.float32),
        np.asarray(seq['joints'], np.float32).reshape(T, -1),
        np.asarray(seq['joints_vel'], np.float32).reshape(T, -1),
    ], axis=1)


def amass_state_windows(seq: dict, num_frames: int,
                        stride: int = 1) -> np.ndarray:
    """Slide a (num_frames)-frame window over a processed sequence ->
    (N, num_frames, 207) world states (the deterministic-split subsequence
    map of amass_discrete_dataset.py:175-213 at frames_in=1/out=1)."""
    states = amass_world_states(seq)
    T = states.shape[0]
    if T < num_frames:
        return np.zeros((0, num_frames, states.shape[1]), np.float32)
    starts = np.arange(0, T - num_frames + 1, stride)
    return np.stack([states[s:s + num_frames] for s in starts])


def canonicalize_windows(windows: np.ndarray, device=None) -> np.ndarray:
    """Express each (N, T, 207) world-state window in its first frame's
    aligned-local frame, the trainer feed convention (the per-window twin
    of amass_discrete_dataset.py:428-436's world2aligned alignment, through
    models/humor.canonicalize_state), in one batched call on ``device``:
    each window's transform repeated over its T frames."""
    from ..models.humor import apply_world2local_state, canonicalize_state

    w = torch.as_tensor(np.asarray(windows, np.float32), device=device)
    N, T, D = w.shape
    with torch.no_grad():
        _, rot, trans = canonicalize_state(w[:, 0])
        # root joint xy of frame 0: the joints field starts at offset
        # 3+3+3+3+63 = 75 in the packed state
        t2j_xy = -(w[:, 0, 75:77] + trans[:, :2])
        t2j = torch.cat([t2j_xy, torch.zeros_like(t2j_xy[:, :1])], dim=1)
        out = apply_world2local_state(
            w.reshape(N * T, D), rot.repeat_interleave(T, dim=0),
            trans.repeat_interleave(T, dim=0),
            t2j.repeat_interleave(T, dim=0)).reshape(N, T, D)
    return out.cpu().numpy()


def load_amass_windows(processed_root: str, num_frames: int,
                       split: str = "train", stride: int = 10,
                       canonicalize: bool = True,
                       max_windows: int = 0, device=None) -> np.ndarray:
    """Walk a processed AMASS tree and assemble the (N, T, 207) training
    window tensor the HuMoR trainer consumes (cli/humor_tool.py train),
    canonicalized on ``device``."""
    out = []
    total = 0
    for d in amass_split_dirs(processed_root, split):
        for path in sorted(glob.glob(osp.join(d, '*/*.npz'))):
            seq = np.load(path, allow_pickle=True)
            w = amass_state_windows(seq, num_frames, stride=stride)
            if w.shape[0] == 0:
                continue
            out.append(w)
            total += w.shape[0]
            if max_windows and total >= max_windows:
                break
        if max_windows and total >= max_windows:
            break
    if not out:
        return np.zeros((0, num_frames, 207), np.float32)
    windows = np.concatenate(out, axis=0)
    if max_windows:
        windows = windows[:max_windows]
    if canonicalize:
        windows = canonicalize_windows(windows, device)
    return windows


# --- fitting observations (AMASSFitDataset) ----------------------------------

def amass_split_dirs(processed_root: str, split: str):
    """Dataset directories for a HuMoR split name
    (process_amass_data.py:42-45)."""
    table = {"train": TRAIN_DATASETS, "val": VAL_DATASETS,
             "test": TEST_DATASETS, "all": ALL_DATASETS}
    return [osp.join(processed_root, d) for d in table[split]
            if osp.isdir(osp.join(processed_root, d))]


def resize_points(points_arr: np.ndarray, num_pts: int,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random subsample or wrap-pad to exactly num_pts rows
    (fitting_utils.py:39-58); a copy of nemo_tpu/data/humor_rgb.py's."""
    rng = rng or np.random.default_rng()
    N = points_arr.shape[0]
    if N > num_pts:
        return points_arr[rng.choice(N, size=num_pts, replace=False)]
    while N < num_pts:
        pad = min(num_pts - N, N)
        points_arr = np.concatenate([points_arr, points_arr[:pad]], axis=0)
        N = points_arr.shape[0]
    return points_arr


# root_only keeps hips/neck/head/leftArm/rightArm observed
# (amass_fit_dataset.py:90-93 via SMPL_JOINTS names)
ROOT_ONLY_KEPT_JOINTS = (0, 12, 15, 16, 17)


def sample_surface_points(verts: np.ndarray, faces: np.ndarray,
                          num_pts: int, rng) -> np.ndarray:
    """Area-weighted uniform surface sampling — the trimesh
    sample_surface twin amass_fit_dataset.py:108-117 relies on.
    verts (V, 3), faces (F, 3) -> (num_pts, 3)."""
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    p = area / max(area.sum(), 1e-12)
    fi = rng.choice(len(faces), size=num_pts, p=p)
    r1 = np.sqrt(rng.random(num_pts))[:, None]
    r2 = rng.random(num_pts)[:, None]
    return (1.0 - r1) * v0[fi] + r1 * (1.0 - r2) * v1[fi] + r1 * r2 * v2[fi]


def amass_fit_observations(seq: dict, model=None, seq_len: int = 60,
                           start: int = 0,
                           return_joints: bool = True,
                           return_verts: bool = True,
                           return_points: bool = False,
                           noise_std: float = 0.0,
                           make_partial: bool = False,
                           partial_height: float = 0.75,
                           drop_middle: bool = False,
                           num_samp_pts: int = 512,
                           root_only: bool = False,
                           seed: int = 0):
    """Observed/GT pair for 3D fitting from one processed AMASS sequence —
    the AMASSFitDataset.__getitem__ surface (amass_fit_dataset.py:70-155):
    clean joints3d / keypoint-marker verts3d / surface-sampled points3d
    observations with optional gaussian noise, height-occlusion
    (non-finite marks occluded, visible points re-sampled to num_samp_pts),
    middle-third dropout, and root-only joint masking. The observed dict
    feeds humor_motion_fit(obs3d=...); points3d requires `model` for the
    full-vertex forward. Returns (observed_dict, gt_dict)."""
    rng = np.random.default_rng(seed)
    sl = slice(start, start + seq_len)
    gt = {k: np.asarray(seq[k], np.float32)[sl]
          for k in ("trans", "root_orient", "pose_body", "joints",
                    "contacts") if k in seq}
    T = gt["trans"].shape[0]
    gt["betas"] = np.asarray(seq["betas"], np.float32)
    if "mojo_verts" in seq and np.asarray(seq["mojo_verts"]).size:
        gt["verts"] = np.asarray(seq["mojo_verts"], np.float32)[sl]

    observed = {}
    if return_joints:
        j = gt["joints"].copy()
        if root_only:
            mask = np.ones(j.shape[1], bool)
            mask[list(ROOT_ONLY_KEPT_JOINTS)] = False
            j[:, mask] = np.inf
        observed["joints3d"] = j
    if return_verts and "verts" in gt:
        observed["verts3d"] = gt["verts"].copy()
    if return_points:
        if model is None:
            raise ValueError("points3d observations need the SMPL model")
        nb = model.shapedirs.shape[-1]
        b = np.zeros(nb, np.float32)
        k = min(nb, gt["betas"].shape[0], NUM_BETAS)
        b[:k] = gt["betas"][:k]
        verts = _full_verts(model, gt["pose_body"], gt["root_orient"],
                            np.repeat(b[None], T, axis=0), gt["trans"])
        gt["points"] = verts
        observed["points3d"] = np.stack(
            [sample_surface_points(verts[t], model.faces, num_samp_pts,
                                   rng) for t in range(T)]).astype(
                                       np.float32)

    if noise_std > 0.0:
        for k in observed:
            observed[k] = observed[k] + noise_std * rng.standard_normal(
                observed[k].shape).astype(np.float32)

    if make_partial:
        for k in list(observed.keys()):
            if k == "joints3d" and root_only:
                continue
            occ = observed[k][:, :, 2:3] < partial_height
            observed[k] = np.where(occ, np.inf, observed[k])
            if k == "points3d":
                pts = observed[k]
                for t in range(T):
                    vis = pts[t][np.isfinite(pts[t]).all(-1)]
                    if vis.shape[0] == 0:
                        vis = np.zeros((1, 3), np.float32)
                    pts[t] = resize_points(vis.reshape(-1, 3),
                                           num_samp_pts, rng)
                observed[k] = pts

    if drop_middle:
        sidx = seq_len // 3
        eidx = sidx + seq_len // 3
        for k in observed:
            observed[k][sidx:eidx] = np.inf

    # (contacts are already full NUM_JOINTS-wide in the processed npz —
    # determine_floor_height_and_contacts scatters them; the reference's
    # final CONTACT_INDS scatter, amass_fit_dataset.py:150-154, is a no-op
    # for this layout)
    return observed, gt
