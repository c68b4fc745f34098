"""VIBE output ingestion: tracklet pickles -> dense per-frame arrays (port
of nemo_tpu/data/vibe.py; numpy, with PARE's rotation matrices converted
by the port's geometry.rotations.rotmat_to_aa on the CPU).

Behavioral reference: nemo/multi_view_sequence.py:30-89 —
prepare_person_dict scatters a tracklet's frames into dense (max_frames, ...)
arrays with a validity mask; select_person_at_center picks the tracked
person whose mean 2D joints are closest to the GT 2D center.

A vibe_output.pkl maps person-id -> dict with keys like 'pose' (F, 72),
'betas', 'joints3d', 'joints2d_img_coord'/'smpl_joints2d', 'frame_ids'.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def densify_person(person: Dict[str, np.ndarray], max_frames: int
                   ) -> Dict[str, np.ndarray]:
    """Scatter one tracklet into dense (max_frames, ...) arrays + 'mask'."""
    out: Dict[str, np.ndarray] = {}
    frame_ids = np.asarray(person["frame_ids"])
    for key, val in person.items():
        if key in ("betas", "frame_ids") or val is None:
            if val is not None:
                out[key] = np.asarray(val)
            continue
        val = np.asarray(val)
        dense = np.zeros((max_frames,) + val.shape[1:], np.float32)
        dense[frame_ids] = val
        out[key] = dense
    mask = np.zeros(max_frames, np.float32)
    mask[frame_ids] = 1.0
    out["mask"] = mask
    return out


def select_person_near_gt(people: Dict, gt_2d: np.ndarray
                          ) -> Optional[Dict[str, np.ndarray]]:
    """Pick the person whose joint-center track best matches the GT 2D.

    people: {pid: densified person dict}; gt_2d: (F, K, >=2).
    """
    if not people:
        return None
    gt_centers = gt_2d[..., :2].mean(1)            # (F, 2)
    best, best_dist = None, np.inf
    for pid, person in people.items():
        j2d = person.get("joints2d_img_coord",
                         person.get("smpl_joints2d"))
        if j2d is None:
            continue
        centers = j2d[:, :15, :2].mean(1)
        m = person["mask"]
        dist = (np.sqrt(((centers - gt_centers) ** 2).sum(-1)) * m).sum() \
            / max(m.sum(), 1)
        if dist < best_dist:
            best, best_dist = person, dist
    return best


def load_vibe_pickle(path, max_frames: int,
                     gt_2d: Optional[np.ndarray] = None
                     ) -> Optional[Dict[str, np.ndarray]]:
    """Load vibe_output.pkl, densify all tracklets and select one person.

    The reference dumps it with joblib (utils.pickles reads the format).
    `path` may also be an already-loaded vibe dict (callers that probe the
    pickle for emptiness first can pass it through without re-reading).
    If gt_2d is None, the longest tracklet wins.
    """
    from ..utils import pickles
    raw = path if isinstance(path, dict) else pickles.load(path)
    people = {pid: densify_person(p, max_frames) for pid, p in raw.items()}
    if not people:
        return None
    if gt_2d is not None:
        return select_person_near_gt(people, gt_2d)
    return max(people.values(), key=lambda p: p["mask"].sum())


def vibe_to_theta(person: Dict[str, np.ndarray]) -> np.ndarray:
    """(F, 70): body pose 69 + validity column, the reference's 'pose' layout
    consumed at neural_motion_model.py:3444-3447 (theta = pose[:, 3:-1])."""
    pose = person["pose"]          # (F, 72) full axis-angle incl. orient
    mask = person["mask"][:, None]
    return np.concatenate([pose[:, 3:], mask], axis=1)


def person_joints2d(person: Dict[str, np.ndarray],
                    n_joints: int = 25) -> Optional[np.ndarray]:
    """(F, n_joints, 3) image-space 2D keypoints + validity confidence.

    The reference stores the tracklet's 'joints2d_img_coord' (SPIN-49
    layout whose first 25 rows are the OpenPose joints) as the per-view
    'vibe_joints2d' label consumed by collate_gt_2d(label_type='vibe')
    (multi_view_sequence.py:327,442-443; neural_motion_model.py:2921-2922).
    The confidence column is the tracklet mask (eval only reads [..., :2]).
    """
    j2d = person.get("joints2d_img_coord", person.get("smpl_joints2d"))
    if j2d is None:
        return None
    j2d = np.asarray(j2d, np.float32)[:, :n_joints, :2]
    conf = np.broadcast_to(person["mask"][:, None, None],
                           j2d.shape[:2] + (1,))
    return np.concatenate([j2d, conf.astype(np.float32)], axis=-1)


def vibe_render_arrays(person: Dict[str, np.ndarray]
                       ) -> Optional[Dict[str, np.ndarray]]:
    """VIBE's own render inputs from a densified person dict.

    Returns {'orient': (F, 3), 'betas': (10,), 'orig_cam': (F, 4)} — the
    per-view slots backing the baseline-rollout figure (the reference keeps
    'vibe_cam'/'vibe_verts' in each sequence dict and renders them in
    render_vibe_rollout, neural_motion_model.py:1457-1462; we keep the
    compact cam + mean betas and re-skin instead of storing verts).
    None when the pickle carries no orig_cam (older VIBE dumps).
    """
    cam = person.get("orig_cam")
    if cam is None:
        return None
    pose = np.asarray(person["pose"], np.float32)       # (F, 72)
    betas = np.asarray(person.get("betas", np.zeros(10)), np.float32)
    return {"orient": pose[:, :3],
            "betas": betas.reshape(-1, 10).mean(0),
            "orig_cam": np.asarray(cam, np.float32)}


def load_baseline_arrays(path: str, max_frames: int, kind: str,
                         gt_2d: Optional[np.ndarray] = None
                         ) -> Optional[Dict[str, np.ndarray]]:
    """A 3D-baseline pickle -> per-frame arrays for the eval columns.

    The reference's commented-out loader slots
    (multi_view_sequence.py:336-392):
      * 'vs'    — VIBE+SMPLify: vibe_output.pkl layout, last person entry
      * 'pare'  — PARE: vibe-like dict but 'pose' holds rotation MATRICES
                  (F, 24, 3, 3), converted to axis-angle (:360-366)
      * 'glamr' — GLAMR grecon pkl: {'person_data': [{'smpl_pose' (F, 69),
                  'smpl_orient_cam', 'root_trans_cam', 'kp_2d', ...}]}
                  (:378-392); orient/trans feed rigid_transform_to_gt's
                  world baseline (neural_motion_model.py:1557-1577)

    Returns {'theta': (F, 70) body pose + validity mask,
             'joints2d': (F, 25, 3) image 2D + conf or None,
             'orient': (F, 3) or None, 'trans': (F, 3) or None}.
    """
    from ..utils import pickles

    data = pickles.load(path)
    joints2d = orient = trans = None
    if kind == "glamr":
        pd_ = data["person_data"][0]
        pose = np.asarray(pd_["smpl_pose"], np.float32)[:max_frames]
        if pose.shape[1] == 72:
            pose = pose[:, 3:]
        mask = np.ones((pose.shape[0], 1), np.float32)
        out = np.concatenate([pose, mask], axis=1)
        if "smpl_orient_cam" in pd_:
            orient = np.asarray(pd_["smpl_orient_cam"],
                                np.float32)[:max_frames]
        if "root_trans_cam" in pd_:
            trans = np.asarray(pd_["root_trans_cam"],
                               np.float32)[:max_frames]
        if "kp_2d" in pd_:
            kp = np.asarray(pd_["kp_2d"], np.float32)[:max_frames]
            pad_j = np.zeros((kp.shape[0], 25, 3), np.float32)
            pad_j[:, :min(25, kp.shape[1]), :kp.shape[2]] = \
                kp[:, :25, :3]
            joints2d = pad_j
    else:
        person = None
        if kind == "vs":
            # the reference indexes the LAST tracklet (:343 vs_output[-1])
            key = sorted(data.keys())[-1]
            person = densify_person(data[key], max_frames)
        else:  # pare
            person = (select_person_near_gt(
                {k: densify_person(v, max_frames) for k, v in data.items()},
                gt_2d) if gt_2d is not None else
                densify_person(data[sorted(data.keys())[0]], max_frames))
        if person is None:
            return None
        pose = np.asarray(person["pose"], np.float32)
        if pose.ndim >= 3 or pose.shape[-1] == 24 * 9:
            # PARE stores rotmats; convert through the quaternion path
            import torch
            from ..geometry.rotations import rotmat_to_aa
            R = torch.from_numpy(pose.reshape(max_frames, 24, 3, 3).copy())
            pose = rotmat_to_aa(R).numpy().reshape(max_frames, 72)
        mask = person["mask"].reshape(-1, 1).astype(np.float32)
        out = np.concatenate([pose[:, 3:], mask], axis=1)
        joints2d = person_joints2d(person)
    if out.shape[0] < max_frames:
        pad = np.zeros((max_frames - out.shape[0], 70), np.float32)
        out = np.concatenate([out, pad], axis=0)

    def _pad(a):
        if a is None or a.shape[0] >= max_frames:
            return None if a is None else a[:max_frames]
        return np.concatenate(
            [a, np.zeros((max_frames - a.shape[0],) + a.shape[1:],
                         np.float32)], axis=0)
    return {"theta": out, "joints2d": _pad(joints2d),
            "orient": _pad(orient), "trans": _pad(trans)}


def load_baseline_pickle(path: str, max_frames: int, kind: str,
                         gt_2d: Optional[np.ndarray] = None
                         ) -> Optional[np.ndarray]:
    """Back-compat wrapper: just the (F, 70) theta of load_baseline_arrays."""
    arrays = load_baseline_arrays(path, max_frames, kind, gt_2d)
    return None if arrays is None else arrays["theta"]
