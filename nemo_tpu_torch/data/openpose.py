"""OpenPose BODY_25 JSON ingestion, GT 2D pickles and GT camera files
(port of nemo_tpu/data/openpose.py; numpy only).

Behavioral reference: nemo/multi_view_sequence.py's per-frame JSON loading
(``..._openpose/NNNNNN_keypoints.json`` with ``people[0].pose_keypoints_2d``),
including the empty-frame handling (:422-425: no detected people -> zeros
with confidence 0).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

# views parsed by each route of load_openpose_dir since the last reset:
# 'native' (the C++ batch parser) or 'json' (the json module)
PARSER_CALLS: Dict[str, int] = {"native": 0, "json": 0}


def reset_parser_calls() -> None:
    for k in PARSER_CALLS:
        PARSER_CALLS[k] = 0


def parse_openpose_json(path: str, person: int = 0) -> np.ndarray:
    """One frame's keypoints: (25, 3) [x, y, confidence]; zeros if empty."""
    with open(path) as f:
        data = json.load(f)
    people = data.get("people", [])
    if not people:
        return np.zeros((25, 3), np.float32)
    kp = np.asarray(people[person]["pose_keypoints_2d"], np.float32)
    return kp.reshape(-1, 3)[:25]


def openpose_json_paths(dirpath: str,
                        num_frames: Optional[int] = None) -> List[str]:
    """A view's keypoint files, sorted by name (the first num_frames)."""
    names = sorted(n for n in os.listdir(dirpath) if n.endswith(".json"))
    if num_frames is not None:
        names = names[:num_frames]
    return [os.path.join(dirpath, n) for n in names]


def load_openpose_dir(dirpath: str, num_frames: Optional[int] = None,
                      use_native: bool = True) -> np.ndarray:
    """All frames of one view: (F, 25, 3), sorted by filename.

    Uses the C++ batch parser (ops.native) when its library builds, else
    the json module; PARSER_CALLS records which one ran.
    """
    paths = openpose_json_paths(dirpath, num_frames)
    if use_native:
        from ..ops.native import get_native, parse_openpose_batch_native
        if get_native() is not None:
            PARSER_CALLS["native"] += 1
            return parse_openpose_batch_native(paths)
    PARSER_CALLS["json"] += 1
    return np.stack([parse_openpose_json(p) for p in paths])


def read_posetrack_keypoints(dirpath: str,
                             num_frames: Optional[int] = None):
    """STAF-tracked OpenPose JSONs -> per-person keypoint tracklets
    {pid: {'joints2d': (T, 25, 3), 'frames': (T,)}}.

    Behavioral reference: VIBE/lib/utils/pose_tracker.py:85-115. Detections
    without a tracked id (person_id [-1], plain OpenPose output) take their
    index within the frame.
    """
    people: dict = {}
    for idx, path in enumerate(openpose_json_paths(dirpath, num_frames)):
        with open(path) as f:
            data = json.load(f)
        for j, person in enumerate(data.get("people", [])):
            pid = person.get("person_id", [-1])
            pid = int(pid[0] if isinstance(pid, (list, tuple)) else pid)
            if pid < 0:
                pid = j
            kp = np.asarray(person["pose_keypoints_2d"],
                            np.float32).reshape(-1, 3)[:25]
            entry = people.setdefault(pid, {"joints2d": [], "frames": []})
            entry["joints2d"].append(kp)
            entry["frames"].append(idx)
    return {pid: {"joints2d": np.stack(p["joints2d"]),
                  "frames": np.asarray(p["frames"])}
            for pid, p in people.items()}


def flip_horizontal(pose2d: np.ndarray, width: float) -> np.ndarray:
    """Mirror keypoints left-right with the L/R joint permutation
    (nemo/utils/misc_utils.py:60-88)."""
    from ..body.constants import OP25_FLIP_PERM
    out = pose2d.copy()
    out[..., 0] = width / 2 + (width / 2 - out[..., 0])
    return out[..., OP25_FLIP_PERM, :]


def load_gt2d_pkl_dir(dirpath: str,
                      num_frames: Optional[int] = None) -> np.ndarray:
    """GT-2D annotation directory -> (F, 25, 3) in OpenPose layout.

    The NeMo-MoCap layout (multi_view_sequence.py:336-344, 429-435):
    ``<view>_gt_new/NNNNNN_keypoints.pkl``, each a joblib pickle of shape
    (P, K, 2); person 0's first 15 joints get confidence 1 and are
    zero-padded to 25 rows.
    """
    from ..utils import pickles

    names = sorted(n for n in os.listdir(dirpath) if n.endswith(".pkl"))
    if num_frames is not None:
        names = names[:num_frames]
    out = []
    for n in names:
        arr = np.asarray(pickles.load(os.path.join(dirpath, n)),
                         dtype=np.float32)
        kp = np.concatenate([arr[0, :15, :2], np.ones((15, 1), np.float32)],
                            axis=1)
        out.append(np.concatenate([kp, np.zeros((10, 3), np.float32)],
                                  axis=0))
    return np.stack(out)


def load_gt_camera_pt(path: str):
    """A NeMo-MoCap GT camera file -> (cam9 (9,), focal_length).

    The on-disk formats (multi_view_sequence.py:402-409,
    nemomocap_utils.py:205-211): a joblib dict {'rot6d', 'tran', 'K'} from
    the re-optimised fit (cam9 = [tran, rot6d], focal K[0, 0]), or a
    torch.save of (learned_cameras (9,) as a tensor or array, focal_length
    as a number or tensor).
    """
    try:
        from ..utils import pickles
        data = pickles.load(path)
        if isinstance(data, dict) and "rot6d" in data:
            cam9 = np.concatenate([
                np.asarray(data["tran"], np.float32).reshape(3),
                np.asarray(data["rot6d"], np.float32).reshape(6)])
            K = np.asarray(data.get("K"), np.float32)
            f = float(K.reshape(3, 3)[0, 0]) if K is not None else 5000.0
            return cam9, f
    except Exception:
        pass
    import torch
    cams, focal = torch.load(path, map_location="cpu", weights_only=False)
    cams = np.asarray(cams.detach().cpu().numpy()
                      if hasattr(cams, "detach") else cams, np.float32)
    if hasattr(focal, "item"):
        focal = focal.item() if focal.numel() == 1 else float(
            np.asarray(focal.detach().cpu().numpy()).reshape(-1)[0])
    return cams.reshape(-1)[:9], float(focal)
