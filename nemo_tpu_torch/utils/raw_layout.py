"""Write an action's raw per-view files in the reference's layouts.

The preprocessing CLI (``cli/preprocess.py``) packs these files into a
bundle; the doctor (``cli/doctor.py``) checks them. Real ones come from
OpenPose, VIBE, PARE, GLAMR and MoSh runs on recorded video. These writers
put arrays into the same layouts, so that the packer and the doctor run end
to end from data made in memory:

  * ``write_openpose_dir``: ``NNNNNN_keypoints.json`` per frame, with
    ``people[i].pose_keypoints_2d`` (75 floats, BODY_25) and an empty
    ``people`` list where a frame has nobody;
  * ``write_gt_new_dir``: ``<view>_gt_new/NNNNNN_keypoints.pkl``, joblib
    (P, K, 2) arrays, 1-indexed;
  * ``write_pickle``: a joblib pickle (a vibe_output.pkl of tracklets
    {'pose', 'betas', 'joints2d_img_coord', 'frame_ids', ...}, a PARE or
    GLAMR output, a MoSh ``{'fullpose', 'trans'}`` mocap file);
  * ``write_camera``: a GT camera as a packed ``.npy`` (9,), a torch
    ``(learned_cameras, focal)`` ``.pt`` or a joblib ``{'rot6d', 'tran',
    'K'}``;
  * ``write_action_yaml``: the per-action YAML (exp_dir + videos.names, or
    a Penn Action seq_names list).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from . import pickles


def write_openpose_dir(path: str, people: Sequence[Sequence[np.ndarray]]
                       ) -> str:
    """One view's OpenPose JSON directory. people[f] lists frame f's
    detections, each a (25, 3) array (person 0 first); an empty list
    writes a frame with nobody. Values are written as float32."""
    os.makedirs(path, exist_ok=True)
    for f, dets in enumerate(people):
        rec = {"version": 1.3, "people": [
            {"person_id": [-1],
             "pose_keypoints_2d": np.asarray(d, np.float32).ravel().tolist()}
            for d in dets]}
        with open(os.path.join(path, f"{f:06d}_keypoints.json"), "w") as fh:
            json.dump(rec, fh)
    return path


def write_gt_new_dir(path: str, kp2d: np.ndarray) -> str:
    """A ``_gt_new`` directory from (F, P, K, 2) keypoints, 1-indexed."""
    os.makedirs(path, exist_ok=True)
    for f, arr in enumerate(np.asarray(kp2d, np.float32)):
        pickles.dump(arr, os.path.join(path, f"{f + 1:06d}_keypoints.pkl"))
    return path


def write_pickle(path: str, obj) -> str:
    """A joblib pickle (the reference dumps its outputs with joblib;
    utils.pickles writes the format)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return pickles.dump(obj, path)


def write_camera(path: str, cam9: np.ndarray, focal: float = 5000.0) -> str:
    """A GT camera file for cam9 = [tran (3), rot6d (6)], in the format
    its extension names: .npy the packed vector, .pt a torch
    (learned_cameras, focal) pair, anything else a joblib
    {'rot6d', 'tran', 'K'}."""
    cam9 = np.asarray(cam9, np.float32).reshape(9)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith(".npy"):
        np.save(path, cam9)
    elif path.endswith(".pt"):
        import torch
        torch.save((torch.from_numpy(cam9.copy()), torch.tensor(focal)),
                   path)
    else:
        K = np.array([[focal, 0, 0], [0, focal, 0], [0, 0, 1]], np.float32)
        write_pickle(path, {"rot6d": cam9[3:], "tran": cam9[:3], "K": K})
    return path


def write_action_yaml(path: str, exp_dir: Optional[str] = None,
                      names: Optional[Sequence[str]] = None,
                      seq_names: Optional[Sequence[str]] = None) -> str:
    """The per-action YAML: exp_dir + videos.names, or seq_names."""
    import yaml
    if seq_names is not None:
        cfg: Dict = {"seq_names": list(seq_names)}
    else:
        cfg = {"exp_dir": exp_dir, "videos": {"names": list(names)}}
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path
