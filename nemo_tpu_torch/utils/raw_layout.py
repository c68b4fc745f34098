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

The HuMoR video fits (``cli/humor_tool.py fit-rgb`` and ``fit-prox``)
read two more layouts:

  * ``write_video_keypoints``: one video's OpenPose directory (one person,
    some frames empty) and, optionally, its frames as JPEGs;
  * ``write_prox_tree``: a PROX tree, by default a quantitative one: one
    ``vicon_*`` recording with ``Color``, ``BodyIndexColor`` and 16-bit
    ``Depth`` frames, the keypoints, the Kinect ``IR.json`` /
    ``Color.json`` calibration (``kinect_calibration`` makes one),
    ``cam2world``, ``vicon2scene.json`` and the MoSh fit pickles (the
    qualitative layout puts the fits under ``PROXD``).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from . import pickles


def write_openpose_dir(path: str, people: Sequence[Sequence[np.ndarray]],
                       person_ids: Optional[Sequence[Sequence[int]]] = None
                       ) -> str:
    """One view's OpenPose JSON directory. people[f] lists frame f's
    detections, each a (25, 3) array (person 0 first); an empty list
    writes a frame with nobody. Values are written as float32. With
    person_ids (parallel to people), each detection carries its tracked
    id, as STAF's output does; else [-1], plain OpenPose's."""
    os.makedirs(path, exist_ok=True)
    for f, dets in enumerate(people):
        ids = person_ids[f] if person_ids is not None else [-1] * len(dets)
        rec = {"version": 1.3, "people": [
            {"person_id": [int(i)],
             "pose_keypoints_2d": np.asarray(d, np.float32).ravel().tolist()}
            for d, i in zip(dets, ids)]}
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


def write_video_keypoints(path: str, kp2d: np.ndarray,
                          empty: Sequence[int] = (),
                          frames_dir: Optional[str] = None,
                          frame_hw=(1080, 1920)) -> str:
    """One video's OpenPose directory from (F, 25, 3) keypoints, the frames
    in ``empty`` with nobody (write_openpose_dir's layout). With
    frames_dir, also the F video frames as ``NNNNNN.jpg`` of frame_hw (H,
    W): a smooth colour ramp that moves with the frame index."""
    kp2d = np.asarray(kp2d, np.float32)
    skip = set(int(f) for f in empty)
    write_openpose_dir(path, [[] if f in skip else [kp2d[f]]
                              for f in range(kp2d.shape[0])])
    if frames_dir is not None:
        from PIL import Image
        os.makedirs(frames_dir, exist_ok=True)
        H, W = frame_hw
        ramp = (np.arange(W, dtype=np.float32)[None] / W
                + np.arange(H, dtype=np.float32)[:, None] / H)
        for f in range(kp2d.shape[0]):
            img = np.stack([ramp * 0.5, np.full_like(ramp, f / kp2d.shape[0]),
                            1.0 - ramp * 0.5], axis=-1)
            Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)
                            ).save(os.path.join(frames_dir, f"{f:06d}.jpg"))
    return path


def kinect_calibration() -> Dict[str, Dict]:
    """A Kinect v2 calibration pair in PROX's IR.json / Color.json fields:
    camera_mtx, k (Brown-Conrady), view_mtx [R | t], R, T. The depth
    camera is 512 x 424 at the origin; the colour camera 1920 x 1080,
    turned 0.03 rad about z and 5 cm to the side."""
    def cam(fx, fy, cx, cy, k, view_R, view_t, R, T):
        return {"camera_mtx": [[fx, 0, cx], [0, fy, cy], [0, 0, 1]],
                "k": list(k),
                "view_mtx": np.concatenate(
                    [view_R, np.asarray(view_t).reshape(3, 1)],
                    axis=1).tolist(),
                "R": R, "T": T}
    depth = cam(360., 362., 256., 212., [0.09, -0.27, 1e-4, -2e-4, 0.09],
                np.eye(3), [0., 0., 0.], np.eye(3).tolist(), [0., 0., 0.])
    ang = 0.03
    Rz = np.array([[np.cos(ang), -np.sin(ang), 0],
                   [np.sin(ang), np.cos(ang), 0], [0, 0, 1.]])
    color = cam(1060., 1061., 960., 540., [0.04, -0.1, 5e-5, -1e-4, 0.02],
                Rz, [0.05, -0.002, 0.01], Rz.tolist(), [0.052, 0.0, 0.011])
    return {"depth_cam": depth, "color_cam": color}


def write_prox_tree(root: str, kp2d: np.ndarray,
                    depth: Callable[[int], np.ndarray],
                    mask: Callable[[int], np.ndarray],
                    fits: Sequence[Optional[Dict[str, np.ndarray]]],
                    recording: str = "vicon_03301_01",
                    quant: bool = True) -> str:
    """A PROX tree under root/quantitative (root/qualitative with quant
    False) for T = len(kp2d) frames named ``s000_frame_NNNNN``: 8 x 8
    Color JPEGs (the fits read only their names), the BodyIndexColor
    mask(t) (uint8, 0 on the person) and the 16-bit Depth depth(t)
    (Kinect units, mm x 8) as PNGs, OpenPose keypoints kp2d[t], IR.json /
    Color.json from kinect_calibration(), cam2world/<scene>.json (a
    translation), vicon2scene.json, and fits[t] (MoSh {transl, betas,
    body_pose, global_orient} arrays) as
    <fits>/<recording>/results/<frame>/000.pkl (fittings/mosh, or PROXD
    when qualitative), none where fits[t] is None. Returns root."""
    from PIL import Image
    data = os.path.join(root, "quantitative" if quant else "qualitative")
    rec = os.path.join(data, "recordings", recording)
    for sub in ("Color", "BodyIndexColor", "Depth"):
        os.makedirs(os.path.join(rec, sub), exist_ok=True)
    kp_dir = os.path.join(data, "keypoints", recording)
    for d in (kp_dir, os.path.join(data, "calibration"),
              os.path.join(data, "cam2world")):
        os.makedirs(d, exist_ok=True)
    calib = kinect_calibration()
    for name, c in (("IR", calib["depth_cam"]),
                    ("Color", calib["color_cam"])):
        with open(os.path.join(data, "calibration", name + ".json"),
                  "w") as f:
            json.dump(c, f)
    cam2world = np.eye(4)
    cam2world[:3, 3] = [0.3, -0.2, 1.0]
    scene = recording.split("_")[0]
    with open(os.path.join(data, "cam2world", scene + ".json"), "w") as f:
        json.dump(cam2world.tolist(), f)
    with open(os.path.join(data, "vicon2scene.json"), "w") as f:
        json.dump(np.eye(4).tolist(), f)
    color = Image.fromarray(np.zeros((8, 8, 3), np.uint8))
    fit_root = os.path.join(data, *(("fittings", "mosh") if quant
                                    else ("PROXD",)), recording, "results")
    for t in range(len(kp2d)):
        name = "s%03d_frame_%05d" % (0, t)
        color.save(os.path.join(rec, "Color", name + ".jpg"))
        Image.fromarray(np.asarray(mask(t), np.uint8)).save(
            os.path.join(rec, "BodyIndexColor", name + ".png"))
        Image.fromarray(np.asarray(depth(t), np.uint16)).save(
            os.path.join(rec, "Depth", name + ".png"))
        with open(os.path.join(kp_dir, name + "_keypoints.json"), "w") as f:
            json.dump({"people": [{"pose_keypoints_2d": np.asarray(
                kp2d[t], np.float64).reshape(-1).tolist()}]}, f)
        if fits[t] is not None:
            d = os.path.join(fit_root, name)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "000.pkl"), "wb") as f:
                pickle.dump(fits[t], f)
    return root
