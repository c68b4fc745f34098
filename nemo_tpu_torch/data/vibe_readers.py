"""Per-dataset VIBE training-db readers: MPII-3DHP, PoseTrack, InstaVariety,
AMASS, H36M and NeMo-MoCap (port of nemo_tpu/data/vibe_readers.py).

Behavioral references:
  * VIBE/lib/data_utils/mpii3d_utils.py:79-190 (annot.mat parsing, segment
    splitting on offscreen joints, kp-extent bboxes, root-centering),
  * VIBE/lib/data_utils/posetrack_utils.py:33-160 (per-track json grouping,
    min-8-frame filter, tlwh->center bbox with 0.8*max(w,h)),
  * VIBE/lib/data_utils/insta_utils.py:102-178,246-334 (tfrecord Example
    fields, kps = [xys;vis] ++ face_pts ++ toe_pts, insta->spin),
  * VIBE/lib/data_utils/amass_utils.py:41-121 (25 fps subsampling,
    joints_to_use, theta = pose72 ++ betas10, min-60-frame filter),
  * VIBE/lib/data_utils/h36m_train_utils.py:160-470 (h36m_idx/global_idx
    SPIN scatter, mm->m, mosh SLERP 5x upsample + root flip),
  * VIBE/lib/data_utils/img_utils.py:281-299 (get_bbox_from_kp2d).

The InstaVariety reader includes a from-scratch TFRecord + tf.train.Example
wire-format parser (pure python/numpy) because TensorFlow is not a
dependency of this framework; the reference needs a full TF session for the
same bytes. Everything here is host-side numpy; joblib files are read
through `utils/pickles`. The SMPL joints a reader can take
(`smpl_joints_fn`) come from the caller, e.g. the port's `smpl_forward`.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import struct
from glob import glob
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .keypoints import POSETRACK_ORIGINAL_NAMES, VOCAB, convert_kps
from .vibe_db import VibeDbBuilder

# ---------------------------------------------------------------------------
# bbox helper (img_utils.py:281-299)


def bbox_from_kp2d(kp_2d: np.ndarray) -> np.ndarray:
    """Keypoint-extent square bbox [cx, cy, w, h], w=h=1.1*max-extent
    (get_bbox_from_kp2d). kp_2d: (J, >=2) or (N, J, >=2)."""
    kp_2d = np.asarray(kp_2d)
    single = kp_2d.ndim == 2
    if single:
        kp_2d = kp_2d[None]
    ul = kp_2d[..., :2].min(axis=1)
    lr = kp_2d[..., :2].max(axis=1)
    w, h = lr[:, 0] - ul[:, 0], lr[:, 1] - ul[:, 1]
    side = np.maximum(w, h) * 1.1
    c = ul + np.stack([w, h], 1) / 2
    out = np.stack([c[:, 0], c[:, 1], side, side], 1)
    return out[0] if single else out


# ---------------------------------------------------------------------------
# TFRecord / tf.train.Example wire-format parsing (pure python)


def _read_varint(buf: bytes, pos: int):
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one protobuf message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wtype}")
        yield fnum, wtype, val


def _signed64(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


def iter_tfrecord(path: str) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file.

    Framing: uint64 LE length, uint32 masked-crc(length), payload,
    uint32 masked-crc(payload). CRCs are not verified (we trust local
    files; the reference's TF reader verifies them)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
            f.read(4)  # data crc
            yield payload


def parse_tf_example(buf: bytes) -> Dict[str, object]:
    """Decode a serialized tf.train.Example into {key: list|ndarray}.

    Message layout (public tensorflow/core/example/example.proto):
    Example.features(1) -> Features.feature(1) map entries
    {key(1), Feature(2)}; Feature is oneof bytes_list(1) / float_list(2) /
    int64_list(3), each with repeated value(1) (floats/ints may be packed).
    """
    feats: Dict[str, object] = {}
    for fnum, _, fv in _iter_fields(buf):
        if fnum != 1:
            continue
        for f2, _, entry in _iter_fields(fv):
            if f2 != 1:
                continue
            key, feature = None, b""
            for f3, _, v3 in _iter_fields(entry):
                if f3 == 1:
                    key = v3.decode()
                elif f3 == 2:
                    feature = v3
            if key is None:
                continue
            for f4, _, v4 in _iter_fields(feature):
                if f4 == 1:  # BytesList
                    feats[key] = [v for n, _, v in _iter_fields(v4)
                                  if n == 1]
                elif f4 == 2:  # FloatList
                    vals: List[float] = []
                    for n, w, v in _iter_fields(v4):
                        if n != 1:
                            continue
                        if w == 2:  # packed
                            vals.extend(np.frombuffer(v, "<f4").tolist())
                        else:
                            vals.append(struct.unpack("<f", v)[0])
                    feats[key] = np.asarray(vals, np.float32)
                elif f4 == 3:  # Int64List
                    ivals: List[int] = []
                    for n, w, v in _iter_fields(v4):
                        if n != 1:
                            continue
                        if w == 2:  # packed
                            p = 0
                            while p < len(v):
                                x, p = _read_varint(v, p)
                                ivals.append(_signed64(x))
                        else:
                            ivals.append(_signed64(v))
                    feats[key] = np.asarray(ivals, np.int64)
    return feats


# ---------------------------------------------------------------------------
# InstaVariety (insta_utils.py:246-334)


def read_insta_record(path: str,
                      builder: Optional[VibeDbBuilder] = None,
                      feature_fn: Optional[Callable] = None
                      ) -> VibeDbBuilder:
    """One insta_variety .tfrecord file -> db sequences.

    Per serialized video: kps (N, 25, 3) assembled as [xys; vis] (14 common
    joints) ++ face_pts (5) ++ toe_pts (6) exactly as
    insta_utils.py:292-301, then converted insta->spin. `[image/phis]`
    presence means crops were preprocessed and kps live in [-1,1] -> mapped
    to 224-crop pixels (:303-308). `feature_fn(encoded_jpegs, kp_2d) ->
    (N, 2048)` supplies CNN features (the reference runs its torch hmr);
    omitted -> zeros, to be filled by vibe_db.extract_features later."""
    b = builder or VibeDbBuilder(with_3d=False)
    for vid_idx, rec in enumerate(iter_tfrecord(path)):
        ex = parse_tf_example(rec)
        n = int(ex["meta/N"][0])
        xys = np.asarray(ex["image/xys"]).reshape(-1, 2, 14)
        vis = np.asarray(ex["image/visibilities"],
                         np.float32).reshape(-1, 1, 14)
        face = np.asarray(ex["image/face_pts"], np.float32)
        face = (face.reshape(-1, 3, 5) if face.size
                else np.zeros((xys.shape[0], 3, 5), np.float32))
        toe = np.asarray(ex.get("image/toe_pts", np.zeros(0)), np.float32)
        toe = (toe.reshape(-1, 3, 6) if toe.size
               else np.zeros((xys.shape[0], 3, 6), np.float32))
        kp = np.concatenate([np.concatenate([xys, vis], 1), face, toe], 2)
        kp = np.transpose(kp, (0, 2, 1))  # (N, 25, 3)
        if "image/phis" in ex:  # preprocessed crops: kps in [-1, 1]
            conf = kp[..., 2:]
            kp = np.concatenate([(kp[..., :2] + 1) * 0.5 * 224, conf], -1)
        j2d = convert_kps(kp[:n], "insta", "spin").astype(np.float32)
        feats = (np.asarray(feature_fn(ex["image/encoded"][:n], j2d),
                            np.float32) if feature_fn is not None else None)
        vis_any = kp[:n, :, 2].sum(1) > 0
        b.add_sequence(f"{path}-{vid_idx}", np.arange(n), j2d,
                       bbox=bbox_from_kp2d(kp[:n]).astype(np.float32),
                       features=feats,
                       valid=vis_any.astype(np.float32))
    return b


def read_insta(folder: str, split: str = "train",
               feature_fn: Optional[Callable] = None) -> VibeDbBuilder:
    """All {folder}/{split}/*.tfrecord files (insta_utils.py:371-381)."""
    b = VibeDbBuilder(with_3d=False)
    for fp in sorted(glob(osp.join(folder, split, "*.tfrecord"))):
        read_insta_record(fp, builder=b, feature_fn=feature_fn)
    return b


# ---------------------------------------------------------------------------
# PoseTrack (posetrack_utils.py:33-160)

_PT_MIN_FRAMES = 8


def read_posetrack(folder: str, split: str = "train") -> VibeDbBuilder:
    """posetrack_data/annotations/{split}/*.json -> per-track sequences.

    Reference semantics: keep labeled images only; group annotations by
    track_id; reorder the file's keypoint names to the canonical posetrack
    order; confidences forced to 1 then zeroed where x=y=0; drop frames
    with degenerate boxes; tlwh -> center bbox with w=h=0.8*max(w,h);
    tracks shorter than 8 usable frames are dropped; posetrack->spin."""
    b = VibeDbBuilder(with_3d=False)
    files = sorted(glob(osp.join(folder, "posetrack_data", "annotations",
                                 split, "*.json")))
    for fname in files:
        with open(fname) as f:
            anns = json.load(f)
        images = [im for im in anns["images"] if im.get("is_labeled")]
        frame2img = {im["frame_id"]: im["file_name"] for im in images}
        kp_names = anns["categories"][0]["keypoints"]
        perm = [kp_names.index(n) for n in POSETRACK_ORIGINAL_NAMES
                if n in kp_names]
        tracks: Dict[int, list] = {}
        for a in anns["annotations"]:
            kps = np.asarray(a["keypoints"], np.float32).reshape(-1, 3)
            if not np.count_nonzero(kps):
                continue
            tracks.setdefault(a["track_id"], []).append(
                (kps[perm], a["bbox"], a["image_id"]))
        for pid, items in sorted(tracks.items()):
            if len(items) < _PT_MIN_FRAMES:
                continue
            rows = []
            for kps, tlwh, image_id in items:
                x, y, w, h = [float(v) for v in tlwh[:4]]
                if w == 0 or h == 0 or image_id not in frame2img:
                    continue
                kp = kps.copy()
                kp[:, 2] = 1.0
                kp[(kp[:, 0] == 0) & (kp[:, 1] == 0), 2] = 0.0
                side = 0.8 * max(w, h)
                rows.append((kp, [x + w / 2, y + h / 2, side, side],
                             image_id))
            if len(rows) < _PT_MIN_FRAMES:
                continue
            kp17 = np.stack([r[0] for r in rows])
            j2d = convert_kps(kp17, "posetrack", "spin").astype(np.float32)
            bbox = np.asarray([r[1] for r in rows], np.float32)
            img_names = [osp.join(folder, frame2img[r[2]]) for r in rows]
            b.add_sequence(f"{fname}_{pid}",
                           np.asarray([r[2] for r in rows], np.int64),
                           j2d, bbox=bbox, img_names=img_names)
    return b


# ---------------------------------------------------------------------------
# MPI-INF-3DHP train set (mpii3d_utils.py:79-190)


def read_mpii3d(folder: str,
                user_list: Sequence[int] = range(1, 9),
                seq_list: Sequence[int] = range(1, 3),
                vid_list: Sequence[int] = tuple(range(3)) +
                tuple(range(4, 9)),
                img_size=(2048, 2048)) -> VibeDbBuilder:
    """S{u}/Seq{s}/annot.mat (annot2/annot3 cell arrays per camera) ->
    sequences split into contiguous fully-on-screen segments.

    Reference semantics: 28-joint annots + conf 1 -> mpii3d->spin; 3D in
    mm -> m, root-centered at spin joint 39 ('hip'); frames with any
    converted 2D joint offscreen end the current segment ("_seg{k}" ids);
    bbox from nonzero kp extents."""
    from scipy.io import loadmat

    h, w = img_size
    b = VibeDbBuilder()
    for user_i in user_list:
        for seq_i in seq_list:
            annot_file = osp.join(folder, f"S{user_i}", f"Seq{seq_i}",
                                  "annot.mat")
            if not osp.exists(annot_file):
                continue
            mat = loadmat(annot_file)
            annot2, annot3 = mat["annot2"], mat["annot3"]
            for vid_i in vid_list:
                a2 = np.asarray(annot2[vid_i][0], np.float32)
                a3 = np.asarray(annot3[vid_i][0], np.float32)
                F = a2.shape[0]
                j2d_raw = a2.reshape(F, 28, 2)
                j2d_raw = np.concatenate(
                    [j2d_raw, np.ones((F, 28, 1), np.float32)], 2)
                j2d = convert_kps(j2d_raw, "mpii3d", "spin")
                j3d = convert_kps(a3.reshape(F, 28, 3) / 1000.0,
                                  "mpii3d", "spin")
                j3d = j3d - j3d[:, 39:40]
                on = ((j2d[..., 0] >= 0) & (j2d[..., 0] < w) &
                      (j2d[..., 1] >= 0) & (j2d[..., 1] < h)).all(1)
                base = f"subj{user_i}_seq{seq_i}_vid{vid_i}"
                img_dir = osp.join(folder, f"S{user_i}", f"Seq{seq_i}",
                                   f"video_{vid_i}")
                # maximal on-screen runs become "_seg{k}" sequences (the
                # reference bumps the seg id on every skipped frame; only
                # distinctness matters for windowing)
                seg = 0
                start = None
                for i in range(F + 1):
                    if i < F and on[i]:
                        start = i if start is None else start
                        continue
                    if start is not None:
                        sl = slice(start, i)
                        j2 = j2d[sl]
                        bbox = np.stack([
                            bbox_from_kp2d(f2[~np.all(f2 == 0, axis=1), :2])
                            for f2 in j2]).astype(np.float32)
                        b.add_sequence(
                            f"{base}_seg{seg}",
                            np.arange(start, i), j2, joints3d=j3d[sl],
                            bbox=bbox,
                            img_names=[osp.join(img_dir,
                                                f"frame_{k + 1:06d}.jpg")
                                       for k in range(start, i)])
                        start = None
                        seg += 1
    return b


# ---------------------------------------------------------------------------
# AMASS (amass_utils.py:41-121)

AMASS_SEQUENCES = (
    "ACCAD", "BioMotionLab_NTroje", "CMU", "EKUT", "Eyes_Japan_Dataset",
    "HumanEva", "KIT", "MPI_HDM05", "MPI_Limits", "MPI_mosh", "SFU",
    "SSM_synced", "TCD_handMocap", "TotalCapture", "Transitions_mocap",
)

# SMPL-H pose columns for the 24 SMPL joints: 0..22 + 37 (right hand root
# stands in for the flat right wrist), amass_utils.py:32-37.
_AMASS_JOINTS = np.array(list(range(23)) + [37])
AMASS_POSE_COLS = (np.arange(156).reshape(-1, 3)[_AMASS_JOINTS]).reshape(-1)


def read_amass(folder: str,
               sequences: Sequence[str] = AMASS_SEQUENCES,
               fps: int = 25, min_frames: int = 60) -> Dict[str, np.ndarray]:
    """{folder}/{seq}/{subject}/*.npz mocap -> theta db for the VIBE motion
    discriminator: subsample mocap_framerate -> fps, take the 24-joint pose
    columns, theta = [pose72, betas10]; clips shorter than 60 frames at
    25 fps are dropped. Returns {'theta', 'trans', 'vid_name'}."""
    thetas, transes, vids = [], [], []
    for seq_name in sequences:
        seq_folder = osp.join(folder, seq_name)
        if not osp.isdir(seq_folder):
            continue
        for subject in sorted(os.listdir(seq_folder)):
            sdir = osp.join(seq_folder, subject)
            if not osp.isdir(sdir):
                continue
            for action in sorted(os.listdir(sdir)):
                if not action.endswith(".npz") or action.endswith(
                        "shape.npz"):
                    continue
                data = np.load(osp.join(sdir, action))
                step = max(int(data["mocap_framerate"]) // fps, 1)
                pose = np.asarray(data["poses"])[::step][:, AMASS_POSE_COLS]
                if pose.shape[0] < min_frames:
                    continue
                trans = np.asarray(data["trans"])[::step]
                betas = np.repeat(
                    np.asarray(data["betas"])[:10][None], pose.shape[0], 0)
                thetas.append(np.concatenate([pose, betas], 1)
                              .astype(np.float32))
                transes.append(trans.astype(np.float32))
                vids.append(np.array(
                    [f"{seq_name}_{subject}_{action[:-4]}"] * pose.shape[0]))
    if not thetas:
        return {"theta": np.zeros((0, 82), np.float32),
                "trans": np.zeros((0, 3), np.float32),
                "vid_name": np.zeros((0,), "U1")}
    return {"theta": np.concatenate(thetas),
            "trans": np.concatenate(transes),
            "vid_name": np.concatenate(vids)}


# ---------------------------------------------------------------------------
# Human3.6M (h36m_train_utils.py:160-470)

# Raw 32-joint H36M annotation order -> the 17 informative joints, and
# their slots inside the 24-joint GT block of the SPIN-49 layout
# (h36m_train_utils.py:183-184).
H36M_RAW_IDX = np.array([11, 6, 7, 8, 1, 2, 3, 12, 24, 14, 15, 17, 18, 19,
                         25, 26, 27])
H36M_GLOBAL_IDX = np.array([14, 3, 4, 5, 2, 1, 0, 16, 12, 17, 18, 9, 10, 11,
                            8, 7, 6])
H36M_CAMERAS = ("54138969", "55011271", "58860488", "60457274")


def h36m_to_spin49(poses_2d: np.ndarray, poses_3d: np.ndarray):
    """Raw (F, 64) 2D / (F, 96) 3D H36M pose rows -> SPIN-49 joints2D
    (pixels + conf 1) and joints3D (meters + valid 1), the scatter of
    h36m_train_utils.py:386-404."""
    F = poses_2d.shape[0]
    part17 = poses_2d.reshape(F, -1, 2)[:, H36M_RAW_IDX]
    j2d = np.zeros((F, 49, 3), np.float32)
    j2d[:, 25 + H36M_GLOBAL_IDX, :2] = part17
    j2d[:, 25 + H36M_GLOBAL_IDX, 2] = 1.0
    s17 = poses_3d.reshape(F, -1, 3)[:, H36M_RAW_IDX] / 1000.0
    j3d = np.zeros((F, 49, 3), np.float32)
    j3d[:, 25 + H36M_GLOBAL_IDX] = s17
    return j2d, j3d, s17


def mosh_slerp_upsample(poses: np.ndarray, factor: int = 5) -> np.ndarray:
    """SLERP-upsample (T, 72) axis-angle mosh poses by `factor`
    (h36m_train_utils.py:263-280: roma.unitquat_slerp with
    linspace(0, 1, 5) between consecutive frames). scipy Slerp per joint."""
    from scipy.spatial.transform import Rotation, Slerp

    T = poses.shape[0]
    if T < 2:
        return np.repeat(poses, factor, 0)
    steps = np.linspace(0.0, 1.0, factor)
    out = np.zeros(((T - 1) * factor, 24, 3))
    aa = poses.reshape(T, 24, 3)
    for j in range(24):
        rot = Rotation.from_rotvec(aa[:, j])
        sl = Slerp(np.arange(T), rot)
        t = (np.arange(T - 1)[:, None] + steps[None]).reshape(-1)
        out[:, j] = sl(t).as_rotvec()
    return out.reshape(-1, 72)


def flip_root_orient(pose: np.ndarray) -> np.ndarray:
    """Compose a pi rotation about x with the global orient, the mosh
    root re-orientation of h36m_train_utils.py:283-288."""
    from scipy.spatial.transform import Rotation

    flip = Rotation.from_rotvec([np.pi, 0.0, 0.0])
    root = Rotation.from_rotvec(pose[:, :3])
    out = np.array(pose, copy=True)
    out[:, :3] = (flip * root).as_rotvec()
    return out


def _default_cdf_pose(path: str) -> np.ndarray:
    """Load the 'Pose' variable of an H36M .cdf annotation file; falls back
    to a sibling .npz (key 'pose') so converted annotations work without
    cdflib (not in this image)."""
    try:
        import cdflib  # type: ignore
        return np.asarray(cdflib.CDF(path)["Pose"][0])
    except ImportError:
        npz = path[:-4] + ".npz" if path.endswith(".cdf") else path
        if osp.exists(npz):
            return np.asarray(np.load(npz)["pose"])
        raise FileNotFoundError(
            f"cdflib unavailable and no converted twin {npz}; convert the "
            ".cdf 'Pose' variable to npz(pose=...) offline")


def read_h36m(folder: str,
              user_list: Sequence[int] = (1, 5, 6, 7, 8),
              protocol_cameras: Optional[Sequence[str]] = None,
              smpl_joints_fn: Optional[Callable] = None,
              cdf_pose_fn: Callable = _default_cdf_pose,
              mosh_upsample: int = 5,
              drop_tail: int = 10) -> VibeDbBuilder:
    """S{u}/MyPoseFeatures/{D3_Positions_mono,D2_Positions}/*.cdf (+ mosh
    neutrSMPL_H3.6 pkls when present) -> db sequences.

    Reference semantics (h36m_train_utils.py:160-470): per action+camera
    sequence, scatter 17 GT joints into SPIN-49; mosh thetas SLERP-upsampled
    5x with the root flipped about x; the last 10 frames dropped (mosh
    interpolation tail); '_ALL' actions skipped; missing mosh pkl skips the
    sequence only when mosh is requested. `smpl_joints_fn(pose72, betas10)
    -> (49, 3)` supplies moshed joints3D; without it GT S49 is stored
    (gt_spin_joints3d in the reference) and pose/shape still come from mosh.
    """
    b = VibeDbBuilder()
    for user_i in user_list:
        user = f"S{user_i}"
        pose3_dir = osp.join(folder, user, "MyPoseFeatures",
                             "D3_Positions_mono")
        pose2_dir = osp.join(folder, user, "MyPoseFeatures", "D2_Positions")
        mosh_dir = osp.join(folder, "mosh", "neutrMosh", "neutrSMPL_H3.6",
                            user)
        seqs = sorted(glob(osp.join(pose3_dir, "*.cdf")) +
                      glob(osp.join(pose3_dir, "*.npz")))
        for seq_path in seqs:
            seq_name = osp.basename(seq_path)
            stem = seq_name.rsplit(".", 1)[0]
            action_w_space, camera = stem.split(".")
            action = action_w_space.replace(" ", "_")
            if action == "_ALL":
                continue
            if protocol_cameras and camera not in protocol_cameras:
                continue
            poses_3d = cdf_pose_fn(seq_path)
            poses_2d = cdf_pose_fn(osp.join(pose2_dir, seq_name))
            j2d, j3d, s17 = h36m_to_spin49(poses_2d, poses_3d)

            pose = shape = None
            mosh_path = osp.join(
                mosh_dir,
                f"{action_w_space}_cam{H36M_CAMERAS.index(camera)}"
                "_aligned.pkl")
            if osp.exists(mosh_path):
                import pickle
                with open(mosh_path, "rb") as f:
                    mosh = pickle.load(f, encoding="latin1")
                theta = mosh_slerp_upsample(
                    np.asarray(mosh["new_poses"]), mosh_upsample)
                pose = flip_root_orient(theta)
                shape = np.asarray(mosh["betas"], np.float32)[:10]

            F = max(j2d.shape[0] - drop_tail, 0)
            if F == 0:
                continue
            j2d, j3d, s17 = j2d[:F], j3d[:F], s17[:F]
            if pose is not None:
                pose = pose[:F].astype(np.float32)
                if pose.shape[0] < F:  # short mosh: pad by repetition
                    pose = np.concatenate(
                        [pose, np.repeat(pose[-1:], F - pose.shape[0], 0)])
                if smpl_joints_fn is not None:
                    mosh_j = np.stack([
                        np.asarray(smpl_joints_fn(pose[i], shape))
                        for i in range(F)])
                    # root-align moshed joints to the GT hip
                    # (h36m_train_utils.py:407-414)
                    j3d = mosh_j + (s17[:, :1] - mosh_j[:, 39:40])
            vid = f"{user}_{action}.{camera}"
            nz = j2d[..., 2] > 0
            bbox = np.stack([
                bbox_from_kp2d(j2d[i][nz[i], :2]) for i in range(F)
            ]).astype(np.float32)
            b.add_sequence(
                vid, np.arange(F), j2d, joints3d=j3d,
                pose=np.zeros((F, 72), np.float32) if pose is None
                else pose,
                shape=shape, bbox=bbox,
                img_names=[osp.join(folder, "images",
                                    f"{vid}_{i + 1:06d}.jpg")
                           for i in range(F)])
    return b


# ---------------------------------------------------------------------------
# NeMo-MoCap (nemomocap_utils.py:557-907)

NEMO_MOCAP_ACTIONS = ("baseball_swing", "baseball_pitch", "golf_swing",
                      "tennis_swing", "tennis_serve")
# create_db2 splits by action (nemomocap_utils.py:819-845)
NEMO_MOCAP_SPLITS = {
    "train": ("baseball_swing", "tennis_serve"),
    "val": ("baseball_pitch", "golf_swing", "tennis_swing"),
}


def _rot6d_to_matrix_np(r6: np.ndarray) -> np.ndarray:
    """Gram-Schmidt 6D -> rotation matrix, numpy twin of
    geometry/rotations.rot6d_to_rotmat for host-side packers."""
    a1, a2 = r6[:3], r6[3:6]
    b1 = a1 / np.linalg.norm(a1)
    a2p = a2 - (b1 @ a2) * b1
    b2 = a2p / np.linalg.norm(a2p)
    return np.stack([b1, b2, np.cross(b1, b2)], axis=1)


def apply_rigid_to_motion(pose: np.ndarray, trans: np.ndarray,
                          rotvec: np.ndarray, cam_trans: np.ndarray):
    """World-view SMPL motion -> camera view: compose `rotvec` into the
    global orient and map trans through R @ t + cam_trans
    (nemomocap_utils.py:73-110 apply_rigid_to_batch)."""
    from scipy.spatial.transform import Rotation

    rig = Rotation.from_rotvec(np.asarray(rotvec).reshape(3))
    R = rig.as_matrix()
    out_pose = np.array(pose, copy=True)
    out_pose[:, :3] = (rig * Rotation.from_rotvec(pose[:, :3])).as_rotvec()
    out_trans = trans @ R.T + np.asarray(cam_trans).reshape(1, 3)
    return out_pose.astype(np.float32), out_trans.astype(np.float32)


def smooth_bbox_from_j2d(j2d: np.ndarray, vis_thresh: float = 0.3,
                         sigma: float = 8.0) -> np.ndarray:
    """Keypoints -> median+gaussian smoothed square bboxes
    (kp_utils.py:23-39 generate_bbox_from_j2d via
    smooth_bbox.get_smooth_bbox_params): per-frame params [cx, cy,
    scale=150/size] from visible-kp extents, smoothed, then
    w = h = 150/scale * 1.1."""
    from .smoothing import smooth_bbox_params

    j2d = np.asarray(j2d)
    params = []
    last = np.array([0.0, 0.0, 1.0])
    for kp in j2d:
        vis = kp[:, 2] > vis_thresh
        if vis.sum() >= 2:
            pts = kp[vis, :2]
            size = max(float((pts.max(0) - pts.min(0)).max()), 1e-3)
            c = (pts.max(0) + pts.min(0)) / 2
            last = np.array([c[0], c[1], 150.0 / size])
        params.append(last)
    sm = smooth_bbox_params(np.asarray(params, np.float32), sigma=sigma)
    side = 150.0 / sm[:, 2] * 1.1
    return np.stack([sm[:, 0], sm[:, 1], side, side], 1).astype(np.float32)


def read_nemomocap(db_dir: str, mocap_root: str, cam_dir: str,
                   split: str = "train",
                   indices: Sequence[int] = range(8),
                   smpl_joints_fn: Optional[Callable] = None,
                   builder: Optional[VibeDbBuilder] = None
                   ) -> VibeDbBuilder:
    """NeMo-MoCap -> VIBE db (nemomocap_utils.py:557-787 process_sequence +
    create_db2 action split).

    Layout per sequence `{action}.{index}.mp4`:
      * frames: {db_dir}/mymocap_{action}/{vid}/%06d.png,
      * GT-2D:  {db_dir}/mymocap_{action}/{vid}_gt_new/%06d_keypoints.pkl,
      * mocap:  {mocap_root}/{action}.{index}.pkl — MoSh fullpose (SMPL-H;
        first 66 cols + 6 zeros -> 72), betas, trans,
      * camera: {cam_dir}/opt_cam_{IMG}_20230227.pt joblib dict
        {'rot6d','tran','K'}, IMG_6287 for tennis_serve else IMG_6289.

    The world-view motion is moved to camera view with the fitted rigid,
    GT-2D becomes conf-1 SPIN-49 rows, bboxes are the smoothed kp-extent
    squares. `smpl_joints_fn(pose72, betas10, trans3) -> (49, 3)` fills
    joints3D (the reference runs its torch SMPL FK); omitted -> zeros.
    """
    from ..utils import pickles

    b = builder or VibeDbBuilder()
    for action in NEMO_MOCAP_SPLITS.get(split, NEMO_MOCAP_SPLITS["train"]):
        for index in indices:
            vid = f"{action}.{index}.mp4"
            img_dir = osp.join(db_dir, f"mymocap_{action}", vid)
            mocap_pkl = osp.join(mocap_root, f"{action}.{index}.pkl")
            if not (osp.isdir(img_dir + "_gt_new") and
                    osp.exists(mocap_pkl)):
                continue
            mocap = pickles.load(mocap_pkl)
            body = np.asarray(mocap["fullpose"], np.float32)[:, :66]
            pose_wv = np.concatenate(
                [body, np.zeros((body.shape[0], 6), np.float32)], 1)
            betas = np.asarray(mocap["betas"], np.float32)[:10]
            trans_wv = np.asarray(mocap["trans"], np.float32)
            F = pose_wv.shape[0]

            img = "IMG_6287" if "tennis_serve" in vid else "IMG_6289"
            cam = pickles.load(
                osp.join(cam_dir, f"opt_cam_{img}_20230227.pt"))
            from scipy.spatial.transform import Rotation
            rotvec = Rotation.from_matrix(_rot6d_to_matrix_np(
                np.asarray(cam["rot6d"], np.float32).reshape(6))
            ).as_rotvec()
            pose_cv, trans_cv = apply_rigid_to_motion(
                pose_wv, trans_wv, rotvec,
                np.asarray(cam["tran"], np.float32))

            gt_dir = img_dir + "_gt_new"
            j2d = np.zeros((F, 49, 3), np.float32)
            for t in range(F):
                raw = np.asarray(pickles.load(
                    osp.join(gt_dir, f"{t + 1:06d}_keypoints.pkl")),
                    np.float32)
                kp = raw[0] if raw.ndim == 3 else raw
                if kp.shape[0] >= 49:
                    j2d[t, :, :2] = kp[:49, :2]
                    j2d[t, :, 2] = 1.0
                else:  # 15-joint layout: fill the leading OP slots
                    k = kp.shape[0]
                    j2d[t, :k, :2] = kp[:, :2]
                    j2d[t, :k, 2] = 1.0

            j3d = None
            if smpl_joints_fn is not None:
                j3d = np.stack([
                    np.asarray(smpl_joints_fn(pose_cv[t], betas,
                                              trans_cv[t]), np.float32)
                    for t in range(F)])
            b.add_sequence(
                vid, np.arange(F), j2d, joints3d=j3d, pose=pose_cv,
                shape=betas, bbox=smooth_bbox_from_j2d(j2d),
                img_names=[osp.join(img_dir, f"{t + 1:06d}.png")
                           for t in range(F)])
    return b
