"""VIBE training-database schema, builder, and windowing (port of
nemo_tpu/data/vibe_db.py).

Behavioral reference: VIBE/lib/data_utils/*_utils.py (h36m/3dpw/mpii3d/
penn_action/posetrack/insta builders — all emit one dict-of-arrays "db"
with the keys below, threedpw_utils.py:44-57) plus the sequence windowing
of VIBE/lib/dataset/dataset_2d.py / dataset_3d.py (seqlen chunks of
contiguous same-video frames) and the CNN feature-extraction pass of
VIBE/lib/data_utils/feature_extractor.py:27-98.

The dataset-independent layer the per-dataset readers plug into:

  * `VibeDbBuilder` — schema-validated accumulation of per-sequence
    arrays into the canonical db dict, saved in joblib's format (the
    reference's vibe_db/*.pt files) through `utils/pickles`, so no joblib
    is needed,
  * `extract_features` — batched ResNet-50 features from frames + bboxes
    (`models/resnet.ResNet50` on its device),
  * `make_windows` — seqlen/stride window indices that never cross video
    boundaries,
  * `db_to_shards` — pack windows into `data/sharded.py` shards,
  * the 2D/3D mixed-batch feed of the trainer.

A per-dataset reader then reduces to: parse annotations -> call
builder.add_sequence(...) per tracklet -> builder.save()/db_to_shards().
Everything here is numpy on the host but `extract_features`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# canonical db schema: key -> (trailing shape, dtype); None = variable str
VIBE_DB_SCHEMA = {
    "vid_name": ((), "U"),         # unique video/tracklet id per frame
    "frame_id": ((), np.int64),
    "img_name": ((), "U"),
    "joints2D": ((49, 3), np.float32),   # SPIN 49-joint 2D + conf
    "joints3D": ((49, 3), np.float32),   # world/cam 3D (zeros if absent)
    "shape": ((10,), np.float32),
    "pose": ((72,), np.float32),
    "bbox": ((4,), np.float32),          # cx, cy, w, h
    "features": ((2048,), np.float32),   # ResNet50 pooled features
    "valid": ((), np.float32),
}


class VibeDbBuilder:
    """Accumulate per-sequence arrays into one canonical VIBE db."""

    def __init__(self, with_3d: bool = True):
        self.with_3d = with_3d
        self._cols: Dict[str, List[np.ndarray]] = {
            k: [] for k in VIBE_DB_SCHEMA}

    def add_sequence(self, vid_name: str, frame_ids: np.ndarray,
                     joints2d: np.ndarray,
                     joints3d: Optional[np.ndarray] = None,
                     pose: Optional[np.ndarray] = None,
                     shape: Optional[np.ndarray] = None,
                     bbox: Optional[np.ndarray] = None,
                     img_names: Optional[Sequence[str]] = None,
                     features: Optional[np.ndarray] = None,
                     valid: Optional[np.ndarray] = None) -> None:
        """One contiguous tracklet; missing annotation kinds are zero-filled
        (the reference zero-fills and relies on 'valid'/conf gating)."""
        F = int(np.asarray(frame_ids).shape[0])

        def fill(key, val):
            shp, dt = VIBE_DB_SCHEMA[key]
            if val is None:
                if dt == "U":
                    val = np.array([""] * F)
                else:
                    val = np.zeros((F,) + shp, dt)
            val = np.asarray(val)
            if dt != "U":
                val = val.astype(dt)
                want = (F,) + shp
                if val.shape != want:
                    raise ValueError(
                        f"{key}: expected {want}, got {val.shape}")
            self._cols[key].append(val)

        fill("vid_name", np.array([vid_name] * F))
        fill("frame_id", np.asarray(frame_ids, np.int64))
        fill("img_name", None if img_names is None else np.asarray(img_names))
        fill("joints2D", joints2d)
        fill("joints3D", joints3d)
        fill("pose", pose)
        fill("shape", None if shape is None
             else np.broadcast_to(np.asarray(shape, np.float32), (F, 10)))
        fill("bbox", bbox)
        fill("features", features)
        fill("valid", np.ones(F, np.float32) if valid is None
             else np.asarray(valid, np.float32).reshape(F))

    def build(self) -> Dict[str, np.ndarray]:
        if not self._cols["vid_name"]:
            raise ValueError("empty db")
        return {k: np.concatenate(v) for k, v in self._cols.items()}

    def save(self, path: str) -> Dict[str, np.ndarray]:
        """Write the db as joblib.dump does, the reference's
        vibe_db/<name>_<set>_db.pt format."""
        from ..utils import pickles
        db = self.build()
        pickles.dump(db, path)
        return db


def load_db(path: str) -> Dict[str, np.ndarray]:
    from ..utils import pickles
    return pickles.load(path)


def make_windows(vid_names: np.ndarray, seqlen: int,
                 stride: Optional[int] = None) -> np.ndarray:
    """(N,) per-frame video ids -> (W, seqlen) window index array.

    Windows are contiguous runs inside one video (dataset_3d.py's
    get_sequences/split_into_chunks semantics); stride defaults to seqlen
    (non-overlapping, the VIBE training default).
    """
    stride = seqlen if stride is None else stride
    vid_names = np.asarray(vid_names)
    out = []
    start = 0
    for i in range(1, len(vid_names) + 1):
        if i == len(vid_names) or vid_names[i] != vid_names[start]:
            run = np.arange(start, i)
            for s in range(0, len(run) - seqlen + 1, stride):
                out.append(run[s:s + seqlen])
            start = i
    if not out:
        return np.zeros((0, seqlen), np.int64)
    return np.stack(out)


def extract_features(backbone, frames: Sequence[np.ndarray],
                     bboxes: np.ndarray, batch_size: int = 64,
                     out_res: int = 224, scale: float = 1.3) -> np.ndarray:
    """Batched ResNet-50 features for tracked crops (feature_extractor.py).

    backbone: a ``models.resnet.ResNet50`` on the device to run on;
    frames: per-frame images; bboxes: (F, 4) [cx, cy, w, h]. One backbone
    call per chunk of crops instead of the reference's per-crop loop.
    """
    import torch

    from .crops import get_single_image_crop

    dev = next(backbone.parameters()).device
    cs = np.stack([[b[0], b[1], max(b[2], b[3]) * scale] for b in bboxes])
    crops = np.stack([
        get_single_image_crop(img, c, out_res=out_res)
        for img, c in zip(frames, cs)])                   # (F, res, res, 3)
    feats = []
    with torch.no_grad():
        for s in range(0, len(crops), batch_size):
            x = torch.as_tensor(crops[s:s + batch_size], device=dev)
            feats.append(backbone(x.permute(0, 3, 1, 2)).cpu().numpy())
    return np.concatenate(feats)


def db_to_shards(db: Dict[str, np.ndarray], out_dir: str, seqlen: int = 16,
                 stride: Optional[int] = None,
                 shard_size: int = 512,
                 keys: Iterable[str] = ("features", "joints2D", "joints3D",
                                        "pose", "shape", "valid")
                 ) -> Tuple[int, np.ndarray]:
    """Window a db and write data/sharded.py shards.

    Each shard row is one (seqlen, ...) window — the layout
    models/vibe_train.py's train step + data.sharded.batch_iterator expect.
    Returns (num_windows, window index array).
    """
    from .sharded import write_shards

    win = make_windows(db["vid_name"], seqlen, stride)
    arrays = {k: np.asarray(db[k])[win] for k in keys if k in db}
    write_shards(arrays, out_dir, shard_size=shard_size)
    return len(win), win


def read_3dpw(folder: str, split: str = "train",
              backbone=None) -> VibeDbBuilder:
    """3DPW reader against the official sequenceFiles layout
    (threedpw_utils.py:42-146): per-sequence pkl with poses/trans/betas per
    person, campose_valid mask, jointPositions, and 2D poses. Requires the
    dataset on disk; the parsing contract is pinned by unit fixtures."""
    import os.path as osp
    import os
    import pickle

    b = VibeDbBuilder()
    seq_dir = osp.join(folder, "sequenceFiles", split)
    for name in sorted(os.listdir(seq_dir)):
        if not name.endswith(".pkl"):
            continue
        with open(osp.join(seq_dir, name), "rb") as f:
            data = pickle.load(f, encoding="latin1")
        seq = name[:-4]
        n_people = len(data["poses"])
        for pid in range(n_people):
            pose = np.asarray(data["poses"][pid], np.float32)      # (F, 72)
            F = pose.shape[0]
            betas = np.asarray(data["betas"][pid], np.float32)[:10]
            valid = np.asarray(data.get(
                "campose_valid", [np.ones(F)] * n_people)[pid],
                np.float32).reshape(F)
            j2d_raw = np.asarray(data["poses2d"][pid],
                                 np.float32)                       # (F, 3, 18)
            j2d = np.zeros((F, 49, 3), np.float32)
            j2d[:, :18] = np.transpose(j2d_raw, (0, 2, 1))
            xy = j2d_raw[:, :2]
            conf = j2d_raw[:, 2] > 0
            w = (xy[:, 0] * conf).max(1) - np.where(
                conf, xy[:, 0], np.inf).min(1)
            h = (xy[:, 1] * conf).max(1) - np.where(
                conf, xy[:, 1], np.inf).min(1)
            cx = np.where(conf, xy[:, 0], 0).sum(1) / np.maximum(
                conf.sum(1), 1)
            cy = np.where(conf, xy[:, 1], 0).sum(1) / np.maximum(
                conf.sum(1), 1)
            bbox = np.stack([cx, cy, np.nan_to_num(w, posinf=0),
                             np.nan_to_num(h, posinf=0)], 1)
            img_names = [osp.join(folder, "imageFiles", seq,
                                  f"image_{i:05d}.jpg") for i in range(F)]
            b.add_sequence(f"{seq}_{pid}", np.arange(F), j2d, pose=pose,
                           shape=betas, bbox=bbox, img_names=img_names,
                           valid=valid)
    return b


def read_penn_action(folder: str) -> VibeDbBuilder:
    """Penn Action reader (penn_action_utils.py:63-123): labels/*.mat ->
    one tracklet per video with 2D joints (here in OP-25 slots of the
    49-joint layout via data.penn_action's L/R-swapped mapping) and
    keypoint-extent bboxes. Features are added separately with
    extract_features once frames are available."""
    import glob
    import os.path as osp

    from .penn_action import load_penn_sequence

    b = VibeDbBuilder(with_3d=False)
    for fname in sorted(glob.glob(osp.join(folder, "labels", "*.mat"))):
        vid = osp.basename(fname)[:-4]
        op = load_penn_sequence(fname)                     # (F, 25, 3)
        F = op.shape[0]
        j2d = np.zeros((F, 49, 3), np.float32)
        j2d[:, :25] = op
        conf = op[..., 2] > 0
        x, y = op[..., 0], op[..., 1]
        x0 = np.where(conf, x, np.inf).min(1)
        x1 = np.where(conf, x, -np.inf).max(1)
        y0 = np.where(conf, y, np.inf).min(1)
        y1 = np.where(conf, y, -np.inf).max(1)
        w = np.nan_to_num(x1 - x0, neginf=0, posinf=0)
        h = np.nan_to_num(y1 - y0, neginf=0, posinf=0)
        bbox = np.stack([(x0 + x1) / 2, (y0 + y1) / 2,
                         w * 1.1, h * 1.1], 1).astype(np.float32)
        bbox = np.nan_to_num(bbox, neginf=0, posinf=0)
        img_names = [osp.join(folder, "frames", vid, f"{i + 1:06d}.jpg")
                     for i in range(F)]
        b.add_sequence(vid, np.arange(F), j2d, bbox=bbox,
                       img_names=img_names,
                       valid=conf.any(1).astype(np.float32))
    return b


# ---------------------------------------------------------------------------
# 2D/3D mixed-batch training feed (VIBE/lib/dataset/loaders.py:22-61 +
# lib/core/trainer.py:140-177)
# ---------------------------------------------------------------------------

def split_2d3d_batch_sizes(batch_size: int, data_2d_ratio: float
                           ) -> Tuple[int, int]:
    """(2d, 3d) per-iteration batch sizes (loaders.py:41-42:
    int(BATCH_SIZE * DATA_2D_RATIO) / remainder)."""
    b2d = int(batch_size * data_2d_ratio)
    return b2d, batch_size - b2d


def merge_2d3d_batch(b2d: Optional[Dict[str, np.ndarray]],
                     b3d: Optional[Dict[str, np.ndarray]]
                     ) -> Dict[str, np.ndarray]:
    """Concatenate a 2D-supervision batch and a 3D batch along the batch
    axis into ONE train-step batch (trainer.py:171-177 torch.cat of the
    features; the criterion's separate data_2d/data_3d handling becomes
    the has_3d/has_smpl masks the repo's vibe_generator_loss consumes).

    2D batches may omit kp_3d/pose/betas — zero-filled from the 3D batch's
    trailing shapes with zeroed masks. Either input may be None
    (3D-only / 2D-only training configs, trainer.py:142/151).
    """
    if b2d is None and b3d is None:
        raise ValueError("need at least one of b2d/b3d")

    def with_masks(b, is_3d):
        b = dict(b)
        B, T = b["features"].shape[:2]
        b.setdefault("has_3d", np.full((B, T), float(is_3d), np.float32))
        b.setdefault("has_smpl", np.full((B, T), float(is_3d), np.float32))
        return b

    if b2d is None:
        return with_masks(b3d, True)
    if b3d is None:
        return with_masks(b2d, False)
    b2d, b3d = with_masks(b2d, False), with_masks(b3d, True)
    B2, T = b2d["features"].shape[:2]
    out = {}
    for k in b3d:
        if k not in b2d:  # kp_3d / pose / betas absent on the 2D side
            fill = np.zeros((B2,) + b3d[k].shape[1:], b3d[k].dtype)
            out[k] = np.concatenate([fill, np.asarray(b3d[k])], axis=0)
        else:
            out[k] = np.concatenate([np.asarray(b2d[k]),
                                     np.asarray(b3d[k])], axis=0)
    return out


def mixed_2d3d_iterator(make_2d_iter, make_3d_iter, num_steps: int):
    """Yield num_steps merged batches, re-creating either iterator when it
    exhausts — the reference's StopIteration-reset pattern
    (trainer.py:140-158). make_*_iter: callables returning fresh iterators
    (or None for a modality that isn't trained)."""
    it2d = make_2d_iter() if make_2d_iter is not None else None
    it3d = make_3d_iter() if make_3d_iter is not None else None

    def pull(it, make):
        nonlocal_self = it
        try:
            return next(nonlocal_self), nonlocal_self
        except StopIteration:
            fresh = make()
            return next(fresh), fresh

    for _ in range(num_steps):
        b2d = b3d = None
        if it2d is not None:
            b2d, it2d = pull(it2d, make_2d_iter)
        if it3d is not None:
            b3d, it3d = pull(it3d, make_3d_iter)
        yield merge_2d3d_batch(b2d, b3d)
