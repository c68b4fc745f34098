"""Packed multi-view action bundles (numpy; a re-home of
nemo_tpu/data/bundle.py's MultiViewBundle, which documents the layout).

Every array is dense and fixed-shape; ``build_assets`` moves the ones a fit
needs to the device once.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class MultiViewBundle:
    """A packed multi-view action: everything a fit needs, as numpy arrays."""
    labels: Dict[str, np.ndarray]          # each (V, F, 25, 3)
    hmr_theta: np.ndarray                  # (V, F, 69)
    hmr_mask: np.ndarray                   # (V, F, 1)
    img_hw: np.ndarray                     # (2,) = (D0 height, D1 width)
    # SPIN per-frame theta for V0's warmup (the reference warms V0 up on
    # spin_theta, neural_motion_model.py:3216-3227, while V1+ uses the VIBE
    # theta in hmr_theta :3441-3452); optional second initializer slot
    spin_theta: Optional[np.ndarray] = None    # (V, F, 69)
    gt3d_pose: Optional[np.ndarray] = None     # (V, F, 72)
    gt3d_trans: Optional[np.ndarray] = None    # (V, F, 3)
    gt_cameras: Optional[np.ndarray] = None    # (V, 9)
    gt_betas: Optional[np.ndarray] = None      # (1, 10)
    framerate_multiplier: Optional[np.ndarray] = None  # (V,)
    frame_paths: Optional[np.ndarray] = None   # (V, F) unicode image paths
    # 3D baseline body poses for eval_3d columns (vs/pare/glamr; vibe lives
    # in hmr_theta): {name: (V, F, 70)} = 69 axis-angle dims + validity mask
    # (the commented-out loader slots of multi_view_sequence.py:336-392)
    baseline_poses: Optional[Dict[str, np.ndarray]] = None
    # GLAMR world-frame baseline for eval_3d_global's mpjpe/mpvpe-glamr
    # columns: global orient + root translation per frame
    # (multi_view_sequence.py glamr_orient/glamr_trans slots :387-389;
    # consumed by rigid_transform_to_gt, neural_motion_model.py:1557-1577)
    glamr_orient: Optional[np.ndarray] = None  # (V, F, 3)
    glamr_trans: Optional[np.ndarray] = None   # (V, F, 3)
    # VIBE's own global orient / shape / weak-persp camera, kept so the
    # baseline-rollout figure (render_vibe_rollout :1415-1462) can render
    # the initializer's prediction straight from the packed bundle
    vibe_orient: Optional[np.ndarray] = None   # (V, F, 3)
    vibe_betas: Optional[np.ndarray] = None    # (V, 10)
    vibe_cam: Optional[np.ndarray] = None      # (V, F, 4) orig_cam
    name: str = "bundle"

    @property
    def num_views(self) -> int:
        return next(iter(self.labels.values())).shape[0]

    @property
    def num_frames(self) -> int:
        return next(iter(self.labels.values())).shape[1]

    @property
    def img_d0(self) -> float:
        return float(self.img_hw[0])

    @property
    def img_d1(self) -> float:
        return float(self.img_hw[1])

    def label(self, label_type: str,
              intersection_threshold: float = 30.0) -> np.ndarray:
        """2D supervision of the given type, with the 'intersection' blend.

        'intersection' averages op and gt positions and gates confidence on
        their agreement within intersection_threshold pixels (collate_gt_2d
        :2929-2945; the reference's --label_intersection_threshold flag).
        """
        if label_type in self.labels:
            return self.labels[label_type]
        if label_type == "intersection":
            gt1 = self.labels["op"]
            gt2 = self.labels["gt"]
            mean = (gt1[..., :2] + gt2[..., :2]) / 2
            dist = np.sqrt(((gt1[..., :2] - gt2[..., :2]) ** 2)
                           .sum(-1, keepdims=True))
            conf = (dist < intersection_threshold).astype(np.float32) \
                * gt1[..., -1:]
            return np.concatenate([mean, conf], -1)
        raise KeyError(f"label type {label_type!r} not in bundle "
                       f"(have {sorted(self.labels)})")

    def bbox_diag(self, label_type: str,
                  intersection_threshold: float = 30.0) -> np.ndarray:
        """Keypoint-extent bbox diagonal per (view, frame): (V, F).

        The 1e-4 shift keeps empty frames from producing a 0 size (whose
        sqrt would NaN gradients downstream) — collate_gt_2d :2950-2960.
        """
        pts = self.label(label_type, intersection_threshold)
        d0 = pts[..., 0].max(-1) - pts[..., 0].min(-1)
        d1 = pts[..., 1].max(-1) - pts[..., 1].min(-1)
        return np.sqrt(d0 ** 2 + d1 ** 2) + 1e-4

    # -- serialization ------------------------------------------------------

    def save(self, path: str) -> None:
        payload = {
            "img_hw": self.img_hw,
            "hmr_theta": self.hmr_theta,
            "hmr_mask": self.hmr_mask,
            "name": np.asarray(self.name),
        }
        for k, v in self.labels.items():
            payload[f"labels_{k}"] = v
        for k, v in (self.baseline_poses or {}).items():
            payload[f"bpose_{k}"] = v
        for k in ("spin_theta", "gt3d_pose", "gt3d_trans", "gt_cameras",
                  "gt_betas", "framerate_multiplier", "frame_paths",
                  "glamr_orient", "glamr_trans",
                  "vibe_orient", "vibe_betas", "vibe_cam"):
            v = getattr(self, k)
            if v is not None:
                payload[k] = v
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path: str) -> "MultiViewBundle":
        data = np.load(path, allow_pickle=False)
        labels = {k[len("labels_"):]: data[k] for k in data.files
                  if k.startswith("labels_")}
        bposes = {k[len("bpose_"):]: data[k] for k in data.files
                  if k.startswith("bpose_")}
        kwargs = {"baseline_poses": bposes} if bposes else {}
        for k in ("spin_theta", "gt3d_pose", "gt3d_trans", "gt_cameras",
                  "gt_betas", "framerate_multiplier", "frame_paths",
                  "glamr_orient", "glamr_trans",
                  "vibe_orient", "vibe_betas", "vibe_cam"):
            if k in data.files:
                kwargs[k] = data[k]
        return cls(labels=labels, hmr_theta=data["hmr_theta"],
                   hmr_mask=data["hmr_mask"], img_hw=data["img_hw"],
                   name=str(data["name"]) if "name" in data.files else "bundle",
                   **kwargs)
