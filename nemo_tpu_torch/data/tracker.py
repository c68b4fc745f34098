"""Multi-person bbox tracking + the VIBE demo pipeline driver (port of
nemo_tpu/data/tracker.py: the trackers and crop geometry are the same host
numpy; the network runs in PyTorch on the SMPL model's device).

Behavioral reference: VIBE/demo2.py / custom_video/VIBE_custom/demo.py —
video -> person tracker -> per-tracklet crops -> VIBE -> vibe_output.pkl.
The reference's tracker is MPT (YOLO + SORT); detection is an external model
there too, so this module takes per-frame detections (bboxes or keypoints)
from any source and provides the IoU association + the pipeline driver that
emits the same {person_id: {pose, betas, frame_ids, joints2d, bboxes}} dict
the data layer consumes.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of [x0, y0, x1, y1] boxes."""
    x0 = max(a[0], b[0])
    y0 = max(a[1], b[1])
    x1 = min(a[2], b[2])
    y1 = min(a[3], b[3])
    inter = max(0.0, x1 - x0) * max(0.0, y1 - y0)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(area_a + area_b - inter, 1e-9)


def track_bboxes(detections: Sequence[np.ndarray], iou_threshold: float = 0.3,
                 max_age: int = 10) -> Dict[int, Dict[str, np.ndarray]]:
    """Greedy IoU tracker over per-frame detections.

    detections: list over frames of (N_f, 4) [x0, y0, x1, y1] boxes.
    Returns {track_id: {'bboxes': (T, 4), 'frame_ids': (T,)}}.
    """
    next_id = 0
    active: Dict[int, dict] = {}   # id -> {'last_box', 'age'}
    tracks: Dict[int, dict] = {}
    for f, boxes in enumerate(detections):
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        unmatched = list(range(len(boxes)))
        # match active tracks greedily by IoU
        for tid in list(active):
            best_j, best_iou = -1, iou_threshold
            for j in unmatched:
                v = iou(active[tid]["last_box"], boxes[j])
                if v > best_iou:
                    best_j, best_iou = j, v
            if best_j >= 0:
                unmatched.remove(best_j)
                active[tid]["last_box"] = boxes[best_j]
                active[tid]["age"] = 0
                tracks[tid]["bboxes"].append(boxes[best_j])
                tracks[tid]["frame_ids"].append(f)
            else:
                active[tid]["age"] += 1
                if active[tid]["age"] > max_age:
                    del active[tid]
        # new tracks for unmatched detections
        for j in unmatched:
            active[next_id] = {"last_box": boxes[j], "age": 0}
            tracks[next_id] = {"bboxes": [boxes[j]], "frame_ids": [f]}
            next_id += 1
    return {tid: {"bboxes": np.stack(t["bboxes"]),
                  "frame_ids": np.asarray(t["frame_ids"])}
            for tid, t in tracks.items()}


def tracks_from_posetrack(people: Dict[int, Dict[str, np.ndarray]],
                          vis_thresh: float = 0.3,
                          min_height: float = 0.5
                          ) -> Dict[int, Dict[str, np.ndarray]]:
    """Keypoint tracklets -> the bbox-track dict run_vibe_on_tracks eats.

    Behavioral reference: the pose-tracking branch of VIBE/demo.py:129-146
    + lib/dataset/inference.py:45-53 + lib/utils/smooth_bbox.py:33-104.
    Per frame the bbox center is the visible-keypoint extent midpoint and
    its side the extent DIAGONAL (kp_to_bbox_param's scale = 150/height,
    un-inverted by inference.py's `150./bboxes[:, 2:]`; vis_thresh 0.3);
    frames with no visible keypoints or height < 0.5 px are invalid,
    interior gaps are linearly interpolated (get_all_bbox_params), and
    the track is trimmed to its first..last valid frames. The keypoints
    ride along as 'joints2d' (zero confidence on interpolated frames) so
    downstream TemporalSMPLify refines against the track's OWN
    detections, as the reference's pose path does (demo.py:182-184).
    """
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for pid, p in people.items():
        frames = np.asarray(p["frames"], np.int64)
        kps = np.asarray(p["joints2d"], np.float32)
        if frames.size == 0:
            continue
        lo, hi = int(frames.min()), int(frames.max())
        span = hi - lo + 1
        dense_kp = np.zeros((span, kps.shape[1], 3), np.float32)
        dense_kp[frames - lo] = kps
        params = np.full((span, 3), np.nan, np.float32)  # cx, cy, height
        for t in range(span):
            vis = dense_kp[t, :, 2] > vis_thresh
            if not np.any(vis):
                continue
            mn = dense_kp[t, vis, :2].min(axis=0)
            mx = dense_kp[t, vis, :2].max(axis=0)
            height = float(np.linalg.norm(mx - mn))
            if height < min_height:
                continue
            params[t] = [*((mn + mx) / 2.0), height]
        valid = ~np.isnan(params[:, 0])
        if not np.any(valid):
            continue
        idx = np.flatnonzero(valid)
        start, end = idx[0], idx[-1]
        params = params[start:end + 1]
        dense_kp = dense_kp[start:end + 1]
        hole = np.isnan(params[:, 0])
        if np.any(hole):
            t = np.arange(len(params), dtype=np.float32)
            for c in range(3):
                params[hole, c] = np.interp(t[hole], t[~hole],
                                            params[~hole, c])
            dense_kp[hole] = 0.0  # interpolated frames carry no detection
        half = params[:, 2] / 2.0
        out[pid] = {
            "bboxes": np.stack([params[:, 0] - half, params[:, 1] - half,
                                params[:, 0] + half, params[:, 1] + half],
                               axis=1).astype(np.float32),
            "frame_ids": np.arange(lo + start, lo + end + 1),
            "joints2d": dense_kp,
        }
    return out


def bbox_to_cs(bbox: np.ndarray, rescale: float = 1.1) -> np.ndarray:
    """[x0,y0,x1,y1] -> [cx, cy, size] square crop spec."""
    cx = (bbox[0] + bbox[2]) / 2
    cy = (bbox[1] + bbox[3]) / 2
    size = max(bbox[2] - bbox[0], bbox[3] - bbox[1]) * rescale
    return np.array([cx, cy, size], np.float32)


def convert_crop_cam_to_orig_img(cam: np.ndarray, bbox_cs: np.ndarray,
                                 img_width: float, img_height: float
                                 ) -> np.ndarray:
    """Crop-frame weak-persp cam (s, tx, ty) -> original-image orig_cam
    (sx, sy, tx, ty) — demo_utils.py:242-259; this 4-vector is what
    vibe_output.pkl carries and what the weak-persp renderers and
    camera_from_weak_persp consume."""
    cx, cy, h = bbox_cs[:, 0], bbox_cs[:, 1], bbox_cs[:, 2]
    hw, hh = img_width / 2.0, img_height / 2.0
    sx = cam[:, 0] * (1.0 / (img_width / h))
    sy = cam[:, 0] * (1.0 / (img_height / h))
    tx = ((cx - hw) / hw / sx) + cam[:, 1]
    ty = ((cy - hh) / hh / sy) + cam[:, 2]
    return np.stack([sx, sy, tx, ty], axis=1).astype(np.float32)


def run_vibe_on_tracks(frames: Sequence[np.ndarray],
                       tracks: Dict[int, Dict[str, np.ndarray]],
                       backbone, gru, head, smpl,
                       min_track_len: int = 25,
                       batch_time: int = 64,
                       out_res: int = 224,
                       smooth_bboxes: bool = True,
                       smooth: bool = False,
                       smooth_min_cutoff: float = 0.004,
                       smooth_beta: float = 0.7) -> Dict[int, dict]:
    """Per-tracklet VIBE inference -> vibe_output-format dict.

    frames: list of (H, W, 3) uint8 images. Mirrors demo2.py's structure:
    median+gaussian bbox smoothing (smooth_bbox.py), crop each tracked
    frame on the host, run features+GRU+regressor on the SMPL model's
    device, optional One-Euro pose smoothing (--smooth, demo2.py:252-258),
    pack results with joints2d converted to image coordinates
    (demo_utils.py:262-275). The crops of a batch_time chunk go to the
    device as one NHWC float tensor, transposed there to the backbone's
    NCHW.
    """
    import torch
    from ..models.vibe import vibe_forward
    from .crops import get_single_image_crop
    from .smoothing import smooth_bbox_params, smooth_pose_sequence

    out: Dict[int, dict] = {}
    for tid, tr in tracks.items():
        if len(tr["frame_ids"]) < min_track_len:
            continue
        bbox_cs = np.stack([bbox_to_cs(b) for b in tr["bboxes"]])
        if smooth_bboxes:
            bbox_cs = smooth_bbox_params(bbox_cs)
        crops = np.stack([
            get_single_image_crop(frames[f], cs, out_res=out_res)
            for f, cs in zip(tr["frame_ids"], bbox_cs)])
        results = {"theta": [], "kp_2d": []}
        for s in range(0, len(crops), batch_time):
            chunk = torch.from_numpy(crops[s:s + batch_time]).to(
                smpl.device).permute(0, 3, 1, 2)[None]
            with torch.no_grad():
                res = vibe_forward(backbone, gru, head, smpl, chunk)
            results["theta"].append(res["theta"][0].cpu().numpy())
            results["kp_2d"].append(res["kp_2d"][0].cpu().numpy())
        theta = np.concatenate(results["theta"])
        pose = theta[:, 3:75]
        if smooth:
            pose = smooth_pose_sequence(pose, smooth_min_cutoff, smooth_beta)
        kp_norm = np.concatenate(results["kp_2d"])
        H, W = frames[0].shape[:2]
        out[tid] = {
            "pose": pose,
            "betas": theta[:, 75:],
            # the pkl's orig_cam is the ORIGINAL-IMAGE 4-vector weak-persp
            # cam (demo2.py:283-288); the crop cam rides along as pred_cam
            "pred_cam": theta[:, :3],
            "orig_cam": convert_crop_cam_to_orig_img(theta[:, :3], bbox_cs,
                                                     W, H),
            "joints2d_img_coord": crop_to_image_coords(bbox_cs, kp_norm,
                                                       out_res),
            "frame_ids": tr["frame_ids"],
            "bboxes": tr["bboxes"],
            # the (possibly smoothed) [cx, cy, size] crop specs actually
            # used — TemporalSMPLify needs them to map detected keypoints
            # into the same crop frame as pred_cam
            "bbox_cs": bbox_cs,
        }
        if "joints2d" in tr:
            # pose-tracked detections ride through to the pkl under the
            # reference's key (demo.py:252 'joints2d'); SMPLify prefers
            # these per-track keypoints over a directory re-read
            out[tid]["joints2d"] = tr["joints2d"]
    return out


# ---------------------------------------------------------------------------
# SORT-style tracking: constant-velocity Kalman filter + Hungarian matching
# (the reference's MPT tracker is YOLO + SORT; demo2.py:117)
# ---------------------------------------------------------------------------

def _bbox_to_z(bbox: np.ndarray) -> np.ndarray:
    """[x0,y0,x1,y1] -> observation [cx, cy, area, aspect]."""
    w = bbox[2] - bbox[0]
    h = bbox[3] - bbox[1]
    return np.array([bbox[0] + w / 2, bbox[1] + h / 2, w * h,
                     w / max(h, 1e-9)], np.float64)


def _z_to_bbox(z: np.ndarray) -> np.ndarray:
    w = np.sqrt(max(z[2], 1e-9) * max(z[3], 1e-9))
    h = max(z[2], 1e-9) / w
    return np.array([z[0] - w / 2, z[1] - h / 2, z[0] + w / 2, z[1] + h / 2],
                    np.float32)


class KalmanBoxTracker:
    """Constant-velocity Kalman filter over [cx, cy, area, aspect] + their
    velocities (aspect held constant) — the SORT motion model."""

    _DIM_X, _DIM_Z = 7, 4

    def __init__(self, bbox: np.ndarray):
        dx, dz = self._DIM_X, self._DIM_Z
        self.F = np.eye(dx)
        for i in range(3):
            self.F[i, dz + i] = 1.0          # position += velocity
        self.H = np.zeros((dz, dx))
        self.H[:dz, :dz] = np.eye(dz)
        self.R = np.diag([1.0, 1.0, 10.0, 10.0])
        self.P = np.diag([10.0, 10.0, 10.0, 10.0, 1e4, 1e4, 1e4])
        self.Q = np.diag([1.0, 1.0, 1.0, 1.0, 0.01, 0.01, 1e-4])
        self.x = np.zeros(dx)
        self.x[:dz] = _bbox_to_z(bbox)
        self.age = 0          # frames since last match
        self.hits = 0

    def predict(self) -> np.ndarray:
        # keep predicted area non-negative: zero the area velocity first
        if self.x[2] + self.x[6] <= 0:
            self.x[6] = 0.0
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        self.age += 1
        return _z_to_bbox(self.x[:4])

    def update(self, bbox: np.ndarray) -> None:
        z = _bbox_to_z(bbox)
        y = z - self.H @ self.x
        S = self.H @ self.P @ self.H.T + self.R
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.P = (np.eye(self._DIM_X) - K @ self.H) @ self.P
        self.age = 0
        self.hits += 1


def track_bboxes_sort(detections: Sequence[np.ndarray],
                      iou_threshold: float = 0.3, max_age: int = 10,
                      min_hits: int = 1) -> Dict[int, Dict[str, np.ndarray]]:
    """Kalman + Hungarian multi-object tracker (SORT association model).

    Unlike the greedy tracker above, each track carries a motion model, so
    crossing or briefly-occluded people keep their identities — matching
    the behavior of the reference's MPT (YOLO + SORT) stage.
    Returns {track_id: {'bboxes': (T, 4), 'frame_ids': (T,)}} like
    track_bboxes.
    """
    from scipy.optimize import linear_sum_assignment

    next_id = 0
    active: Dict[int, KalmanBoxTracker] = {}
    tracks: Dict[int, dict] = {}
    for f, boxes in enumerate(detections):
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        preds = {tid: kf.predict() for tid, kf in active.items()}
        tids = list(preds)
        matched_dets: set = set()
        if tids and len(boxes):
            iou_m = np.array([[iou(preds[tid], b) for b in boxes]
                              for tid in tids])
            rows, cols = linear_sum_assignment(-iou_m)
            for r, c in zip(rows, cols):
                if iou_m[r, c] < iou_threshold:
                    continue
                tid = tids[r]
                active[tid].update(boxes[c])
                tracks[tid]["bboxes"].append(boxes[c])
                tracks[tid]["frame_ids"].append(f)
                matched_dets.add(c)
        for tid in list(active):
            if active[tid].age > max_age:
                del active[tid]
        for j in range(len(boxes)):
            if j in matched_dets:
                continue
            active[next_id] = KalmanBoxTracker(boxes[j])
            tracks[next_id] = {"bboxes": [boxes[j]], "frame_ids": [f]}
            next_id += 1
    return {tid: {"bboxes": np.stack(t["bboxes"]),
                  "frame_ids": np.asarray(t["frame_ids"])}
            for tid, t in tracks.items()
            if len(t["frame_ids"]) >= min_hits}


def crop_to_image_coords(bbox_cs: np.ndarray, kp_norm: np.ndarray,
                         crop_size: float = 224.0) -> np.ndarray:
    """[-1, 1] crop keypoints -> original image coordinates.

    demo_utils.py:262-275 with the [cx, cy, size] square-crop spec of
    bbox_to_cs: x_img = (cx - size/2) + size * (x_norm + 1) / 2.
    """
    cx, cy, h = bbox_cs[..., 0], bbox_cs[..., 1], bbox_cs[..., 2]
    kp = 0.5 * (kp_norm + 1.0) * h[..., None, None]
    out = kp.copy()
    out[..., 0] += (cx - h / 2)[..., None]
    out[..., 1] += (cy - h / 2)[..., None]
    return out
