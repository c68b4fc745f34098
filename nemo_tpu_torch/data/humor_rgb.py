"""HuMoR RGB / PROX observation datasets (host-side data layer), in numpy.

Port of nemo_tpu/data/humor_rgb.py (behavioral references:
humor/humor/datasets/rgb_dataset.py:18-231, prox_dataset.py:18-441 and
fitting/fitting_utils.py:21-146): the OpenPose keypoint walk, the
overlapping-subsequence split, person-mask joint occlusion, the PlaneRCNN
floor plane, the PROX recording walk with its flip convention and ground
truth fits, and the Kinect depth back-projection (the inverse
Brown-Conrady distortion by fixed-point iteration, as cv2 solves it). It is
the JAX package's numpy, copied: the port imports nothing of nemo_tpu.
Masks and 16-bit depth images are read with PIL through
``data/images.py``, which gives the values ``plt.imread`` gives the JAX
module; PIL is required for them (an ImportError names it).
"""

from __future__ import annotations

import glob
import json
import math
import os
import os.path as osp
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .amass_process import np_rodrigues, resize_points
from .images import read_depth, read_mask
from .openpose import parse_openpose_json

# --- OpenPose BODY_25 constants (fitting_utils.py:678-682) -------------------

OP_NUM_JOINTS = 25
OP_IGNORE_JOINTS = [1, 9, 12]  # neck and left/right hip
OP_EDGE_LIST = [[1, 8], [1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7],
                [8, 9], [9, 10], [10, 11], [8, 12], [12, 13], [13, 14],
                [1, 0], [0, 15], [15, 17], [0, 16], [16, 18], [14, 19],
                [19, 20], [14, 21], [11, 22], [22, 23], [11, 24]]
OP_FLIP_MAP = [0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11, 16, 15,
               18, 17, 22, 23, 24, 19, 20, 21]

# --- RGB video dataset constants (rgb_dataset.py:16) --------------------------

DEFAULT_GROUND = np.array([0.0, -1.0, 0.0, -0.5])
# fx, fy the RGB fitting assumes without intrinsics (fitting_utils.py:18)
DEFAULT_FOCAL_LEN = (1060.531764702488, 1060.3856705041237)

# --- PROX constants (prox_dataset.py:18-50) -----------------------------------

TRIM_EDGES = 90  # frames cut off each end of qualitative recordings
QUAL_FPS = 30
QUANT_FPS = 5
QUANT_SPLITS = [['vicon'], ['vicon']]
QUAL_TRAIN = ['BasementSittingBooth', 'MPH16', 'N0SittingBooth', 'N3Office',
              'MPH112', 'MPH1Library', 'N0Sofa', 'N3OpenArea', 'MPH11',
              'MPH8', 'N3Library', 'Werkraum']
QUAL_TEST = ['N3Office', 'N0Sofa', 'N3Library', 'MPH1Library']
QUAL_SPLITS = [QUAL_TRAIN, QUAL_TEST]

SMPL_NAME_MAP = {'transl': 'trans', 'beta': 'betas',
                 'body_pose': 'pose_body', 'global_orient': 'root_orient',
                 'betas': 'betas'}
SMPL_SIZES = {'trans': 3, 'betas': 10, 'pose_body': 63, 'root_orient': 3}

FEMALE_SUBJ_IDS = [162, 3452, 159, 3403]
DEPTH_SCALE = 1e-3
IMG_WIDTH, IMG_HEIGHT = 1920, 1080


# --- keypoints ----------------------------------------------------------------

def read_keypoints(keypoint_fn: str) -> np.ndarray:
    """First person's (25, 3) [x, y, conf] from an OpenPose JSON; zeros
    when no people were detected (fitting_utils.py:21-37)."""
    return parse_openpose_json(keypoint_fn)


def mask_joints2d(joints2d: np.ndarray, masks: Sequence[np.ndarray],
                  img_width: Optional[int] = None,
                  img_height: Optional[int] = None) -> np.ndarray:
    """Zero out joints that land on nonzero person-segmentation mask pixels
    (occluded), in place on a copy (rgb_dataset.py:174-187 /
    prox_dataset.py:283-290). masks: per-frame (H, W) uint8 arrays where 0
    marks the visible person."""
    joints2d = np.array(joints2d, copy=True)
    for t, mask in enumerate(masks):
        imh, imw = mask.shape[:2]
        imw = img_width or imw
        imh = img_height or imh
        uvs = np.round(joints2d[t, :, :2]).astype(int)
        uvs[:, 0] = np.clip(uvs[:, 0], None, imw - 1)
        uvs[:, 1] = np.clip(uvs[:, 1], None, imh - 1)
        occluded = mask[uvs[:, 1], uvs[:, 0]] != 0
        joints2d[t, occluded] = 0.0
    return joints2d


# --- floor plane ---------------------------------------------------------------

def load_planercnn_res(res_path: str) -> np.ndarray:
    """Heuristic ground plane (a, b, c, d) from a PlaneRCNN result dir:
    the plane owning the most pixels in the bottom 10 rows whose (camera
    frame, -y up) normal is mostly vertical (fitting_utils.py:105-146)."""
    planes_param_path = glob.glob(res_path + '/*_plane_parameters_*.npy')[0]
    planes_mask_path = glob.glob(res_path + '/*_plane_masks_*.npy')[0]
    planes_params = np.load(planes_param_path)
    planes_masks = np.load(planes_mask_path)

    nrows = 10
    label_count = np.sum(planes_masks[:, -nrows:, :], axis=(1, 2))
    floor_idx = int(np.argmax(label_count))
    while True:
        raw = planes_params[floor_idx]
        # PlaneRCNN axes -> camera frame (:129)
        plane = np.array([raw[0], -raw[2], raw[1]])
        offset = np.linalg.norm(plane)
        normal = plane / offset
        if normal[1] > 0.0:  # y should be negative (up is -y)
            offset, normal = -offset, -normal
        floor_plane = np.array([normal[0], normal[1], normal[2], offset])
        if abs(normal[1]) > abs(normal[0]) and abs(normal[1]) > abs(normal[2]):
            return floor_plane
        label_count[floor_idx] = 0
        floor_idx = int(np.argmax(label_count))


# --- RGB video dataset ----------------------------------------------------------

def split_overlapping_intervals(num_frames: int, seq_len: int,
                                overlap_len: int
                                ) -> Tuple[List[Tuple[int, int]], int]:
    """The reference's even overlapping-subsequence split
    (rgb_dataset.py:75-95): covers [0, num_frames) with ceil-many seq_len
    windows, growing the overlap so extra coverage is spread evenly; the
    first `r` gaps get one extra overlap frame. Returns (intervals,
    effective overlap_len)."""
    num_seqs = math.ceil((num_frames - overlap_len) / (seq_len - overlap_len))
    r = seq_len * num_seqs - overlap_len * (num_seqs - 1) - num_frames
    extra_o = r // (num_seqs - 1) if num_seqs > 1 else 0
    overlap_len = overlap_len + extra_o
    new_cov = seq_len * num_seqs - overlap_len * (num_seqs - 1)
    r = new_cov - num_frames

    intervals = []
    cur_s = 0
    cur_e = cur_s + seq_len
    for int_idx in range(num_seqs):
        intervals.append((cur_s, cur_e))
        cur_overlap = overlap_len
        if int_idx < r:
            cur_overlap += 1
        cur_s += seq_len - cur_overlap
        cur_e = cur_s + seq_len
    return intervals, overlap_len


def load_rgb_video_observations(joints2d_path: str,
                                cam_mat: np.ndarray,
                                seq_len: Optional[int] = None,
                                overlap_len: Optional[int] = None,
                                img_path: Optional[str] = None,
                                masks_path: Optional[str] = None,
                                mask_joints: bool = False,
                                planercnn_path: Optional[str] = None,
                                video_name: str = 'rgb_video',
                                imread=None) -> List[Dict]:
    """Single-RGB-video observation assembly (rgb_dataset.py:63-231).

    Walks `<joints2d_path>/*_keypoints.json`, splits the video into
    overlapping subsequences (or one whole-video sequence), and returns one
    dict per subsequence: joints2d (T, 25, 3), cam_matx (3, 3), floor_plane
    (4,), name, seq_interval, and img_paths/mask_paths when provided. With
    mask_joints=True the person-segmentation masks zero occluded joints
    (requires masks_path; `imread` defaults to data/images.read_mask)."""
    keyp_paths = sorted(glob.glob(osp.join(joints2d_path,
                                           '*_keypoints.json')))
    frame_names = ['_'.join(osp.basename(f).split('_')[:-1])
                   for f in keyp_paths]
    num_frames = len(keyp_paths)

    if seq_len is not None and overlap_len is not None:
        seq_intervals, overlap_len = split_overlapping_intervals(
            num_frames, seq_len, overlap_len)
    else:
        seq_len = num_frames
        seq_intervals = [(0, num_frames)]

    img_paths = None
    if img_path is not None:
        img_paths = sorted(
            osp.join(img_path, fn) for fn in os.listdir(img_path)
            if (fn.endswith('.png') or fn.endswith('.jpg'))
            and not fn.startswith('.'))
    mask_paths = None
    if masks_path is not None:
        mask_paths = [osp.join(masks_path, f + '.png') for f in frame_names]

    if planercnn_path is not None:
        floor_plane = load_planercnn_res(planercnn_path)
    else:
        floor_plane = DEFAULT_GROUND.copy()

    all_kp = np.stack([read_keypoints(f) for f in keyp_paths], axis=0) \
        if keyp_paths else np.zeros((0, OP_NUM_JOINTS, 3), np.float32)

    imread = imread or read_mask
    out = []
    for seq_idx, (sidx, eidx) in enumerate(seq_intervals):
        joints2d = all_kp[sidx:eidx].copy()
        entry = {
            'joints2d': joints2d,
            'cam_matx': np.asarray(cam_mat, np.float32),
            'floor_plane': floor_plane,
            'name': '%s_%04d' % (video_name, seq_idx),
            'seq_interval': (sidx, eidx),
        }
        if img_paths is not None:
            entry['img_paths'] = img_paths[sidx:eidx]
        if mask_paths is not None:
            entry['mask_paths'] = mask_paths[sidx:eidx]
            if mask_joints:
                masks = [imread(p) for p in mask_paths[sidx:eidx]]
                entry['joints2d'] = mask_joints2d(joints2d, masks)
        out.append(entry)
    return out


# --- PROX dataset ---------------------------------------------------------------

def read_fitting_seq(fitting_paths: Sequence[str], return_valid: bool = False):
    """PROX/PROXD per-frame SMPL fit pkls -> stacked numpy dict with this
    framework's field names; missing/non-finite frames become zero rows
    (prox_dataset.py:52-94)."""
    fit_dict: Dict[str, List[np.ndarray]] = {v: [] for v in SMPL_SIZES}
    valid_list = []
    for fpath in fitting_paths:
        if not osp.exists(fpath):
            for k, v in SMPL_SIZES.items():
                fit_dict[k].append(np.zeros((1, v), np.float32))
            valid_list.append(False)
            continue
        with open(fpath, 'rb') as f:
            param = pickle.load(f, encoding='latin1')
        cur_valid = True
        for key in param:
            if key in SMPL_NAME_MAP:
                arr = np.asarray(param[key], np.float32)
                cur_valid = cur_valid and bool(np.isfinite(arr).all())
                name = SMPL_NAME_MAP[key]
                if cur_valid:
                    fit_dict[name].append(arr.reshape(1, -1))
                else:
                    fit_dict[name].append(
                        np.zeros((1, SMPL_SIZES[name]), np.float32))
        valid_list.append(cur_valid)
    out = {k: np.concatenate(v, axis=0) for k, v in fit_dict.items() if v}
    if return_valid:
        return out, valid_list
    return out


def prox_recordings(root_path: str, quant: bool = False,
                    split: str = 'train',
                    recording: Optional[str] = None) -> List[str]:
    """Recording directories of a PROX split (prox_dataset.py:161-180)."""
    data_dir = osp.join(root_path, 'quantitative' if quant
                        else 'qualitative')
    rec_root = osp.join(data_dir, 'recordings')
    if recording is not None:
        rec_path = osp.join(rec_root, recording)
        return [rec_path] if osp.exists(rec_path) else []
    splits = QUANT_SPLITS if quant else QUAL_SPLITS
    split_scenes = splits[0] if split == 'train' else splits[1]
    recs = [osp.join(rec_root, f) for f in sorted(os.listdir(rec_root))
            if f[0] != '.'] if osp.isdir(rec_root) else []
    recs = [f for f in recs if osp.isdir(f)]
    return [f for f in recs
            if osp.basename(f).split('_')[0] in split_scenes]


def prox_subsequences(root_path: str, quant: bool = False,
                      split: str = 'train', seq_len: int = 10,
                      recording: Optional[str] = None,
                      recording_subseq_idx: int = -1
                      ) -> Tuple[List[List[str]], List[int]]:
    """Non-overlapping seq_len splits of each recording's Color frames,
    with the qualitative edge trim (prox_dataset.py:186-222). Returns
    (per-subsequence img path lists, per-subsequence indices)."""
    img_path_list: List[List[str]] = []
    subseq_idx_list: List[int] = []
    for rec_path in prox_recordings(root_path, quant, split, recording):
        img_folder = osp.join(rec_path, 'Color')
        if not osp.isdir(img_folder):
            continue
        img_paths = sorted(
            osp.join(img_folder, fn) for fn in os.listdir(img_folder)
            if (fn.endswith('.png') or fn.endswith('.jpg'))
            and not fn.startswith('.'))
        cur_rec_len = len(img_paths)
        if not quant and (cur_rec_len - 2 * TRIM_EDGES) >= seq_len:
            img_paths = img_paths[TRIM_EDGES:-TRIM_EDGES]
            cur_rec_len = len(img_paths)
        if cur_rec_len < seq_len:
            continue
        num_seqs = cur_rec_len // seq_len
        if recording_subseq_idx > -1:
            sidx = recording_subseq_idx * seq_len
            img_path_list.append(img_paths[sidx:sidx + seq_len])
            subseq_idx_list.append(recording_subseq_idx)
        else:
            for i in range(num_seqs):
                img_path_list.append(img_paths[i * seq_len:
                                               (i + 1) * seq_len])
                subseq_idx_list.append(i)
    return img_path_list, subseq_idx_list


def prox_data_paths_from_img(img_paths: Sequence[str], root_path: str,
                             quant: bool = False) -> Dict[str, List[str]]:
    """Sibling modality paths for one subsequence's Color frames
    (prox_dataset.py:223-242)."""
    data_dir = osp.join(root_path, 'quantitative' if quant
                        else 'qualitative')
    rec_path = osp.dirname(osp.dirname(img_paths[0]))
    rec_name = osp.basename(rec_path)
    frame_names = ['.'.join(osp.basename(f).split('.')[:-1])
                   for f in img_paths]
    fitting_root = (osp.join(data_dir, 'fittings/mosh') if quant
                    else osp.join(data_dir, 'PROXD'))
    return {
        'keypoints': [osp.join(data_dir, 'keypoints', rec_name,
                               f + '_keypoints.json') for f in frame_names],
        'depth': [osp.join(rec_path, 'Depth', f + '.png')
                  for f in frame_names],
        'mask': [osp.join(rec_path, 'BodyIndex', f + '.png')
                 for f in frame_names],
        'mask_color': [osp.join(rec_path, 'BodyIndexColor', f + '.png')
                       for f in frame_names],
        'fitting': [osp.join(fitting_root, rec_name, 'results', f,
                             '000.pkl') for f in frame_names],
    }


def prox_gender(rec_name: str) -> str:
    """Subject gender from a recording name (prox_dataset.py:434-436)."""
    subj_id = rec_name.split('_')[1]
    return 'female' if int(subj_id) in FEMALE_SUBJ_IDS else 'male'


def load_prox_calibration(calib_dir: str) -> Dict[str, Dict]:
    """PROX Kinect calibration jsons (prox_dataset.py:444-448). Returns
    {'depth_cam': ..., 'color_cam': ...} dicts with camera_mtx, k (8-coeff
    Brown-Conrady distortion), view_mtx, R, T entries."""
    with open(osp.join(calib_dir, 'IR.json')) as f:
        depth_cam = json.load(f)
    with open(osp.join(calib_dir, 'Color.json')) as f:
        color_cam = json.load(f)
    return {'depth_cam': depth_cam, 'color_cam': color_cam}


# --- Kinect depth back-projection (numpy; replaces cv2 calls) -------------------

def _undistort_points(uv: np.ndarray, camera_mtx: np.ndarray,
                      k: np.ndarray, iters: int = 5) -> np.ndarray:
    """Normalized image coordinates of distorted pixel coords, inverting
    the Brown-Conrady model by fixed-point iteration — the same scheme as
    cv2.undistortPoints (prox_dataset.py:461-462 calls cv2). k: up to 8
    coefficients [k1, k2, p1, p2, k3, k4, k5, k6]."""
    camera_mtx = np.asarray(camera_mtx, np.float64)
    kk = np.zeros(8)
    k = np.asarray(k, np.float64).reshape(-1)
    kk[:k.shape[0]] = k
    k1, k2, p1, p2, k3, k4, k5, k6 = kk
    fx, fy = camera_mtx[0, 0], camera_mtx[1, 1]
    cx, cy = camera_mtx[0, 2], camera_mtx[1, 2]
    xd = (uv[:, 0] - cx) / fx
    yd = (uv[:, 1] - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = (1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3) / \
                 (1 + k4 * r2 + k5 * r2 ** 2 + k6 * r2 ** 3)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return np.stack([x, y], axis=1)


def _distort_project(points: np.ndarray, cam: Dict) -> np.ndarray:
    """Forward Brown-Conrady projection of (N, 3) camera-frame points to
    pixel coords — cv2.projectPoints with the calib's R/T
    (prox_dataset.py:470-472)."""
    R = np.asarray(cam.get('R', np.eye(3)), np.float64)
    if R.size == 3:  # rodrigues vector
        R = np_rodrigues(R.reshape(3))
    T = np.asarray(cam.get('T', np.zeros(3)), np.float64).reshape(3)
    camera_mtx = np.asarray(cam['camera_mtx'], np.float64)
    kk = np.zeros(8)
    kcoef = np.asarray(cam.get('k', []), np.float64).reshape(-1)
    kk[:kcoef.shape[0]] = kcoef
    k1, k2, p1, p2, k3, k4, k5, k6 = kk
    pc = points @ R.T + T
    x = pc[:, 0] / pc[:, 2]
    y = pc[:, 1] / pc[:, 2]
    r2 = x * x + y * y
    radial = (1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3) / \
             (1 + k4 * r2 + k5 * r2 ** 2 + k6 * r2 ** 3)
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    fx, fy = camera_mtx[0, 0], camera_mtx[1, 1]
    cx, cy = camera_mtx[0, 2], camera_mtx[1, 2]
    return np.stack([xd * fx + cx, yd * fy + cy], axis=1)


def unproject_depth_image(depth_image: np.ndarray, cam: Dict) -> np.ndarray:
    """Back-project a (H, W) metric depth image to camera-frame points
    (H, W, 3) using the calib's intrinsics + distortion + view matrix
    (prox_dataset.py:455-468)."""
    H, W = depth_image.shape
    us = np.arange(depth_image.size) % W
    vs = np.arange(depth_image.size) // W
    ds = depth_image.ravel()
    xy = _undistort_points(np.stack([us, vs], axis=1).astype(np.float64),
                           np.asarray(cam['camera_mtx']),
                           np.asarray(cam.get('k', [])))
    xyz = np.concatenate([xy, ds[:, None]], axis=1)
    xyz[:, :2] *= xyz[:, 2:3]
    view = np.asarray(cam['view_mtx'], np.float64)
    xyz = (xyz - view[:, 3]) @ view[:, :3]
    return xyz.reshape(H, W, 3)


def create_scan(mask: np.ndarray, depth_im: np.ndarray, calib: Dict,
                mask_on_color: bool = True, coord: str = 'color',
                thresh: float = 1e-2) -> np.ndarray:
    """Person point cloud from a Kinect depth frame + body-index mask
    (prox_dataset.py:474-511): back-project the depth image, keep points
    whose color-frame projection lands on mask==0 pixels (mask_on_color)
    or zero masked depth first, optionally transform to the color camera
    frame, and drop points with z <= thresh. Returns (N, 3)."""
    depth_cam, color_cam = calib['depth_cam'], calib['color_cam']
    depth_im = np.array(depth_im, np.float64, copy=True)
    if not mask_on_color:
        depth_im[mask != 0] = 0
    points = unproject_depth_image(depth_im, depth_cam).reshape(-1, 3)
    uvs = np.round(_distort_project(points, color_cam)).astype(int)
    valid = ((uvs[:, 1] >= 0) & (uvs[:, 1] < IMG_HEIGHT)
             & (uvs[:, 0] >= 0) & (uvs[:, 0] < IMG_WIDTH))
    if mask_on_color:
        keep = valid.copy()
        keep[valid] = mask[uvs[valid][:, 1], uvs[valid][:, 0]] == 0
        points = points[keep]
    else:
        points = points[valid]
    if coord == 'color':
        view = np.asarray(color_cam['view_mtx'], np.float64)
        points = points @ view[:, :3].T + view[:, 3]
    return points[points[:, 2] > thresh]


def load_prox_depth_points(depth_paths: Sequence[str],
                           masks: Sequence[np.ndarray], calib: Dict,
                           max_pts: int = 4096, mask_on_color: bool = True,
                           flip: bool = True, imread=None,
                           seed: int = 0) -> np.ndarray:
    """Per-frame person point clouds (T, max_pts, 3) from PROX depth pngs
    (prox_dataset.py:320-352): raw/8 * 1e-3 metric scaling, optional
    horizontal flip, empty frames copy the previous frame (zeros at t=0)."""
    imread = imread or read_depth
    rng = np.random.default_rng(seed)
    points_list: List[np.ndarray] = []
    for dpath, mask in zip(depth_paths, masks):
        depth_im = np.asarray(imread(dpath), np.float64) / 8.0 * DEPTH_SCALE
        if flip:
            depth_im = depth_im[:, ::-1]
        pts = create_scan(mask, depth_im, calib, mask_on_color=mask_on_color)
        if pts.shape[0] == 0:
            pts = (points_list[-1] if points_list
                   else np.zeros((max_pts, 3)))
        else:
            pts = resize_points(pts, max_pts, rng)
        points_list.append(pts)
    return np.stack(points_list, axis=0)


def load_prox_observations(root_path: str, quant: bool = False,
                           split: str = 'train', seq_len: int = 10,
                           recording: Optional[str] = None,
                           recording_subseq_idx: int = -1,
                           mask_joints: bool = False,
                           load_floor_plane: bool = False,
                           return_fitting: bool = True,
                           flip: bool = True, imread=None) -> List[Dict]:
    """PROX observation assembly (prox_dataset.py:246-441, RGB modalities).

    Returns one dict per subsequence: joints2d (with the reference's flip
    convention: qualitative detections are reflected via OP_FLIP_MAP +
    x -> W - x when flip=True), cam_matx, cam2world, name, gender,
    img/keypoint/mask paths, optional PlaneRCNN floor_plane and PROX(D)
    ground-truth SMPL fit arrays. Depth point clouds are loaded separately
    via `load_prox_depth_points` (they need the mask images)."""
    data_dir = osp.join(root_path, 'quantitative' if quant
                        else 'qualitative')
    seqs, subseq_inds = prox_subsequences(
        root_path, quant, split, seq_len, recording, recording_subseq_idx)
    calib_dir = osp.join(data_dir, 'calibration')
    calib = (load_prox_calibration(calib_dir) if osp.isdir(calib_dir)
             else None)

    imread = imread or read_mask
    out = []
    for img_paths, subseq_idx in zip(seqs, subseq_inds):
        rec_name = osp.basename(osp.dirname(osp.dirname(img_paths[0])))
        paths = prox_data_paths_from_img(img_paths, root_path, quant)
        joints2d = np.stack([read_keypoints(f) for f in paths['keypoints']],
                            axis=0)
        # quant keypoints ship pre-flipped (prox_dataset.py:278-281)
        if (not quant and flip) or (quant and not flip):
            joints2d = joints2d[:, OP_FLIP_MAP, :]
            joints2d[:, :, 0] = IMG_WIDTH - joints2d[:, :, 0]
        if mask_joints:
            masks = [imread(p) for p in paths['mask_color']]
            if flip:
                masks = [m[:, ::-1] for m in masks]
            joints2d = mask_joints2d(joints2d, masks,
                                     IMG_WIDTH, IMG_HEIGHT)
        entry = {
            'joints2d': joints2d,
            'img_paths': list(img_paths),
            'keypoint_paths': paths['keypoints'],
            'mask_paths': paths['mask_color'],
            'depth_paths': paths['depth'],
            'name': '%s_%04d' % (rec_name, subseq_idx),
            'gender': prox_gender(rec_name),
        }
        scene_name = rec_name.split('_')[0]
        cam2world_path = osp.join(data_dir, 'cam2world',
                                  scene_name + '.json')
        if osp.exists(cam2world_path):
            with open(cam2world_path) as f:
                entry['cam2world'] = np.array(json.load(f))
        if calib is not None:
            entry['cam_matx'] = np.asarray(
                calib['color_cam']['camera_mtx'], np.float32)
        if load_floor_plane:
            planes_path = osp.join(data_dir, 'planes', scene_name)
            if osp.isdir(planes_path):
                entry['floor_plane'] = load_planercnn_res(planes_path)
        if return_fitting:
            fit_paths = [p for p in paths['fitting']]
            entry.update({('gt_' + k): v for k, v in
                          read_fitting_seq(fit_paths).items()})
        out.append(entry)
    return out
