"""Image crop utilities: bbox -> square patch crop + ImageNet normalize
(port of nemo_tpu/data/crops.py; host numpy, the same code).

Behavioral reference: hmr/img_utils.py (get_single_image_crop / crop_image)
— the affine crop feeding HMR/VIBE 224x224 inputs. cv2-free: the affine
resample is a numpy bilinear gather on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..body.constants import IMG_NORM_MEAN, IMG_NORM_STD, IMG_RES


def bbox_from_keypoints(kp: np.ndarray, rescale: float = 1.2
                        ) -> np.ndarray:
    """Square bbox [cx, cy, size] around confident keypoints (..., K, 3)."""
    conf = kp[..., 2] > 0
    xs = np.where(conf, kp[..., 0], np.nan)
    ys = np.where(conf, kp[..., 1], np.nan)
    x0, x1 = np.nanmin(xs, -1), np.nanmax(xs, -1)
    y0, y1 = np.nanmin(ys, -1), np.nanmax(ys, -1)
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    size = np.maximum(x1 - x0, y1 - y0) * rescale
    return np.stack([cx, cy, size], -1)


def crop_image(img: np.ndarray, center: Tuple[float, float], size: float,
               out_res: int = IMG_RES) -> np.ndarray:
    """Crop a square patch (bilinear, zero-padded outside) -> (res, res, C)."""
    H, W = img.shape[:2]
    cx, cy = center
    # source sample grid
    lin = (np.arange(out_res) + 0.5) / out_res - 0.5
    xs = cx + lin * size
    ys = cy + lin * size
    gx, gy = np.meshgrid(xs, ys)

    x0 = np.floor(gx).astype(np.int64)
    y0 = np.floor(gy).astype(np.int64)
    fx = gx - x0
    fy = gy - y0

    def sample(yy, xx):
        valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        yy = np.clip(yy, 0, H - 1)
        xx = np.clip(xx, 0, W - 1)
        out = img[yy, xx].astype(np.float32)
        return out * valid[..., None]

    c = (sample(y0, x0) * ((1 - fx) * (1 - fy))[..., None]
         + sample(y0, x0 + 1) * (fx * (1 - fy))[..., None]
         + sample(y0 + 1, x0) * ((1 - fx) * fy)[..., None]
         + sample(y0 + 1, x0 + 1) * (fx * fy)[..., None])
    return c


def get_single_image_crop(img: np.ndarray, bbox: np.ndarray,
                          out_res: int = IMG_RES,
                          normalize: bool = True) -> np.ndarray:
    """bbox [cx, cy, size] -> normalized (res, res, 3) float32 patch.

    Matches the reference pipeline: crop, scale to [0, 1], ImageNet
    normalize (hmr/img_utils.py + constants IMG_NORM_*). NHWC layout (the
    torch reference is CHW).
    """
    patch = crop_image(img, (bbox[0], bbox[1]), bbox[2], out_res)
    if img.dtype == np.uint8 or patch.max() > 2.0:
        patch = patch / 255.0
    if normalize:
        patch = (patch - np.asarray(IMG_NORM_MEAN)) / np.asarray(IMG_NORM_STD)
    return patch.astype(np.float32)


# ---------------------------------------------------------------------------
# SPIN-style scale/rotation crop frame (utils/imutils.py:12-139) — the
# training-time augmentation geometry of the HMR/VIBE datasets.
# ---------------------------------------------------------------------------

def get_transform(center, scale, res, rot: float = 0.0) -> np.ndarray:
    """Output-pixel <- input-pixel affine for a (center, scale) crop of
    size res, optionally rotated by `rot` degrees around the crop center
    (utils/imutils.py:12-36; h = 200*scale is the SPIN convention)."""
    h = 200.0 * scale
    t = np.zeros((3, 3))
    t[0, 0] = res[1] / h
    t[1, 1] = res[0] / h
    t[0, 2] = res[1] * (-center[0] / h + 0.5)
    t[1, 2] = res[0] * (-center[1] / h + 0.5)
    t[2, 2] = 1.0
    if rot != 0:
        rad = np.deg2rad(-rot)
        sn, cs = np.sin(rad), np.cos(rad)
        rot_mat = np.array([[cs, -sn, 0.0], [sn, cs, 0.0], [0.0, 0.0, 1.0]])
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2
        t_mat[1, 2] = -res[0] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def transform_point(pt, center, scale, res, invert: bool = False,
                    rot: float = 0.0) -> np.ndarray:
    """Map a (1-based) pixel location through the crop transform
    (utils/imutils.py:38-45)."""
    t = get_transform(center, scale, res, rot=rot)
    if invert:
        t = np.linalg.inv(t)
    new_pt = t @ np.array([pt[0] - 1.0, pt[1] - 1.0, 1.0])
    return new_pt[:2].astype(int) + 1


def crop_scale(img: np.ndarray, center, scale, res=(IMG_RES, IMG_RES),
               rot: float = 0.0) -> np.ndarray:
    """(center, scale)-crop with optional rotation, edge padding, and
    resize to `res` (utils/imutils.py:47-100) — cv2/PIL-free via the
    bilinear gather + scipy rotation."""
    ul = transform_point([1, 1], center, scale, res, invert=True) - 1
    br = transform_point([res[0] + 1, res[1] + 1], center, scale, res,
                         invert=True) - 1
    pad = int(np.linalg.norm(br - ul) / 2 - float(br[1] - ul[1]) / 2)
    if rot != 0:
        ul = ul - pad
        br = br + pad
    # crop the [ul, br) window at native resolution (edge padding) through
    # the shared bilinear sampler, then rotate/trim/resize
    side = np.array([br[1] - ul[1], br[0] - ul[0]], float)
    cx, cy = (ul[0] + br[0]) / 2.0, (ul[1] + br[1]) / 2.0
    n = int(max(side))
    patch = _sample_patch(img, cx, cy, float(br[0] - ul[0]),
                          float(br[1] - ul[1]), n, n)
    if rot != 0:
        from scipy.ndimage import rotate as nd_rotate
        patch = nd_rotate(patch, rot, reshape=False, order=1, mode="nearest")
        frac = pad / max((br[1] - ul[1]), 1)
        cut = int(round(frac * n))
        if cut > 0:
            patch = patch[cut:-cut, cut:-cut]
    return _resize_bilinear(patch, res)


def _sample_patch(img, cx, cy, w, h, out_w, out_h):
    """Bilinear sample a (w, h) window centred at (cx, cy) to (out_h,
    out_w), clamping to the image edge (repeated edge padding)."""
    H, W = img.shape[:2]
    xs = cx + ((np.arange(out_w) + 0.5) / out_w - 0.5) * w
    ys = cy + ((np.arange(out_h) + 0.5) / out_h - 0.5) * h
    gx, gy = np.meshgrid(xs, ys)
    x0 = np.floor(gx).astype(np.int64)
    y0 = np.floor(gy).astype(np.int64)
    fx, fy = gx - x0, gy - y0

    def samp(yy, xx):
        return img[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)].astype(
            np.float32)

    out = (samp(y0, x0) * ((1 - fx) * (1 - fy))[..., None]
           + samp(y0, x0 + 1) * (fx * (1 - fy))[..., None]
           + samp(y0 + 1, x0) * ((1 - fx) * fy)[..., None]
           + samp(y0 + 1, x0 + 1) * (fx * fy)[..., None])
    return out


def _resize_bilinear(img, res):
    H, W = img.shape[:2]
    return _sample_patch(img, W / 2.0 - 0.5, H / 2.0 - 0.5, W, H,
                         res[1], res[0])


def uncrop(img: np.ndarray, center, scale, orig_shape) -> np.ndarray:
    """Paste a cropped/resized patch back into original-image coordinates
    (utils/imutils.py:102-126; nearest resize, used for segmentation
    eval)."""
    res = img.shape[:2]
    ul = transform_point([1, 1], center, scale, res, invert=True) - 1
    br = transform_point([res[0] + 1, res[1] + 1], center, scale, res,
                         invert=True) - 1
    crop_shape = (br[1] - ul[1], br[0] - ul[0])
    new_shape = list(orig_shape)
    new_img = np.zeros(new_shape, dtype=img.dtype)
    new_x = max(0, -ul[0]), min(br[0], orig_shape[1]) - ul[0]
    new_y = max(0, -ul[1]), min(br[1], orig_shape[0]) - ul[1]
    old_x = max(0, ul[0]), min(orig_shape[1], br[0])
    old_y = max(0, ul[1]), min(orig_shape[0], br[1])
    # nearest-neighbour resize to the crop window
    yy = np.clip((np.arange(crop_shape[0]) * res[0] / crop_shape[0])
                 .astype(np.int64), 0, res[0] - 1)
    xx = np.clip((np.arange(crop_shape[1]) * res[1] / crop_shape[1])
                 .astype(np.int64), 0, res[1] - 1)
    big = img[yy][:, xx]
    new_img[old_y[0]:old_y[1], old_x[0]:old_x[1]] = \
        big[new_y[0]:new_y[1], new_x[0]:new_x[1]]
    return new_img


def rot_aa(aa: np.ndarray, rot: float) -> np.ndarray:
    """Rotate global-orientation axis-angle by `rot` degrees about the
    camera z axis (utils/imutils.py:128-139)."""
    from scipy.spatial.transform import Rotation

    rad = np.deg2rad(-rot)
    Rz = Rotation.from_rotvec([0.0, 0.0, rad])
    return (Rz * Rotation.from_rotvec(np.asarray(aa, float))).as_rotvec()


def flip_img(img: np.ndarray) -> np.ndarray:
    """Horizontal image flip (utils/imutils.py:141-146)."""
    return np.ascontiguousarray(img[:, ::-1])
