"""Overlay videos: per-frame keypoint or mesh overlays -> mp4.

Port of nemo_tpu/render/video.py. The mesh video renders all views of a
frame in one batched call on the render device, copies them to the host
once, composites them with numpy and writes the frame with a PNG encoder
built on ``zlib`` and ``struct`` alone, so writing needs neither PIL nor
matplotlib; the video frames behind a mesh are read with PIL. Frames
become an mp4 through ffmpeg, or stay as a ``.frames`` directory where
ffmpeg is missing.
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
import struct
import subprocess
import tempfile
import zlib
from typing import Optional

import numpy as np
import torch

from .keypoints import draw_skeleton


def render_overlay_video(out_path: str, pts2d_pred: np.ndarray, bundle,
                         label_type: str = "gt", fps: float = 30.0,
                         max_views: int = 4, dpi: int = 60) -> str:
    """mp4 of predicted against labelled 2D keypoints per frame, views
    side by side (matplotlib; pts2d_pred (V, F, 25, 2))."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    V = min(bundle.num_views, max_views)
    labels = bundle.label(label_type)
    d0, d1 = bundle.img_d0, bundle.img_d1
    with tempfile.TemporaryDirectory() as tmp:
        for f in range(bundle.num_frames):
            fig, axs = plt.subplots(1, V, figsize=(4 * V, 4))
            axs = np.atleast_1d(axs)
            for v in range(V):
                ax = axs[v]
                ax.set_xlim(0, d1), ax.set_ylim(d0, 0)
                ax.set_xticks([]), ax.set_yticks([])
                draw_skeleton(ax, labels[v, f, :, :2], "C0",
                              labels[v, f, :, 2:])
                draw_skeleton(ax, pts2d_pred[v, f], "C3")
                ax.set_title(f"view {v} frame {f}", fontsize=8)
            fig.savefig(osp.join(tmp, f"{f:06d}.png"), dpi=dpi,
                        bbox_inches="tight")
            plt.close(fig)
        # bbox_inches can give odd sizes: ffmpeg pads to even ones
        cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-i",
               osp.join(tmp, "%06d.png"), "-vf",
               "pad=ceil(iw/2)*2:ceil(ih/2)*2", "-c:v", "libx264",
               "-pix_fmt", "yuv420p", out_path]
        return _assemble(tmp, out_path, cmd)


def _assemble(frame_dir: str, out_path: str, cmd) -> str:
    """Run the ffmpeg command cmd that turns frame_dir into out_path;
    without ffmpeg (or when it fails) the frames are left in out_path +
    '.frames', which is returned instead."""
    os.makedirs(osp.dirname(osp.abspath(out_path)), exist_ok=True)
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        if not osp.exists(out_path):
            raise OSError("ffmpeg produced no output")
        return out_path
    except Exception:
        fallback = out_path + ".frames"
        os.makedirs(fallback, exist_ok=True)
        for name in os.listdir(frame_dir):
            shutil.copy(osp.join(frame_dir, name), fallback)
        return fallback


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 RGB image as PNG bytes: filter 0 on every row,
    zlib level 1 (fast; the frames are large)."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got "
                         f"{arr.shape} {arr.dtype}")
    H, W = arr.shape[:2]
    rows = np.zeros((H, 1 + 3 * W), np.uint8)            # filter byte 0
    rows[:, 1:] = arr.reshape(H, 3 * W)
    header = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _png_chunk(b"IEND", b""))


def _write_png(path: str, img: np.ndarray) -> None:
    """Float [0, 1] (H, W, 3) image -> PNG file (values clipped, scaled by
    255 and truncated to uint8, as the JAX package's writer does)."""
    with open(path, "wb") as f:
        f.write(encode_png((np.clip(img, 0, 1) * 255).astype(np.uint8)))


def _load_frame(path: str, img_hw) -> Optional[np.ndarray]:
    """One video frame as float [0, 1] (H, W, 3), cropped or padded (white)
    to the bundle's (D0, D1); None when the file is missing or not an
    image. PIL reads it, with plt.imread's values (data/images.py); without
    PIL this raises."""
    from ..data.images import imread
    try:
        img = imread(path)
    except (OSError, ValueError):
        return None
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = np.asarray(img, np.float32)[..., :3]
    H, W = int(img_hw[0]), int(img_hw[1])
    out = np.ones((H, W, 3), np.float32)
    h, w = min(H, img.shape[0]), min(W, img.shape[1])
    out[:h, :w] = img[:h, :w]
    return out


def render_mesh_video(out_path: str, verts: np.ndarray, faces: np.ndarray,
                      cameras, bundle, fps: float = 30.0,
                      max_views: int = 4, every: int = 1,
                      method: str = "auto", device="cuda") -> str:
    """The mesh rollout video: per rendered frame, each view's predicted
    mesh through its learned camera over the video frame (or white), views
    side by side; every k-th frame.

    verts: (V, F, N, 3) world vertices; faces (Nf, 3); cameras: per-view
    Camera tuples of numpy fields. One batched render and one copy to the
    host per frame. Returns the mp4 path, or the .frames directory."""
    from ..data.video import frames_to_video
    from .mesh import composite_panel, make_mesh_panel_fn

    V = min(bundle.num_views, max_views)
    F = verts.shape[1]
    H, W = int(bundle.img_d0), int(bundle.img_d1)
    frame_paths = getattr(bundle, "frame_paths", None)
    panel_fn = make_mesh_panel_fn(faces, cameras[:V], (H, W), method=method,
                                  device=device)
    R_stack = np.stack([np.asarray(cameras[v].rotation) for v in range(V)])
    t_stack = np.stack([np.asarray(cameras[v].translation)
                        for v in range(V)])
    with tempfile.TemporaryDirectory() as tmp:
        for out_idx, f in enumerate(range(0, F, max(every, 1))):
            imgs, masks = panel_fn(verts[:V, f], R_stack, t_stack)
            both = torch.cat([imgs, masks[..., None]], dim=-1).cpu().numpy()
            panels = []
            for v in range(V):
                image = None
                if frame_paths is not None:
                    image = _load_frame(str(frame_paths[v][f]), (H, W))
                panels.append(composite_panel(both[v, ..., :3],
                                              both[v, ..., 3], image, (H, W)))
            _write_png(osp.join(tmp, f"{out_idx:06d}.png"),
                       np.concatenate(panels, axis=1))
        return _assemble(tmp, out_path,
                         frames_to_video(tmp, out_path, fps=fps, run=False))
