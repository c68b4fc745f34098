"""Composed multi-panel figures (port of the part of
nemo_tpu/render/figures.py the fit CLI calls).

Mesh panels come from ``render_mesh_overlay`` on the render device; grids
are composed with numpy hconcat/vconcat and a nearest-neighbour resize and
written with the standard-library PNG writer. ``render_global_overlay`` is
a matplotlib plot, imported when it is drawn.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np

MAX_SIZE = 2000


def _resize_nearest(img: np.ndarray, max_size: int = MAX_SIZE) -> np.ndarray:
    """Cap the longer side at max_size, nearest neighbour."""
    H, W = img.shape[:2]
    long_side = max(H, W)
    if long_side <= max_size:
        return img
    scale = max_size / long_side
    yi = np.clip((np.arange(int(H * scale)) / scale).astype(int), 0, H - 1)
    xi = np.clip((np.arange(int(W * scale)) / scale).astype(int), 0, W - 1)
    return img[yi][:, xi]


def _compose_grid(rows: Sequence[Sequence[np.ndarray]],
                  max_size: int = MAX_SIZE) -> np.ndarray:
    """hconcat the panels of each row, vconcat the rows, then resize."""
    row_imgs = [np.concatenate(list(r), axis=1) for r in rows]
    grid = row_imgs[0] if len(row_imgs) == 1 \
        else np.concatenate(row_imgs, axis=0)
    return _resize_nearest(grid, max_size)


def _frame_indices(num_frames: int, ncol: int,
                   start_phase: float = 0.0) -> list:
    """frame = round(phase * num_frames) with phase = start_phase +
    (1 - start_phase) * cidx / ncol."""
    out = []
    for cidx in range(ncol):
        phase = start_phase + (1 - start_phase) * (cidx / ncol)
        out.append(min(int(np.round(phase * num_frames)), num_frames - 1))
    return out


def _mesh_panel(verts_world, faces, camera, image, img_hw, device):
    from .mesh import render_mesh_overlay
    return render_mesh_overlay(verts_world, faces, camera, image, img_hw,
                               device=device)


def _bundle_frame(bundle, view: int, frame: int) -> Optional[np.ndarray]:
    paths = getattr(bundle, "frame_paths", None)
    if paths is None:
        return None
    from .video import _load_frame
    return _load_frame(str(paths[view][frame]),
                       (bundle.img_d0, bundle.img_d1))


def _imsave(path: str, img: np.ndarray) -> None:
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    from .video import _write_png
    _write_png(path, img)


def render_rollout_figure(path: str, verts: np.ndarray, faces: np.ndarray,
                          cameras, bundle, num_frames: int = 10,
                          num_views: int = -1, no_bg: bool = False,
                          max_size: int = MAX_SIZE,
                          device="cuda") -> np.ndarray:
    """(views x sampled frames) grid of mesh-over-frame renders, written to
    path and returned. verts: (V, F, N, 3) world vertices; cameras:
    per-view Camera tuples."""
    from ..eval.metrics import eval_frame_indices
    V, F = verts.shape[:2]
    nrow = V if num_views < 0 else min(V, num_views)
    hw = (int(bundle.img_d0), int(bundle.img_d1))
    fidx = eval_frame_indices(F, num_frames).tolist()
    rows = [[_mesh_panel(verts[v, f], faces, cameras[v],
                         None if no_bg else _bundle_frame(bundle, v, f), hw,
                         device) for f in fidx] for v in range(nrow)]
    grid = _compose_grid(rows, max_size)
    _imsave(path, grid)
    return grid


def render_comparison_figure(path: str, view_idx: int, verts: np.ndarray,
                             faces: np.ndarray, camera, bundle,
                             init_verts: Optional[np.ndarray] = None,
                             init_cameras=None, num_frames: int = 6,
                             start_phase: float = 0.0,
                             crop: Optional[Sequence[int]] = None,
                             max_size: int = MAX_SIZE,
                             device="cuda") -> np.ndarray:
    """One view's comparison strip: the frames (white without frames), the
    initializer's mesh when init_verts is given, and the fit's mesh over
    the frames. verts: (F, N, 3) world vertices of this view; crop=(r0, r1)
    row-slices the panels."""
    F = verts.shape[0]
    ncol = min(F, num_frames) if num_frames > 0 else F
    hw = (int(bundle.img_d0), int(bundle.img_d1))

    def _crop(im):
        return im if crop is None else im[int(crop[0]):int(crop[1])]

    data_row, init_row, pred_row = [], [], []
    for f in _frame_indices(F, ncol, start_phase):
        image = _bundle_frame(bundle, view_idx, f)
        blank = np.ones(hw + (3,), np.float32)
        data_row.append(_crop(image if image is not None else blank))
        if init_verts is not None:
            cam = init_cameras if init_cameras is not None else camera
            init_row.append(_crop(_mesh_panel(init_verts[f], faces, cam,
                                              image, hw, device)))
        pred_row.append(_crop(_mesh_panel(verts[f], faces, camera, image, hw,
                                          device)))
    rows = [data_row] + ([init_row] if init_row else []) + [pred_row]
    grid = _compose_grid(rows, max_size)
    _imsave(path, grid)
    return grid


def baseline_persons_from_bundle(bundle):
    """Per-view person dicts ('pose' (F, 72), 'betas', 'orig_cam' (F, 4))
    rebuilt from a bundle's vibe_orient/vibe_betas/vibe_cam slots and
    hmr_theta, or None when the bundle does not carry them."""
    if bundle.vibe_cam is None or bundle.vibe_orient is None:
        return None
    persons = []
    for v in range(bundle.num_views):
        pose = np.concatenate([np.asarray(bundle.vibe_orient[v], np.float32),
                               np.asarray(bundle.hmr_theta[v], np.float32)],
                              axis=-1)
        betas = (np.asarray(bundle.vibe_betas[v], np.float32)
                 if bundle.vibe_betas is not None
                 else np.zeros(10, np.float32))
        persons.append({"pose": pose, "betas": betas,
                        "orig_cam": np.asarray(bundle.vibe_cam[v],
                                               np.float32)})
    return persons


def render_baseline_rollout(path: str, model, persons, bundle,
                            num_frames: int = 8, num_views: int = -1,
                            max_size: int = MAX_SIZE,
                            device="cuda") -> np.ndarray:
    """The baseline initializer's own SMPL prediction over the frames
    through its weak-perspective cameras, one row a view (the reference's
    render_vibe_rollout). persons: load_vibe_pickle-layout dicts; betas
    are averaged over frames."""
    import torch

    from ..body.smpl import smpl_forward
    from ..eval.metrics import eval_frame_indices
    from ..geometry.camera import camera_from_weak_persp
    from ..geometry.rotations import batch_rodrigues

    nrow = len(persons) if num_views < 0 else min(len(persons), num_views)
    hw = (int(bundle.img_d0), int(bundle.img_d1))
    dev = model.device
    rows = []
    for v in range(nrow):
        p = persons[v]
        fidx = eval_frame_indices(int(np.asarray(p["pose"]).shape[0]),
                                  num_frames)
        pose = torch.as_tensor(np.asarray(p["pose"], np.float32)[fidx],
                               device=dev)
        rot = batch_rodrigues(pose.reshape(-1, 3)).reshape(len(fidx), 24, 3,
                                                           3)
        betas = np.asarray(p["betas"], np.float32).reshape(-1, 10)
        with torch.no_grad():
            verts, _ = smpl_forward(model, torch.as_tensor(
                betas.mean(0)[None], device=dev), rot[:, 1:], rot[:, :1],
                want_vertices=True)
        verts = verts.cpu().numpy()
        cams = camera_from_weak_persp(
            np.asarray(p["orig_cam"], np.float32)[fidx], *hw)
        rows.append([_mesh_panel(verts[i], model.faces,
                                 type(cams)(*(np.asarray(a)[i] for a in cams)),
                                 _bundle_frame(bundle, v, int(f)), hw, device)
                     for i, f in enumerate(fidx)])
    grid = _compose_grid(rows, max_size)
    _imsave(path, grid)
    return grid


def render_global_overlay(path: str, gt_trans: np.ndarray,
                          pred_trans: np.ndarray,
                          glamr_trans: Optional[np.ndarray] = None) -> None:
    """Aligned root trajectories as a 3D scatter: GT Greens, GLAMR Reds,
    NeMo Blues, a 0.3 -> 1 colormap ramp over time, one legend line each
    (matplotlib). Inputs are (F, 3) world root translations after the
    eval_3d_global alignment."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.lines import Line2D

    sets = [("GT", gt_trans, "Greens", "g"),
            ("NeMo", pred_trans, "Blues", "b")]
    if glamr_trans is not None:
        sets.insert(1, ("GLAMR", glamr_trans, "Reds", "r"))
    allpts = np.concatenate([s[1] for s in sets], axis=0)
    mins, maxs = allpts.min(0), allpts.max(0)
    fig = plt.figure()
    ax = plt.axes(projection="3d")
    ax.set_xlim([mins[0], maxs[0]])
    ax.set_ylim([mins[1], maxs[1]])
    ax.set_zlim([mins[2], maxs[2]])
    for _name, pts, cmap, _c in sets:
        ax.scatter3D(pts[:, 0], pts[:, 1], pts[:, 2],
                     c=np.linspace(0.3, 1, len(pts)), cmap=cmap)
    ax.legend([Line2D([0], [0], color=s[3], lw=4) for s in sets],
              [s[0] for s in sets])
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
