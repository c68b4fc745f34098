"""Composed multi-panel figures (port of nemo_tpu/render/figures.py).

Mesh panels come from ``render_mesh_overlay`` on the render device (K5s on
a CUDA device), the pretty figures from ``render_pretty`` (one K5s launch a
scene); grids are composed with numpy hconcat/vconcat and a
nearest-neighbour resize and written with the standard-library PNG writer.
``render_global_overlay`` and ``render_global_root_trajectories`` are
matplotlib plots, imported when they are drawn; without matplotlib the
second still returns its distances and names each PNG it skipped.
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


def _pretty_camera(hw):
    """The pretty figures' fixed camera: identity pose, the reference's 5x
    focal-to-image ratio, centred principal point."""
    from ..geometry.camera import Camera
    H, W = hw
    return Camera(rotation=np.eye(3, dtype=np.float32),
                  translation=np.zeros(3, np.float32),
                  focal_length=np.float32(5.0 * min(H, W)),
                  center=np.array([W / 2.0, H / 2.0], np.float32))


def _view_rotation(camera) -> np.ndarray:
    R = np.asarray(camera.rotation, np.float32)
    return R[0] if R.ndim == 3 else R


def render_input_figure(path: str, bundle, num_frames: int = 8,
                        num_views: int = -1,
                        max_size: int = MAX_SIZE) -> np.ndarray:
    """The sampled input frames as a (views x frames) grid, no overlay;
    views without frame paths give white panels."""
    from ..eval.metrics import eval_frame_indices
    V, F = bundle.num_views, bundle.num_frames
    nrow = V if num_views < 0 else min(V, num_views)
    hw = (int(bundle.img_d0), int(bundle.img_d1))
    blank = np.ones(hw + (3,), np.float32)
    rows = []
    for v in range(nrow):
        row = []
        for f in eval_frame_indices(F, num_frames):
            im = _bundle_frame(bundle, v, int(f))
            row.append(blank if im is None else np.asarray(im, np.float32))
        rows.append(row)
    grid = _compose_grid(rows, max_size)
    _imsave(path, grid)
    return grid


def render_rollout_mv_figure(path: str, motion_idx: int, verts: np.ndarray,
                             faces: np.ndarray, cameras, bundle,
                             num_frames: int = 8, num_views: int = -1,
                             max_size: int = MAX_SIZE,
                             device="cuda") -> np.ndarray:
    """One view's motion, verts[motion_idx], through every view's camera
    on white: row = camera view, column = sampled frame."""
    from ..eval.metrics import eval_frame_indices
    V, F = verts.shape[:2]
    nrow = V if num_views < 0 else min(V, num_views)
    hw = (int(bundle.img_d0), int(bundle.img_d1))
    fidx = eval_frame_indices(F, num_frames)
    rows = [[_mesh_panel(verts[motion_idx, int(f)], faces, cameras[v], None,
                         hw, device) for f in fidx] for v in range(nrow)]
    grid = _compose_grid(rows, max_size)
    _imsave(path, grid)
    return grid


def render_pretty_rollout_figure(path: str, verts: np.ndarray,
                                 faces: np.ndarray, cameras, bundle,
                                 num_frames: int = 6, num_views: int = -1,
                                 spread_people: bool = True,
                                 frame_idxs: Optional[Sequence[int]] = None,
                                 color: Optional[Sequence[float]] = None,
                                 max_size: int = MAX_SIZE,
                                 device="cuda") -> np.ndarray:
    """Per view, every sampled frame as one person of a single
    checkerboard-ground scene (render_pretty: one K5s launch a row): each
    frame's vertices rotated by the view's camera rotation, centred,
    spread evenly over x in [-1, 1] and set 10 m in front of a fixed
    camera. frame_idxs picks the frames instead of the even sample; color
    replaces the blue spectrum by one base colour."""
    from ..eval.metrics import eval_frame_indices
    from .mesh import render_pretty
    V, F = verts.shape[:2]
    nrow = V if num_views < 0 else min(V, num_views)
    fidx = (list(frame_idxs) if frame_idxs is not None
            else eval_frame_indices(F, num_frames))
    n = max(len(fidx), 1)
    hw = (int(bundle.img_d0), int(bundle.img_d1))
    cam = _pretty_camera(hw)
    rows = []
    for v in range(nrow):
        R = _view_rotation(cameras[v])
        people = []
        for i, f in enumerate(fidx):
            p = np.asarray(verts[v, int(f)], np.float32) @ R.T
            p = p - p.mean(0, keepdims=True)
            if spread_people:
                p[:, 0] += -1.0 + (2.0 * i + 1.0) / n
            p[:, 2] += 10.0
            people.append(p)
        rows.append([render_pretty(
            people, faces, cam, hw,
            person_colors=None if color is None else np.asarray(color),
            device=device)])
    grid = _compose_grid(rows, max_size)
    _imsave(path, grid)
    return grid


def render_pretty_individual_figure(dirname: str, verts: np.ndarray,
                                    faces: np.ndarray, camera, bundle,
                                    max_size: int = MAX_SIZE,
                                    device="cuda") -> list:
    """Each body of verts (N, V, 3) alone, rotated by one view's camera
    rotation, no ground plane, to dirname/{i}.png; returns the paths."""
    from .mesh import render_pretty
    os.makedirs(dirname, exist_ok=True)
    hw = (int(bundle.img_d0), int(bundle.img_d1))
    R = _view_rotation(camera)
    cam = _pretty_camera(hw)
    paths = []
    for i in range(verts.shape[0]):
        p = np.asarray(verts[i], np.float32) @ R.T
        p = p - p.mean(0, keepdims=True)
        p[:, 2] += 10.0
        im = render_pretty([p], faces, cam, hw, add_ground=False,
                           device=device)
        fpath = osp.join(dirname, f"{i}.png")
        _imsave(fpath, _resize_nearest(im, max_size))
        paths.append(fpath)
    return paths


def render_3d_rollout_figure(path: str, verts: np.ndarray,
                             faces: np.ndarray, bundle,
                             init_orient_rotmat: Optional[np.ndarray] = None,
                             num_frames: int = 10, max_size: int = MAX_SIZE,
                             device="cuda") -> np.ndarray:
    """Two rows of fixed synthetic cameras (euler xyz pi/2 * [2.5, .5, .5]
    and pi/2 * [1.5, .5, .5], 100 m away), each composed with the inverse
    of the motion's initial orientation; row r shows view r's motion,
    centred, on white. The focal length makes a 1.2 m half-extent fill
    the frame."""
    from scipy.spatial.transform import Rotation as sRot

    from ..eval.metrics import eval_frame_indices
    from ..geometry.camera import Camera
    F = verts.shape[1]
    fidx = eval_frame_indices(F, num_frames)
    hw = (int(bundle.img_d0), int(bundle.img_d1))
    H, W = hw
    inv0 = (np.eye(3, dtype=np.float32) if init_orient_rotmat is None
            else np.asarray(init_orient_rotmat, np.float32).T)
    cam = Camera(rotation=np.eye(3, dtype=np.float32),
                 translation=np.zeros(3, np.float32),
                 focal_length=np.float32(min(H, W) * 100.0 / 2.4),
                 center=np.array([W / 2.0, H / 2.0], np.float32))
    off = np.array([0.0, 0.0, 100.0], np.float32)
    rows = []
    for r in ([2.5, 0.5, 0.5], [1.5, 0.5, 0.5]):
        R = sRot.from_euler(
            "xyz", np.pi / 2 * np.asarray(r)).as_matrix().astype(np.float32)
        R = (R @ inv0).astype(np.float32)
        v = min(len(rows), verts.shape[0] - 1)
        row = []
        for f in fidx:
            p = np.asarray(verts[v, int(f)], np.float32)
            row.append(_mesh_panel((p - p.mean(0)) @ R.T + off, faces, cam,
                                   None, hw, device))
        rows.append(row)
    grid = _compose_grid(rows, max_size)
    _imsave(path, grid)
    return grid


def render_global_root_trajectories(out_dir: str, gt_trans: np.ndarray,
                                    pred_trans: np.ndarray,
                                    glamr_trans: Optional[np.ndarray] = None,
                                    ) -> dict:
    """One 3D panel a root trajectory, gt.png, glamr.png and pred.png in
    out_dir: a grey line and a Greens time-ramp scatter, axis limits shared
    by all panels, GLAMR and NeMo titled with their mean euclidean distance
    to GT in metres. Inputs are (F, 3) world root translations after the
    rigid alignment. Returns {name: mean distance to GT} for the non-GT
    trajectories; without matplotlib it returns them all the same and
    names each PNG it skipped."""
    sets = [("gt", "GT", np.asarray(gt_trans, np.float64))]
    if glamr_trans is not None:
        sets.append(("glamr", "GLAMR", np.asarray(glamr_trans, np.float64)))
    sets.append(("pred", "NeMo", np.asarray(pred_trans, np.float64)))
    errs = {name: float(np.sqrt(((pts - sets[0][2]) ** 2).sum(-1)).mean())
            for name, _, pts in sets[1:]}
    try:
        import matplotlib
    except ImportError:
        for name, _, _ in sets:
            print(f"[render] matplotlib is not installed: skipped "
                  f"{osp.join(out_dir, name + '.png')}")
        return errs
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    allpts = np.concatenate([s[2] for s in sets], axis=0)
    mins, maxs = allpts.min(0), allpts.max(0)
    for name, label, pts in sets:
        title = ("GT" if name == "gt"
                 else f"{label} - Dist: {errs[name]:.2f} meter")
        fig = plt.figure()
        ax = plt.axes(projection="3d")
        ax.plot3D(pts[:, 0], pts[:, 1], pts[:, 2], "gray")
        ax.scatter3D(pts[:, 0], pts[:, 1], pts[:, 2],
                     c=np.linspace(0.3, 1, len(pts)), cmap="Greens")
        ax.set_xlim([mins[0], maxs[0]])
        ax.set_ylim([mins[1], maxs[1]])
        ax.set_zlim([mins[2], maxs[2]])
        ax.set_xticks(np.linspace(mins[0], maxs[0], 5))
        ax.set_yticks(np.linspace(mins[1], maxs[1], 5))
        ax.set_zticks(np.linspace(mins[2], maxs[2], 5))
        ax.set_title(title, fontsize=20)
        fig.savefig(osp.join(out_dir, f"{name}.png"), bbox_inches="tight")
        plt.close(fig)
    return errs


# ---------------------------------------------------------------------------
# world-frame rollouts through the GT-fit cameras
# ---------------------------------------------------------------------------

def gt_cameras_for_render(gt_cameras9: np.ndarray, img_hw,
                          focal_length: float = 5000.0):
    """Per-view Cameras from the packed (V, 9) GT-fit camera vectors, in
    numpy. The principal point is (IMG_D0, IMG_D1), the full image size
    and not its half, as the reference's GT rollouts have it."""
    from ..geometry.camera import Camera
    from ..geometry.rotations import rot6d_to_rotmat_np
    return [Camera(rotation=rot6d_to_rotmat_np(cam9[3:]),
                   translation=cam9[:3],
                   focal_length=np.float32(focal_length),
                   center=np.asarray([float(img_hw[0]), float(img_hw[1])],
                                     np.float32))
            for cam9 in np.asarray(gt_cameras9, np.float32)]


def _gt_world(model, bundle, n_joints=15):
    """GT world vertices and joints over the (V, F) grid (K1f on a CUDA
    body model)."""
    from ..eval.metrics import world_grid_forward
    return world_grid_forward(model, bundle.gt3d_pose, bundle.gt3d_trans,
                              n_joints=n_joints)


def _aligned_to(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Each view's (F, N, 3) meshes of src moved by the rigid transform
    that best maps them onto dst's."""
    from ..geometry.procrustes import rigid_transform_np
    out = np.empty_like(src)
    for v in range(src.shape[0]):
        R, t = rigid_transform_np(src[v].reshape(-1, 3),
                                  dst[v].reshape(-1, 3))
        out[v] = (src[v].reshape(-1, 3) @ R.T + t).reshape(src[v].shape)
    return out


def _gt_camera_rollout(path, model, verts, bundle, num_frames, focal_length,
                       device):
    cams = gt_cameras_for_render(bundle.gt_cameras, bundle.img_hw,
                                 focal_length)
    return render_rollout_figure(path, verts, model.faces, cams, bundle,
                                 num_frames=num_frames, device=device)


def render_gt_rollout(path: str, model, bundle, num_frames: int = 8,
                      focal_length: float = 5000.0,
                      device="cuda") -> np.ndarray:
    """The GT world motion through the GT-fit cameras."""
    v_gt, _ = _gt_world(model, bundle)
    return _gt_camera_rollout(path, model, v_gt, bundle, num_frames,
                              focal_length, device)


def render_pred_in_gt_rollout(path: str, model, pred_v: np.ndarray,
                              bundle, num_frames: int = 8,
                              focal_length: float = 5000.0,
                              device="cuda") -> np.ndarray:
    """The predicted world meshes pred_v (V, F, N, 3), each view rigidly
    aligned to the GT world, through the GT-fit cameras."""
    v_gt, _ = _gt_world(model, bundle)
    return _gt_camera_rollout(path, model, _aligned_to(pred_v, v_gt), bundle,
                              num_frames, focal_length, device)


def render_glamr_rollout(path: str, model, bundle, num_frames: int = 8,
                         focal_length: float = 5000.0,
                         device="cuda") -> np.ndarray:
    """The GLAMR world baseline, each view rigidly aligned to the GT
    world, through the GT-fit cameras; raises ValueError when the bundle
    has no GLAMR pose, orient and trans slots."""
    from ..eval.metrics import world_grid_forward
    if bundle.glamr_orient is None or bundle.glamr_trans is None or \
            "glamr" not in (bundle.baseline_poses or {}):
        raise ValueError("bundle carries no GLAMR world baseline")
    g_pose = np.concatenate([bundle.glamr_orient,
                             bundle.baseline_poses["glamr"][..., :69]], -1)
    v_gl, _ = world_grid_forward(model, g_pose, bundle.glamr_trans)
    v_gt, _ = _gt_world(model, bundle)
    return _gt_camera_rollout(path, model, _aligned_to(v_gl, v_gt), bundle,
                              num_frames, focal_length, device)
