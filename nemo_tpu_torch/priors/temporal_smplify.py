"""TemporalSMPLify: multi-frame SMPL refinement of VIBE predictions (port of
nemo_tpu/priors/temporal_smplify.py).

Behavioral reference: VIBE/lib/smplify/temporal_smplify.py:26-251 (the
two-stage fit with betas shared across the sequence),
VIBE/lib/smplify/losses.py:103-200 (temporal body/camera losses with the
2D/3D smoothness terms), and VIBE/lib/utils/demo_utils.py:91-167
(smplify_runner: weak-persp <-> full-camera conversion, best-frame betas
selection, per-frame accept mask).

Each stage is ``fit.lbfgs.lbfgs_run``, the port's copy of the optax.lbfgs
(zoom linesearch) iterations the JAX package scans. Betas are one (10,)
tensor shared across frames, so both stages take ``smpl_forward``'s
joints-only path with (1, 10) betas (FK through kernel K1, its gradient
through K1's backward); the final vertices and the pre-fit loss use
per-frame betas on the vertex path, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import device_index
from ..body import constants
from ..body.smpl import SMPLModel, smpl_forward
from ..fit.lbfgs import lbfgs_run
from ..fit.model import _AbsJax
from ..geometry.rotations import batch_rodrigues
from .gmm import GMMPrior, gmm_log_likelihood
from .robustifiers import angle_prior, gmof
from .smplify import project_joints, torso_terms

# Joints excluded from the body-fitting stage
# (temporal_smplify.py:44-45): the hips/neck are unreliable in 2D.
IGN_JOINTS = [constants.JOINT_IDS[j] for j in
              ("OP Neck", "OP RHip", "OP LHip", "Right Hip", "Left Hip")]


def temporal_camera_fitting_loss(model_joints: torch.Tensor,
                                 camera_t: torch.Tensor,
                                 camera_t_est: torch.Tensor,
                                 camera_center: torch.Tensor,
                                 joints_2d: torch.Tensor,
                                 joints_conf: torch.Tensor,
                                 focal_length: float = 5000.0,
                                 depth_loss_weight: float = 100.0
                                 ) -> torch.Tensor:
    """temporal_camera_fitting_loss (losses.py:170-200): OpenPose torso
    joints only (no GT fallback, unlike the single-frame variant) + depth
    anchor to the initial estimate."""
    err_op, _, is_valid = torso_terms(
        project_joints(model_joints, camera_t, camera_center, focal_length),
        joints_2d, joints_conf)
    reproj = (is_valid * err_op).sum(dim=(1, 2))
    depth = (depth_loss_weight ** 2) * (camera_t[:, 2]
                                        - camera_t_est[:, 2]) ** 2
    return (reproj + depth).sum()


def temporal_body_fitting_loss(body_pose: torch.Tensor, betas: torch.Tensor,
                               model_joints: torch.Tensor,
                               camera_t: torch.Tensor,
                               camera_center: torch.Tensor,
                               joints_2d: torch.Tensor,
                               joints_conf: torch.Tensor,
                               pose_prior: GMMPrior,
                               focal_length: float = 5000.0,
                               sigma: float = 100.0,
                               pose_prior_weight: float = 4.78,
                               shape_prior_weight: float = 5.0,
                               angle_prior_weight: float = 15.2,
                               smooth_2d_weight: float = 0.01,
                               smooth_3d_weight: float = 1.0,
                               output: str = "sum") -> torch.Tensor:
    """temporal_body_fitting_loss (losses.py:103-167): the single-frame
    body loss plus L1 frame-difference smoothness on projected 2D joints
    (weight 0.01^2) and 3D joints (weight 1.0^2), both gated by the NEXT
    frame's squared confidence with a zero row prepended. The L1 terms
    differentiate |x| as jnp.abs does (+1 at a tie, where neighbouring
    frames project alike).

    output='reprojection' returns the per-frame, per-joint conf^2-weighted
    GMoF reprojection term (B, J) — what smplify_runner thresholds on.
    """
    proj = project_joints(model_joints, camera_t, camera_center,
                          focal_length)
    reproj = gmof(proj - joints_2d, rho=sigma)
    reproj_loss = (joints_conf ** 2) * reproj.sum(-1)          # (B, J)
    if output == "reprojection":
        return reproj_loss

    prior_loss = (pose_prior_weight ** 2) * gmm_log_likelihood(
        pose_prior, body_pose)
    ang_loss = (angle_prior_weight ** 2) * angle_prior(body_pose).sum(-1)
    shape_loss = (shape_prior_weight ** 2) * (betas ** 2).sum(-1)
    total = reproj_loss.sum(-1) + prior_loss + ang_loss + shape_loss

    # Frame-difference smoothness (losses.py:137-155): the conf gate is
    # conf[1:] (the later frame of each pair), a zero row prepended.
    conf_d = joints_conf[1:] ** 2                              # (B-1, J)
    j2d_d = _AbsJax.apply(proj[1:] - proj[:-1]).sum(-1)        # (B-1, J)
    j3d_d = _AbsJax.apply(model_joints[1:] - model_joints[:-1]).sum(-1)
    zero = total.new_zeros((1,))
    smooth_2d = (smooth_2d_weight ** 2) * torch.cat(
        [zero, (conf_d * j2d_d).sum(-1)])
    smooth_3d = (smooth_3d_weight ** 2) * torch.cat(
        [zero, (conf_d * j3d_d).sum(-1)])
    return (total + smooth_2d + smooth_3d).sum()


def _ign_conf(conf: torch.Tensor) -> torch.Tensor:
    out = conf.clone()
    out[:, device_index(IGN_JOINTS, conf.device)] = 0.0
    return out


def temporal_smplify_fit(smpl: SMPLModel, pose_prior: GMMPrior,
                         init_pose: torch.Tensor, init_betas: torch.Tensor,
                         init_cam_t: torch.Tensor,
                         camera_center: torch.Tensor,
                         keypoints_2d: torch.Tensor,
                         focal_length: float = 5000.0,
                         num_iters: int = 1,
                         max_iter: int = 20,
                         stats: Optional[dict] = None,
                         ) -> Dict[str, torch.Tensor]:
    """Two-stage temporal fit (temporal_smplify.py:58-214).

    Stage 1 optimizes {global orient, camera translation} against the
    torso-only camera loss; stage 2 optimizes {body pose, global orient,
    shared betas} against the temporal body loss with IGN_JOINTS
    confidences zeroed; each runs num_iters * max_iter L-BFGS iterations.

    init_pose: (B, 72) axis-angle. init_betas: (10,) — ONE shape shared
    across the whole sequence. Returns refined pose/betas/cam_t, final
    vertices/joints, the per-frame reprojection loss (B, J), the
    weak-perspective camera the VIBE pickle format carries and both
    stages' losses ('cam_losses', 'losses'). stats, when a dict, takes
    each stage's L-BFGS counts under 'camera' and 'body'.
    """
    joints_2d = keypoints_2d[..., :2]
    conf = keypoints_2d[..., 2]
    B = init_pose.shape[0]
    focal = torch.full((), focal_length, dtype=init_pose.dtype,
                       device=init_pose.device)

    def fwd(orient, body, betas10, want_vertices=False):
        pose = torch.cat([orient, body], dim=-1)
        rot = batch_rodrigues(pose.reshape(-1, 24, 3))
        betas = (betas10[None].expand(B, betas10.shape[0])
                 if want_vertices else betas10[None])
        return smpl_forward(smpl, betas, rot[:, 1:], rot[:, :1],
                            want_vertices=want_vertices)

    orient0 = init_pose[:, :3]
    body0 = init_pose[:, 3:]
    n_steps = num_iters * max_iter
    st_cam = st_body = None
    if stats is not None:
        st_cam, st_body = stats.setdefault("camera", {}), \
            stats.setdefault("body", {})

    # ---- stage 1: camera translation + global orientation ----
    def cam_loss(p):
        _, j = fwd(p["orient"], body0, init_betas)
        return temporal_camera_fitting_loss(
            j, p["cam_t"], init_cam_t, camera_center, joints_2d, conf,
            focal)

    cam_p, cam_losses = lbfgs_run(
        cam_loss, {"orient": orient0, "cam_t": init_cam_t}, n_steps,
        stats=st_cam)
    cam_t = cam_p["cam_t"]

    # ---- stage 2: body pose + shared betas + orientation ----
    conf_body = _ign_conf(conf)

    def body_loss(p):
        _, j = fwd(p["orient"], p["body"], p["betas"])
        return temporal_body_fitting_loss(
            p["body"], p["betas"][None], j, cam_t, camera_center,
            joints_2d, conf_body, pose_prior, focal)

    body_p, losses = lbfgs_run(
        body_loss,
        {"orient": cam_p["orient"], "body": body0, "betas": init_betas},
        n_steps, stats=st_body)

    with torch.no_grad():
        verts, joints = fwd(body_p["orient"], body_p["body"],
                            body_p["betas"], want_vertices=True)
        reproj = temporal_body_fitting_loss(
            body_p["body"], body_p["betas"][None], joints, cam_t,
            camera_center, joints_2d, conf_body, pose_prior, focal,
            output="reprojection")

    # Back to the crop-frame weak-perspective cam the pickle stores
    # (temporal_smplify.py:201-205): s = 2f / (224 * tz).
    weak_cam = torch.stack([
        2.0 * focal_length / (224.0 * cam_t[:, 2] + 1e-9),
        cam_t[:, 0], cam_t[:, 1]], dim=-1)

    return {"pose": torch.cat([body_p["orient"], body_p["body"]], dim=-1),
            "betas": body_p["betas"], "cam_t": cam_t,
            "weak_cam": weak_cam, "verts": verts, "joints": joints,
            "reproj_loss": reproj, "cam_losses": cam_losses,
            "losses": losses}


def get_fitting_loss(smpl: SMPLModel, pose_prior: GMMPrior,
                     pose: torch.Tensor, betas: torch.Tensor,
                     cam_t: torch.Tensor, camera_center: torch.Tensor,
                     keypoints_2d: torch.Tensor,
                     focal_length: float = 5000.0) -> torch.Tensor:
    """Pre-fit per-frame reprojection loss (temporal_smplify.py:217-251):
    conf^2-weighted GMoF on the CURRENT prediction with IGN_JOINTS zeroed.
    pose: (B, 72), betas: (B, 10), per frame, so the vertex path. Returns
    (B, J)."""
    joints_2d = keypoints_2d[..., :2]
    conf = _ign_conf(keypoints_2d[..., 2])
    rot = batch_rodrigues(pose.reshape(-1, 24, 3))
    _, joints = smpl_forward(smpl, betas, rot[:, 1:], rot[:, :1],
                             want_vertices=True)
    return temporal_body_fitting_loss(
        pose[:, 3:], betas, joints, cam_t, camera_center, joints_2d,
        conf, pose_prior, focal_length, output="reprojection")


def run_temporal_smplify(smpl: SMPLModel, pose_prior: GMMPrior,
                         pred_pose: torch.Tensor, pred_betas: torch.Tensor,
                         pred_cam: torch.Tensor, j2d: torch.Tensor,
                         focal_length: float = 5000.0,
                         crop_size: float = 224.0,
                         opt_steps: int = 1,
                         max_iter: int = 20,
                         stats: Optional[dict] = None,
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """smplify_runner (demo_utils.py:91-167): weak-persp -> full camera,
    betas pinned to the best pre-fit frame, temporal fit, per-frame accept
    mask where the refined reprojection loss improves.

    pred_pose: (B, 72) aa. pred_cam: (B, 3) crop-frame weak persp
    (s, tx, ty). j2d: (B, 49, 3) keypoints in crop pixel coords.
    Returns (refined dict, update mask (B,) bool).
    """
    B = pred_pose.shape[0]
    cam_t = torch.stack([
        pred_cam[:, 1], pred_cam[:, 2],
        2.0 * focal_length / (crop_size * pred_cam[:, 0] + 1e-9)], dim=-1)
    center = torch.full((B, 2), 0.5 * crop_size, dtype=pred_pose.dtype,
                        device=pred_pose.device)

    with torch.no_grad():
        pre_loss = get_fitting_loss(smpl, pose_prior, pred_pose, pred_betas,
                                    cam_t, center, j2d,
                                    focal_length).mean(-1)      # (B,)
    best = torch.argmin(pre_loss)
    betas0 = torch.index_select(pred_betas, 0, best.reshape(1))[0]  # (10,)

    out = temporal_smplify_fit(smpl, pose_prior, pred_pose, betas0,
                               cam_t, center, j2d, focal_length,
                               num_iters=opt_steps, max_iter=max_iter,
                               stats=stats)
    new_loss = out["reproj_loss"].mean(-1)
    update = new_loss < pre_loss
    out["new_loss"] = new_loss
    out["pre_loss"] = pre_loss
    return out, update
