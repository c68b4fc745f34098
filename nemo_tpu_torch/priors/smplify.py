"""SMPLify: classic single-frame SMPL fitting, losses and the two-stage
Adam fit (port of nemo_tpu/priors/smplify.py).

Behavioral reference: hmr/smplify/losses.py:11-96 (gmof robustifier,
angle prior, body_fitting_loss, camera_fitting_loss) and the SMPLify stage
used for the VIBE+SMPLify baseline. Each stage runs Adam with optax's
float32 bias correction (``fit.optimizer.GroupAdam``), as the JAX package
runs optax.adam; the joints come from ``smpl_forward``'s joints-only path
(FK through kernel K1).
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import device_index
from ..body import constants
from ..body.smpl import SMPLModel, smpl_forward
from ..geometry.camera import perspective_projection
from ..geometry.rotations import batch_rodrigues
from .gmm import GMMPrior, gmm_log_likelihood
from .robustifiers import angle_prior, gmof

_TORSO_OP = [constants.JOINT_IDS[j] for j in
             ("OP RHip", "OP LHip", "OP RShoulder", "OP LShoulder")]
_TORSO_GT = [constants.JOINT_IDS[j] for j in
             ("Right Hip", "Left Hip", "Right Shoulder", "Left Shoulder")]


def project_joints(model_joints: torch.Tensor, camera_t: torch.Tensor,
                   camera_center: torch.Tensor, focal_length
                   ) -> torch.Tensor:
    """(B, J, 2) pixels through an identity-rotation camera."""
    B = model_joints.shape[0]
    eye = torch.eye(3, dtype=model_joints.dtype,
                    device=model_joints.device).expand(B, 3, 3)
    return perspective_projection(model_joints, eye, camera_t, focal_length,
                                  camera_center)


def torso_terms(proj: torch.Tensor, joints_2d: torch.Tensor,
                joints_conf: torch.Tensor):
    """(squared error of the OpenPose torso joints (B, 4, 2), of the GT
    torso joints, the OpenPose torso's validity (B, 1, 1))."""
    dev = proj.device
    op, gt = device_index(_TORSO_OP, dev), device_index(_TORSO_GT, dev)
    err_op = (joints_2d[:, op] - proj[:, op]) ** 2
    err_gt = (joints_2d[:, gt] - proj[:, gt]) ** 2
    valid = (joints_conf[:, op].min(dim=-1).values > 0).to(
        proj.dtype)[:, None, None]
    return err_op, err_gt, valid


def smplify_body_fitting_loss(body_pose: torch.Tensor, betas: torch.Tensor,
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
                              angle_prior_weight: float = 15.2
                              ) -> torch.Tensor:
    """body_fitting_loss (losses.py:27-58): robust reprojection +
    GMM/angle/shape priors; identity camera rotation."""
    proj = project_joints(model_joints, camera_t, camera_center,
                          focal_length)
    reproj = gmof(proj - joints_2d, rho=sigma)
    reproj_loss = ((joints_conf ** 2) * reproj.sum(-1)).sum(-1)

    prior_loss = (pose_prior_weight ** 2) * gmm_log_likelihood(
        pose_prior, body_pose)
    ang_loss = (angle_prior_weight ** 2) * angle_prior(body_pose).sum(-1)
    shape_loss = (shape_prior_weight ** 2) * (betas ** 2).sum(-1)
    return (reproj_loss + prior_loss + ang_loss + shape_loss).sum()


def smplify_camera_fitting_loss(model_joints: torch.Tensor,
                                camera_t: torch.Tensor,
                                camera_t_est: torch.Tensor,
                                camera_center: torch.Tensor,
                                joints_2d: torch.Tensor,
                                joints_conf: torch.Tensor,
                                focal_length: float = 5000.0,
                                depth_loss_weight: float = 100.0
                                ) -> torch.Tensor:
    """camera_fitting_loss (losses.py:61-96): torso-joint reprojection with
    an OP-vs-GT validity switch + depth anchor."""
    err_op, err_gt, is_valid = torso_terms(
        project_joints(model_joints, camera_t, camera_center, focal_length),
        joints_2d, joints_conf)
    reproj = (is_valid * err_op + (1 - is_valid) * err_gt).sum(dim=(1, 2))
    depth = (depth_loss_weight ** 2) * (camera_t[:, 2]
                                        - camera_t_est[:, 2]) ** 2
    return (reproj + depth).sum()


def smplify_fit(smpl: SMPLModel, pose_prior: GMMPrior,
                init_pose: torch.Tensor, init_betas: torch.Tensor,
                init_cam_t: torch.Tensor, camera_center: torch.Tensor,
                keypoints_2d: torch.Tensor,
                focal_length: float = 5000.0,
                num_iters: int = 100,
                lr: float = 1e-2,
                ) -> Dict[str, torch.Tensor]:
    """Two-stage SMPLify: camera translation, then body pose/shape, each
    num_iters Adam steps. init_pose: (B, 72) axis-angle (orient + body);
    init_betas (1, 10), shared. Returns refined {'pose', 'betas', 'cam_t',
    'loss'} (the last step's loss)."""
    from ..models.humor_fit import _run_adam
    joints_2d = keypoints_2d[..., :2]
    conf = keypoints_2d[..., 2]

    def model_joints_of(pose72, betas):
        rot = batch_rodrigues(pose72.reshape(-1, 24, 3))
        _, j = smpl_forward(smpl, betas, rot[:, 1:], rot[:, :1],
                            want_vertices=False)
        return j

    with torch.no_grad():
        j0 = model_joints_of(init_pose, init_betas)
    cam, _ = _run_adam(lambda p: smplify_camera_fitting_loss(
        j0, p["cam_t"], init_cam_t, camera_center, joints_2d, conf,
        focal_length), {"cam_t": init_cam_t}, num_iters, lr)
    cam_t = cam["cam_t"]

    def body_loss(p):
        j = model_joints_of(p["pose"], p["betas"])
        return smplify_body_fitting_loss(
            p["pose"][:, 3:], p["betas"], j, cam_t, camera_center,
            joints_2d, conf, pose_prior, focal_length)

    params, losses = _run_adam(body_loss, {"pose": init_pose,
                                           "betas": init_betas},
                               num_iters, lr)
    return {"pose": params["pose"], "betas": params["betas"],
            "cam_t": cam_t, "loss": losses[-1]}
