"""The NeMo neural motion model: parameters, forward pass and losses.

Port of nemo_tpu/fit/model.py for model version 2 (MotionNet + RBF phase
embedding + instance codes), the version of the reference workload. Versions
0, 1, 3 and 4, the HuMoR dynamics term, the v2v vertex subset and the 3D
theta loss are still to port (ROADMAP Queue 1, Slice 2) and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import device_index
from ..body import constants as body_constants
from ..body.smpl import SMPLModel, smpl_forward, smpl_v2v_l1_sum
from ..geometry.camera import (FOCAL_LENGTH, camera_from_params,
                               init_camera_params, perspective_projection)
from ..geometry.rotations import batch_rodrigues, rot6d_to_rotmat
from ..modules.networks import (RBF, MonotonicNets, MotionNet,
                                apply_monotonic_gather, apply_rbf)
from ..priors.gmm import GMMPrior, gmm_log_likelihood
from ..priors.vposer import (vposer_decode, vposer_encode,
                             vposer_kl_to_std_normal)
from .losses import camera_fitting_loss, keypoint_loss, per_view_average

Metrics = Dict[str, torch.Tensor]

_ROADMAP = "see ROADMAP.md, Queue 1 (Slice 2)"


@dataclasses.dataclass(frozen=True)
class NemoConfig:
    """Fit hyper-parameters: the same fields and defaults as
    nemo_tpu.fit.NemoConfig, so configs and CLI flags carry over."""
    model_version: int = 2
    h_dim: int = 500
    instance_code_size: int = 10
    phase_rbf_dim: int = 0
    rbf_kernel: str = "linear"
    monotonic_network_n_nodes: int = 200
    phase_init: str = "rand"
    loss: str = "mse_robust"
    lr_camera: float = 0.1
    lr_human: float = 0.01
    lr_instance: float = 0.001
    lr_phase: float = 1e-5
    lr_pose: float = 0.01
    lr_orient: float = 0.01
    lr_trans: float = 0.01
    lr_factor: float = 0.5
    wd_human: float = 0.001
    opt_human: str = "adam"
    weight_vp_loss: float = 0.0
    weight_vp_z_loss: float = 0.0
    weight_gmm_loss: float = 0.5
    vp_v2v_n_verts: int = 0
    weight_instance_loss: float = 0.0
    weight_3d_loss: float = 0.0
    weight_humor_loss: float = 0.0
    humor_fps: float = 30.0
    code_noise: float = 0.0
    batch_size: int = 512
    n_steps: int = 2000
    warmup_step: int = 300
    opt_cam_step: int = 1000
    full_batch: bool = False
    label_type: str = "op"
    label_intersection_threshold: float = 30.0
    focal_length: float = FOCAL_LENGTH

    @property
    def uses_rbf(self) -> bool:
        return self.model_version >= 2 and self.phase_rbf_dim > 0

    @property
    def uses_instance_code(self) -> bool:
        return self.instance_code_size > 0 and self.model_version >= 1

    @property
    def proj_joint_idx(self) -> np.ndarray:
        return np.asarray(body_constants.PROJ_JOINT_IDX_V0)

    @property
    def motion_input_dim(self) -> int:
        base = self.phase_rbf_dim if self.uses_rbf else 1
        return base + self.instance_code_size


def check_supported(cfg: NemoConfig) -> None:
    """Raise for every setting the port does not run yet."""
    unsupported = {
        "model_version != 2": cfg.model_version != 2,
        "vp_v2v_n_verts": cfg.vp_v2v_n_verts != 0,
        "weight_3d_loss": cfg.weight_3d_loss != 0,
        "weight_humor_loss": cfg.weight_humor_loss != 0,
        "code_noise": cfg.code_noise != 0,
        "full_batch": cfg.full_batch,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"nemo_tpu_torch does not port {', '.join(bad)} yet ({_ROADMAP})")


@dataclasses.dataclass(frozen=True)
class NemoAssets:
    """Frozen components and 2D supervision, as tensors on one device."""
    smpl: SMPLModel
    gmm: Optional[GMMPrior]
    vposer: Optional[Dict[str, torch.Tensor]]
    points2d_gt: torch.Tensor    # (V, F, 25, 3)
    bbox_diag: torch.Tensor      # (V, F)
    hmr_theta: torch.Tensor      # (V, F, 69)
    hmr_mask: torch.Tensor       # (V, F, 1)
    img_d0: float
    img_d1: float

    @property
    def num_views(self) -> int:
        return self.points2d_gt.shape[0]

    @property
    def num_frames(self) -> int:
        return self.points2d_gt.shape[1]

    @property
    def device(self) -> torch.device:
        return self.points2d_gt.device


class NemoParams(nn.Module):
    """The trainable parameters, one attribute per optimizer group:
    cameras, phase, betas, motion, instance, rbf (the JAX pytree's keys)."""

    def __init__(self, cfg: NemoConfig, num_views: int, img_d0: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        self.cameras = nn.Parameter(init_camera_params(
            num_views, img_d0, cfg.focal_length, generator))
        self.phase = MonotonicNets(num_views, cfg.monotonic_network_n_nodes,
                                   cfg.phase_init, generator)
        self.betas = nn.Parameter(torch.zeros(1, 10))
        self.motion = MotionNet(cfg.motion_input_dim, cfg.h_dim, n_joints=24,
                                init_last_layer_zero=True,
                                generator=generator)
        if cfg.uses_instance_code:
            self.instance = nn.Parameter(1e-4 * torch.randn(
                (num_views, cfg.instance_code_size), generator=generator))
        if cfg.uses_rbf:
            self.rbf = RBF(cfg.phase_rbf_dim)


def init_params(cfg: NemoConfig, num_views: int, img_d0: float,
                generator: Optional[torch.Generator] = None,
                device=None) -> NemoParams:
    """Fresh parameters drawn from ``generator`` (a CPU generator), moved
    to ``device``."""
    return NemoParams(cfg, num_views, img_d0, generator).to(device)


def frame_idx_to_raw_phase(frame_idx: torch.Tensor, num_frames: int
                           ) -> torch.Tensor:
    return frame_idx.to(torch.float32) / (num_frames - 1)


def _embed(params: NemoParams, cfg: NemoConfig, phases: torch.Tensor,
           codes: Optional[torch.Tensor]) -> torch.Tensor:
    emb = apply_rbf(params.rbf, phases, cfg.rbf_kernel) if cfg.uses_rbf \
        else phases
    if cfg.uses_instance_code:
        emb = torch.cat([emb, codes], dim=-1)
    return emb


def _trans_at_phase0(params: NemoParams, cfg: NemoConfig) -> torch.Tensor:
    """MotionNet translation at phase 0 (through the RBF) with a ZERO
    instance code (reference :3754-3764)."""
    dev = params.cameras.device
    zero_phase = torch.zeros((1, 1), device=dev)
    codes = torch.zeros((1, cfg.instance_code_size), device=dev)
    _, _, trans0 = params.motion(_embed(params, cfg, zero_phase, codes))
    return trans0


def predict(params: NemoParams, cfg: NemoConfig, assets: NemoAssets,
            view_idx: torch.Tensor, frame_idx: torch.Tensor,
            want_vertices: bool = False, detach_pose: bool = False,
            add_trans: bool = True) -> Dict[str, torch.Tensor]:
    """Phase warp -> motion MLP -> SMPL FK (+ translation). Returns 'j'
    (B, 25, 3) projection joints, 'j49', 'poses' (B, 69) axis-angle,
    'pose_rotmat', 'orient' (B, 6), 'orient_aa', 'trans', 'warped_phase',
    and 'v' (B, V, 3) with want_vertices."""
    raw = frame_idx_to_raw_phase(frame_idx, assets.num_frames)[:, None]
    warped = apply_monotonic_gather(params.phase, view_idx, raw)
    codes = params.instance[view_idx] if cfg.uses_instance_code else None
    pose_d, orient_d, trans = params.motion(
        _embed(params, cfg, warped, codes))
    trans = trans - _trans_at_phase0(params, cfg)

    body_rotmat = pose_d["rotmat"]
    if detach_pose:
        body_rotmat = body_rotmat.detach()
    orient_rotmat = rot6d_to_rotmat(orient_d["rot6d"])[:, None]
    verts, joints49 = smpl_forward(assets.smpl, params.betas, body_rotmat,
                                   orient_rotmat, want_vertices=want_vertices)
    if add_trans:
        joints49 = joints49 + trans[:, None, :]
        if verts is not None:
            verts = verts + trans[:, None, :]
    out = {
        "j": joints49[:, device_index(cfg.proj_joint_idx, joints49.device)],
        "j49": joints49,
        "poses": pose_d["pose"],
        "pose_rotmat": pose_d["rotmat"],
        "orient": orient_d["rot6d"],
        "orient_aa": orient_d["pose"],
        "trans": trans,
        "warped_phase": warped,
    }
    if verts is not None:
        out["v"] = verts
    return out


def project_to_views(params: NemoParams, cfg: NemoConfig, assets: NemoAssets,
                     points3d: torch.Tensor, view_idx: torch.Tensor
                     ) -> torch.Tensor:
    """Project (B, N, 3) points through each sample's learned camera."""
    cam = camera_from_params(params.cameras[view_idx], assets.img_d0,
                             assets.img_d1, cfg.focal_length)
    return perspective_projection(points3d, cam.rotation, cam.translation,
                                  cam.focal_length, cam.center)


def vposer_losses(params: NemoParams, assets: NemoAssets,
                  poses: torch.Tensor, orient6d: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v2v recon L1, KL): the VPoser mean-latent reconstruction, compared
    mesh to mesh through K2 with the reconstruction detached."""
    vp = assets.vposer
    B = poses.shape[0]
    mu, scale = vposer_encode(vp, poses[:, :63])
    dec = vposer_decode(vp, mu)
    recon = torch.cat([dec["pose_body"].reshape(B, 63), poses[:, 63:]], dim=1)
    rot_o = batch_rodrigues(poses.reshape(B, 23, 3))
    rot_r = batch_rodrigues(recon.reshape(B, 23, 3))
    orient_rot = rot6d_to_rotmat(orient6d)[:, None]
    total = smpl_v2v_l1_sum(assets.smpl, params.betas, rot_o, orient_rot,
                            rot_r, orient_rot)
    v2v = total / (B * 3 * assets.smpl.num_vertices)
    return v2v, vposer_kl_to_std_normal(mu, scale)


def fit_loss(params: NemoParams, cfg: NemoConfig, assets: NemoAssets,
             view_idx: torch.Tensor, frame_idx: torch.Tensor,
             include_priors: bool = True) -> Tuple[torch.Tensor, Metrics]:
    """Main-stage loss (reference NemoV2 step): (total, metrics)."""
    preds = predict(params, cfg, assets, view_idx, frame_idx)
    points2d = project_to_views(params, cfg, assets, preds["j"], view_idx)
    gt = assets.points2d_gt[view_idx, frame_idx]
    gt_size = assets.bbox_diag[view_idx, frame_idx]
    loss_all = keypoint_loss(points2d, gt[..., :2], gt[..., 2:], gt_size,
                             cfg.loss)
    kp = per_view_average(loss_all, gt[..., 2:], view_idx, assets.num_views)
    loss = kp
    metrics = {"kp_loss": kp}
    if include_priors:
        poses = preds["poses"]
        if cfg.weight_vp_loss > 0 or cfg.weight_vp_z_loss > 0:
            v2v, kl = vposer_losses(params, assets, poses, preds["orient"])
            metrics["vp_recon_loss"] = v2v
            metrics["vp_kl_loss"] = kl
            if cfg.weight_vp_loss:
                loss = loss + cfg.weight_vp_loss * v2v
            if cfg.weight_vp_z_loss:
                loss = loss + cfg.weight_vp_z_loss * kl
        else:
            metrics["vp_recon_loss"] = kp.new_zeros(())
            metrics["vp_kl_loss"] = kp.new_zeros(())
        if assets.gmm is not None:
            g = gmm_log_likelihood(assets.gmm, poses).mean()
            metrics["gmm_loss"] = g
            if cfg.weight_gmm_loss:
                loss = loss + cfg.weight_gmm_loss * g
    metrics["total_loss"] = loss
    return loss, metrics


def warmup_loss(params: NemoParams, cfg: NemoConfig, assets: NemoAssets,
                view_idx: torch.Tensor, frame_idx: torch.Tensor
                ) -> Tuple[torch.Tensor, Metrics]:
    """Warmup: mse_robust of the predicted axis-angle pose against the
    initializer theta under its validity mask (reference :3455-3509)."""
    preds = predict(params, cfg, assets, view_idx, frame_idx)
    theta = assets.hmr_theta[view_idx, frame_idx]
    mask = assets.hmr_mask[view_idx, frame_idx]
    loss = keypoint_loss(preds["poses"], theta, mask,
                         loss_type="mse_robust").mean()
    return loss, {"warmup_loss": loss}


def camera_stage_loss(params: NemoParams, cfg: NemoConfig, assets: NemoAssets,
                      view_idx: torch.Tensor, frame_idx: torch.Tensor
                      ) -> Tuple[torch.Tensor, Metrics]:
    """Camera stage (V0-V3, reference :2869-2906): plain mean keypoint
    loss; the fitter steps the cameras only."""
    joints = predict(params, cfg, assets, view_idx, frame_idx)["j"]
    points2d = project_to_views(params, cfg, assets, joints, view_idx)
    gt = assets.points2d_gt[view_idx, frame_idx]
    gt_size = assets.bbox_diag[view_idx, frame_idx]
    loss = camera_fitting_loss(points2d, gt, gt_size, cfg.loss)
    return loss, {"cam_loss": loss}
