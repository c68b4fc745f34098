"""The NeMo neural motion model: parameters, forward pass and losses.

Port of nemo_tpu/fit/model.py, model versions 0-4:

  V0  separate pose/orient/trans networks, warmup on SPIN theta
  V1  one MotionNet (pose+orient+trans) + instance codes
  V2  V1 + RBF phase embedding (the reference workload)
  V3  V2 + instance-code L2 + 3D loss against the initializer theta + code
      noise
  V4  V3 + a camera stage that trains every group with the pose detached,
      and straight 25-joint projection indexing

The VPoser v2v prior runs on the full mesh through K2 or on a vertex subset
(``vp_v2v_n_verts``) through K3. The custom entry's HuMoR dynamics term
(``weight_humor_loss``) runs the batch's (f-1, f, f+1) windows through one
predict and the frozen HuMoR CVAE.

Each part of the main-stage loss runs under one layer span (utils.trace):
``nemo.net.phase`` and ``nemo.net.motion`` (the networks), ``nemo.body.smpl``
(SMPL), ``nemo.loss.keypoints`` and ``nemo.loss.3d`` (the data terms), and
``nemo.prior.vposer``, ``nemo.prior.v2v`` (K2 or the subset path),
``nemo.prior.instance``, ``nemo.prior.gmm`` and ``nemo.prior.humor``; inside
the last, ``nemo.humor.state`` builds the HuMoR states and
``nemo.humor.posterior`` and ``nemo.humor.prior`` (models/humor.py) run
the CVAE.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import device_index
from ..body import constants as body_constants
from ..body.smpl import (SMPLModel, smpl_forward, smpl_v2v_l1_sum,
                         smpl_verts_t_subset)
from ..geometry.camera import (FOCAL_LENGTH, camera_from_params,
                               init_camera_params, perspective_projection)
from ..geometry.rotations import batch_rodrigues, rot6d_to_rotmat
from ..geometry.rotations import rotmat_to_aa
from ..models.humor import STATE_DIM, HumorConfig, humor_infer_seq
from ..modules.networks import (FCNN, RBF, MonotonicNets, MotionNet, RotNet,
                                apply_monotonic_gather, apply_rbf)
from ..priors.gmm import GMMPrior, gmm_log_likelihood
from ..priors.vposer import (vposer_decode, vposer_encode,
                             vposer_kl_per_sample)
from ..utils.trace import span
from .losses import (batch_mean, camera_fitting_loss, keypoint_loss,
                     per_view_average)

Metrics = Dict[str, torch.Tensor]


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
        if self.model_version >= 4:
            return np.asarray(body_constants.PROJ_JOINT_IDX_V4)
        return np.asarray(body_constants.PROJ_JOINT_IDX_V0)

    @property
    def motion_input_dim(self) -> int:
        base = self.phase_rbf_dim if self.uses_rbf else 1
        return base + self.instance_code_size


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
    # V0's warmup target when the bundle carries SPIN theta (:3216-3227)
    spin_theta: Optional[torch.Tensor] = None          # (V, F, 69)
    # the v2v prior's vertex subset (cfg.vp_v2v_n_verts > 0), from
    # body.smpl.subset_skin_tables
    v2v_vidx: Optional[torch.Tensor] = None            # (n,) long
    v2v_posedirs_t: Optional[torch.Tensor] = None      # (207, 3, n)
    v2v_lbs_weights_t: Optional[torch.Tensor] = None   # (24, n)
    # gradient mode of the full-mesh v2v prior (ops.lbs.skin_v2v_l1)
    v2v_vjp: str = "fused"
    # the MotionNet's MLP: "plain" matmuls or "fused" through K6
    # (modules.networks.MotionNet.forward)
    motion_mlp: str = "plain"
    # every network product's precision (ops.mlp.NET_PRECISIONS: "highest",
    # "high", "bf16"; the JAX package's NEMO_TPU_NET_PRECISION)
    net_precision: str = "highest"
    # the v2v subset's meshes and their cotangents: f32, or bf16 (the JAX
    # package's NEMO_TPU_SKIN_IO_BF16)
    skin_io_dtype: torch.dtype = torch.float32
    # the frozen HuMoR CVAE of the weight_humor_loss term
    # (models.humor parameter tree) and its config
    humor: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
    humor_cfg: Optional[HumorConfig] = None

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
    """The trainable parameters, one attribute per optimizer group, named
    as the JAX pytree's keys: cameras, phase, betas, and for V1+ motion,
    instance, rbf, for V0 poses, orient, trans."""

    def __init__(self, cfg: NemoConfig, num_views: int, img_d0: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cameras = nn.Parameter(init_camera_params(
            num_views, img_d0, cfg.focal_length, generator))
        self.phase = MonotonicNets(num_views, cfg.monotonic_network_n_nodes,
                                   cfg.phase_init, generator)
        self.betas = nn.Parameter(torch.zeros(1, 10))
        if cfg.model_version == 0:
            # separate RotNet(23) / RotNet(1) / FCNN(1 -> 3) (:3127-3205)
            self.poses = RotNet(1, cfg.h_dim, 23, generator=generator)
            self.orient = RotNet(1, cfg.h_dim, 1, generator=generator)
            self.trans = FCNN(1, cfg.h_dim, 3, generator)
            return
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


def _trans_at_phase0(params: NemoParams, cfg: NemoConfig,
                     mlp: str = "plain",
                     precision: str = "highest") -> torch.Tensor:
    """MotionNet translation at phase 0 (through the RBF) with a ZERO
    instance code (reference :3754-3764), a batch of one through the
    MotionNet's ``mlp`` mode at ``precision``."""
    dev = params.cameras.device
    zero_phase = torch.zeros((1, 1), device=dev)
    codes = torch.zeros((1, cfg.instance_code_size), device=dev)
    _, _, trans0 = params.motion(_embed(params, cfg, zero_phase, codes),
                                 mlp=mlp, precision=precision)
    return trans0


def predict(params: NemoParams, cfg: NemoConfig, assets: NemoAssets,
            view_idx: torch.Tensor, frame_idx: torch.Tensor,
            want_vertices: bool = False, detach_pose: bool = False,
            add_trans: bool = True, noise: Optional[torch.Tensor] = None,
            want_fk_joints: bool = False) -> Dict[str, torch.Tensor]:
    """Phase warp -> motion networks -> SMPL FK (+ translation). Returns
    'j' (B, 25, 3) projection joints, 'j49', 'poses' (B, 69) axis-angle,
    'pose_rotmat', 'orient' (B, 6), 'orient_aa', 'trans', 'warped_phase',
    'v' (B, V, 3) with want_vertices, and with want_fk_joints the 24
    kinematic-chain joints 'fk_joints' (B, 24, 3) in SMPL tree order and
    the root rotation 'orient_rotmat' (B, 3, 3).

    noise: a standard normal draw shaped like the batch's instance codes
    (B, instance_code_size); with cfg.code_noise > 0 the codes become
    codes + code_noise * noise (:206-217). The caller draws it, from a
    torch.Generator in the fitter or injected by a test.
    """
    with span("nemo.net.phase"):
        raw = frame_idx_to_raw_phase(frame_idx, assets.num_frames)[:, None]
        warped = apply_monotonic_gather(params.phase, view_idx, raw)
    prec = assets.net_precision
    with span("nemo.net.motion"):
        if cfg.model_version == 0:
            # separate networks (get_preds_given_phases :3005-3034)
            pose_d = params.poses(warped, prec)
            orient_d = params.orient(warped, prec)
            trans = params.trans(warped, prec) - params.trans(
                warped.new_zeros((1, 1)), prec)
        else:
            codes = params.instance[view_idx] if cfg.uses_instance_code \
                else None
            if codes is not None and noise is not None and \
                    cfg.code_noise > 0:
                codes = codes + cfg.code_noise * noise
            pose_d, orient_d, trans = params.motion(
                _embed(params, cfg, warped, codes), mlp=assets.motion_mlp,
                precision=prec)
            trans = trans - _trans_at_phase0(params, cfg, assets.motion_mlp,
                                             prec)

    with span("nemo.body.smpl"):
        body_rotmat = pose_d["rotmat"]
        if detach_pose:
            body_rotmat = body_rotmat.detach()
        orient_rotmat = rot6d_to_rotmat(orient_d["rot6d"])[:, None]
        verts, joints49, *fk = smpl_forward(
            assets.smpl, params.betas, body_rotmat, orient_rotmat,
            want_vertices=want_vertices, want_fk_joints=want_fk_joints)
        if add_trans:
            joints49 = joints49 + trans[:, None, :]
            if verts is not None:
                verts = verts + trans[:, None, :]
            fk = [j + trans[:, None, :] for j in fk]
        joints = joints49[:, device_index(cfg.proj_joint_idx,
                                          joints49.device)]
    out = {
        "j": joints,
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
    if want_fk_joints:
        out["fk_joints"] = fk[0]
        out["orient_rotmat"] = orient_rotmat[:, 0]
    return out


def project_to_views(params: NemoParams, cfg: NemoConfig, assets: NemoAssets,
                     points3d: torch.Tensor, view_idx: torch.Tensor
                     ) -> torch.Tensor:
    """Project (B, N, 3) points through each sample's learned camera."""
    cam = camera_from_params(params.cameras[view_idx], assets.img_d0,
                             assets.img_d1, cfg.focal_length)
    return perspective_projection(points3d, cam.rotation, cam.translation,
                                  cam.focal_length, cam.center)


class _AbsJax(torch.autograd.Function):
    """|x| with jnp.abs's derivative: +1 at x = 0 (including -0), where
    torch's abs has 0. Elsewhere the same gradient, bit for bit. The subset
    v2v prior's meshes tie (rec == orig) at a few entries in bf16, and
    there JAX's gradient is -1/n on the orig side."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def vposer_losses(params: NemoParams, assets: NemoAssets,
                  poses: torch.Tensor, orient6d: torch.Tensor, mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v2v recon L1, KL): the VPoser mean-latent reconstruction, compared
    mesh to mesh with the reconstruction detached (:2775-2804). The full
    mesh goes through K2 (in the assets' v2v_vjp mode); a vertex subset
    through K3, the rec side forward only, both meshes in the assets'
    skin_io_dtype and widened to f32 before their difference, as the JAX
    package does, |.| differentiated as jnp.abs is (so a bf16 mesh's
    cotangent is bf16(+-weight / n) at every entry, ties included).

    Under a data-parallel mesh, poses are this rank's rows and n counts
    the global batch, so K2's cotangent weight / n is the single-device
    one (and so, in bf16, is its rounding)."""
    vp = assets.vposer
    B = poses.shape[0]
    B_all = B * (1 if mesh is None else mesh.size)
    with span("nemo.prior.vposer"):
        mu, scale = vposer_encode(vp, poses[:, :63])
        dec = vposer_decode(vp, mu)
        recon = torch.cat([dec["pose_body"].reshape(B, 63), poses[:, 63:]],
                          dim=1)
        rot_o = batch_rodrigues(poses.reshape(B, 23, 3))
        rot_r = batch_rodrigues(recon.reshape(B, 23, 3))
        orient_rot = rot6d_to_rotmat(orient6d)[:, None]
    smpl = assets.smpl
    with span("nemo.prior.v2v"):
        if assets.v2v_vidx is None:
            total = smpl_v2v_l1_sum(smpl, params.betas, rot_o, orient_rot,
                                    rot_r, orient_rot, vjp=assets.v2v_vjp)
            v2v = total / (B_all * 3 * smpl.num_vertices)
        else:
            sub = (assets.v2v_vidx, assets.v2v_posedirs_t,
                   assets.v2v_lbs_weights_t)
            io = assets.skin_io_dtype
            verts_o = smpl_verts_t_subset(smpl, params.betas, rot_o,
                                          orient_rot, *sub, io)
            with torch.no_grad():
                verts_r = smpl_verts_t_subset(smpl, params.betas, rot_r,
                                              orient_rot, *sub, io)
            v2v = _AbsJax.apply(verts_r.float() - verts_o.float()).sum() / (
                B_all * 3 * sub[0].shape[0])
    with span("nemo.prior.vposer"):
        kl = batch_mean(vposer_kl_per_sample(mu, scale), mesh)
    return v2v, kl


def humor_dynamics_loss(params: NemoParams, cfg: NemoConfig,
                        assets: NemoAssets, view_idx: torch.Tensor,
                        frame_idx: torch.Tensor, mesh=None) -> torch.Tensor:
    """The HuMoR dynamics prior: the mean KL of the predicted motion's
    transitions under the frozen conditional prior (the custom entry's
    --weight_humor_loss term).

    Each batch frame f, clamped to [1, F-2], gives a window (f-1, f, f+1);
    one predict runs the 3B rows. The window yields two HuMoR states with
    velocities by finite differences at cfg.humor_fps (the reference's
    estimate_velocities) and one transition KL. No code noise: the term
    reads the motion field itself.
    """
    F = assets.num_frames
    B = view_idx.shape[0]
    fc = frame_idx.clamp(1, F - 2)
    preds = predict(params, cfg, assets, view_idx.repeat(3),
                    torch.cat([fc - 1, fc, fc + 1]), want_fk_joints=True)

    def split3(x):
        return x[:B], x[B:2 * B], x[2 * B:]

    trans = split3(preds["trans"])
    orient_R = split3(preds["orient_rotmat"])
    orient_aa = split3(preds["orient_aa"])
    poses = split3(preds["poses"])
    joints = split3(preds["fk_joints"][:, :22].reshape(3 * B, 66))
    fps = cfg.humor_fps

    def state(i):
        """The 'smpl+joints' state at window position i (reads i - 1)."""
        dR = torch.einsum("bij,bkj->bik", orient_R[i], orient_R[i - 1])
        return torch.cat([
            trans[i], (trans[i] - trans[i - 1]) * fps, orient_aa[i],
            rotmat_to_aa(dR) * fps, poses[i][:, :63], joints[i],
            (joints[i] - joints[i - 1]) * fps], dim=-1)

    with span("nemo.humor.state"):
        states = torch.stack([state(1), state(2)], dim=1)  # (B, 2, STATE_DIM)
    assert states.shape[-1] == STATE_DIM
    kl = humor_infer_seq(assets.humor, assets.humor_cfg, states)["kl"]
    return batch_mean(kl, mesh)


def fit_loss(params: NemoParams, cfg: NemoConfig, assets: NemoAssets,
             view_idx: torch.Tensor, frame_idx: torch.Tensor,
             include_priors: bool = True, noise: Optional[torch.Tensor] = None,
             detach_pose: bool = False, include_3d: Optional[bool] = None,
             mesh=None) -> Tuple[torch.Tensor, Metrics]:
    """Main-stage loss (reference NemoV3 step :3796-3909, the V1/V2 path
    when the extra weights are zero): (total, metrics).

    include_priors gates the VPoser, instance-code and GMM terms; include_3d
    (default: include_priors) gates the 3D theta loss, which V4's camera
    stage keeps while dropping the priors (:4128-4140). noise: the code
    noise draw of predict (training steps only).

    mesh: a data-parallel mesh (parallel.make_mesh) when view_idx and
    frame_idx are this rank's rows of the global batch. Every batch term is
    then this rank's share of the global value (its rows' sum over the
    global count; per-view counts summed over the ranks), and the
    instance-code term, which reads the parameters alone, counts on rank 0
    only; the loss, metrics and gradients of the ranks sum to the
    single-device ones (parallel.mesh.reduce_gradients sums them).
    """
    if include_3d is None:
        include_3d = include_priors
    preds = predict(params, cfg, assets, view_idx, frame_idx,
                    detach_pose=detach_pose, noise=noise)
    with span("nemo.loss.keypoints"):
        points2d = project_to_views(params, cfg, assets, preds["j"],
                                    view_idx)
        gt = assets.points2d_gt[view_idx, frame_idx]
        gt_size = assets.bbox_diag[view_idx, frame_idx]
        loss_all = keypoint_loss(points2d, gt[..., :2], gt[..., 2:], gt_size,
                                 cfg.loss)
        kp = per_view_average(loss_all, gt[..., 2:], view_idx,
                              assets.num_views, mesh)
    loss = kp
    metrics = {"kp_loss": kp}
    if include_priors:
        poses = preds["poses"]
        if cfg.weight_vp_loss > 0 or cfg.weight_vp_z_loss > 0:
            v2v, kl = vposer_losses(params, assets, poses, preds["orient"],
                                    mesh)
            metrics["vp_recon_loss"] = v2v
            metrics["vp_kl_loss"] = kl
            if cfg.weight_vp_loss:
                loss = loss + cfg.weight_vp_loss * v2v
            if cfg.weight_vp_z_loss:
                loss = loss + cfg.weight_vp_z_loss * kl
        else:
            metrics["vp_recon_loss"] = kp.new_zeros(())
            metrics["vp_kl_loss"] = kp.new_zeros(())
        if cfg.uses_instance_code and cfg.model_version >= 3:
            with span("nemo.prior.instance"):
                inst = (params.instance ** 2).mean()
                if mesh is not None and mesh.rank != 0:
                    inst = torch.zeros_like(inst)
                metrics["instance_loss"] = inst
                if cfg.weight_instance_loss:
                    loss = loss + cfg.weight_instance_loss * inst
        if assets.gmm is not None:
            with span("nemo.prior.gmm"):
                g = batch_mean(gmm_log_likelihood(assets.gmm, poses), mesh)
                metrics["gmm_loss"] = g
                if cfg.weight_gmm_loss:
                    loss = loss + cfg.weight_gmm_loss * g
        if cfg.weight_humor_loss and assets.humor is not None:
            with span("nemo.prior.humor"):
                hl = humor_dynamics_loss(params, cfg, assets, view_idx,
                                         frame_idx, mesh)
                metrics["humor_loss"] = hl
                loss = loss + cfg.weight_humor_loss * hl
    if include_3d and cfg.weight_3d_loss and cfg.model_version >= 3:
        with span("nemo.loss.3d"):
            theta = assets.hmr_theta[view_idx, frame_idx]
            mask = assets.hmr_mask[view_idx, frame_idx]
            l3d = batch_mean(keypoint_loss(preds["poses"], theta, mask,
                                           loss_type="mse_robust"), mesh)
            metrics["loss_3d"] = l3d
            loss = loss + cfg.weight_3d_loss * l3d
    metrics["total_loss"] = loss
    return loss, metrics


def warmup_loss(params: NemoParams, cfg: NemoConfig, assets: NemoAssets,
                view_idx: torch.Tensor, frame_idx: torch.Tensor, mesh=None
                ) -> Tuple[torch.Tensor, Metrics]:
    """Warmup: fit the predicted axis-angle pose to an initializer theta.
    V1+ (:3455-3509): mse_robust under the initializer's validity mask.
    V0 (:3207-3269): plain unmasked MSE against SPIN theta, or the VIBE
    theta when the bundle carries no SPIN slot."""
    preds = predict(params, cfg, assets, view_idx, frame_idx)
    if cfg.model_version == 0:
        src = assets.spin_theta if assets.spin_theta is not None \
            else assets.hmr_theta
        loss = batch_mean((preds["poses"] - src[view_idx, frame_idx]) ** 2,
                          mesh)
    else:
        theta = assets.hmr_theta[view_idx, frame_idx]
        mask = assets.hmr_mask[view_idx, frame_idx]
        loss = batch_mean(keypoint_loss(preds["poses"], theta, mask,
                                        loss_type="mse_robust"), mesh)
    return loss, {"warmup_loss": loss}


def camera_stage_loss(params: NemoParams, cfg: NemoConfig, assets: NemoAssets,
                      view_idx: torch.Tensor, frame_idx: torch.Tensor,
                      noise: Optional[torch.Tensor] = None, mesh=None
                      ) -> Tuple[torch.Tensor, Metrics]:
    """Camera stage. V0-V3 (:2869-2906): a plain mean keypoint loss; the
    fitter steps the cameras only, at frame 0 of every view. V4
    (:4060-4149): fit_loss with the pose detached, no priors and the 3D
    loss, on random batches; the fitter steps every group but the betas."""
    if cfg.model_version >= 4:
        return fit_loss(params, cfg, assets, view_idx, frame_idx,
                        include_priors=False, noise=noise, detach_pose=True,
                        include_3d=True, mesh=mesh)
    joints = predict(params, cfg, assets, view_idx, frame_idx)["j"]
    points2d = project_to_views(params, cfg, assets, joints, view_idx)
    gt = assets.points2d_gt[view_idx, frame_idx]
    gt_size = assets.bbox_diag[view_idx, frame_idx]
    loss = camera_fitting_loss(points2d, gt, gt_size, cfg.loss, mesh)
    return loss, {"cam_loss": loss}
