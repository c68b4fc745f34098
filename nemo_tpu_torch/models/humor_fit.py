"""HuMoR test-time motion optimization from 3D observations, in PyTorch.

Port of nemo_tpu/models/humor_fit.py (behavioral reference:
humor/humor/fitting/motion_optimizer.py and fitting_loss.py), the 3-stage
schedule the AMASS fitting driver runs:

  stage 1: global orientation + translation (trans starts at the per-frame
           point-cloud mean when point clouds are observed)
  stage 2: + the SMPL pose sequence and betas (smoothness-regularized)
  stage 3: the motion as (initial state, latent sequence z) of the CVAE,
           decoded by the rollout, with the motion prior, consistency,
           bone-length and contact/floor terms

against the 3D energies (masked L2 on joints and marker vertices, the
one-way scan->mesh chamfer through kernel K4, joint smoothness). Each stage
is a Python loop of Adam steps with optax.adam's arithmetic
(``fit.optimizer.GroupAdam``); the loss histories stay on the device until
the stage ends. The 2D keypoint term, the camera optimization and the
camera->prior frame utilities (the RGB drivers' path) are still to port
(ROADMAP.md Queue 1, item 7.1), as is ``optimizer="lbfgs"`` (item 7.4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import device_index
from ..body.smpl import SMPLModel, smpl_forward
from ..fit.optimizer import GroupAdam
from ..geometry.rotations import batch_rodrigues
from ..ops.chamfer import chamfer_one_way
from .humor import HumorConfig, Params, humor_roll_out, pack_state, split_state


@dataclasses.dataclass(frozen=True)
class MotionOptConfig:
    """Stage schedule + loss weights (defaults from the reference's
    fit_rgb_demo_no_split.cfg stage-3 column), as nemo_tpu's, less the 2D
    term's fields (rho, kp2d_weight, optimize_camera), still to port."""
    steps_stage1: int = 30
    steps_stage2: int = 80
    steps_stage3: int = 70
    lr: float = 1e-2
    smooth_weight: float = 100.0
    motion_prior_weight: float = 0.075
    joint_consistency_weight: float = 100.0
    shape_prior_weight: float = 0.05
    bone_length_weight: float = 2000.0
    contact_vel_weight: float = 100.0
    contact_height_weight: float = 10.0
    floor_reg_weight: float = 0.167
    init_motion_prior_weight: float = 0.075
    contact_height_thresh: float = 0.08
    joints3d_weight: float = 0.0
    verts3d_weight: float = 0.0
    points3d_weight: float = 0.0
    joints3d_rollout_weight: float = 0.0
    joints3d_smooth_weight: float = 0.0
    robust_loss: str = "bisquare"
    robust_tuning_const: float = 4.6851
    optimizer: str = "adam"


# SMPL joints predicted as contacts by HuMoR: hips, knees, ankles, toes,
# hands (amass_utils.py:22-23 CONTACT_ORDERING -> SMPL joint ids)
CONTACT_INDS = (0, 4, 5, 7, 8, 10, 11, 20, 21)


# --- observation energies ----------------------------------------------------

def masked_l2_loss(obs: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """joints3d/verts3d observation loss (fitting_loss.py:360-376): 0.5 *
    sum of squared error over the finite obs entries (non-finite obs marks
    occluded data)."""
    vis = torch.isfinite(obs)
    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    diff = torch.where(vis, obs, zero) - torch.where(vis, pred, zero)
    return 0.5 * (diff ** 2).sum()


def joints3d_smooth_loss(pred: torch.Tensor) -> torch.Tensor:
    """0.5 * sum of squared per-frame joint deltas (fitting_loss.py:366-370);
    pred (T, J, 3)."""
    return 0.5 * ((pred[1:] - pred[:-1]) ** 2).sum()


def points3d_loss(obs_pts: torch.Tensor, pred_verts: torch.Tensor,
                  robust_loss: str = "bisquare",
                  tune_const: float = 4.6851) -> torch.Tensor:
    """One-way scan->mesh chamfer with robust weighting
    (fitting_loss.py:378-396): min squared distance from each observed point
    to the predicted vertex set (K4, one search: ``chamfer_one_way``, the
    first direction of ``chamfer_distance``, which is all the loss reads;
    its distances are computed directly and never negative, see
    ops/chamfer.py), sqrt'd without a clamp, Tukey-bisquare weighted on the
    detached residuals, then 0.5 * the sum of the weighted squares. obs_pts
    (T, N, 3), pred_verts (T, V, 3)."""
    sq = chamfer_one_way(obs_pts, pred_verts)            # (T, N)
    res = torch.sqrt(sq + 1e-12).reshape(1, -1)          # (1, T*N)
    weighted, _ = apply_robust_weighting(res, robust_loss, tune_const)
    return 0.5 * weighted.sum()


# --- robust weighting (humor/humor/fitting/fitting_utils.py) -----------------

def _lower_median(x: torch.Tensor) -> torch.Tensor:
    """torch.median semantics: the LOWER of the two middle order statistics
    on even counts; (..., n) -> (..., 1)."""
    k = (x.shape[-1] - 1) // 2
    return torch.sort(x, dim=-1).values[..., k:k + 1]


def robust_std(res: torch.Tensor) -> torch.Tensor:
    """Robust per-row std via the median absolute deviation
    (fitting_utils.py:211-225). res: (B, N) -> (B, 1)."""
    med = _lower_median(res)
    mad = _lower_median(torch.abs(res - med))
    return mad / 0.67449


def bisquare_robust_weights(res: torch.Tensor,
                            tune_const: float = 4.6851) -> torch.Tensor:
    """Tukey bisquare weights, zero outside the tuning radius
    (fitting_utils.py:230-249; assumes non-negative residuals)."""
    norm_res = res / (robust_std(res) * tune_const)
    w = (1.0 - norm_res ** 2) ** 2
    return torch.where(norm_res >= 1.0, torch.zeros_like(w), w)


def apply_robust_weighting(res: torch.Tensor,
                           robust_loss_type: str = "bisquare",
                           robust_tuning_const: float = 4.6851):
    """Robustly weighted squared residuals (fitting_utils.py:190-209): the
    weights come from the detached residuals, so no gradient flows through
    them. Returns (weighted squared residuals, weights)."""
    detached = res.detach()
    if robust_loss_type == "none":
        w = torch.ones_like(detached)
    else:
        w = bisquare_robust_weights(detached, robust_tuning_const)
    return w * res ** 2, w


# --- init-state prior --------------------------------------------------------

def load_init_motion_prior(path: str, device=None) -> Dict[str, torch.Tensor]:
    """The init-state GMM (prior_gmm.npz: weights (K,), means (K, D),
    covariances (K, D, D); D = 138), Cholesky factors and log-determinants
    computed on the host in float64 (train_state_prior.py:123,
    run_fitting.py:252-262)."""
    import os.path as osp

    f = path if path.endswith(".npz") else osp.join(path, "prior_gmm.npz")
    data = np.load(f)
    chol = np.linalg.cholesky(np.asarray(data["covariances"], np.float64))
    logdet = 2.0 * np.log(np.diagonal(chol, axis1=1, axis2=2)).sum(1)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return {"log_weights": torch.log(t(data["weights"])),
            "means": t(data["means"]), "chol": t(chol), "logdet": t(logdet)}


def init_state_gmm_nll(state: torch.Tensor,
                       prior: Dict[str, torch.Tensor]) -> torch.Tensor:
    """-log p(state) under the full-covariance GMM
    (fitting_loss.py:416-429 init_motion_prior_loss); state (D,)."""
    diff = state[None] - prior["means"]                       # (K, D)
    y = torch.linalg.solve_triangular(prior["chol"], diff[..., None],
                                      upper=False)[..., 0]    # (K, D)
    d = state.shape[-1]
    comp = (prior["log_weights"]
            - 0.5 * (d * math.log(2 * math.pi) + prior["logdet"]
                     + (y ** 2).sum(-1)))
    return -torch.logsumexp(comp, dim=0)


# --- body model helpers ------------------------------------------------------

def _betas(betas: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    return like.new_zeros((1, 10)) if betas is None else betas.reshape(1, 10)


def fk22(smpl: SMPLModel, pose72: torch.Tensor, trans: torch.Tensor,
         betas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 22 SMPL-tree joints (T, 22, 3) in the world frame, through K1."""
    rot = batch_rodrigues(pose72.reshape(-1, 24, 3))
    _, _, jf = smpl_forward(smpl, _betas(betas, pose72), rot[:, 1:],
                            rot[:, :1], want_vertices=False,
                            transl=trans.reshape(-1, 3), want_fk_joints=True)
    return jf[:, :22]


def body_verts(smpl: SMPLModel, pose72: torch.Tensor, trans: torch.Tensor,
               betas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The posed mesh (T, V, 3)."""
    rot = batch_rodrigues(pose72.reshape(-1, 24, 3))
    v, _ = smpl_forward(smpl, _betas(betas, pose72), rot[:, 1:], rot[:, :1],
                        want_vertices=True, transl=trans)
    return v


def obs3d_terms(smpl: SMPLModel, cfg: MotionOptConfig,
                obs3d: Optional[Dict[str, torch.Tensor]],
                pose72: torch.Tensor, trans: torch.Tensor,
                betas: Optional[torch.Tensor] = None):
    """The 3D data losses of root_fit (fitting_loss.py:94-125), shared by
    all stages; each active when its observation is present and its weight
    is positive."""
    if obs3d is None:
        return 0.0
    loss = 0.0
    if "joints3d" in obs3d and cfg.joints3d_weight > 0:
        loss = loss + cfg.joints3d_weight * masked_l2_loss(
            obs3d["joints3d"], fk22(smpl, pose72, trans, betas))
    want_verts = (("verts3d" in obs3d and cfg.verts3d_weight > 0)
                  or ("points3d" in obs3d and cfg.points3d_weight > 0))
    if want_verts:
        v = body_verts(smpl, pose72, trans, betas)
        if "verts3d" in obs3d and cfg.verts3d_weight > 0:
            vi = obs3d.get("verts3d_inds")
            pred_m = v if vi is None else v[:, device_index(vi, v.device)]
            loss = loss + cfg.verts3d_weight * masked_l2_loss(
                obs3d["verts3d"], pred_m)
        if "points3d" in obs3d and cfg.points3d_weight > 0:
            loss = loss + cfg.points3d_weight * points3d_loss(
                obs3d["points3d"], v, cfg.robust_loss,
                cfg.robust_tuning_const)
    return loss


def state_from(smpl: SMPLModel, betas: torch.Tensor, pose72: torch.Tensor,
               trans: torch.Tensor, prev_pose72: torch.Tensor,
               prev_trans: torch.Tensor) -> torch.Tensor:
    """The packed HuMoR state (207,) of one frame and the frame before it;
    joints are the true FK joints (SMPL tree order, world frame)."""
    j22 = fk22(smpl, pose72, trans, betas)[0].reshape(-1)
    jp = fk22(smpl, prev_pose72, prev_trans, betas)[0].reshape(-1)
    return pack_state({
        "trans": trans, "trans_vel": trans - prev_trans,
        "root_orient": pose72[:3],
        "root_orient_vel": pose72[:3] - prev_pose72[:3],
        "pose_body": pose72[3:66], "joints": j22, "joints_vel": j22 - jp})


def decode_motion(humor_params: Params, humor_cfg: HumorConfig,
                  p: Dict[str, torch.Tensor], T: int):
    """(pose (T, 72), trans (T, 3), states (T, 207), rollout outputs) of the
    latent motion p = {"x0" (1, 207), "z" (1, T-1, L)}."""
    out = humor_roll_out(humor_params, humor_cfg, p["x0"], T - 1,
                         z_seq=p["z"])
    states = torch.cat([p["x0"][:, None], out["states"]], dim=1)[0]
    d = split_state(states)
    pose = torch.cat([d["root_orient"], d["pose_body"],
                      states.new_zeros((T, 6))], dim=1)
    return pose, d["trans"], states, out


def _floor_height(points: torch.Tensor, floor: torch.Tensor) -> torch.Tensor:
    """Signed distance of (..., 3) points above the plane encoded as
    normal*offset (fitting_loss.py floor convention :471-485)."""
    norm = torch.sqrt((floor ** 2).sum() + 1e-12)
    return (points @ floor) / norm - norm


def stage3_loss(smpl: SMPLModel, humor_params: Params,
                humor_cfg: HumorConfig, cfg: MotionOptConfig,
                p: Dict[str, torch.Tensor], betas: torch.Tensor,
                floor0: torch.Tensor,
                obs3d: Optional[Dict[str, torch.Tensor]] = None,
                init_motion_prior: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """Stage 3's objective at the latent motion p ({"x0", "z"} and, when a
    floor/contact term is on, "floor"): the 3D data terms on the decoded
    motion, the motion prior (NLL of z under the rollout's conditional
    prior, fitting_loss.py:404-414), regressed-joint consistency (:431-434),
    constant bone lengths (:436-442), the optional init-state GMM
    (:416-429) and the contact velocity / height and floor terms
    (:450-485)."""
    T = p["z"].shape[1] + 1
    pose, trans, states, out = decode_motion(humor_params, humor_cfg, p, T)
    data = obs3d_terms(smpl, cfg, obs3d, pose, trans, betas)
    pm, pv = out["prior_mean"][0], out["prior_var"][0]
    z = p["z"][0]
    prior = (0.5 * (torch.log(2 * math.pi * pv)
                    + (z - pm) ** 2 / pv)).sum(-1).mean()
    roll_j = split_state(states)["joints"].reshape(T, 22, 3)
    if (obs3d is not None and "joints3d" in obs3d
            and cfg.joints3d_rollout_weight > 0):
        data = data + cfg.joints3d_rollout_weight * masked_l2_loss(
            obs3d["joints3d"], roll_j)
    consist = ((roll_j - fk22(smpl, pose, trans, betas)) ** 2).mean()
    par = device_index(smpl.parents[1:22], roll_j.device)
    bl = torch.sqrt(((roll_j[:, 1:22] - roll_j[:, par]) ** 2).sum(-1)
                    + 1e-12)
    bone = ((bl[1:] - bl[:-1]) ** 2).mean()
    loss = (data + cfg.motion_prior_weight * prior
            + cfg.joint_consistency_weight * consist
            + cfg.bone_length_weight * bone)
    if init_motion_prior is not None:
        d0 = split_state(p["x0"][0])
        init_state = torch.cat([d0["joints"], d0["joints_vel"],
                                d0["trans_vel"], d0["root_orient_vel"]],
                               dim=-1).reshape(-1)
        loss = loss + cfg.init_motion_prior_weight * init_state_gmm_nll(
            init_state, init_motion_prior)
    if humor_cfg.pred_contacts and (cfg.contact_vel_weight > 0
                                    or cfg.contact_height_weight > 0):
        conf = torch.sigmoid(out["contacts"][0])             # (T-1, 9)
        cj = roll_j[:, device_index(CONTACT_INDS, roll_j.device)]
        vel = ((cj[1:] - cj[:-1]) ** 2).sum(-1)
        loss = loss + cfg.contact_vel_weight * (vel * conf).mean()
        if "floor" in p:
            h = torch.abs(_floor_height(cj[1:], p["floor"]))
            pen = torch.relu(h - cfg.contact_height_thresh)
            loss = loss + cfg.contact_height_weight * (pen * conf).mean()
            loss = loss + cfg.floor_reg_weight * (
                (p["floor"] - floor0) ** 2).sum()
    return loss


# --- the optimizer loop ------------------------------------------------------

def _run_adam(loss_fn: Callable, params0: Dict[str, torch.Tensor],
              steps: int, lr: float):
    """``steps`` Adam steps (optax.adam: bias-corrected moments, eps outside
    the square root) from params0. Returns (final params, detached, and the
    loss before each step (steps,) on the device)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    opt = GroupAdam(list(params.values()), lr)
    losses = []
    for _ in range(steps):
        for v in params.values():
            v.grad = None
        loss = loss_fn(params)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    first = next(iter(params.values()))
    hist = torch.stack(losses) if losses else first.new_zeros((0,))
    return {k: v.detach() for k, v in params.items()}, hist


def humor_motion_fit(smpl: SMPLModel, humor_params: Params,
                     humor_cfg: HumorConfig,
                     kp2d: Optional[torch.Tensor],
                     init_pose: torch.Tensor,
                     cfg: MotionOptConfig = MotionOptConfig(),
                     init_motion_prior: Optional[Dict[str, torch.Tensor]]
                     = None,
                     obs3d: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Fit a motion of T frames to 3D observations with the HuMoR prior.

    init_pose: (T, 72) per-frame initializer. obs3d: the 3D observations,
    each active when its weight in cfg is positive: 'joints3d' (T, 22, 3)
    (non-finite = occluded), 'verts3d' (T, K, 3) markers at 'verts3d_inds'
    (int array), 'points3d' (T, N, 3) per-frame scan, 'floor_plane' (3,) or
    (4,) observed plane. Everything lies on the SMPL model's device.
    Returns the fitted 'pose' (T, 72), 'trans' (T, 3), 'z', 'betas', the
    per-stage loss histories, the stage-2 pose and trans, and 'floor' when
    the floor is optimized, as nemo_tpu's. kp2d (the 2D keypoint term, with
    nemo_tpu's camera arguments) is still to port and must be None.
    """
    if kp2d is not None:
        raise NotImplementedError(
            "humor_motion_fit: the 2D keypoint term and camera optimization "
            "(the RGB drivers' path) are not ported yet; see ROADMAP.md "
            "Queue 1, item 7.1")
    if cfg.optimizer != "adam":
        raise NotImplementedError(
            f"humor_motion_fit: optimizer={cfg.optimizer!r} is not ported "
            "yet (no humor_tool entry point selects it); see ROADMAP.md "
            "Queue 1, item 7.4")
    T = init_pose.shape[0]
    dev = init_pose.device

    # ---- stage 1: root orient + trans ----
    trans0 = (obs3d["points3d"].mean(dim=1)
              if obs3d is not None and "points3d" in obs3d
              else init_pose.new_zeros((T, 3)))

    def s1_loss(p):
        pose = torch.cat([p["orient"], init_pose[:, 3:]], dim=1)
        return obs3d_terms(smpl, cfg, obs3d, pose, p["trans"], None)

    s1, l1 = _run_adam(s1_loss, {"orient": init_pose[:, :3],
                                 "trans": trans0},
                       cfg.steps_stage1, cfg.lr)

    # ---- stage 2: full pose sequence + betas + smoothness ----
    def s2_loss(p):
        data = obs3d_terms(smpl, cfg, obs3d, p["pose"], p["trans"],
                           p["betas"])
        smooth = ((p["pose"][1:] - p["pose"][:-1]) ** 2).mean() + \
            ((p["trans"][1:] - p["trans"][:-1]) ** 2).mean()
        if cfg.joints3d_smooth_weight > 0:
            data = data + cfg.joints3d_smooth_weight * joints3d_smooth_loss(
                fk22(smpl, p["pose"], p["trans"], p["betas"]))
        shape_prior = (p["betas"] ** 2).sum()
        return (data + cfg.smooth_weight * smooth
                + cfg.shape_prior_weight * shape_prior)

    s2, l2 = _run_adam(
        s2_loss, {"pose": torch.cat([s1["orient"], init_pose[:, 3:]], dim=1),
                  "trans": s1["trans"],
                  "betas": init_pose.new_zeros(10)},
        cfg.steps_stage2, cfg.lr)
    betas_fit = s2["betas"]

    # ---- stage 3: latent-space motion (initial state + z sequence) ----
    with torch.no_grad():
        x0 = state_from(smpl, betas_fit, s2["pose"][0], s2["trans"][0],
                        s2["pose"][0], s2["trans"][0])[None]
        # floor plane (normal * offset, motion_optimizer.py:142-150): the
        # observed plane, else the lowest stage-2 contact-joint height
        if obs3d is not None and "floor_plane" in obs3d:
            fp = torch.as_tensor(obs3d["floor_plane"], dtype=torch.float32,
                                 device=dev).reshape(-1)
            floor0 = fp[:3] * fp[3] if fp.shape[0] == 4 else fp
        else:
            j2 = fk22(smpl, s2["pose"], s2["trans"], betas_fit)
            cid = device_index(CONTACT_INDS, dev)
            floor0 = init_pose.new_tensor([0.0, 0.0, 1.0]) * (
                j2[:, cid, 2].min() + 1e-3)
    s3_0 = {"x0": x0, "z": init_pose.new_zeros((1, T - 1,
                                                humor_cfg.latent_size))}
    use_floor = (cfg.contact_height_weight > 0 or cfg.floor_reg_weight > 0
                 ) and humor_cfg.pred_contacts
    if use_floor:
        s3_0["floor"] = floor0

    s3, l3 = _run_adam(
        lambda p: stage3_loss(smpl, humor_params, humor_cfg, cfg, p,
                              betas_fit, floor0, obs3d, init_motion_prior),
        s3_0, cfg.steps_stage3, cfg.lr)
    with torch.no_grad():
        pose, trans, _, _ = decode_motion(humor_params, humor_cfg, s3, T)

    out = {"pose": pose, "trans": trans, "z": s3["z"][0], "betas": betas_fit,
           "stage1_loss": l1, "stage2_loss": l2, "stage3_loss": l3,
           "stage2_pose": s2["pose"], "stage2_trans": s2["trans"]}
    if use_floor:
        out["floor"] = s3["floor"]
    return out
