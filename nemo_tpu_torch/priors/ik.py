"""IK engine: VPoser-latent inverse kinematics, in PyTorch.

Port of nemo_tpu/priors/ik.py (behavioral reference:
human_body_prior/models/ik_engine.py:156-287): fit the VPoser latent z,
betas, global orientation and translation so that the posed body's joints
match 3D targets, with a masked data term and z and betas regularisers, by
Adam (optax's arithmetic) or by optax's L-BFGS with its zoom linesearch,
through the HuMoR fit's stage loop (``models.humor_fit._run_opt``, as
SMPLify uses its Adam loop). Each loss evaluation
runs SMPL's fused joints-only path: one K1f launch, and one K1b under the
gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..body.smpl import SMPLModel, smpl_forward
from ..geometry.rotations import batch_rodrigues
from .vposer import Params as VPoserParams, vposer_decode


@dataclasses.dataclass(frozen=True)
class IKConfig:
    num_steps: int = 100
    lr: float = 1e-1
    data_weight: float = 100.0
    z_weight: float = 1.0      # latent magnitude regulariser
    betas_weight: float = 0.5
    # 'adam' | 'lbfgs', the reference's optimizer switch
    # (ik_engine.py:246-252); L-BFGS needs far fewer steps
    optimizer: str = "adam"


def ik_fit(smpl: SMPLModel, vposer: VPoserParams,
           target_joints: torch.Tensor,
           joint_mask: Optional[torch.Tensor] = None,
           init: Optional[Dict[str, torch.Tensor]] = None,
           cfg: IKConfig = IKConfig(),
           stats: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Fit body state to (B, 49, 3) target joints (the SPIN 49-joint
    order) through the VPoser decoder, on the targets' device.

    joint_mask: (49,) or (B, 49) weights, all ones by default. init:
    optional 'z' (B, latent), 'betas' (1, 10), 'orient' (B, 3) axis-angle,
    'trans' (B, 3). stats, when a dict, gathers L-BFGS's 'loss_evals',
    'host_reads' and 'linesearch_steps'. Returns the fitted 'z', 'betas',
    'orient', 'trans', 'pose_body' (B, 63), 'joints' (B, 49, 3) and the
    'loss' before each step (num_steps,)."""
    B = target_joints.shape[0]
    dev, dt = target_joints.device, target_joints.dtype
    if joint_mask is None:
        joint_mask = torch.ones(target_joints.shape[1], dtype=dt, device=dev)
    joint_mask = torch.as_tensor(joint_mask, dtype=dt, device=dev).expand(
        target_joints.shape[:2])

    params0 = {
        "z": torch.zeros((B, vposer["dec_w1"].shape[0]), dtype=dt,
                         device=dev),
        "betas": torch.zeros((1, 10), dtype=dt, device=dev),
        "orient": torch.zeros((B, 3), dtype=dt, device=dev),
        "trans": torch.zeros((B, 3), dtype=dt, device=dev),
    }
    if init:
        params0.update({k: torch.as_tensor(v, dtype=dt, device=dev)
                        for k, v in init.items()})

    def joints_of(p):
        pose63 = vposer_decode(vposer, p["z"])["pose_body"].reshape(B, 63)
        full = torch.cat([pose63, pose63.new_zeros((B, 6))], dim=1)
        rot = batch_rodrigues(full.reshape(B, 23, 3))
        orient = batch_rodrigues(p["orient"].reshape(B, 1, 3))
        _, j = smpl_forward(smpl, p["betas"], rot, orient,
                            want_vertices=False, transl=p["trans"])
        return j, pose63

    def loss_fn(p):
        j, _ = joints_of(p)
        data = (joint_mask[..., None] * (j - target_joints) ** 2).sum(-1)
        loss = cfg.data_weight * data.mean()
        loss = loss + cfg.z_weight * (p["z"] ** 2).mean()
        return loss + cfg.betas_weight * (p["betas"] ** 2).mean()

    from ..models.humor_fit import _run_opt
    params, losses = _run_opt(loss_fn, params0, cfg.num_steps, cfg.lr,
                              cfg.optimizer, stats)
    with torch.no_grad():
        joints, pose63 = joints_of(params)
    return {**params, "pose_body": pose63, "joints": joints, "loss": losses}
