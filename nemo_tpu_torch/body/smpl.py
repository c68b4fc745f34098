"""SMPL body model: linear blend skinning and the 49-joint output.

Port of nemo_tpu/body/smpl.py. Forward kinematics runs through kernel K1
(``ops.fk.fk_compose``) and the VPoser v2v objective through kernel K2
(``ops.lbs.skin_v2v_l1``); everything else is plain PyTorch.

The model keeps logical tables only: ``posedirs_t (207, 3, V)`` and
``lbs_weights_t (24, V)`` feed K2 directly (the kernel masks the ragged
vertex edge, so there is no tiled or padded copy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import device_index
from ..geometry.rotations import batch_rodrigues
from ..ops.fk import fk_compose
from ..ops.lbs import skin_v2v_l1

NUM_BODY_JOINTS = 23
NUM_JOINTS = 24
NUM_VERTICES = 6890
NUM_BETAS = 10
NUM_OUTPUT_JOINTS = 49

_TENSOR_FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor",
                  "lbs_weights", "J_regressor_extra", "fused_ES", "fused_EP",
                  "fused_EW", "posedirs_t", "lbs_weights_t")


@dataclasses.dataclass(frozen=True)
class SMPLModel:
    """SMPL constants as tensors on one device, plus static index arrays."""
    v_template: torch.Tensor         # (V, 3)
    shapedirs: torch.Tensor          # (V, 3, n_betas)
    posedirs: torch.Tensor           # (207, V*3) reference layout
    J_regressor: torch.Tensor        # (24, V)
    lbs_weights: torch.Tensor        # (V, 24)
    J_regressor_extra: torch.Tensor  # (9, V)
    fused_ES: torch.Tensor           # (30, 24)
    fused_EP: torch.Tensor           # (30, 24, 3, 207)
    fused_EW: torch.Tensor           # (30, V, 24)
    posedirs_t: torch.Tensor         # (207, 3, V) vertex-major, for K2
    lbs_weights_t: torch.Tensor      # (24, V)
    parents: np.ndarray              # (24,) int
    vertex_joint_ids: np.ndarray     # (21,) int
    joint_map: np.ndarray            # (49,) int
    faces: Optional[np.ndarray] = None

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def to(self, device) -> "SMPLModel":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _TENSOR_FIELDS})

    @classmethod
    def from_numpy(cls, device=None, **arrays) -> "SMPLModel":
        """Build from numpy arrays keyed by field name."""
        kw = {f: torch.tensor(np.ascontiguousarray(arrays[f], np.float32),
                              device=device) for f in _TENSOR_FIELDS}
        return cls(**kw, parents=np.asarray(arrays["parents"], np.int64),
                   vertex_joint_ids=np.asarray(arrays["vertex_joint_ids"],
                                               np.int64),
                   joint_map=np.asarray(arrays["joint_map"], np.int64),
                   faces=(None if arrays.get("faces") is None
                          else np.asarray(arrays["faces"], np.int64)))


def build_fused_tables(lbs_weights: np.ndarray, J_regressor_extra: np.ndarray,
                       vertex_joint_ids: np.ndarray, posedirs: np.ndarray):
    """Fold the 30 extra-joint regressors through the skinning equation
    (numpy, once): ES (30, 24), EP (30, 24, 3, 207), EW (30, V, 24); see
    nemo_tpu/body/smpl.py for the derivation."""
    V = lbs_weights.shape[0]
    E_sel = len(vertex_joint_ids)
    Rx = np.zeros((E_sel + J_regressor_extra.shape[0], V), dtype=np.float32)
    Rx[np.arange(E_sel), np.asarray(vertex_joint_ids)] = 1.0
    Rx[E_sel:] = J_regressor_extra
    EW = Rx[:, :, None] * lbs_weights[None]
    ES = EW.sum(axis=1)
    pd = posedirs.reshape(-1, V, 3)
    EP = np.einsum('evj,pvk->ejkp', EW, pd, optimize=True)
    return ES, EP.astype(np.float32), EW


def _rel_joints(joints: torch.Tensor, parents: np.ndarray) -> torch.Tensor:
    idx = device_index(np.asarray(parents)[1:], joints.device)
    return torch.cat([joints[:, :1], joints[:, 1:] - joints[:, idx]], dim=1)


def fk_rt(rot_mats: torch.Tensor, joints: torch.Tensor, parents: np.ndarray
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FK as (R, t) pairs through K1. Returns (R_global (B, J, 3, 3),
    posed_joints (B, J, 3), t_rel (B, J, 3)) with the skinning transform
    [R_global | t_rel], t_rel = posed_joint - R_global @ rest_joint."""
    if joints.dim() == 2:
        joints = joints[None]
    B, J = rot_mats.shape[:2]
    joints = joints.expand(B, J, 3)
    R_g, posed = fk_compose(rot_mats.contiguous(),
                            _rel_joints(joints, parents).contiguous(), parents)
    t_rel = posed - torch.einsum('bnij,bnj->bni', R_g, joints)
    return R_g, posed, t_rel


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: np.ndarray
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics: (posed_joints (B, J, 3), rel_transforms
    (B, J, 4, 4)), the skinning transforms relative to the rest pose."""
    R_g, posed, t_rel = fk_rt(rot_mats, joints, parents)
    B, J = R_g.shape[:2]
    top = torch.cat([R_g, t_rel[..., None]], dim=-1)          # (B, J, 3, 4)
    bottom = top.new_zeros((B, J, 1, 4))
    bottom[..., 0, 3] = 1.0
    return posed, torch.cat([top, bottom], dim=-2)


def _v_shaped(model: SMPLModel, betas: torch.Tensor) -> torch.Tensor:
    return model.v_template + torch.einsum('bl,mkl->bmk', betas,
                                           model.shapedirs)


def smpl_forward(model: SMPLModel, betas: torch.Tensor,
                 body_pose: torch.Tensor, global_orient: torch.Tensor,
                 pose2rot: bool = False, want_vertices: bool = True,
                 transl: Optional[torch.Tensor] = None,
                 want_fk_joints: bool = False):
    """Full SMPL forward pass.

    body_pose: (B, 23, 3, 3) rotmats (pose2rot=False) or (B, 69) axis-angle;
    global_orient: (B, 1, 3, 3) rotmat or (B, 3) axis-angle; betas (1, 10)
    or (B, 10). want_vertices=False takes the fused joints-only path.
    Returns (vertices (B, V, 3) or None, joints49 (B, 49, 3)), plus the 24
    kinematic joints with want_fk_joints.
    """
    if pose2rot:
        body_rot = batch_rodrigues(body_pose.reshape(-1, 23, 3))
        orient_rot = batch_rodrigues(global_orient.reshape(-1, 1, 3))
    else:
        body_rot = body_pose
        orient_rot = global_orient.reshape(-1, 1, 3, 3)
    B = body_rot.shape[0]
    rot_mats = torch.cat([orient_rot.expand(B, 1, 3, 3), body_rot], dim=1)

    v_shaped = _v_shaped(model, betas)
    J = torch.einsum('jv,bvk->bjk', model.J_regressor, v_shaped)
    if J.shape[0] == 1 and B > 1:
        J = J.expand(B, NUM_JOINTS, 3)

    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, 23 * 9)
    posed_joints, A = batch_rigid_transform(rot_mats, J, model.parents)
    joint_map = device_index(model.joint_map, rot_mats.device)

    if want_vertices:
        pose_offsets = torch.matmul(pose_feature, model.posedirs).reshape(
            B, -1, 3)
        v_posed = pose_offsets + v_shaped
        A34 = A[:, :, :3, :4].reshape(B, NUM_JOINTS, 12)
        M = torch.einsum('vj,bjl->bvl', model.lbs_weights, A34).reshape(
            B, -1, 3, 4)
        vh = torch.cat([v_posed, v_posed.new_ones(v_posed.shape[:-1] + (1,))],
                       dim=-1)
        verts = torch.einsum('bvik,bvk->bvi', M, vh)
        extra = torch.einsum('jv,bvk->bjk', model.J_regressor_extra, verts)
        sel = verts[:, device_index(model.vertex_joint_ids, verts.device)]
        joints54 = torch.cat([posed_joints, sel, extra], dim=1)
        joints49 = joints54[:, joint_map]
        if transl is not None:
            verts = verts + transl[:, None, :]
            joints49 = joints49 + transl[:, None, :]
        if want_fk_joints:
            pj = posed_joints + transl[:, None, :] if transl is not None \
                else posed_joints
            return verts, joints49, pj
        return verts, joints49

    # ---- joints-only fused path ----
    if v_shaped.shape[0] != 1:
        raise NotImplementedError(
            "joints-only path requires shared betas (shape (1, 10))")
    S = torch.einsum('evj,vk->ejk', model.fused_EW, v_shaped[0])
    E = model.fused_EP.shape[0]
    EP_flat = model.fused_EP.permute(3, 0, 1, 2).reshape(207, -1)
    Pterm = torch.matmul(pose_feature, EP_flat).reshape(B, E, 24, 3)
    base = S[None] + Pterm
    A_perm = A[:, :, :3, :3].transpose(-1, -2).reshape(B, 72, 3)
    ej = torch.bmm(base.reshape(B, E, 72), A_perm)
    ej = ej + torch.einsum('ej,bji->bei', model.fused_ES, A[:, :, :3, 3])
    joints54 = torch.cat([posed_joints, ej], dim=1)
    joints49 = joints54[:, joint_map]
    if transl is not None:
        joints49 = joints49 + transl[:, None, :]
    if want_fk_joints:
        pj = posed_joints + transl[:, None, :] if transl is not None \
            else posed_joints
        return None, joints49, pj
    return None, joints49


def smpl_v2v_l1_sum(model: SMPLModel, betas: torch.Tensor,
                    body_rot_o: torch.Tensor, orient_rot_o: torch.Tensor,
                    body_rot_r: torch.Tensor, orient_rot_r: torch.Tensor
                    ) -> torch.Tensor:
    """sum |verts(rec) - verts(orig)| through K2, without building either
    mesh. The rec side is computed detached (no FK backward runs for it),
    like the reference's detached reconstruction. Shared betas (1, 10)."""
    v_shaped = _v_shaped(model, betas)
    if v_shaped.shape[0] != 1:
        raise NotImplementedError("smpl_v2v_l1_sum requires shared betas")
    J = torch.einsum('jv,bvk->bjk', model.J_regressor, v_shaped)
    ident = torch.eye(3, dtype=J.dtype, device=J.device)

    def side(body_rot, orient_rot):
        B = body_rot.shape[0]
        rot_mats = torch.cat([orient_rot.reshape(-1, 1, 3, 3).expand(
            B, 1, 3, 3), body_rot], dim=1)
        pf = (rot_mats[:, 1:] - ident).reshape(B, 23 * 9)
        R_g, _, t_rel = fk_rt(rot_mats, J, model.parents)
        A34 = torch.cat([R_g, t_rel[..., None]], dim=-1).reshape(
            B, NUM_JOINTS, 12)
        return pf.contiguous(), A34.contiguous()

    pf_o, A_o = side(body_rot_o, orient_rot_o)
    with torch.no_grad():
        pf_r, A_r = side(body_rot_r, orient_rot_r)
    return skin_v2v_l1(model.num_vertices, pf_o, A_o,
                       v_shaped[0].t().contiguous(), model.posedirs_t,
                       model.lbs_weights_t, pf_r, A_r)
