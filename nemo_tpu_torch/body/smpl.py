"""SMPL body model: linear blend skinning and the 49-joint output.

Port of nemo_tpu/body/smpl.py. Forward kinematics runs through kernel K1
(``ops.fk.fk_compose``), the VPoser v2v objective through kernel K2
(``ops.lbs.skin_v2v_l1``) and the vertex-major meshes of ``smpl_verts_t``
through kernel K3 (``ops.lbs.skin_verts_t``); everything else is plain
PyTorch.

The model keeps logical tables: ``posedirs_t (207, 3, V)`` and
``lbs_weights_t (24, V)`` feed K2 and K3 directly (the kernels mask the
ragged vertex edge, so there is no tiled copy), and a vertex subset's tables
are contiguous column slices of them. The one padded copy is
``posedirs_pad``, posedirs_t with rows padded to a multiple of 16 vertices
(``ops.lbs.padded_posedirs``), made once here for K2's fused kernel with
f32 tables. Those two are the
skinning tables, in float32 or, built with ``skin_dtype=torch.bfloat16``
(the JAX package's NEMO_TPU_SKIN_BF16 / ``--skin_bf16``), in bfloat16, which
selects the kernels' bf16 computation; they feed only K2 and K3. Every
other field stays float32, so the keypoints, the evals and the renders
(``smpl_forward``: ``posedirs``, ``lbs_weights``) do not see the choice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import device_index
from ..geometry.rotations import batch_rodrigues
from ..ops.fk import fk_compose
from ..ops.lbs import padded_posedirs, skin_v2v_l1, skin_verts_t

NUM_BODY_JOINTS = 23
NUM_JOINTS = 24
NUM_VERTICES = 6890
NUM_BETAS = 10
NUM_OUTPUT_JOINTS = 49

_TENSOR_FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor",
                  "lbs_weights", "J_regressor_extra", "fused_ES", "fused_EP",
                  "fused_EW", "posedirs_t", "lbs_weights_t")
_SKIN_TABLES = ("posedirs_t", "lbs_weights_t")
SKIN_DTYPES = (torch.float32, torch.bfloat16)


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
    posedirs_t: torch.Tensor         # (207, 3, V) vertex-major, for K2/K3
    lbs_weights_t: torch.Tensor      # (24, V); both f32 or bf16
    parents: np.ndarray              # (24,) int
    vertex_joint_ids: np.ndarray     # (21,) int
    joint_map: np.ndarray            # (49,) int
    faces: Optional[np.ndarray] = None
    posedirs_pad: Optional[torch.Tensor] = None  # f32 tables: K2's copy

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def to(self, device) -> "SMPLModel":
        pad = self.posedirs_pad
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _TENSOR_FIELDS},
            posedirs_pad=None if pad is None else pad.to(device))

    @classmethod
    def from_numpy(cls, device=None, skin_dtype: torch.dtype = torch.float32,
                   **arrays) -> "SMPLModel":
        """Build from numpy arrays keyed by field name; the skinning tables
        (posedirs_t, lbs_weights_t) rounded to ``skin_dtype`` (float32 or
        bfloat16, round to nearest even), every other field float32; with
        float32 tables also posedirs_pad."""
        if skin_dtype not in SKIN_DTYPES:
            raise ValueError(f"skin_dtype {skin_dtype}: expected one of "
                             f"{SKIN_DTYPES}")
        kw = {f: torch.tensor(np.ascontiguousarray(arrays[f], np.float32),
                              device=device) for f in _TENSOR_FIELDS}
        for f in _SKIN_TABLES:
            kw[f] = kw[f].to(skin_dtype)
        return cls(**kw, parents=np.asarray(arrays["parents"], np.int64),
                   vertex_joint_ids=np.asarray(arrays["vertex_joint_ids"],
                                               np.int64),
                   joint_map=np.asarray(arrays["joint_map"], np.int64),
                   faces=(None if arrays.get("faces") is None
                          else np.asarray(arrays["faces"], np.int64)),
                   posedirs_pad=(padded_posedirs(kw["posedirs_t"])
                                 if skin_dtype == torch.float32 else None))


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


def _skin_inputs(model: SMPLModel, betas: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v_shaped (V, 3), rest joints (1, 24, 3)) for shared betas (1, 10)."""
    v_shaped = _v_shaped(model, betas)
    if v_shaped.shape[0] != 1:
        raise NotImplementedError("vertex-major skinning requires shared "
                                  "betas (shape (1, 10))")
    J = torch.einsum('jv,bvk->bjk', model.J_regressor, v_shaped)
    return v_shaped[0], J


def _pose_inputs(model: SMPLModel, J: torch.Tensor, body_rot: torch.Tensor,
                 orient_rot: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pf (B, 207), A34 (B, 24, 12)): the skinning kernels' per-row
    inputs, FK in (R, t) form through K1."""
    B = body_rot.shape[0]
    rot_mats = torch.cat([orient_rot.reshape(-1, 1, 3, 3).expand(
        B, 1, 3, 3), body_rot], dim=1)
    ident = torch.eye(3, dtype=J.dtype, device=J.device)
    pf = (rot_mats[:, 1:] - ident).reshape(B, 23 * 9)
    R_g, _, t_rel = fk_rt(rot_mats, J, model.parents)
    A34 = torch.cat([R_g, t_rel[..., None]], dim=-1).reshape(
        B, NUM_JOINTS, 12)
    return pf.contiguous(), A34.contiguous()


def smpl_verts_t(model: SMPLModel, betas: torch.Tensor,
                 body_rot: torch.Tensor, orient_rot: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Vertex-major SMPL vertices (B, 3, V) through K3: the same math as
    smpl_forward(want_vertices=True) minus the joint outputs. Shared betas
    (1, 10). out_dtype: the mesh's, f32 or bf16 (ops.lbs.skin_verts_t).
    The JAX package's padded variant (zero lanes past V) has no
    counterpart: the kernels mask the ragged edge, so there are no lanes
    to pad."""
    v_shaped, J = _skin_inputs(model, betas)
    pf, A34 = _pose_inputs(model, J, body_rot, orient_rot)
    return skin_verts_t(model.num_vertices, pf, A34,
                        v_shaped.t().contiguous(), model.posedirs_t,
                        model.lbs_weights_t, out_dtype)


def subset_skin_tables(model: SMPLModel, n: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """An even vertex subsample and its skinning tables (once, at setup):
    (vidx (n',) long, posedirs_t (207, 3, n'), lbs_weights_t (24, n')),
    contiguous on the model's device, in the model's table dtype (as the
    JAX package tiles the subset in skin_tables_dtype). The vertices are
    those of nemo_tpu/body/smpl.py subset_skin_tables,
    unique(linspace(0, V-1, n)), so n' <= n; the tables are logical column
    slices, not tiles."""
    V = model.num_vertices
    vidx = np.unique(np.linspace(0, V - 1, n).astype(np.int64))
    idx = torch.as_tensor(vidx, device=model.device)
    return (idx, model.posedirs_t[:, :, idx].contiguous(),
            model.lbs_weights_t[:, idx].contiguous())


def smpl_verts_t_subset(model: SMPLModel, betas: torch.Tensor,
                        body_rot: torch.Tensor, orient_rot: torch.Tensor,
                        vidx: torch.Tensor, posedirs_sub: torch.Tensor,
                        weights_sub: torch.Tensor,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """smpl_verts_t on a vertex subset: (B, 3, len(vidx)) in out_dtype,
    tables from subset_skin_tables. The joints still come from the full
    v_shaped (the kinematic tree does not change); only the skinned output
    is subsampled, and the gradient of v_shaped reaches the betas through
    the gather."""
    v_shaped, J = _skin_inputs(model, betas)
    pf, A34 = _pose_inputs(model, J, body_rot, orient_rot)
    vsh_sub = v_shaped.t()[:, vidx].contiguous()
    return skin_verts_t(int(vidx.shape[0]), pf, A34, vsh_sub, posedirs_sub,
                        weights_sub, out_dtype)


def smpl_v2v_l1_sum(model: SMPLModel, betas: torch.Tensor,
                    body_rot_o: torch.Tensor, orient_rot_o: torch.Tensor,
                    body_rot_r: torch.Tensor, orient_rot_r: torch.Tensor,
                    vjp: str = "fused") -> torch.Tensor:
    """sum |verts(rec) - verts(orig)| through K2, without building either
    mesh. The rec side is computed detached (no FK backward runs for it),
    like the reference's detached reconstruction. Shared betas (1, 10).
    vjp: the gradient mode of ops.lbs.skin_v2v_l1."""
    v_shaped, J = _skin_inputs(model, betas)
    pf_o, A_o = _pose_inputs(model, J, body_rot_o, orient_rot_o)
    with torch.no_grad():
        pf_r, A_r = _pose_inputs(model, J, body_rot_r, orient_rot_r)
    return skin_v2v_l1(model.num_vertices, pf_o, A_o,
                       v_shaped.t().contiguous(), model.posedirs_t,
                       model.lbs_weights_t, pf_r, A_r, vjp=vjp,
                       posedirs_pad=model.posedirs_pad)
