"""Plain SMPL and rotation conversions in float32 PyTorch.

The yardstick's own body model: the published SMPL equations (shape blend,
joint regression, pose blend, forward kinematics, linear blend skinning)
and SPIN's 49-joint output, written from the papers with no kernel, cache
or fused table. It imports nothing of the program under test.
"""

from __future__ import annotations

import torch

# SMPL's kinematic tree: the parent of each of the 24 joints
PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
           18, 19, 20, 21)
# the 21 vertex keypoints of smplx's VertexJointSelector (face, feet, hands)
VERTEX_JOINT_IDS = (332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617, 6624,
                    6787, 2746, 2319, 2445, 2556, 2673, 6191, 5782, 5905,
                    6016, 6133)
# SPIN's 49 joints (25 OpenPose + 24 ground truth) as indices into the 54
# of [24 kinematic, 21 vertex keypoints, 9 extra regressed]
JOINT_MAP = (24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7, 25, 26, 27,
             28, 29, 30, 31, 32, 33, 34, 8, 5, 45, 46, 4, 7, 21, 19, 17, 16,
             18, 20, 47, 48, 49, 50, 51, 52, 53, 24, 26, 25, 28, 27)


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3). The angle is
    taken of aa + 1e-8, as SMPL's own batch_rodrigues does, so it is never
    0."""
    angle = torch.linalg.vector_norm(aa + 1e-8, dim=-1, keepdim=True)
    k = aa / angle
    s, c = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
    x, y, z = k.unbind(-1)
    o = torch.zeros_like(x)
    K = torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(
        aa.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + s * K + (1 - c) * (K @ K)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """Zhou et al.'s 6D rotation (..., 6), read as two 3-vectors in the
    columns of a (3, 2) matrix -> Gram-Schmidt frame [b1, b2, b1 x b2]."""
    x = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = x[..., 0], x[..., 1]
    b1 = a1 / a1.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    u = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = u / u.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.stack([b1, b2, torch.cross(b1, b2, dim=-1)], dim=-1)


def rotmat_to_aa(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle through a unit quaternion taken by
    Shepperd's rule (the case of the largest of w, x, y, z), then
    2 atan2(|v|, w) v / |v|, with v / |v| times the angle's limit 2 / w
    where |v| is 0."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cands = torch.stack([
        torch.stack([1 + tr, m[..., 2, 1] - m[..., 1, 2],
                     m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1]], -1),
        torch.stack([m[..., 2, 1] - m[..., 1, 2],
                     1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                     m[..., 0, 1] + m[..., 1, 0],
                     m[..., 0, 2] + m[..., 2, 0]], -1),
        torch.stack([m[..., 0, 2] - m[..., 2, 0],
                     m[..., 0, 1] + m[..., 1, 0],
                     1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                     m[..., 1, 2] + m[..., 2, 1]], -1),
        torch.stack([m[..., 1, 0] - m[..., 0, 1],
                     m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1],
                     1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], -1),
    ], -2)                                              # (..., 4 cases, 4)
    diag = torch.stack([cands[..., i, i] for i in range(4)], -1)
    pick = diag.argmax(-1, keepdim=True)
    q = torch.gather(cands, -2, pick[..., None].expand(
        pick.shape + (4,))).squeeze(-2)
    q = q / (2 * torch.sqrt(torch.gather(diag, -1, pick).clamp_min(1e-12)))
    q = torch.where(q[..., :1] < 0, -q, q)              # w >= 0
    w, v = q[..., 0], q[..., 1:]
    s = v.norm(dim=-1)
    safe = s > 1e-12
    s_safe = torch.where(safe, s, torch.ones_like(s))
    k = torch.where(safe, 2 * torch.atan2(s_safe, w) / s_safe,
                    2 / w.clamp_min(1e-12))
    return v * k[..., None]


class Body:
    """The SMPL tables (float32, on one device) and the forward pass."""

    def __init__(self, v_template, shapedirs, posedirs, J_regressor,
                 lbs_weights, J_regressor_extra):
        self.v_template = v_template          # (V, 3)
        self.shapedirs = shapedirs            # (V, 3, 10)
        self.posedirs = posedirs              # (207, 3 V), column 3 v + k
        self.J_regressor = J_regressor        # (24, V)
        self.lbs_weights = lbs_weights        # (V, 24)
        self.J_regressor_extra = J_regressor_extra   # (9, V)
        dev = v_template.device
        V = v_template.shape[0]
        # a body of another size takes the keypoints at the same share of
        # its vertices
        self.vertex_ids = torch.tensor([i * V // 6890 for i in
                                        VERTEX_JOINT_IDS], device=dev)
        self.joint_map = torch.tensor(JOINT_MAP, device=dev)

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    def shaped(self, betas: torch.Tensor):
        """(v_shaped (B', V, 3), rest joints (B', 24, 3)) of betas (B', 10)."""
        v = self.v_template + torch.einsum('bl,vkl->bvk', betas,
                                           self.shapedirs)
        return v, torch.einsum('jv,bvk->bjk', self.J_regressor, v)

    def posed(self, betas: torch.Tensor, rot: torch.Tensor):
        """(posed vertices (B, V, 3), posed joints (B, 24, 3)) of rotations
        rot (B, 24, 3, 3), joint 0 the global orientation; betas (1, 10)
        shared or (B, 10)."""
        B = rot.shape[0]
        v_shaped, J = self.shaped(betas)
        J = J.expand(B, 24, 3)
        eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
        pose_feature = (rot[:, 1:] - eye).reshape(B, 207)
        v_posed = v_shaped + (pose_feature @ self.posedirs).reshape(B, -1, 3)
        # forward kinematics, joint by joint down the tree
        Rg, tg = [rot[:, 0]], [J[:, 0]]
        for j in range(1, 24):
            p = PARENTS[j]
            Rg.append(Rg[p] @ rot[:, j])
            tg.append(tg[p] + (Rg[p] @ (J[:, j] - J[:, p])[..., None])[..., 0])
        Rg, tg = torch.stack(Rg, 1), torch.stack(tg, 1)
        t_rel = tg - (Rg @ J[..., None])[..., 0]
        A = torch.cat([Rg, t_rel[..., None]], -1).reshape(B, 24, 12)
        M = torch.einsum('vj,bjl->bvl', self.lbs_weights, A).reshape(
            B, -1, 3, 4)
        verts = (M[..., :3] @ v_posed[..., None])[..., 0] + M[..., 3]
        return verts, tg

    def joints49(self, betas: torch.Tensor, rot: torch.Tensor
                 ) -> torch.Tensor:
        """SPIN's 49 joints (B, 49, 3): the 24 posed joints, the 21 vertex
        keypoints and the 9 extra joints regressed from the posed mesh."""
        verts, posed = self.posed(betas, rot)
        extra = torch.einsum('ev,bvk->bek', self.J_regressor_extra, verts)
        j54 = torch.cat([posed, verts[:, self.vertex_ids], extra], 1)
        return j54[:, self.joint_map]
