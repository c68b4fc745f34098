"""HuMoR's motion prior in plain float32 PyTorch: the part that the custom
entry's dynamics term reads.

HuMoR (Rempe et al., ICCV 2021, arXiv 2105.04668; its code's
``humor/models/humor_model.py``) is a conditional VAE over the transitions
of a 207-d "smpl+joints" state: trans, trans_vel, root_orient,
root_orient_vel, pose_body (63), joints (22 x 3) and joints_vel. Its
posterior encoder reads (x_{t-1}, x_t) and its conditional prior x_{t-1};
both are MLPs (``MLP``: Linear, then (GroupNorm, ReLU, Linear) for each
further layer) whose last layer gives a latent's mean and log-variance. The
dynamics term of NeMo's custom entry is the mean over transitions of
KL(posterior || prior) (``kl_normal``).

Departures from the HuMoR code, each with its reason:
- weights come as (in, out) matrices and are applied as ``x @ w + b``,
  torch.nn.Linear's ``x @ W.T + b`` with W = w.T: the layout both sides of
  the benchmark are given;
- only the encoder and the conditional prior are built: the term reads no
  decoder;
- no module objects: the layers are the functional calls that
  ``nn.Linear``, ``nn.GroupNorm`` and ``nn.ReLU`` make
  (``torch.nn.functional.group_norm``, eps 1e-5).

It imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .body import PARENTS, rotmat_to_aa

STATE_DIM = 207
# HuMoR's joints in the state: SMPL's first 22 (the hands left out)
STATE_JOINTS = 22


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, n_linear: int,
        groups: int) -> torch.Tensor:
    """HuMoR's MLP: Linear, then (GroupNorm, ReLU, Linear) n_linear - 1
    times; p holds w0, b0, ... and gn<i>_g, gn<i>_b before Linear i."""
    x = x @ p["w0"] + p["b0"]
    for i in range(1, n_linear):
        x = F.relu(F.group_norm(x, groups, p[f"gn{i}_g"], p[f"gn{i}_b"],
                                eps=1e-5))
        x = x @ p[f"w{i}"] + p[f"b{i}"]
    return x


def gaussian(out: torch.Tensor, latent: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, variance) from an MLP's last layer: the variance is the exp of
    the second half."""
    return out[:, :latent], torch.exp(out[:, latent:])


def kl_normal(qm, qv, pm, pv) -> torch.Tensor:
    """KL(N(qm, qv) || N(pm, pv)) of each row, summed over the latent."""
    return (0.5 * (torch.log(pv) - torch.log(qv) + qv / pv
                   + (qm - pm) ** 2 / pv - 1)).sum(-1)


def transition_kl(params: Dict[str, Dict[str, torch.Tensor]], cfg: dict,
                  past: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """The KL of each transition (past -> nxt), (N, 207) states, under the
    posterior encoder and the conditional prior."""
    L, G = cfg["latent_size"], cfg["num_groups"]
    n_enc = len(cfg["encoder_widths"]) + 1
    n_pri = len(cfg["prior_widths"]) + 1
    qm, qv = gaussian(mlp(params["encoder"], torch.cat([past, nxt], 1),
                          n_enc, G), L)
    pm, pv = gaussian(mlp(params["prior"], past, n_pri, G), L)
    return kl_normal(qm, qv, pm, pv)


def fk_joints(body, betas: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """SMPL's 24 posed joints (B, 24, 3) of rotations rot (B, 24, 3, 3):
    the rest joints of the shaped body through the kinematic tree, without
    the mesh."""
    B = rot.shape[0]
    _, J = body.shaped(betas)
    J = J.expand(B, 24, 3)
    Rg, tg = [rot[:, 0]], [J[:, 0]]
    for j in range(1, 24):
        p = PARENTS[j]
        Rg.append(Rg[p] @ rot[:, j])
        tg.append(tg[p] + (Rg[p] @ (J[:, j] - J[:, p])[..., None])[..., 0])
    return torch.stack(tg, 1)


def window_states(trans, rot, joints, fps: float) -> torch.Tensor:
    """The custom entry's HuMoR states of a window of three frames (f - 1,
    f, f + 1): each a tuple of that frame's (B, ...) tensors; returns
    (B, 2, 207), the states at f and f + 1. Velocities are finite
    differences at ``fps`` (HuMoR's estimate_velocities); the root's angular
    velocity is the axis-angle of R_t R_{t-1}^T times fps."""
    def state(i):
        dR = rot[i][:, 0] @ rot[i - 1][:, 0].transpose(-1, -2)
        pose = rotmat_to_aa(rot[i][:, 1:22]).reshape(-1, 63)
        return torch.cat([trans[i], (trans[i] - trans[i - 1]) * fps,
                          rotmat_to_aa(rot[i][:, 0]),
                          rotmat_to_aa(dR) * fps, pose,
                          joints[i].reshape(-1, 3 * STATE_JOINTS),
                          (joints[i] - joints[i - 1]).reshape(
                              -1, 3 * STATE_JOINTS) * fps], -1)
    return torch.stack([state(1), state(2)], 1)
