"""VPoser, frozen in inference mode (port of nemo_tpu/priors/vposer.py).

BatchNorm runs on stored statistics and Dropout is identity, so the model is
a fixed chain of affine maps and LeakyReLUs over a dict of weight tensors
(``(in, out)`` layout, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry.rotations import rot6d_to_rotmat, rotmat_to_aa

Params = Dict[str, torch.Tensor]

NUM_JOINTS = 21
N_FEATURES = NUM_JOINTS * 3


@dataclasses.dataclass(frozen=True)
class VPoserConfig:
    num_neurons: int = 512
    latent_dim: int = 32


def init_vposer(cfg: VPoserConfig = VPoserConfig(),
                generator: Optional[torch.Generator] = None) -> Params:
    """Random init with torch.nn.Linear's uniform bounds (tests and
    synthetic runs; real use converts the V02_05 checkpoint)."""
    n, d = cfg.num_neurons, cfg.latent_dim

    def lin(i, o):
        s = 1.0 / np.sqrt(i)
        return ((torch.rand((i, o), generator=generator) * 2 - 1) * s,
                (torch.rand((o,), generator=generator) * 2 - 1) * s)

    p: Params = {}
    for (w, b), (i, o) in zip(
            (("enc_w1", "enc_b1"), ("enc_w2", "enc_b2"), ("enc_w3", "enc_b3"),
             ("mu_w", "mu_b"), ("logvar_w", "logvar_b"),
             ("dec_w1", "dec_b1"), ("dec_w2", "dec_b2"),
             ("dec_w3", "dec_b3")),
            ((N_FEATURES, n), (n, n), (n, n), (n, d), (n, d), (d, n), (n, n),
             (n, NUM_JOINTS * 6))):
        p[w], p[b] = lin(i, o)
    for name, size in (("bn0", N_FEATURES), ("bn1", n)):
        p[f"{name}_mean"] = torch.zeros(size)
        p[f"{name}_var"] = torch.ones(size)
        p[f"{name}_gamma"] = torch.ones(size)
        p[f"{name}_beta"] = torch.zeros(size)
    return p


def vposer_from_numpy(arrays) -> Params:
    """VPoser weights from numpy arrays keyed as nemo_tpu's pytree."""
    return {k: torch.tensor(np.asarray(v, np.float32))
            for k, v in arrays.items()}


def _bn(x, mean, var, gamma, beta, eps: float = 1e-5):
    return (x - mean) / torch.sqrt(var + eps) * gamma + beta


def vposer_encode(p: Params, pose_body: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """63-d body pose -> (mu, scale = softplus(logvar head))."""
    x = pose_body.reshape(pose_body.shape[0], -1)
    x = _bn(x, p["bn0_mean"], p["bn0_var"], p["bn0_gamma"], p["bn0_beta"])
    x = F.leaky_relu(x @ p["enc_w1"] + p["enc_b1"], negative_slope=0.01)
    x = _bn(x, p["bn1_mean"], p["bn1_var"], p["bn1_gamma"], p["bn1_beta"])
    x = x @ p["enc_w2"] + p["enc_b2"]
    x = x @ p["enc_w3"] + p["enc_b3"]
    mu = x @ p["mu_w"] + p["mu_b"]
    scale = F.softplus(x @ p["logvar_w"] + p["logvar_b"])
    return mu, scale


def vposer_decode(p: Params, z: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Latent -> {'pose_body' (B, 21, 3), 'pose_body_matrot' (B, 21, 9)}."""
    B = z.shape[0]
    x = F.leaky_relu(z @ p["dec_w1"] + p["dec_b1"], negative_slope=0.01)
    x = F.leaky_relu(x @ p["dec_w2"] + p["dec_b2"], negative_slope=0.01)
    x = x @ p["dec_w3"] + p["dec_b3"]
    rotmat = rot6d_to_rotmat(x.reshape(B, NUM_JOINTS, 6))
    aa = rotmat_to_aa(rotmat)
    return {"pose_body": aa.reshape(B, NUM_JOINTS, 3),
            "pose_body_matrot": rotmat.reshape(B, NUM_JOINTS, 9)}


def vposer_kl_to_std_normal(mu: torch.Tensor, scale: torch.Tensor
                            ) -> torch.Tensor:
    """KL(N(mu, scale) || N(0, 1)), summed over latents, mean over batch."""
    kl = -torch.log(scale) + (scale ** 2 + mu ** 2) / 2.0 - 0.5
    return torch.mean(torch.sum(kl, dim=1))
