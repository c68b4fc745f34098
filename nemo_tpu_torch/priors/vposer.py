"""VPoser, frozen in inference mode (port of nemo_tpu/priors/vposer.py).

BatchNorm runs on stored statistics and Dropout is identity, so the model is
a fixed chain of affine maps and LeakyReLUs over a dict of weight tensors
(``(in, out)`` layout, as in the JAX package). ``load_vposer`` reads a
V02_05 snapshot directory or checkpoint file.
"""

from __future__ import annotations

import dataclasses
import os
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


def vposer_from_numpy(arrays, device=None) -> Params:
    """VPoser weights from numpy arrays keyed as nemo_tpu's pytree."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in arrays.items()}


# torch module name -> this layout's names: (weight, bias) of a Linear, or
# (gamma, beta, mean, var) of a BatchNorm
_TORCH_KEY_MAP = {
    "encoder_net.1": ("bn0_gamma", "bn0_beta", "bn0_mean", "bn0_var"),
    "encoder_net.2": ("enc_w1", "enc_b1"),
    "encoder_net.4": ("bn1_gamma", "bn1_beta", "bn1_mean", "bn1_var"),
    "encoder_net.6": ("enc_w2", "enc_b2"),
    "encoder_net.7": ("enc_w3", "enc_b3"),
    "encoder_net.8.mu": ("mu_w", "mu_b"),
    "encoder_net.8.logvar": ("logvar_w", "logvar_b"),
    "decoder_net.0": ("dec_w1", "dec_b1"),
    "decoder_net.3": ("dec_w2", "dec_b2"),
    "decoder_net.5": ("dec_w3", "dec_b3"),
}


def convert_torch_state_dict(sd: dict, device=None) -> Params:
    """A torch VPoser state dict (tensor- or numpy-valued) in this layout.

    Linear weights are transposed (torch stores (out, in)); BatchNorm
    running statistics map to the eval-mode affine. Keys may carry the
    'vp_model.' prefix of the snapshot files.
    """
    def get(k):
        for prefix in ("", "vp_model."):
            if prefix + k in sd:
                v = sd[prefix + k]
                return np.asarray(v.detach().cpu().numpy()
                                  if hasattr(v, "detach") else v)
        raise KeyError(k)

    arrays = {}
    for tkey, names in _TORCH_KEY_MAP.items():
        if len(names) == 4:  # batchnorm
            for name, field in zip(names, ("weight", "bias", "running_mean",
                                           "running_var")):
                arrays[name] = get(f"{tkey}.{field}")
        else:
            arrays[names[0]] = get(tkey + ".weight").T
            arrays[names[1]] = get(tkey + ".bias")
    return vposer_from_numpy(arrays, device)


def load_vposer(ckpt_dir_or_file: str, device=None) -> Params:
    """A V02_05-style VPoser snapshot directory (its last snapshots/* file
    in sorted order) or .ckpt file."""
    path = ckpt_dir_or_file
    if os.path.isdir(path):
        snap = os.path.join(path, "snapshots")
        cands = sorted(os.listdir(snap)) if os.path.isdir(snap) else []
        if not cands:
            raise FileNotFoundError(f"no snapshots under {path}")
        path = os.path.join(snap, cands[-1])
    # the snapshots pickle more than tensors; torch >= 2.6 defaults to
    # weights_only=True, which refuses them
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return convert_torch_state_dict(ckpt.get("state_dict", ckpt), device)


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


def vposer_kl_per_sample(mu: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    """KL(N(mu, scale) || N(0, 1)) of each row, summed over latents: (B,)."""
    kl = -torch.log(scale) + (scale ** 2 + mu ** 2) / 2.0 - 0.5
    return torch.sum(kl, dim=1)


def vposer_kl_to_std_normal(mu: torch.Tensor, scale: torch.Tensor
                            ) -> torch.Tensor:
    """KL(N(mu, scale) || N(0, 1)), summed over latents, mean over batch."""
    return torch.mean(vposer_kl_per_sample(mu, scale))
