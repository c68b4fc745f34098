"""VIBE video SMPL regressor: per-frame features -> GRU -> SPIN regressor
(port of nemo_tpu/models/vibe.py).

Behavioral reference: VIBE/lib/models/vibe.py:27-179 — a 1-layer GRU
(hidden 2048, residual connection) over per-frame ResNet-50 features,
followed by the SPIN iterative Regressor on each frame. Frozen inference
component used to produce the `vibe_output.pkl` initialization NeMo consumes.

The GRU is ``nn.GRU`` (cuDNN on the card; ``gru_cell``'s ``lax.scan`` of
matmuls in the JAX package, not a Pallas kernel): torch's gate order
(r, z, n) and n = tanh(W_in x + b_in + r * (W_hn h + b_hn)), the semantics
the JAX cell copies. Its parameters sit at ``gru.weight_ih_l0`` etc., so a
VIBE checkpoint's ``encoder.*`` entries load into ``TemporalEncoder``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..body.smpl import SMPLModel
from .hmr import HMRHead, _theta_outputs, spin_projection
from .resnet import ResNet50

HIDDEN = 2048


class TemporalEncoder(nn.Module):
    """VIBE's TemporalEncoder without its optional linear layer: one GRU
    layer over (B, T, F) features, plus the input where widths agree."""

    def __init__(self, input_size: int = HIDDEN, hidden_size: int = HIDDEN,
                 use_residual: bool = True):
        super().__init__()
        self.gru = nn.GRU(input_size, hidden_size, 1, batch_first=True)
        self.use_residual = use_residual

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        y, _ = self.gru(feats)
        if self.use_residual and y.shape[-1] == feats.shape[-1]:
            y = y + feats
        return y


def init_gru(generator: torch.Generator, input_size: int = HIDDEN,
             hidden_size: int = HIDDEN) -> TemporalEncoder:
    """torch.nn.GRU's initialization, uniform(-1/sqrt(H), 1/sqrt(H)) on
    every weight and bias, drawn from a torch generator; on the CPU."""
    enc = TemporalEncoder(input_size, hidden_size)
    s = 1.0 / np.sqrt(hidden_size)
    with torch.no_grad():
        for name in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                     "bias_hh_l0"):
            getattr(enc.gru, name).uniform_(-s, s, generator=generator)
    return enc.eval()


def gru_from_jax(params: Mapping[str, np.ndarray]) -> TemporalEncoder:
    """The JAX package's GRU pytree ((in, 3H) ``w_ih``, ``w_hh``, ``b_ih``,
    ``b_hh``) as the module: the inverse of its ``convert_torch_gru``."""
    p = {k: np.array(v, np.float32) for k, v in params.items()}
    enc = TemporalEncoder(p["w_ih"].shape[0], p["w_hh"].shape[0])
    enc.gru.load_state_dict({
        "weight_ih_l0": torch.from_numpy(np.ascontiguousarray(p["w_ih"].T)),
        "weight_hh_l0": torch.from_numpy(np.ascontiguousarray(p["w_hh"].T)),
        "bias_ih_l0": torch.from_numpy(p["b_ih"]),
        "bias_hh_l0": torch.from_numpy(p["b_hh"])})
    return enc.eval()


def hmr_forward_from_features(head: HMRHead, smpl: SMPLModel,
                              features: torch.Tensor, n_iter: int = 3
                              ) -> Dict[str, torch.Tensor]:
    """SPIN Regressor on precomputed features (VIBE/lib/models/spin.py);
    kp_2d through SPIN's weak-persp -> perspective conversion
    (spin.py:309-322), as in reference vibe_output joints2d."""
    theta, verts, joints, cam = _theta_outputs(head, smpl, features, n_iter)
    return {"theta": theta, "verts": verts, "kp_3d": joints,
            "kp_2d": spin_projection(joints, cam)}


def vibe_forward(backbone: ResNet50, gru: TemporalEncoder, head: HMRHead,
                 smpl: SMPLModel, images_ntchw: torch.Tensor,
                 n_iter: int = 3) -> Dict[str, torch.Tensor]:
    """Full VIBE_Demo path (vibe.py:160-179): crops -> features -> GRU ->
    per-frame SPIN regressor -> SMPL.

    images_ntchw: (B, T, 3, H, W) normalized crops (the JAX package's
    (B, T, H, W, 3) transposed). Returns a dict with (B, T, ...) leading
    axes.
    """
    B, T = images_ntchw.shape[:2]
    flat = images_ntchw.reshape((B * T,) + images_ntchw.shape[2:])
    feats = gru(backbone(flat).reshape(B, T, -1))
    out = hmr_forward_from_features(head, smpl, feats.reshape(B * T, -1),
                                    n_iter)
    return {k: v.reshape((B, T) + v.shape[1:]) for k, v in out.items()}
