"""HMR/SPIN single-image SMPL regressor (port of nemo_tpu/models/hmr.py).

Behavioral reference: hmr/hmr_model.py:60-207 — ResNet-50 features -> 3
iterations of an MLP that refines (pose 24x6D, shape 10, cam 3) from the
SMPL mean parameters, then SMPL forward + weak-perspective projection.
Frozen inference component (SPIN checkpoint); dropout is identity.

``HMRHead``'s parameter and buffer names are SPIN's (``fc1``, ``fc2``,
``decpose``, ``decshape``, ``deccam``, ``init_pose/shape/cam``), so a SPIN
state dict loads into it and into ``resnet.ResNet50`` as it is. The SMPL
pass is the port's ``smpl_forward`` (FK through kernel K1).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..body.smpl import SMPLModel, smpl_forward
from ..geometry.rotations import rot6d_to_rotmat, rotmat_to_aa
from .resnet import ResNet50

NPOSE = 24 * 6
FEAT_DIM = 2048
# seed of the untrained GRU a checkpoint without encoder.gru.* weights gets
GRU_SEED = 0


class HMRHead(nn.Module):
    """The SPIN iterative regressor (VIBE/lib/models/spin.py Regressor)."""

    def __init__(self, feat_dim: int = FEAT_DIM):
        super().__init__()
        self.fc1 = nn.Linear(feat_dim + NPOSE + 13, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.decpose = nn.Linear(1024, NPOSE)
        self.decshape = nn.Linear(1024, 10)
        self.deccam = nn.Linear(1024, 3)
        # mean params default: identity pose in 6D, zero shape, unit cam
        self.register_buffer("init_pose", torch.tensor(
            [1.0, 0, 0, 1, 0, 0]).repeat(24)[None])
        self.register_buffer("init_shape", torch.zeros((1, 10)))
        self.register_buffer("init_cam", torch.tensor([[0.9, 0.0, 0.0]]))

    def forward(self, features: torch.Tensor, n_iter: int = 3
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Iterative refinement (hmr_model.py:166-180): (pose6d (B, 144),
        shape (B, 10), cam (B, 3))."""
        B = features.shape[0]
        pose = self.init_pose.expand(B, NPOSE)
        shape = self.init_shape.expand(B, 10)
        cam = self.init_cam.expand(B, 3)
        for _ in range(n_iter):
            xc = torch.cat([features, pose, shape, cam], dim=1)
            xc = self.fc2(self.fc1(xc))
            pose = self.decpose(xc) + pose
            shape = self.decshape(xc) + shape
            cam = self.deccam(xc) + cam
        return pose, shape, cam


def init_hmr_head(generator: torch.Generator, feat_dim: int = FEAT_DIM
                  ) -> HMRHead:
    """Random head weights with the JAX init_hmr_head's distributions
    (uniform fc layers, Xavier-uniform decoders with gain 0.01 and zero
    bias), drawn from a torch generator; on the CPU."""
    head = HMRHead(feat_dim)

    def lin(layer, gain=None):
        o, i = layer.weight.shape
        if gain is None:
            s = 1.0 / np.sqrt(i)
            layer.weight.uniform_(-s, s, generator=generator)
            layer.bias.uniform_(-s, s, generator=generator)
        else:
            a = gain * np.sqrt(6.0 / (i + o))
            layer.weight.uniform_(-a, a, generator=generator)
            layer.bias.zero_()

    with torch.no_grad():
        lin(head.fc1)
        lin(head.fc2)
        for layer in (head.decpose, head.decshape, head.deccam):
            lin(layer, gain=0.01)
    return head.eval()


def hmr_head_from_jax(params: Mapping[str, np.ndarray]) -> HMRHead:
    """The JAX package's head pytree ((in, out) ``*_w``, ``*_b``, the init
    rows) as the module: the inverse of its ``convert_torch_hmr``."""
    p = {k: np.array(v, np.float32) for k, v in params.items()}
    sd = {}
    for name in ("fc1", "fc2", "decpose", "decshape", "deccam"):
        sd[f"{name}.weight"] = p[f"{name}_w"].T
        sd[f"{name}.bias"] = p[f"{name}_b"]
    for name in ("init_pose", "init_shape", "init_cam"):
        sd[name] = p[name]
    head = HMRHead(p["fc1_w"].shape[0] - NPOSE - 13)
    head.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()})
    return head.eval()


def weak_perspective_projection(joints: torch.Tensor, cam: torch.Tensor
                                ) -> torch.Tensor:
    """VIBE-style weak perspective: s * (x, y) + t (normalized coords)."""
    s = cam[:, 0:1, None]
    t = cam[:, None, 1:3]
    return s * joints[..., :2] + t


def spin_projection(joints: torch.Tensor, cam: torch.Tensor,
                    focal_length: float = 5000.0,
                    img_res: float = 224.0) -> torch.Tensor:
    """SPIN's kp_2d (VIBE/lib/models/spin.py:309-322): the (s, tx, ty)
    camera as a translation (tx, ty, 2f / (res * s + 1e-9)), an identity
    perspective camera centred at 0, divided by res/2 into [-1, 1] crop
    coordinates."""
    tz = 2.0 * focal_length / (img_res * cam[:, 0] + 1e-9)
    t = torch.stack([cam[:, 1], cam[:, 2], tz], dim=-1)       # (B, 3)
    pts = joints + t[:, None, :]
    xy = pts[..., :2] / pts[..., 2:3]
    return focal_length * xy / (img_res / 2.0)


def _theta_outputs(head: HMRHead, smpl: SMPLModel, features: torch.Tensor,
                   n_iter: int):
    pose6d, shape, cam = head(features, n_iter)
    rotmat = rot6d_to_rotmat(pose6d.reshape(-1, 24, 6))       # (B, 24, 3, 3)
    verts, joints = smpl_forward(smpl, shape, rotmat[:, 1:], rotmat[:, :1])
    pose_aa = rotmat_to_aa(rotmat).reshape(-1, 72)
    theta = torch.cat([cam, pose_aa, shape], dim=1)
    return theta, verts, joints, cam


def hmr_forward(backbone: ResNet50, head: HMRHead, smpl: SMPLModel,
                images_nchw: torch.Tensor, n_iter: int = 3
                ) -> Dict[str, torch.Tensor]:
    """Full HMR: image -> theta dict (hmr_model.py:145-207).

    Returns {'theta': (B, 85) = [cam3, pose72(aa), shape10], 'verts',
    'kp_3d' (49 joints), 'kp_2d' (weak-perspective)}.
    """
    theta, verts, joints, cam = _theta_outputs(
        head, smpl, backbone(images_nchw), n_iter)
    return {"theta": theta, "verts": verts, "kp_3d": joints,
            "kp_2d": weak_perspective_projection(joints, cam)}


def imagenet_normalize(images_uint8_nhwc: torch.Tensor) -> torch.Tensor:
    """uint8 RGB -> normalized float (hmr/img_utils.py crop pipeline)."""
    mean = torch.tensor([0.485, 0.456, 0.406],
                        device=images_uint8_nhwc.device)
    std = torch.tensor([0.229, 0.224, 0.225],
                       device=images_uint8_nhwc.device)
    return (images_uint8_nhwc.float() / 255.0 - mean) / std


def _module_subset(module: nn.Module, sd: Mapping[str, torch.Tensor],
                   prefix: str = "") -> Dict[str, torch.Tensor]:
    """The entries of a checkpoint's state dict that ``module`` owns
    (under ``prefix``), as float32 CPU tensors; a missing one raises
    KeyError."""
    return {k: torch.as_tensor(sd[prefix + k]).detach().cpu().float()
            for k in module.state_dict()}


def load_spin_checkpoint(path: str) -> Tuple[ResNet50, HMRHead, "nn.Module"]:
    """(backbone, head, temporal encoder) from a SPIN or VIBE checkpoint
    read with ``torch.load``: its ``model`` (or ``gen_state_dict``) state
    dict, torchvision ResNet-50 keys and SPIN's regressor keys at the top
    level, the GRU under ``encoder.gru.*`` when it has one. What the JAX
    package's ``convert_torch_hmr``/``convert_torch_gru`` and its
    vibe_demo.py:268-282 do.

    A checkpoint without ``encoder.gru.*`` keys (SPIN's own, which the
    custom-video recipe hands the demo) gets an untrained GRU, as the JAX
    CLI draws one; here from ``torch.Generator().manual_seed(GRU_SEED)``,
    since JAX's draw cannot be reproduced without JAX. A line says so. All
    three modules are in eval form, on the CPU."""
    from .vibe import TemporalEncoder, init_gru
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt.get("gen_state_dict", ckpt))
    backbone, head = ResNet50(), HMRHead()
    backbone.load_state_dict(_module_subset(backbone, sd))
    head.load_state_dict(_module_subset(head, sd))
    gru: Optional[nn.Module] = None
    if "encoder.gru.weight_ih_l0" in sd:
        gru = TemporalEncoder()
        gru.load_state_dict(_module_subset(gru, sd, "encoder."))
    else:
        print(f"[vibe_demo] WARNING: {path} has no encoder.gru.* weights; "
              f"the temporal encoder is an untrained GRU drawn from "
              f"torch.Generator().manual_seed({GRU_SEED}), added residually "
              f"to the backbone's features")
        gru = init_gru(torch.Generator().manual_seed(GRU_SEED))
    return backbone.eval(), head.eval(), gru.eval()
