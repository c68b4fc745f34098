"""ResNet-50 feature extractor (port of nemo_tpu/models/resnet.py).

Behavioral reference: the torchvision ResNet-50 backbone used by both HMR
(hmr/hmr_model.py:60-207) and VIBE's feature extractor
(VIBE/lib/models/spin.py). A frozen inference component: BatchNorm always
reads its running statistics (eps 1e-5), whatever the module's train/eval
flag, and the parameter and buffer names are torchvision's, so a SPIN
state dict loads with ``load_state_dict``.

Layout: NCHW images and OIHW kernels, where the JAX package has NHWC and
HWIO. The convolutions pad k//2 on both sides (the JAX package's explicit
symmetric padding) and the max pool is torch's ``MaxPool2d(3, 2, 1)``, the
``-inf``-padded ``reduce_window`` of the JAX version. Convolutions and
batch norm are cuDNN's on the card: in the JAX package they are XLA's, not
Pallas kernels.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# ResNet-50 stage structure
STAGE_BLOCKS = (3, 4, 6, 3)
STAGE_CHANNELS = (256, 512, 1024, 2048)
BN_EPS = 1e-5


class FrozenBatchNorm2d(nn.Module):
    """Batch norm from running statistics only (torchvision's buffer
    names): (x - mean) / sqrt(var + eps) * weight + bias."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 bottleneck with an optional projection
    shortcut (``downsample.0`` conv, ``downsample.1`` norm)."""

    def __init__(self, cin: int, cout: int, stride: int, project: bool):
        super().__init__()
        mid = cout // 4
        self.conv1 = _conv(cin, mid, 1)
        self.bn1 = FrozenBatchNorm2d(mid)
        self.conv2 = _conv(mid, mid, 3, stride)
        self.bn2 = FrozenBatchNorm2d(mid)
        self.conv3 = _conv(mid, cout, 1)
        self.bn3 = FrozenBatchNorm2d(cout)
        self.downsample = (nn.Sequential(_conv(cin, cout, 1, stride),
                                         FrozenBatchNorm2d(cout))
                           if project else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


class ResNet50(nn.Module):
    """(B, 3, H, W) normalized crops -> (B, 2048) pooled features."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm2d(64)
        in_c = 64
        for si, (nblocks, out_c) in enumerate(zip(STAGE_BLOCKS,
                                                  STAGE_CHANNELS)):
            blocks = []
            for bi in range(nblocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                blocks.append(Bottleneck(in_c, out_c, stride, bi == 0))
                in_c = out_c
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.max_pool2d(out, 3, 2, padding=1)
        for si in range(len(STAGE_BLOCKS)):
            out = getattr(self, f"layer{si + 1}")(out)
        return out.mean(dim=(2, 3))


def init_resnet50(generator: torch.Generator) -> ResNet50:
    """He-init random weights (as the JAX init_resnet50, from a torch
    generator: the draws differ), identity batch norms; on the CPU."""
    net = ResNet50()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight.shape[1] * m.weight.shape[2] \
                    * m.weight.shape[3]
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator)
                               * np.sqrt(2.0 / fan_in))
    return net.eval()


def resnet50_from_jax(params: Mapping[str, np.ndarray]) -> ResNet50:
    """The JAX package's NHWC pytree (HWIO kernels, ``*.gamma/beta/mean/
    var`` norms, ``down``/``downbn`` shortcuts; numpy or anything
    ``np.asarray`` reads) as the module: the inverse of its
    ``convert_torch_resnet50``."""
    p = {k: np.array(v, np.float32) for k, v in params.items()}
    sd: Dict[str, np.ndarray] = {
        "conv1.weight": p["conv1.w"].transpose(3, 2, 0, 1)}

    def bn(dst, src):
        for k, v in (("weight", "gamma"), ("bias", "beta"),
                     ("running_mean", "mean"), ("running_var", "var")):
            sd[f"{dst}.{k}"] = p[f"{src}.{v}"]

    bn("bn1", "bn1")
    for si, nblocks in enumerate(STAGE_BLOCKS):
        for bi in range(nblocks):
            pre = f"layer{si + 1}.{bi}"
            for ci in (1, 2, 3):
                sd[f"{pre}.conv{ci}.weight"] = \
                    p[f"{pre}.conv{ci}.w"].transpose(3, 2, 0, 1)
                bn(f"{pre}.bn{ci}", f"{pre}.bn{ci}")
            if f"{pre}.down.w" in p:
                sd[f"{pre}.downsample.0.weight"] = \
                    p[f"{pre}.down.w"].transpose(3, 2, 0, 1)
                bn(f"{pre}.downsample.1", f"{pre}.downbn")
    net = ResNet50()
    net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in sd.items()})
    return net.eval()
