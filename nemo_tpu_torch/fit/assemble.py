"""Build NemoAssets from a bundle and the frozen model components."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..body.smpl import SMPLModel
from ..priors.gmm import GMMPrior
from .model import NemoAssets, NemoConfig


def build_assets(bundle, smpl: SMPLModel, cfg: NemoConfig,
                 gmm: Optional[GMMPrior] = None,
                 vposer: Optional[Dict[str, torch.Tensor]] = None,
                 device=None) -> NemoAssets:
    """Collate the 2D supervision (reference collate_gt_2d :2908-2961) and
    move everything to ``device`` once. ``bundle`` is a MultiViewBundle of
    either package (both are numpy)."""
    device = torch.device(device) if device is not None else smpl.device
    thr = cfg.label_intersection_threshold
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return NemoAssets(
        smpl=smpl.to(device),
        gmm=None if gmm is None else gmm.to(device),
        vposer=(None if vposer is None
                else {k: v.to(device) for k, v in vposer.items()}),
        points2d_gt=t(bundle.label(cfg.label_type, thr)),
        bbox_diag=t(bundle.bbox_diag(cfg.label_type, thr)),
        hmr_theta=t(bundle.hmr_theta),
        hmr_mask=t(bundle.hmr_mask),
        img_d0=bundle.img_d0,
        img_d1=bundle.img_d1,
    )
