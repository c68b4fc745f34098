"""Build NemoAssets from a bundle and the frozen model components."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..body.smpl import SMPLModel, subset_skin_tables
from ..models.humor import HumorConfig, humor_to
from ..modules.networks import MLP_MODES
from ..ops.lbs import VJP_MODES
from ..priors.gmm import GMMPrior
from .model import NemoAssets, NemoConfig


def build_assets(bundle, smpl: SMPLModel, cfg: NemoConfig,
                 gmm: Optional[GMMPrior] = None,
                 vposer: Optional[Dict[str, torch.Tensor]] = None,
                 device=None, v2v_vjp: str = "fused",
                 motion_mlp: str = "plain", humor=None,
                 humor_cfg: Optional[HumorConfig] = None) -> NemoAssets:
    """Collate the 2D supervision (reference collate_gt_2d :2908-2961) and
    move everything to ``device`` once. ``bundle`` is a MultiViewBundle of
    either package (both are numpy). With cfg.vp_v2v_n_verts > 0 the v2v
    prior's vertex subset and its tables are built here; v2v_vjp picks the
    full-mesh prior's gradient mode (ops.lbs.skin_v2v_l1), motion_mlp the
    MotionNet's MLP ("plain" matmuls or "fused" through K6, the counterpart
    of the JAX package's NEMO_TPU_NET_FUSED=1; model version 0 has no
    MotionNet and ignores it). humor: the HuMoR parameter tree of the
    weight_humor_loss term, with humor_cfg (default HumorConfig())."""
    if v2v_vjp not in VJP_MODES:
        raise ValueError(f"v2v_vjp {v2v_vjp!r}: expected one of {VJP_MODES}")
    if motion_mlp not in MLP_MODES:
        raise ValueError(f"motion_mlp {motion_mlp!r}: expected one of "
                         f"{MLP_MODES}")
    device = torch.device(device) if device is not None else smpl.device
    thr = cfg.label_intersection_threshold
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    smpl = smpl.to(device)
    subset = {}
    if cfg.vp_v2v_n_verts:
        subset = dict(zip(("v2v_vidx", "v2v_posedirs_t", "v2v_lbs_weights_t"),
                          subset_skin_tables(smpl, cfg.vp_v2v_n_verts)))
    if humor is not None and humor_cfg is None:
        humor_cfg = HumorConfig()
    spin = getattr(bundle, "spin_theta", None)
    return NemoAssets(
        smpl=smpl,
        gmm=None if gmm is None else gmm.to(device),
        vposer=(None if vposer is None
                else {k: v.to(device) for k, v in vposer.items()}),
        points2d_gt=t(bundle.label(cfg.label_type, thr)),
        bbox_diag=t(bundle.bbox_diag(cfg.label_type, thr)),
        hmr_theta=t(bundle.hmr_theta),
        hmr_mask=t(bundle.hmr_mask),
        img_d0=bundle.img_d0,
        img_d1=bundle.img_d1,
        spin_theta=None if spin is None else t(spin),
        v2v_vjp=v2v_vjp,
        motion_mlp=motion_mlp,
        humor=None if humor is None else humor_to(humor, device),
        humor_cfg=humor_cfg,
        **subset,
    )
