"""Per-parameter-group Adam and on-device plateau LR scheduling.

Port of nemo_tpu/fit/optimizer.py. The reference builds one torch Adam per
group (cameras, motion+rbf, phase, instance) with a ReduceLROnPlateau each,
stepped every main-stage step with the current loss. Here each group has its
own Adam state, and each plateau scheduler is a small state machine of device
tensors (best, bad-step count, scale) whose scale multiplies the group's
update, so stepping it never waits for the device. torch semantics: mode
'min', relative threshold 1e-4, patience 10, cooldown 0, min_lr 1e-6.

The Adam arithmetic follows optax's chain(add_decayed_weights, scale_by_adam,
scale(-lr)) term for term, the JAX package's form of torch Adam with
L2-in-gradient weight decay.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional

import torch

from .model import NemoConfig, NemoParams

PLATEAU_PATIENCE = 10
PLATEAU_THRESHOLD = 1e-4
PLATEAU_MIN_LR = 1e-6

GROUPS = ("cameras", "motion", "rbf", "phase", "instance", "betas")


class PlateauState(NamedTuple):
    best: torch.Tensor      # 0-d float
    num_bad: torch.Tensor   # 0-d int
    scale: torch.Tensor     # 0-d lr multiplier


def plateau_init(device=None) -> PlateauState:
    return PlateauState(best=torch.tensor(float("inf"), device=device),
                        num_bad=torch.tensor(0, dtype=torch.int32,
                                             device=device),
                        scale=torch.tensor(1.0, device=device))


def plateau_update(state: PlateauState, loss: torch.Tensor, factor: float,
                   base_lr: float) -> PlateauState:
    """One ReduceLROnPlateau step, torch-exact, on device tensors."""
    improved = loss < state.best * (1.0 - PLATEAU_THRESHOLD)
    best = torch.where(improved, loss, state.best)
    num_bad = torch.where(improved, torch.zeros_like(state.num_bad),
                          state.num_bad + 1)
    trip = num_bad > PLATEAU_PATIENCE
    min_scale = PLATEAU_MIN_LR / max(base_lr, PLATEAU_MIN_LR)
    scale = torch.where(trip, torch.clamp(state.scale * factor, min=min_scale),
                        state.scale)
    num_bad = torch.where(trip, torch.zeros_like(num_bad), num_bad)
    return PlateauState(best=best, num_bad=num_bad, scale=scale)


def group_lrs(cfg: NemoConfig) -> Dict[str, float]:
    return {
        "cameras": cfg.lr_camera,
        "motion": cfg.lr_human,
        "rbf": cfg.lr_human,     # rbf lives in the reference's motion Adam
        "phase": cfg.lr_phase,
        "instance": cfg.lr_instance,
        "betas": 0.0,            # the reference never optimizes its betas
    }


class GroupAdam:
    """Adam over one group's tensors. weight_decay is added to the gradient
    before the moments (torch Adam), or to the update after them
    (``decoupled``, torch AdamW)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 weight_decay: float = 0.0, decoupled: bool = False,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.wd, self.decoupled = lr, weight_decay, decoupled
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, scale: Optional[torch.Tensor] = None) -> None:
        """Apply one update from the parameters' ``.grad`` (None = 0)."""
        ps = self.params
        g = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in ps]
        if self.wd and not self.decoupled:
            g = torch._foreach_add(g, ps, alpha=self.wd)
        self.count += 1
        torch._foreach_mul_(self.m, self.b1)
        torch._foreach_add_(self.m, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.v, self.b2)
        torch._foreach_addcmul_(self.v, g, g, value=1.0 - self.b2)
        mhat = torch._foreach_div(self.m, 1.0 - self.b1 ** self.count)
        vhat = torch._foreach_div(self.v, 1.0 - self.b2 ** self.count)
        denom = torch._foreach_sqrt(vhat)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mhat, denom)
        if self.wd and self.decoupled:
            torch._foreach_add_(u, ps, alpha=self.wd)
        torch._foreach_mul_(u, -self.lr)
        if scale is not None:
            torch._foreach_mul_(u, scale)
        torch._foreach_add_(ps, u)


def _group_tensors(params: NemoParams, group: str) -> List[torch.Tensor]:
    mod = getattr(params, group)
    return [mod] if isinstance(mod, torch.nn.Parameter) \
        else list(mod.parameters())


class GroupOptimizer:
    """One GroupAdam per parameter group present in ``params``; groups at
    lr 0 (betas) get no optimizer and never move."""

    def __init__(self, params: NemoParams, cfg: NemoConfig):
        lrs = group_lrs(cfg)
        self.groups: Dict[str, GroupAdam] = {}
        for g in GROUPS:
            if not hasattr(params, g) or lrs[g] == 0.0:
                continue
            wd = cfg.wd_human if g in ("motion", "rbf") else 0.0
            self.groups[g] = GroupAdam(_group_tensors(params, g), lrs[g],
                                       weight_decay=wd,
                                       decoupled=cfg.opt_human == "adamw")

    def step(self, active: Optional[Iterable[str]] = None,
             plateau: Optional[Dict[str, PlateauState]] = None) -> None:
        """Step the active groups (all by default); inactive groups keep
        their parameters and state. A plateau state's scale multiplies its
        group's update."""
        active = set(self.groups) if active is None else set(active)
        for g, opt in self.groups.items():
            if g in active:
                opt.step(plateau[g].scale if plateau and g in plateau
                         else None)


def make_camera_stage_optimizer(params: NemoParams,
                                cfg: NemoConfig) -> GroupAdam:
    """The V0-V3 camera stage's fresh Adam over the cameras (no decay)."""
    return GroupAdam([params.cameras], cfg.lr_camera)


def plateau_init_all(cfg: NemoConfig, device=None) -> Dict[str, PlateauState]:
    return {g: plateau_init(device) for g, lr in group_lrs(cfg).items()
            if lr > 0}


def plateau_update_all(states: Dict[str, PlateauState], loss: torch.Tensor,
                       cfg: NemoConfig) -> Dict[str, PlateauState]:
    if cfg.lr_factor >= 1:
        return states
    lrs = group_lrs(cfg)
    return {g: plateau_update(s, loss, cfg.lr_factor, lrs[g])
            for g, s in states.items()}
