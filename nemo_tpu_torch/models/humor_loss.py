"""The full HuMoR training loss and trainer step, in PyTorch.

Port of nemo_tpu/models/humor_loss.py (behavioral reference:
humor/humor/losses/humor_loss.py:19-391, HumorLoss: per-field weighted
regression, KL with annealing/cycling, contact BCE and contact-velocity
terms, the SMPL-reconstruction terms; humor/humor/models/humor_model.py
step :32-99 and scheduled_sampling :500-690; the trainer mechanics of
humor/humor/train/train_humor.py:113-215: MultiStepLR, the NaN-loss /
NaN-gradient skip, the scheduled-sampling schedule :167-174).

Scheduled sampling is a Python loop over the T transitions, the
reference's own form of the JAX package's ``lax.scan``; each step's choice
between the GT past and the carried prediction is a ``torch.where`` on a
device tensor of coins, so a step never waits for the device. The
random draws (the T coins and each step's posterior draw) are arguments;
``make_humor_full_train_step`` draws them from a ``torch.Generator`` on the
parameters' device unless the caller gives them. The SMPL terms take an
``smpl_fn``; ``smpl_terms_fn`` builds one on the port's ``smpl_forward``,
whose FK runs K1f (and K1b under the gradient) on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..geometry.rotations import batch_rodrigues
from .humor import (HumorConfig, Params, apply_world2local_state,
                    bce_with_logits, compute_world2aligned_mat, humor_adam,
                    humor_single_step, split_state)

# amass_utils.py:22-23 CONTACT_ORDERING -> SMPL joint ids (hips, l/r leg,
# l/r foot, l/r toe, l/r hand)
CONTACT_INDS = (0, 4, 5, 7, 8, 10, 11, 20, 21)
CONTACT_THRESH = 0.5  # humor_loss.py:14

Stats = Dict[str, object]   # device tensors, and host floats


@dataclasses.dataclass(frozen=True)
class HumorLossConfig:
    """Weights mirror HumorLoss.__init__ (humor_loss.py:19-41); a weight of
    0 removes the term. Anneal/cycle semantics: humor_loss.py:122-147."""
    kl_loss: float = 1.0
    kl_loss_anneal_start: int = 0
    kl_loss_anneal_end: int = 0
    kl_loss_cycle_len: int = -1
    regr_trans_loss: float = 1.0
    regr_trans_vel_loss: float = 1.0
    regr_root_orient_loss: float = 1.0
    regr_root_orient_vel_loss: float = 1.0
    regr_pose_loss: float = 1.0
    regr_pose_vel_loss: float = 1.0
    regr_joint_loss: float = 1.0
    regr_joint_vel_loss: float = 1.0
    contacts_loss: float = 0.0
    contacts_vel_loss: float = 0.0
    smpl_joint_loss: float = 0.0
    smpl_mesh_loss: float = 0.0
    smpl_joint_consistency_loss: float = 0.0
    smpl_vert_consistency_loss: float = 0.0

    @property
    def use_kl_cycle(self) -> bool:
        return self.kl_loss_cycle_len > 0

    @property
    def use_kl_anneal(self) -> bool:
        # cycle overrides anneal (humor_loss.py:63-66)
        return (not self.use_kl_cycle
                and self.kl_loss_anneal_end > self.kl_loss_anneal_start)

    @property
    def field_weights(self) -> Dict[str, float]:
        """regr_loss_weight_dict (humor_loss.py:74-86), keyed by the packed
        state's field names. pose_body_vel / verts(+vel) /
        joints_orient_vel do not exist in the 'smpl+joints' state config."""
        return {
            "trans": self.regr_trans_loss,
            "trans_vel": self.regr_trans_vel_loss,
            "root_orient": self.regr_root_orient_loss,
            "root_orient_vel": self.regr_root_orient_vel_loss,
            "pose_body": self.regr_pose_loss,
            "joints": self.regr_joint_loss,
            "joints_vel": self.regr_joint_vel_loss,
        }


def _f32(x) -> float:
    """x rounded to float32, as a host float."""
    return float(np.float32(x))


def kl_normal(qm, qv, pm, pv) -> torch.Tensor:
    """Elementwise KL(q || p) between diagonal Gaussians, summed over the
    last dim (humor_loss.py:359-375). Returns (batch,)."""
    el = 0.5 * (torch.log(pv) - torch.log(qv) + qv / pv
                + (qm - pm) ** 2 / pv - 1.0)
    return el.sum(-1)


def kl_anneal_weight(lcfg: HumorLossConfig, cur_epoch: int) -> float:
    """KL anneal multiplier (humor_loss.py:129-147): linear ramp in
    [anneal_start, anneal_end], or within the first half of each cycle.
    A host float, in float32 as the JAX package computes it."""
    if lcfg.use_kl_cycle:
        e = int(cur_epoch) % lcfg.kl_loss_cycle_len
        start, end = 0, lcfg.kl_loss_cycle_len // 2
    elif lcfg.use_kl_anneal:
        e = int(cur_epoch)
        start, end = lcfg.kl_loss_anneal_start, lcfg.kl_loss_anneal_end
    else:
        return 1.0
    w = np.float32(e - start) / np.float32(max(end - start, 1))
    w = w if e >= start else np.float32(0.0)
    return float(min(w, np.float32(1.0)))


def humor_loss_terms(
    lcfg: HumorLossConfig,
    pred_state: torch.Tensor,
    gt_state: torch.Tensor,
    posterior: Tuple[torch.Tensor, torch.Tensor],
    prior: Tuple[torch.Tensor, torch.Tensor],
    cur_epoch: int,
    contact_logits: Optional[torch.Tensor] = None,
    contacts_gt: Optional[torch.Tensor] = None,
    smpl_fn: Optional[Callable] = None,
    betas: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Stats]:
    """HumorLoss.forward (humor_loss.py:106-348) on packed (B, D) states.

    smpl_fn(trans (B, 3), root_orient_aa (B, 3), pose_body_aa (B, 63),
    betas) -> (joints (B, >= 22, 3), verts (B, V, 3)) enables the SMPL
    terms. Returns (loss, stats) with the reference's stat names; stats are
    device tensors but kl_anneal_weight, a host float.
    """
    loss = pred_state.new_zeros(())
    stats: Stats = {}

    if lcfg.kl_loss > 0.0:
        kl = kl_normal(*posterior, *prior).mean()
        stats["kl_loss"] = kl
        aw = kl_anneal_weight(lcfg, cur_epoch)
        loss = loss + _f32(aw * np.float32(lcfg.kl_loss)) * kl
        stats["kl_anneal_weight"] = aw
        stats["kl_weighted_loss"] = loss

    pred_d, gt_d = split_state(pred_state), split_state(gt_state)
    for name, w in lcfg.field_weights.items():
        if w > 0.0:
            term = ((pred_d[name] - gt_d[name]) ** 2).mean()
            stats[name + "_loss"] = term
            loss = loss + w * term

    if lcfg.contacts_loss > 0.0 and contact_logits is not None \
            and contacts_gt is not None:
        # BCEWithLogits, stable form (:176-184)
        x = contact_logits
        bce = bce_with_logits(x, contacts_gt)
        stats["contacts_loss"] = bce
        loss = loss + lcfg.contacts_loss * bce
        # confusion-matrix stats (:186-208)
        pred_c = torch.sigmoid(x) > CONTACT_THRESH
        gt_c = contacts_gt > 0.5
        tp = (pred_c & gt_c).sum().float()
        fp = (pred_c & ~gt_c).sum().float()
        fn = (~pred_c & gt_c).sum().float()
        tn = (~pred_c & ~gt_c).sum().float()
        stats["contacts_acc"] = (tp + tn) / (tp + fp + fn + tn)
        stats["contacts_pos_acc"] = tp / (tp + fn)
        stats["contacts_neg_acc"] = tn / (tn + fp)

    if lcfg.contacts_vel_loss > 0.0 and contact_logits is not None:
        # predicted contact probability gates squared joint-velocity
        # magnitude at the contact joints (:212-225)
        J = pred_d["joints_vel"].shape[-1] // 3
        vel = pred_d["joints_vel"].reshape(-1, J, 3)
        mag2 = (vel[:, list(CONTACT_INDS)] ** 2).sum(-1)
        term = (torch.sigmoid(contact_logits) * mag2).mean()
        stats["contacts_vel_loss"] = term
        loss = loss + lcfg.contacts_vel_loss * term

    use_smpl = (lcfg.smpl_joint_loss + lcfg.smpl_mesh_loss
                + lcfg.smpl_joint_consistency_loss) > 0.0
    if lcfg.smpl_vert_consistency_loss > 0.0:
        raise ValueError(
            "smpl_vert_consistency_loss needs a 'verts' state field, which "
            "the 'smpl+joints' state config does not carry "
            "(humor_loss.py:330-346)")
    if use_smpl:
        if smpl_fn is None or betas is None:
            raise ValueError("SMPL loss terms need smpl_fn and betas "
                             "(humor_loss.py:229-232)")
        pj, pm_ = smpl_fn(pred_d["trans"], pred_d["root_orient"],
                          pred_d["pose_body"], betas)
        gj, gm = smpl_fn(gt_d["trans"], gt_d["root_orient"],
                         gt_d["pose_body"], betas)
        if lcfg.smpl_joint_loss > 0.0:
            term = ((pj - gj) ** 2).mean()
            stats["smpl_joint_loss"] = term
            loss = loss + lcfg.smpl_joint_loss * term
        if lcfg.smpl_mesh_loss > 0.0:
            term = ((pm_ - gm) ** 2).mean()
            stats["smpl_mesh_loss"] = term
            loss = loss + lcfg.smpl_mesh_loss * term
        if lcfg.smpl_joint_consistency_loss > 0.0:
            J = pred_d["joints"].shape[-1] // 3
            regressed = pred_d["joints"].reshape(-1, J, 3)
            term = ((pj[:, :J] - regressed) ** 2).mean()
            stats["smpl_joint_consistency_loss"] = term
            loss = loss + lcfg.smpl_joint_consistency_loss * term

    if lcfg.kl_loss > 0.0:
        stats["reconstr_weighted_loss"] = loss - stats["kl_weighted_loss"]
    stats["loss"] = loss
    return loss, stats


def smpl_terms_fn(model) -> Callable:
    """smpl_fn for the SMPL terms on the port's smpl_forward: (trans,
    root_orient, pose_body (B, 63), betas (B, 10)) -> (the 24 FK joints,
    the vertices), the body's hand joints at zero. Its FK is K1f, and K1b
    under the gradient, on the card."""
    from ..body.smpl import smpl_forward

    def smpl_fn(trans, root_orient, pose_body, betas):
        body = torch.cat([pose_body, pose_body.new_zeros(
            (pose_body.shape[0], 6))], dim=1)
        verts, _, fk = smpl_forward(model, betas, body, root_orient,
                                    pose2rot=True, transl=trans,
                                    want_fk_joints=True)
        return fk, verts
    return smpl_fn


def humor_full_loss(p: Params, cfg: HumorConfig, lcfg: HumorLossConfig,
                    past: torch.Tensor, target: torch.Tensor,
                    eps: torch.Tensor, cur_epoch: int,
                    contacts_gt: Optional[torch.Tensor] = None,
                    smpl_fn: Optional[Callable] = None,
                    betas: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Stats]:
    """Supervised training step loss: single_step forward + HumorLoss
    (humor_model.py step :54-60 fully-supervised branch + :96-99); eps is
    the (B, L) posterior draw."""
    out = humor_single_step(p, cfg, past, target, eps)
    return humor_loss_terms(lcfg, out["pred"], target, out["posterior"],
                            out["prior"], cur_epoch,
                            contact_logits=out["contacts"],
                            contacts_gt=contacts_gt, smpl_fn=smpl_fn,
                            betas=betas)


def sched_samp_gt_p(epoch: int, start: int, end: int) -> float:
    """Probability of feeding GT (vs own prediction) at the given epoch
    (train_humor.py:167-174): 1 before start, linear decay to 0 at end.
    A host float, in float32."""
    frac = (np.float32(epoch) - np.float32(start)) / np.float32(
        max(end - start, 1))
    return float(np.clip(np.float32(1.0) - frac, np.float32(0.0),
                         np.float32(1.0)))


def scheduled_draws(generator: torch.Generator, use_gt_p: float, T: int,
                    B: int, latent: int, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A scheduled-sampling step's draws from ``generator``: (coins (T,)
    bool, True with probability use_gt_p, as jax.random.bernoulli's
    uniform < p; eps (T, B, latent) standard normal)."""
    coins = torch.rand((T,), generator=generator, device=device) < use_gt_p
    eps = torch.randn((T, B, latent), generator=generator, device=device)
    return coins, eps


def humor_step_scheduled(p: Params, cfg: HumorConfig, lcfg: HumorLossConfig,
                         x_past: torch.Tensor, x_t: torch.Tensor,
                         coins: torch.Tensor, eps: torch.Tensor,
                         cur_epoch: int,
                         contacts_gt: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Stats]:
    """Scheduled-sampling training step over (B, T, D) transition windows
    (humor_model.py step :61-77 + scheduled_sampling :500-690).

    Each of the T transitions takes the GT past where its coin (a (T,)
    bool device tensor) is true and, where it is false, the model's own
    previous prediction re-expressed in its aligned local frame
    (world2aligned rot/trans + the first input's constant trans2joint,
    :605-625), detached (detach_sched_samp); step 0 always takes the GT
    past. eps (T, B, L) holds each step's posterior draw. Supervision stays
    in each step's local frame. Loss = HumorLoss over all B*T steps, the
    per-step outputs stacked (T, B, .) and flattened batch-major.
    """
    B, T, D = x_past.shape
    # constant trans2joint from the first input (scheduled_sampling :523-525)
    j0 = split_state(x_past[:, 0])["joints"]
    t2j = torch.cat([-j0[:, :2], torch.zeros_like(j0[:, :1])], dim=1)
    outs = []
    prev = None
    for i in range(T):
        past_in = x_past[:, i] if i == 0 else torch.where(
            coins[i], x_past[:, i], prev)
        out = humor_single_step(p, cfg, past_in, x_t[:, i], eps[i])
        pred = out["pred"]
        # canonicalize own prediction for the next step (:605-625)
        dp = split_state(pred.detach())
        w2a_rot = compute_world2aligned_mat(batch_rodrigues(
            dp["root_orient"]))
        w2a_trans = torch.cat([-dp["trans"][:, :2],
                               torch.zeros_like(dp["trans"][:, :1])], dim=1)
        prev = apply_world2local_state(pred.detach(), w2a_rot, w2a_trans,
                                       t2j)
        contacts = (out["contacts"] if out["contacts"] is not None
                    else pred.new_zeros((B, 0)))
        outs.append((pred, contacts, *out["posterior"], *out["prior"]))

    def flat(k):
        return torch.stack([o[k] for o in outs]).transpose(0, 1).reshape(
            B * T, -1)

    cg = contacts_gt.reshape(B * T, -1) if contacts_gt is not None else None
    return humor_loss_terms(
        lcfg, flat(0), x_t.reshape(B * T, D), (flat(2), flat(3)),
        (flat(4), flat(5)), cur_epoch,
        contact_logits=flat(1) if cfg.pred_contacts else None,
        contacts_gt=cg)


def multistep_lr(lr: float, milestones=(), gamma: float = 1.0
                 ) -> Callable[[int], float]:
    """MultiStepLR(optimizer, milestones, gamma) as an epoch -> lr callable
    (train_humor.py:114): lr * gamma ** (milestones passed), a host float
    in float32 as the JAX package computes it."""
    ms = sorted(int(m) for m in milestones)

    def lr_at(epoch: int) -> float:
        n = sum(1 for m in ms if epoch >= m)
        if not ms:
            return _f32(lr)
        decay = torch.tensor(gamma, dtype=torch.float32) ** torch.tensor(
            float(n), dtype=torch.float32)
        return float(torch.tensor(lr, dtype=torch.float32) * decay)

    return lr_at


def make_humor_full_train_step(cfg: HumorConfig, lcfg: HumorLossConfig,
                               lr: float = 1e-4, weight_decay: float = 0.0,
                               sched_milestones=(),
                               sched_decay: float = 1.0,
                               sched_samp_start: Optional[int] = None,
                               sched_samp_end: Optional[int] = None,
                               generator: Optional[torch.Generator] = None):
    """The HuMoR trainer step with the reference trainer's mechanics
    (train_humor.py:84-215): Adam (optax's scale_by_adam, then p - lr(epoch)
    u) with L2 weight decay added to the gradient, MultiStepLR by epoch,
    scheduled sampling past sched_samp_start, and the NaN-loss /
    NaN-gradient skip, decided on the device: the gradients count as zeros
    (Adam's count still rises and its moments decay) and the parameters
    keep their values (``GroupAdam.step(gate=...)``).

    Returns (init, step): init(params) -> opt (a GroupAdam; it marks the
    parameters as requiring gradients); step(params, opt, x_past, x_t,
    epoch, draws=None, contacts_gt=None) -> (params, opt, stats), updating
    params and opt in place, with nothing in it that waits for the device.
    Supervised mode feeds (B, D) past / target and draws = eps (B, L);
    scheduled-sampling mode (sched_samp_* given) feeds (B, T, D) windows
    and draws = (coins (T,), eps (T, B, L)). Without draws the step draws
    them from ``generator`` (a torch.Generator on the parameters' device).
    grad_norm is the global norm after the decay; stats are device tensors
    but lr and kl_anneal_weight, host floats.
    """
    lr_at = multistep_lr(lr, sched_milestones, sched_decay)
    use_ss = (sched_samp_start is not None and sched_samp_end is not None
              and sched_samp_start >= 0
              and sched_samp_end >= sched_samp_start)

    def init(params: Params):
        return humor_adam(params, lr)

    def step(params: Params, opt, x_past: torch.Tensor, x_t: torch.Tensor,
             epoch: int, draws=None, contacts_gt=None):
        leaves = opt.params
        with torch.enable_grad():
            if use_ss:
                if draws is None:
                    draws = scheduled_draws(
                        generator, sched_samp_gt_p(epoch, sched_samp_start,
                                                   sched_samp_end),
                        x_past.shape[1], x_past.shape[0], cfg.latent_size,
                        x_past.device)
                loss, stats = humor_step_scheduled(
                    params, cfg, lcfg, x_past, x_t, draws[0], draws[1],
                    epoch, contacts_gt)
            else:
                if draws is None:
                    draws = torch.randn((x_past.shape[0], cfg.latent_size),
                                        generator=generator,
                                        device=x_past.device)
                loss, stats = humor_full_loss(params, cfg, lcfg, x_past, x_t,
                                              draws, epoch, contacts_gt)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        if weight_decay > 0.0:  # torch Adam weight_decay = L2 on the grad
            grads = torch._foreach_add(grads, leaves, alpha=weight_decay)
        # optax.global_norm: the per-tensor sums of squares, summed (torch's
        # vector_norm on the CPU is some 5e-5 off it on a 1024 x 1024 tensor)
        gnorm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        for t, g in zip(leaves, grads):
            t.grad = g
        cur_lr = lr_at(epoch)
        opt.step(lr=cur_lr, gate=finite)
        for t in leaves:
            t.grad = None
        stats = {k: v.detach() if torch.is_tensor(v) else v
                 for k, v in stats.items()}
        stats.update(grad_norm=gnorm, lr=cur_lr,
                     update_skipped=(~finite).float())
        return params, opt, stats

    return init, step


def stats_to_host(stats: Stats) -> Dict[str, float]:
    """A step's stats as host floats, the device ones in one copy."""
    dev = [k for k, v in stats.items() if torch.is_tensor(v)]
    vals = (torch.stack([stats[k].float().reshape(()) for k in dev]).cpu()
            .tolist() if dev else [])
    out = {k: float(v) for k, v in stats.items() if not torch.is_tensor(v)}
    out.update(zip(dev, vals))
    return {k: out[k] for k in stats}


__all__ = ["CONTACT_INDS", "CONTACT_THRESH", "HumorLossConfig",
           "humor_full_loss", "humor_loss_terms",
           "humor_step_scheduled", "kl_anneal_weight", "kl_normal",
           "make_humor_full_train_step", "multistep_lr", "sched_samp_gt_p",
           "scheduled_draws", "smpl_terms_fn", "stats_to_host"]
