"""The NeMo main stage with HuMoR's dynamics prior, in plain float32
PyTorch: the reference that the cell of the custom entry's
``--weight_humor_loss`` term is held to.

A step is reference/nemo_fit.py's NemoV3 step (imported, its SMPL passes
in blocks of 2048 rows) plus ``weight_humor_loss`` times the dynamics
term: each row (view v, frame f) of the batch takes the window of frames
(f' - 1, f', f' + 1), f' = f clamped to [1, F - 2], through the same phase
warp, RBF embedding and MotionNet (its translation less the one at phase
0), and SMPL's kinematic chain for the joints; the window gives two HuMoR
states (reference/humor.py window_states) and one transition, whose KL
under the frozen posterior encoder and conditional prior
(reference/humor.py transition_kl) is averaged over the rows. HuMoR's
weights are constants: no gradient reaches them, and nothing steps them.

It imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import humor, nemo_fit
from .body import rot6d_to_rotmat


def humor_term(P: Dict[str, torch.Tensor], problem: dict, body,
               humor_params, cfg: dict, hcfg: dict,
               half: bool = False) -> torch.Tensor:
    """The mean transition KL over the batch's rows (every row, or with
    half every other frame of each view, as nemo_fit.loss_and_grad's
    half-batch fault takes them)."""
    labels = problem["labels"]
    V, Fr = labels.shape[:2]
    dev = labels.device
    frames = torch.arange(0, Fr, 2 if half else 1, device=dev)
    vi = torch.arange(V, device=dev).repeat_interleave(frames.shape[0])
    fc = frames.repeat(V).clamp(1, Fr - 2)
    _, trans0 = nemo_fit._motion(P, nemo_fit._embed(
        P, torch.zeros((1, 1), device=dev),
        torch.zeros_like(P["instance"][:1])))
    trans, rot, joints = [], [], []
    for f in (fc - 1, fc, fc + 1):
        phase = (f.float() / (Fr - 1))[:, None]
        warped = nemo_fit._warp(P["phase.shifts"][vi], P["phase.scales"][vi],
                                phase)
        rot6d, t = nemo_fit._motion(P, nemo_fit._embed(P, warped,
                                                       P["instance"][vi]))
        t = t - trans0
        r = rot6d_to_rotmat(rot6d.reshape(-1, 24, 6))
        j = humor.fk_joints(body, P["betas"], r)[:, :humor.STATE_JOINTS]
        trans.append(t)
        rot.append(r)
        joints.append(j + t[:, None])
    states = humor.window_states(trans, rot, joints, cfg["humor_fps"])
    return humor.transition_kl(humor_params, hcfg, states[:, 0],
                               states[:, 1]).mean()


def run_steps(init: Dict[str, torch.Tensor], problem: dict, body, priors,
              humor_params, cfg: dict, hcfg: dict, steps: int,
              tf32: bool = False, half: bool = False) -> dict:
    """nemo_fit.run_steps with the dynamics term: ``steps`` main-stage
    steps from ``init``, each step's total loss, the first step's gradients
    as Adam takes them and the parameters after the last step. tf32: the
    control, every float32 product of the reference in TF32; half: the
    half-batch fault."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        P = {k: v.detach().clone().float() for k, v in init.items()}
        settings = nemo_fit.group_settings(cfg)
        opts = []
        for g, (lr, wd) in settings.items():
            leaves: List[torch.Tensor] = [P[k].requires_grad_() for k in P
                                          if nemo_fit.group_of(k) == g]
            opts.append(torch.optim.Adam(leaves, lr=lr, weight_decay=wd,
                                         foreach=False))
        w = cfg["weight_humor_loss"]
        losses, grad1 = [], {}
        for step in range(steps):
            for o in opts:
                o.zero_grad(set_to_none=True)
            total, _ = nemo_fit.loss_and_grad(P, problem, body, priors, cfg,
                                              half=half)
            hl = humor_term(P, problem, body, humor_params, cfg, hcfg, half)
            (w * hl).backward()
            losses.append(total + w * float(hl.detach()))
            if step == 0:
                for k, v in P.items():
                    g = nemo_fit.group_of(k)
                    if v.grad is not None and g in settings:
                        grad1[k] = (v.grad + settings[g][1]
                                    * v.detach()).clone()
            for o in opts:
                o.step()
        return {"losses": losses, "grad1": grad1,
                "params": {k: v.detach().clone() for k, v in P.items()}}
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
