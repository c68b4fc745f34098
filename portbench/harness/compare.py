"""The comparisons that decide ``correct``, shared by the drivers.

A driver keeps what its program did in the steps the reference follows:
``init`` (the starting tensors by name), ``losses`` (each step's),
``grad1`` (the first gradient as the optimizer took it, by name), ``after``
(the tensors after the last of those steps) and ``nonfinite`` (the
window's non-finite losses). A reference run gives ``losses``, ``grad1``
and ``params`` by the same names."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Tuple

import torch


def loss_gap(prog: Iterable[float], ref: Iterable[float]) -> float:
    """The widest relative gap between the two sides' step losses; inf
    where the program's is not finite."""
    out = 0.0
    for a, b in zip(prog, ref, strict=True):
        a, b = float(a), float(b)
        if not math.isfinite(a):
            return math.inf
        out = max(out, abs(a - b) / max(abs(b), 1e-30))
    return out


def worst_leaf_gap(prog: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor],
                   skip: Iterable[str] = ()) -> Tuple[float, str]:
    """(gap, leaf): the widest gap between the norm of a leaf on the two
    sides, over the larger of the reference's norm of that leaf and of the
    median leaf. Leaves in ``skip`` are left out; a leaf the program lacks
    or holds non-finite counts as inf."""
    keys = [k for k in ref if k not in set(skip)]
    norms = {k: float(ref[k].double().norm()) for k in keys}
    med = statistics.median(norms.values())
    worst: List = [0.0, ""]
    for k in keys:
        if k not in prog:
            return math.inf, k
        p = float(prog[k].double().norm())
        if not math.isfinite(p):
            return math.inf, k
        gap = abs(p - norms[k]) / max(norms[k], med, 1e-30)
        if gap > worst[0]:
            worst = [gap, k]
    return worst[0], worst[1]


class AsProgram:
    """A reference run standing in the program's place (the control, a
    planted fault), with the fields the drivers' compare() reads."""

    def __init__(self, init, run):
        self.init, self.losses = init, run["losses"]
        self.grad1, self.after = run["grad1"], run["params"]
        self.nonfinite = 0


def compare(drv, ref: dict, limits: dict, info: dict = None):
    """[(name, value, limit)] of a program's steps against a reference
    run. Leaves whose reference gradient is under 1e-3 of the median
    leaf's move under Adam by round-off alone and are left out of the
    change. info, where given, gets the leaf that set each worst-leaf
    gap."""
    grad_ref = ref["grad1"]
    med = statistics.median(float(v.norm()) for v in grad_ref.values())
    skip = {k for k, v in grad_ref.items() if float(v.norm()) < 1e-3 * med}
    change_ref = {k: ref["params"][k] - drv.init[k] for k in drv.init}
    change_prog = {k: drv.after[k] - drv.init[k] for k in drv.init}
    grad = worst_leaf_gap(drv.grad1, grad_ref)
    change = worst_leaf_gap(change_prog, change_ref, skip)
    if info is not None:
        info.update(grad_leaf=grad[1], change_leaf=change[1],
                    skipped=sorted(skip))
    return [("loss_gap", loss_gap(drv.losses, ref["losses"]),
             limits["loss_gap"]),
            ("grad_gap", grad[0], limits["grad_gap"]),
            ("change_gap", change[0], limits["change_gap"]),
            ("nonfinite_window_losses", float(drv.nonfinite), 0.0)]


def readings(drv) -> dict:
    """The compared numbers of the program, of the control (the reference
    in TF32 in the program's place) and of the half-batch fault planted
    in the reference put in the program's place, each against the float32
    reference; and the leaves that set the program's worst-leaf gaps. The
    program's state is freed first."""
    drv.release()
    ref = drv.reference()
    info = {}
    out = {"program": compare(drv, ref, drv.limits, info)}
    for kind, kw in (("control_tf32", {"tf32": True}),
                     ("fault_half_batch", {"half": True})):
        out[kind] = compare(AsProgram(drv.init, drv.reference(**kw)), ref,
                            drv.limits)
    out["leaves"] = [(k, v, None) for k, v in info.items()]
    return out
