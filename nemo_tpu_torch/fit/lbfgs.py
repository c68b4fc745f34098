"""L-BFGS with optax's zoom linesearch, in PyTorch.

The port's copy of ``optax.lbfgs()`` (optax 0.2.6) at its defaults, with
``optax.value_and_grad_from_state``, which the JAX package runs in its
TemporalSMPLify (``nemo_tpu/priors/temporal_smplify.py:_lbfgs_scan``):

* ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``: the memory
  of parameter and gradient differences, the two-loop recursion
  (Nocedal & Wright, Algorithm 7.4) over the ring buffer in optax's order,
  the identity scale <ds, dg> / <dg, dg> and, on the first step,
  min(1, 1 / |g|);
* ``scale(-1)``;
* ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')``: Algorithms 3.5 and 3.6 of Nocedal &
  Wright with the strong-Wolfe constants c1 = 1e-4, c2 = 0.9, Hager and
  Zhang's approximate decrease criterion (rtol 1e-6), doubling to find an
  interval, then cubic, quadratic or bisection steps with their safeguards
  (0.2 and 0.1 of the interval), the interval threshold 1e-5, and on
  failure the best step with sufficient decrease (or a zero step when
  the function is not finite);
* the value and gradient at the accepted step reused as the next step's.

Every scalar stays a float32 tensor on the parameters' device, computed in
optax's order, as optax computes them on the device: the linesearch
branches on loss values, and a different rounding can pick a different
step. The parameters are a dict of tensors, flattened in sorted key order
(a JAX dict pytree's order), which fixes the order of the sums across
leaves. The one host read a linesearch iteration is the loop's condition
(done or failed, and which phase comes next); ``stats`` counts them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4          # c1, sufficient decrease
CURV_RTOL = 0.9            # c2, small curvature
APPROX_DEC_RTOL = 1e-6     # Hager-Zhang switch
INTERVAL_THRESHOLD = 1e-5  # stepsize_precision
INCREASE_FACTOR = 2.0


def _vdot(x: Params, y: Params) -> torch.Tensor:
    """optax.tree.vdot: the leaves' dot products summed in key order."""
    out = None
    for k in sorted(x):
        v = torch.dot(x[k].reshape(-1), y[k].reshape(-1))
        out = v if out is None else out + v
    return out


def _sqnorm(x: Params) -> torch.Tensor:
    out = None
    for k in sorted(x):
        v = torch.sum(x[k] * x[k])
        out = v if out is None else out + v
    return out


def _add_scale(x: Params, s: torch.Tensor, y: Params) -> Params:
    """x + s * y, leaf by leaf."""
    return {k: x[k] + s * y[k] for k in x}


def _scale(s, x: Params) -> Params:
    return {k: s * x[k] for k in x}


def _where(c: torch.Tensor, a, b):
    if isinstance(a, dict):
        return {k: torch.where(c, a[k], b[k]) for k in a}
    return torch.where(c, a, b)


def value_and_grad(loss_fn: Callable[[Params], torch.Tensor], params: Params
                   ) -> Tuple[torch.Tensor, Params]:
    """(loss, gradient dict) at params; a leaf the loss does not read has
    a zero gradient, as in JAX."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    keys = sorted(leaves)
    with torch.enable_grad():
        value = loss_fn(leaves)
        grads = torch.autograd.grad(value, [leaves[k] for k in keys],
                                    allow_unused=True)
    return value.detach(), {
        k: (torch.zeros_like(leaves[k]) if g is None else g)
        for k, g in zip(keys, grads)}


# ---------------------------------------------------------------------------
# the zoom linesearch (optax/_src/linesearch.py zoom_linesearch)
# ---------------------------------------------------------------------------

def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    x0 = fb - fa - C * db
    x1 = fc - fa - C * dc
    A = (dc * dc * x0 + (-(db * db)) * x1) / denom
    B = (-(dc * (dc * dc)) * x0 + db * (db * db) * x1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (2.0 * B)


def _decrease_error(stepsize, value_step, slope_step, value_init,
                    slope_init):
    dec = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta = value_step - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
    approx = torch.maximum(approx, delta)
    dec = torch.clamp_min(torch.minimum(approx, dec), 0.0)
    return torch.where(torch.isnan(dec), torch.full_like(dec, torch.inf),
                       dec)


def _curvature_error(slope_step, slope_init):
    curv = torch.clamp_min(torch.abs(slope_step)
                           - CURV_RTOL * torch.abs(slope_init), 0.0)
    return torch.where(torch.isnan(curv), torch.full_like(curv, torch.inf),
                       curv)


def _on_line(value_and_grad_fn, params, stepsize, updates):
    step = _add_scale(params, stepsize, updates)
    value, grad = value_and_grad_fn(step)
    return value, grad, _vdot(grad, updates)


def _search_interval(s: dict, it: int, value_and_grad_fn) -> dict:
    """Algorithm 3.5: double the step until an interval holds a good one."""
    new_step = s["guess"] if it == 0 else INCREASE_FACTOR * s["stepsize"]
    value, grad, slope = _on_line(value_and_grad_fn, s["params"], new_step,
                                  s["updates"])
    dec = _decrease_error(new_step, value, slope, s["value_init"],
                          s["slope_init"])
    curv = _curvature_error(slope, s["slope_init"])
    err = torch.maximum(dec, curv)
    safe = dec <= 0.0
    set_high = dec > 0.0
    if it > 0:
        set_high = set_high | (value >= s["value"])
    set_low = (slope >= 0.0) & ~set_high
    # default: low <- previous, high <- new; swapped when set_low
    low = torch.where(set_low, new_step, s["stepsize"])
    value_low = torch.where(set_low, value, s["value"])
    slope_low = torch.where(set_low, slope, s["slope"])
    high = torch.where(set_low, s["stepsize"], new_step)
    value_high = torch.where(set_low, s["value"], value)
    slope_high = torch.where(set_low, s["slope"], slope)
    found = set_high | set_low | (err <= 0.0)
    done = err <= 0.0
    return dict(
        s, stepsize=new_step, value=value, grad=grad, slope=slope,
        decrease_error=dec, curvature_error=curv,
        interval_found=found, done=done,
        failed=(~done if it + 1 >= MAX_LINESEARCH_STEPS
                else torch.zeros_like(done)),
        low=low, value_low=value_low, slope_low=slope_low,
        high=high, value_high=value_high, slope_high=slope_high,
        cubic_ref=low, value_cubic_ref=value_low,
        safe_stepsize=torch.where(safe, new_step, s["safe_stepsize"]),
        safe_value=torch.where(safe, value, s["safe_value"]),
        safe_grad=_where(safe, grad, s["safe_grad"]))


def _zoom(s: dict, it: int, value_and_grad_fn) -> dict:
    """Algorithm 3.6: shrink the interval by interpolation."""
    low, high = s["low"], s["high"]
    value_low, slope_low = s["value_low"], s["slope_low"]
    value_high, slope_high = s["value_high"], s["slope_high"]
    delta = torch.abs(high - low)
    left = torch.minimum(high, low)
    right = torch.maximum(high, low)
    cubic_chk = 0.2 * delta
    quad_chk = 0.1 * delta
    too_small = delta <= INTERVAL_THRESHOLD
    mid_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                          s["cubic_ref"], s["value_cubic_ref"])
    use_cubic = (mid_cubic > left + cubic_chk) & (mid_cubic
                                                  < right - cubic_chk)
    mid_quad = _quadmin(low, value_low, slope_low, high, value_high)
    use_quad = ~use_cubic & (mid_quad > left + quad_chk) & (
        mid_quad < right - quad_chk)
    use_bisect = ~use_cubic & ~use_quad
    middle = torch.where(use_cubic, mid_cubic, s["cubic_ref"])
    middle = torch.where(use_quad, mid_quad, middle)
    middle = torch.where(use_bisect, (low + high) / 2.0, middle)

    value, grad, slope = _on_line(value_and_grad_fn, s["params"], middle,
                                  s["updates"])
    dec = _decrease_error(middle, value, slope, s["value_init"],
                          s["slope_init"])
    curv = _curvature_error(slope, s["slope_init"])
    err = torch.maximum(dec, curv)
    upd_safe = (dec <= 0.0) & (value < s["safe_value"])
    safe_stepsize = torch.where(upd_safe, middle, s["safe_stepsize"])
    done = err <= 0.0
    set_high_mid = (dec > 0.0) | (value >= value_low)
    set_high_low = (slope * (high - low) >= 0.0) & ~set_high_mid
    set_low_mid = ~set_high_mid
    nh = torch.where(set_high_mid, middle, high)
    nvh = torch.where(set_high_mid, value, value_high)
    nsh = torch.where(set_high_mid, slope, slope_high)
    new_high = torch.where(set_high_low, low, nh)
    new_value_high = torch.where(set_high_low, value_low, nvh)
    new_slope_high = torch.where(set_high_low, slope_low, nsh)
    new_low = torch.where(set_low_mid, middle, low)
    new_value_low = torch.where(set_low_mid, value, value_low)
    new_slope_low = torch.where(set_low_mid, slope, slope_low)
    ref_high = set_high_mid | set_high_low
    if it + 1 >= MAX_LINESEARCH_STEPS:
        failed = ~done
    else:
        failed = too_small & (safe_stepsize > 0.0) & ~done
    return dict(
        s, stepsize=middle, value=value, grad=grad, slope=slope,
        decrease_error=dec, curvature_error=curv, done=done, failed=failed,
        low=new_low, value_low=new_value_low, slope_low=new_slope_low,
        high=new_high, value_high=new_value_high, slope_high=new_slope_high,
        cubic_ref=torch.where(ref_high, high, low),
        value_cubic_ref=torch.where(ref_high, value_high, value_low),
        safe_stepsize=safe_stepsize,
        safe_value=torch.where(upd_safe, value, s["safe_value"]),
        safe_grad=_where(upd_safe, grad, s["safe_grad"]))


def _try_safe_step(s: dict) -> dict:
    """On failure: the best step with sufficient decrease, or the safe
    (zero) step when the function left its domain; else the last one.
    Applied with where on the failed flag, so no host read."""
    use_safe = s["failed"] & ((s["safe_stepsize"] > 0.0)
                              | torch.isinf(s["decrease_error"]))
    return dict(s, stepsize=torch.where(use_safe, s["safe_stepsize"],
                                        s["stepsize"]),
                value=torch.where(use_safe, s["safe_value"], s["value"]),
                grad=_where(use_safe, s["safe_grad"], s["grad"]))


def zoom_linesearch(value_and_grad_fn, params: Params, updates: Params,
                    value: torch.Tensor, grad: Params,
                    stats: Optional[dict] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, Params, bool]:
    """A stepsize along updates from params: (stepsize, value and grad at
    the step, whether that value is finite), optax's
    scale_by_zoom_linesearch with initial guess 1."""
    zero = torch.zeros((), dtype=value.dtype, device=value.device)
    slope = _vdot(updates, grad)
    false = torch.zeros((), dtype=torch.bool, device=value.device)
    s = dict(params=params, updates=updates, guess=zero + 1.0,
             stepsize=zero, value=value, grad=grad, slope=slope,
             value_init=value, slope_init=slope,
             decrease_error=zero + torch.inf,
             curvature_error=zero + torch.inf,
             interval_found=false, done=false, failed=false,
             low=zero, value_low=value, slope_low=slope,
             high=zero, value_high=value, slope_high=slope,
             cubic_ref=zero, value_cubic_ref=value,
             safe_stepsize=zero, safe_value=value, safe_grad=grad)
    found, it = False, 0
    while True:
        step = _zoom if found else _search_interval
        s = _try_safe_step(step(s, it, value_and_grad_fn))
        it += 1
        stop, found, finite = torch.stack([
            s["done"] | s["failed"], s["interval_found"],
            torch.isfinite(s["value"])]).tolist()
        if stats is not None:
            stats["host_reads"] = stats.get("host_reads", 0) + 1
            stats["linesearch_steps"] = stats.get("linesearch_steps", 0) + 1
        if stop:
            return s["stepsize"], s["value"], s["grad"], finite


# ---------------------------------------------------------------------------
# L-BFGS (optax/_src/transform.py scale_by_lbfgs) and the loop
# ---------------------------------------------------------------------------

class _LBFGSMemory:
    def __init__(self, params: Params):
        self.m = MEMORY_SIZE
        self.count = 0
        self.params = {k: torch.zeros_like(v) for k, v in params.items()}
        self.updates = {k: torch.zeros_like(v) for k, v in params.items()}
        self.dw = {k: v.new_zeros((MEMORY_SIZE,) + v.shape)
                   for k, v in params.items()}
        self.du = {k: v.new_zeros((MEMORY_SIZE,) + v.shape)
                   for k, v in params.items()}
        first = next(iter(params.values()))
        self.rho = first.new_zeros((MEMORY_SIZE,))

    def precondition(self, grad: Params, params: Params) -> Params:
        """Store the newest difference pair, then P_k g by the two-loop
        recursion."""
        m, count = self.m, self.count
        memory_idx, prev_idx = count % m, (count - 1) % m
        if count > 0:
            dw = {k: params[k] - self.params[k] for k in params}
            du = {k: grad[k] - self.updates[k] for k in grad}
            num = _vdot(du, dw)
            weight = torch.where(num == 0.0, torch.zeros_like(num),
                                 1.0 / num)
            den = _sqnorm(du)
            scale = torch.where(den > 0.0, num / den, torch.ones_like(num))
        else:
            dw = {k: torch.zeros_like(v) for k, v in params.items()}
            du = {k: torch.zeros_like(v) for k, v in grad.items()}
            weight = torch.zeros_like(self.rho[0])
            scale = torch.clamp_max(1.0 / torch.sqrt(_sqnorm(grad)), 1.0)
        for k in dw:
            self.dw[k][prev_idx] = dw[k]
            self.du[k][prev_idx] = du[k]
        self.rho[prev_idx] = weight

        order = [(memory_idx + i) % m for i in range(m)]
        vec = grad
        alphas = {}
        for idx in reversed(order):
            dwi = {k: v[idx] for k, v in self.dw.items()}
            dui = {k: v[idx] for k, v in self.du.items()}
            alphas[idx] = self.rho[idx] * _vdot(dwi, vec)
            vec = _add_scale(vec, -alphas[idx], dui)
        vec = _scale(scale, vec)
        for idx in order:
            dwi = {k: v[idx] for k, v in self.dw.items()}
            dui = {k: v[idx] for k, v in self.du.items()}
            beta = self.rho[idx] * _vdot(dui, vec)
            vec = _add_scale(vec, alphas[idx] - beta, dwi)
        self.params, self.updates = params, grad
        self.count += 1
        return vec


def lbfgs_run(loss_fn: Callable[[Params], torch.Tensor], params: Params,
              n_steps: int, stats: Optional[dict] = None
              ) -> Tuple[Params, torch.Tensor]:
    """n_steps of optax.lbfgs() from params (a dict of float32 tensors):
    (the final parameters, the loss at the start of each step (n_steps,)).
    The counterpart of the JAX package's _lbfgs_scan. stats, when a dict,
    gathers 'host_reads', 'linesearch_steps' and 'loss_evals'."""
    params = {k: v.detach() for k, v in params.items()}
    memory = _LBFGSMemory(params)

    def vg(p):
        if stats is not None:
            stats["loss_evals"] = stats.get("loss_evals", 0) + 1
        return value_and_grad(loss_fn, p)

    losses: List[torch.Tensor] = []
    value = grad = None
    finite = False
    for _ in range(n_steps):
        # optax.value_and_grad_from_state: reuse the linesearch's value and
        # gradient unless there is none yet or it is not finite
        if not finite:
            value, grad = vg(params)
        updates = _scale(-1.0, memory.precondition(grad, params))
        stepsize, new_value, new_grad, finite = zoom_linesearch(
            vg, params, updates, value, grad, stats)
        losses.append(value)
        params = {k: params[k] + stepsize * updates[k] for k in params}
        value, grad = new_value, new_grad
    if not losses:
        return params, next(iter(params.values())).new_zeros((0,))
    return params, torch.stack(losses)
