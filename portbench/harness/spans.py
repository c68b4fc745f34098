"""The port's spans in a torch.profiler trace: who owns each device
operation, and the host's time and launch calls by span.

The port parts its main-stage step into ``nemo.*`` spans
(nemo_tpu_torch/utils/trace.py): ``nemo.fit.step`` around
``nemo.fit.forward``, ``nemo.fit.backward`` and ``nemo.fit.optimizer``;
layer spans inside the forward (``nemo.net.*``, ``nemo.body.smpl``,
``nemo.loss.*``, ``nemo.prior.*``); ``nemo.fit.metrics_copy`` around a
chunk's host copy; and ``nemo.ops.<key>`` around each launch of a
hand-written kernel. Host events and device operations share the trace's
clock.

A device operation's owner: its launch call (the runtime or driver event
with the operation's correlation id), then up through the host events that
enclose the call (``cpu_parent``) to the outermost owner span, looking
through ``nemo.ops.*``. A walk that meets an autograd node of the backward
(an event with a sequence number and a forward thread) goes on from the
forward operator of the same (thread, sequence number), so that a backward
kernel belongs to the layer whose forward made its node. An operation that
reaches no owner span is unattributed.

``reduce_spans`` takes ``prof.events()`` and returns plain numbers and
lists (``attribute`` does the work on plain tuples, which the tests can
write by hand).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from .readers import CUBLAS, MissingKernel
from .trace import LAUNCH_CALLS, MARK, gaps, union_us

STEP = "nemo.fit.step"
# the spans that own device time, outermost first on a walk
OWNER = re.compile(r"^nemo\.(net|body|loss|prior)\.|"
                   r"^nemo\.fit\.(optimizer|metrics_copy)$")
# CUDA runtime and driver calls on the host
CUDA_CALL = re.compile(r"^cu(da)?[A-Z]")
UNATTRIBUTED = "(unattributed)"

# host event: (name, thread, start_us, end_us, parent index or -1,
#              sequence_nr, fwd_thread, correlation id)
Host = Tuple[str, int, float, float, int, int, int, int]
# device operation: (name, start_us, dur_us, correlation id)
Device = Tuple[str, float, float, int]


def plain_events(events, mark: Optional[str] = MARK
                 ) -> Tuple[List[Host], List[Device], float, float]:
    """(host, device, lo, hi) from ``prof.events()``: every host event, the
    device operations that began inside the mark's host interval [lo, hi)
    (the whole trace with mark None), device-side annotations left out."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    if mark is None:
        lo = min(e.time_range.start for e in events)
        hi = max(e.time_range.end for e in events)
    else:
        marks = [e for e in cpu if e.name == mark]
        if not marks:
            raise RuntimeError(f"the trace holds no {mark} mark")
        lo, hi = marks[0].time_range.start, marks[0].time_range.end
    index = {id(e): i for i, e in enumerate(cpu)}
    host = [(e.name, e.thread, e.time_range.start, e.time_range.end,
             index.get(id(e.cpu_parent), -1), e.sequence_nr,
             e.fwd_thread or 0, e.id) for e in cpu]
    # a record_function's range drawn on the device's timeline (the
    # harness's mark among them) is no device operation
    dev = [(e.name, e.time_range.start,
            e.time_range.end - e.time_range.start, e.id)
           for e in events if e.device_type == DeviceType.CUDA
           and lo <= e.time_range.start < hi and not e.is_user_annotation]
    return host, dev, lo, hi


def _forward_ops(host: Sequence[Host]) -> Dict[Tuple[int, int], int]:
    """(thread, sequence_nr) -> the latest-starting forward operator with
    that number: the one that made the autograd node (an operator that
    makes none records the number the next node will take)."""
    out: Dict[Tuple[int, int], int] = {}
    for i, (_, thread, start, _, _, seq, fwd, _) in enumerate(host):
        if seq >= 0 and not fwd:
            j = out.get((thread, seq))
            if j is None or host[j][2] <= start:
                out[(thread, seq)] = i
    return out


def owner_of(host: Sequence[Host], i: int,
             fwd_ops: Dict[Tuple[int, int], int]) -> Tuple[str, str]:
    """(owner span, innermost nemo.ops span or "") of host event i: the
    outermost owner span up from i, a backward node's walk going on from
    its forward operator."""
    owner, ops = UNATTRIBUTED, ""
    # each jump lands on an earlier event, so the walk ends
    while i >= 0:
        name, _, _, _, parent, seq, fwd, _ = host[i]
        if OWNER.match(name):
            owner = name
        elif name.startswith("nemo.ops.") and not ops:
            ops = name
        if seq >= 0 and fwd:
            j = fwd_ops.get((fwd, seq))
            if j is not None:
                i = j
                continue
        i = parent
    return owner, ops


def attribute(host: Sequence[Host], dev: Sequence[Device], lo: float,
              hi: float, steps: int) -> dict:
    """The span record of the marked stretch [lo, hi) (see the module's
    docstring): device µs (and its cuBLAS part) and launch calls by owner,
    the same by ``nemo.ops.*`` span, each nemo span's calls and host self
    µs, the step spans' count and their host µs outside CUDA calls, and
    the ten longest idle gaps: [s, the owner and caller of the operation
    that ends it, the innermost host event open as it began]."""
    fwd_ops = _forward_ops(host)
    launch_of = {h[7]: i for i, h in enumerate(host)
                 if CUDA_CALL.match(h[0])}
    owned: Dict[str, float] = defaultdict(float)
    # the cuBLAS part of each owner's time (gemm_ms_per_step.fit's kernels)
    cublas: Dict[str, float] = defaultdict(float)
    cublas_rx = re.compile(CUBLAS, re.I)
    by_ops: Dict[str, float] = defaultdict(float)
    first_op: List[Tuple[float, str, str]] = []
    for name, start, dur, corr in dev:
        i = launch_of.get(corr, -1)
        owner, ops = owner_of(host, i, fwd_ops) if i >= 0 \
            else (UNATTRIBUTED, "")
        owned[owner] += dur
        if cublas_rx.search(name):
            cublas[owner] += dur
        if ops:
            by_ops[ops] += dur
        caller = host[i][0] if i < 0 or host[i][4] < 0 \
            else host[host[i][4]][0]
        first_op.append((start, owner, caller))
    launches: Dict[str, int] = defaultdict(int)
    for i, h in enumerate(host):
        if LAUNCH_CALLS.match(h[0]) and lo <= h[2] < hi:
            owner, ops = owner_of(host, i, fwd_ops)
            launches[owner] += 1
            if ops:
                launches[ops] += 1

    inside = [i for i, h in enumerate(host)
              if h[0].startswith("nemo.") and lo <= h[2] < hi]
    spans: Dict[str, dict] = {}
    for i in inside:
        s = spans.setdefault(host[i][0], {"calls": 0, "host_self_us": 0.0})
        s["calls"] += 1
        s["host_self_us"] += host[i][3] - host[i][2]
    for i in inside:
        # a nested nemo span's time is its nearest nemo ancestor's no more
        p = host[i][4]
        while p >= 0 and not host[p][0].startswith("nemo."):
            p = host[p][4]
        if p >= 0 and lo <= host[p][2] < hi:
            spans[host[p][0]]["host_self_us"] -= host[i][3] - host[i][2]
    for name, s in spans.items():
        s["device_us"] = owned.get(name, by_ops.get(name))
        s["launches"] = launches.get(name, 0)

    steps_iv = [(h[2], h[3]) for h in host if h[0] == STEP
                and lo <= h[2] < hi]
    calls = []
    for h in host:
        if CUDA_CALL.match(h[0]):
            for s, t in steps_iv:
                a, b = max(h[2], s), min(h[3], t)
                if b > a:
                    calls.append((a, b))
    step_host_us = sum(t - s for s, t in steps_iv) - union_us(calls)

    busy = [(s, s + d) for _, s, d, _ in dev]
    first_op.sort()
    idle = []
    for g0, g1 in sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:10]:
        nxt = next((o for o in first_op if o[0] >= g1), None)
        # the innermost host event open as the device fell idle
        open_ = max(((h[2], h[0]) for h in host if h[2] <= g0 < h[3]
                     and h[0] != MARK), default=(0, ""))[1]
        idle.append([(g1 - g0) / 1e6, nxt[1] if nxt else "(end of mark)",
                     nxt[2] if nxt else "", open_])
    return {"steps": steps, "step_spans": len(steps_iv),
            "owned_us": dict(owned), "cublas_us": dict(cublas),
            "unattributed_us":
            owned.get(UNATTRIBUTED, 0.0), "device_us": sum(owned.values()),
            "launches": {k: v for k, v in launches.items()},
            "spans": spans, "step_host_us": step_host_us,
            "idle_gaps": idle}


def reduce_spans(events, steps: int, mark: Optional[str] = MARK) -> dict:
    """``attribute`` over ``prof.events()`` inside the mark (the whole trace
    with mark None)."""
    return attribute(*plain_events(events, mark), steps)


class StepCountMismatch(MissingKernel):
    """Step spans were traced, but not one a step: the spans and the
    harness's count of steps disagree (a reading is then null, as for a
    renamed kernel)."""


def _checked(sp: dict) -> Optional[dict]:
    if not sp or sp["step_spans"] == 0:
        return None
    if sp["step_spans"] != sp["steps"]:
        raise StepCountMismatch(f"{sp['step_spans']} {STEP} spans in a "
                                f"stretch of {sp['steps']} steps")
    return sp


def owned_ms_per_step(sp: dict, pattern: str) -> Optional[float]:
    """Device ms a step owned by the owner spans whose name matches
    ``pattern`` (searched); None where the trace holds no step span."""
    sp = _checked(sp)
    if sp is None:
        return None
    rx = re.compile(pattern)
    return sum(us for name, us in sp["owned_us"].items()
               if rx.search(name)) / 1e3 / sp["steps"]


def host_ms_per_step(sp: dict) -> Optional[float]:
    """Host ms a step inside the step spans, outside CUDA runtime and
    driver calls; None where the trace holds no step span."""
    sp = _checked(sp)
    return None if sp is None else sp["step_host_us"] / 1e3 / sp["steps"]


# the per-layer readings of the spans: name -> (reader, its argument)
READINGS = {
    "networks_ms_per_step.fit": r"^nemo\.net\.",
    "smpl_ms_per_step.fit": r"^nemo\.body\.smpl$",
    "v2v_prior_ms_per_step.fit": r"^nemo\.prior\.v2v$",
    "priors_ms_per_step.fit": r"^nemo\.prior\.(?!v2v$)",
    "loss_terms_ms_per_step.fit": r"^nemo\.loss\.",
}


def readings(sp: dict) -> Dict[str, Optional[float]]:
    """The six per-layer readings of a span record."""
    out = {name: owned_ms_per_step(sp, rx) for name, rx in READINGS.items()}
    out["host_ms_per_step.fit"] = host_ms_per_step(sp)
    return out


def table(sp: dict) -> str:
    """A text table: per nemo span, calls, host self ms, device ms and launch
    calls a step; the unattributed share; the ten longest idle gaps."""
    n = max(sp["steps"], 1)
    rows = [f"{'span':<28} {'calls':>6} {'host self ms':>12} "
            f"{'device ms':>10} {'cuBLAS ms':>10} {'launches':>9}"]
    for name in sorted(sp["spans"]):
        s = sp["spans"][name]
        dev = "-" if s["device_us"] is None else \
            f"{s['device_us'] / 1e3 / n:.3f}"
        gemm = sp["cublas_us"].get(name)
        gemm = "-" if gemm is None else f"{gemm / 1e3 / n:.3f}"
        rows.append(f"{name:<28} {s['calls'] / n:>6.1f} "
                    f"{s['host_self_us'] / 1e3 / n:>12.3f} {dev:>10} "
                    f"{gemm:>10} {s['launches'] / n:>9.1f}")
    total = sp["device_us"]
    un = sp["unattributed_us"]
    rows.append(f"{UNATTRIBUTED:<28} {'':>6} {'':>12} "
                f"{un / 1e3 / n:>10.3f} {'':>10} "
                f"{sp['launches'].get(UNATTRIBUTED, 0) / n:>9.1f}")
    rows.append(f"device ms a step {total / 1e3 / n:.3f}, owned "
                f"{100.0 * (1 - un / total) if total else 0.0:.2f}%; "
                f"{sp['step_spans']} {STEP} spans over {sp['steps']} steps; "
                f"host ms a step outside CUDA calls "
                f"{sp['step_host_us'] / 1e3 / n:.3f}")
    for sec, owner, caller, open_ in sp["idle_gaps"]:
        rows.append(f"idle {sec * 1e3:.3f} ms from {open_ or '-'}, ended "
                    f"by {owner} ({caller})")
    return "\n".join(rows)
