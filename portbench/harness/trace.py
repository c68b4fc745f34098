"""The traced run's record: what torch.profiler saw inside the marked
stretch, reduced to plain numbers and lists that the per-layer metric
readers take.

A record holds ``steps`` (steps inside the mark), ``window_us`` (the
mark's host length), ``kernels`` ([name, start_us, dur_us] of every
device operation that began inside the mark), ``launches`` (CUDA runtime
launch calls on the host inside the mark), ``busy_us`` (the union of the
device operations' intervals), ``breakdown`` and whatever the driver adds
(``rate``, ``shapes``, ``launch_counts``, ``peak_bytes``).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

MARK = "portbench.traced"
# host-side runtime calls that put a kernel on the device
LAUNCH_CALLS = re.compile(r"^(cudaLaunch|cuLaunch|cudaGraphLaunch)")


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi) between the intervals."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [g for g in out if g[1] > g[0]]


def reduce_events(events, steps: int) -> dict:
    """A record from torch.profiler's ``prof.events()`` (each with .name,
    .device_type, .time_range) over a stretch marked by record_function
    (MARK). Device operations are those whose device type is CUDA."""
    from torch.autograd import DeviceType
    marks = [e for e in events if e.name == MARK
             and e.device_type == DeviceType.CPU]
    if not marks:
        raise RuntimeError(f"the trace holds no {MARK} mark")
    lo, hi = marks[0].time_range.start, marks[0].time_range.end
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the mark's own range on the device timeline is no operation
            if lo <= s < hi and not e.name.startswith("portbench."):
                dev.append((e.name, s, t - s))
        elif lo <= s < hi and e.name != MARK:
            host.append((e.name, s, t))
    return build_record(dev, host, lo, hi, steps)


def build_record(dev: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]],
                 lo: float, hi: float, steps: int) -> dict:
    """The record from device operations (name, start_us, dur_us) and host
    events (name, start_us, end_us) of the marked stretch [lo, hi)."""
    spans = [(s, s + d) for _, s, d in dev]
    busy = union_us(spans)
    by_name: Dict[str, float] = defaultdict(float)
    for name, _, d in dev:
        by_name[name] += d
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:10]
    idle_named = []
    for g0, g1 in idle:
        # what the host was doing when the device fell idle: the innermost
        # host event open at the gap's start
        open_ = [(s, name) for name, s, t in host if s <= g0 < t]
        idle_named.append([max(open_)[1] if open_ else "(no host event)",
                           (g1 - g0) / 1e6])
    return {
        "steps": steps,
        "window_us": hi - lo,
        "kernels": [[n, s, d] for n, s, d in dev],
        "launches": sum(1 for name, _, _ in host
                        if LAUNCH_CALLS.match(name)),
        "busy_us": busy,
        "breakdown": {"device_ops": [[n, d / 1e6] for n, d in top_ops],
                      "idle_gaps": idle_named},
    }
