"""Helpers that the per-layer metric files share: device time by kernel
name, rooflines against the table of peaks, and loading a metric's file
by its name."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Iterable, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def peaks() -> dict:
    """The table of peaks (peaks.json): FLOP/s and bytes/s of one card."""
    with open(os.path.join(ROOT, "peaks.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(ROOT, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_us(rec: dict, pattern: str) -> float:
    """Device microseconds of the operations whose name matches pattern
    (a regular expression, searched, case-insensitive)."""
    rx = re.compile(pattern, re.I)
    return sum(d for name, _, d in rec["kernels"] if rx.search(name))


def ms_per_step(rec: dict, pattern: str) -> Optional[float]:
    """Device ms a step of the matching operations; None where none ran."""
    if not any(re.search(pattern, n, re.I) for n, _, _ in rec["kernels"]):
        return None
    return kernel_us(rec, pattern) / 1e3 / rec["steps"]


def launched(rec: dict, keys: Iterable[str]) -> int:
    """Launches the program's own counters saw under these keys."""
    counts = rec.get("launch_counts") or {}
    return sum(counts.get(k, 0) for k in keys)


class MissingKernel(Exception):
    """The program's counters saw a kernel launch, but no device operation
    of the trace bears its name: a renamed kernel. The harness reports the
    metric as null and names the kernel on standard error."""


def roofline_pct(rec: dict, bound_s: float, pattern: str,
                 keys: Iterable[str]) -> Optional[float]:
    """100 x least time / device time of a kernel over the traced steps.
    None where its counters saw no launch (nothing to read); MissingKernel
    where they saw some but no device operation matches ``pattern``."""
    if launched(rec, keys) == 0:
        return None
    us = kernel_us(rec, pattern)
    if us <= 0:
        raise MissingKernel(f"the program launched {'/'.join(keys)} but "
                            f"no device operation matches {pattern!r}")
    return 100.0 * bound_s * 1e6 / us


# cuBLAS's GEMM and GEMV kernels (sgemm, the sm90 xmma and cutlass GEMMs,
# gemv2N/gemv2T, gemvx, the split-K reduction), and not the program's own
# K6 GEMM (mlp_gemm_kernel)
CUBLAS = r"^(?!.*mlp_gemm_kernel).*(gemm|gemv|splitkreduce)"
# the foreach kernels of torch._foreach_* (GroupAdam's update)
FOREACH = r"multi_tensor_apply"


def busy_ms_per_step(rec: dict) -> float:
    return rec["busy_us"] / 1e3 / rec["steps"]


def idle_pct(rec: dict) -> Optional[float]:
    """100 (1 - busy ms a step x the unprofiled steps a second / 1000)."""
    if rec["busy_us"] <= 0:
        return None
    return 100.0 * (1.0 - busy_ms_per_step(rec) * rec["rate"] / 1e3)


def mfu_pct(rec: dict, count: str) -> Optional[float]:
    """100 x FLOPs a step (counts/<count>.py at the cell's shapes) x the
    unprofiled rate / the TF32 dense peak."""
    flops = load_module("counts", count).step(rec["shapes"])["flops"]
    return 100.0 * flops * rec["rate"] / peaks()["tf32_flops"]
