"""One run of one cell: set-up, the timed window, the traced stretch, the
check against the reference, and the result line's fields.

Everything about a cell is found by name: its entry in BENCHMARK.json,
``workloads/<cell>.json`` (driver, limits), ``configs/<config>.json``,
``traffic/<traffic>.json``, ``drivers/<driver>.py`` and one
``metrics/<metric>.py`` for each per-layer metric the cell reports.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import torch

from .readers import ROOT, MissingKernel, load_module
from .trace import MARK, reduce_events

REPO = os.path.dirname(ROOT)
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "nemo_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(name: str) -> dict:
    """The cell's entry in BENCHMARK.json joined with its own files."""
    bench = load_json(REPO, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    wl = load_json(ROOT, "workloads", name + ".json")
    for key in ("config", "traffic", "chips"):
        if wl[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json's {key} {wl[key]!r} "
                             f"differs from BENCHMARK.json's {entry[key]!r}")
    return {"bench": bench, "entry": entry, "workload": wl,
            "config": load_json(ROOT, "configs", entry["config"] + ".json"),
            "traffic": load_json(ROOT, "traffic", entry["traffic"] + ".json")}


def cell_metrics(bench: dict, name: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") this cell
    reports: those that list it, or list no cells and move an end-to-end
    metric that the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])}
    out = []
    for m in bench[kind]:
        cells = m.get("workloads")
        if cells is not None:
            if name in cells:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def sync(device):
    """Wait for the card's queue (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, traffic_over: Optional[dict] = None,
             parts: Optional[dict] = None) -> dict:
    """One run; returns {"result": the result line's object, "compared":
    [(name, value, limit)]}. traffic_over: keys that replace the traffic
    file's (the tests' small sizes); parts: seconds of set-up's parts
    before the call, printed with the driver's own."""
    device = torch.device(device)
    spec = cell_spec(name)
    bench, wl = spec["bench"], spec["workload"]
    traffic = {**spec["traffic"], **(traffic_over or {})}
    driver_mod = load_module("drivers", wl["driver"])
    drv = driver_mod.Driver(spec["config"], traffic, seed, device,
                            wl["limits"])
    sync(device)
    setup_s = time.perf_counter() - t_start
    parts = {**(parts or {}), **getattr(drv, "parts", {})}
    print("setup parts: " + " ".join(f"{k} {v:.3f}" for k, v in
                                     parts.items())
          + f" total {setup_s:.3f}", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    steps, wall, failed = drv.window(seconds)
    rate = steps / wall
    # (steps done, seconds into the window) along the window, for a look
    # at how steadily it ran
    print("window marks: " + " ".join(f"{n}:{t:.3f}" for n, t in
                                      getattr(drv, "marks", [])),
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if not trace:
        values = {drv.rate_metric: rate, "setup_s": setup_s}
        wanted = cell_metrics(bench, name, "end_to_end")
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": units[m["name"]]} for m in wanted}
    else:
        rec = traced_record(drv, device)
        rec.update(rate=rate, shapes=drv.shapes, peak_bytes=peak)
        metrics = {}
        for m in cell_metrics(bench, name, "per_layer"):
            try:
                v = load_module("metrics", m["name"]).read(rec)
            except MissingKernel as e:
                # a renamed kernel reads null, never 0, and says so
                print(f"portbench: {m['name']} reads null: {e}",
                      file=sys.stderr)
                metrics[m["name"]] = {"value": None, "unit": m["unit"]}
                continue
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = rec["busy_us"] / 1e6
        device_info["window_s"] = rec["window_us"] / 1e6
        breakdown = rec["breakdown"]
    compared = drv.check()
    correct = all(v <= lim for _, v, lim in compared)
    result = {"correct": correct, "attempted": steps, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in compared}
    return {"result": result, "compared": compared}


def traced_record(drv, device) -> dict:
    """The driver's traced stretch under torch.profiler, reduced."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from nemo_tpu_torch.ops import launch_counts, reset_launches
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        drv.warm_trace()
        reset_launches()
        with record_function(MARK):
            steps = drv.traced_steps()
        counts = dict(launch_counts())
    rec = reduce_events(prof.events(), steps)
    rec["launch_counts"] = counts
    return rec
