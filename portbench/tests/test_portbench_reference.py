"""The reference against the port's CPU path at a small size, and runs
driven with the timed path broken underneath: each fault a cell can have
turns ``correct`` false. The look for a card is skipped; each cell of
BENCHMARK.json runs through run_cell, as run.py drives it, at the small
traffic its workload file gives under ``small``."""

import json
import os
import time

import pytest
import torch

from portbench.harness.cell import REPO, cell_spec, run_cell
from portbench.harness.readers import load_module

with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    CELLS = sorted(w["name"] for w in json.load(f)["workloads"])
FIT_CELLS = [c for c in CELLS
             if cell_spec(c)["workload"]["driver"] == "fit_main"]


def small(cell):
    return cell_spec(cell)["workload"]["small"]


def files_spec(cell):
    """The cell's driver, configuration, small traffic and limits, read
    from its own files."""
    spec = cell_spec(cell)
    wl = spec["workload"]
    return (load_module("drivers", wl["driver"]), spec["config"],
            {**spec["traffic"], **wl["small"]}, wl["limits"])


def run(cell, seed=2 ** 31 + 11):
    """(correct, {name: value}) of one small run on the CPU."""
    torch.manual_seed(0)
    res = run_cell(cell, seed, 0.5, False, "cpu", time.perf_counter(),
                   small(cell))["result"]
    return res["correct"], {k: v["value"] for k, v in res["compared"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_cpu_path(cell):
    correct, compared = run(cell)
    assert correct, compared


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell):
    res = run_cell(cell, 2 ** 31 + 12, 0.5, True, "cpu", time.perf_counter(),
                   small(cell))["result"]
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _no_update(self, *a, **k):
    """GroupAdam.step that returns its state unchanged."""


@pytest.mark.parametrize("cell", CELLS)
def test_state_unchanged_is_caught(cell, monkeypatch):
    from nemo_tpu_torch.fit import optimizer
    monkeypatch.setattr(optimizer.GroupAdam, "step", _no_update)
    correct, compared = run(cell)
    assert not correct
    assert compared["change_gap"] >= 0.99


@pytest.mark.parametrize("cell", FIT_CELLS)
def test_half_batch_is_caught(cell, monkeypatch):
    """The fit's full batch with every other row left out: the losses are
    means over the rest."""
    from nemo_tpu_torch.fit import loop
    init = loop.NemoFitter.__init__

    def half_grid(self, *a, **k):
        init(self, *a, **k)
        self._grid = tuple(g[::2] for g in self._grid)
    monkeypatch.setattr(loop.NemoFitter, "__init__", half_grid)
    assert not run(cell)[0]
