"""Every piece of the benchmark is found by its name: BENCHMARK.json names
only files that exist, and each configuration, traffic mix, cell, driver,
metric and count loads from its own file."""

import json
import os
import re

import pytest

from portbench.harness.cell import REPO, cell_metrics, cell_spec
from portbench.harness.readers import ROOT, load_module

with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    path = os.path.join(REPO, cfg["file"])
    assert cfg["file"].startswith("portbench/") and os.path.isfile(path)
    with open(path) as f:
        data = json.load(f)
    assert data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert os.path.isfile(os.path.join(REPO, data["reference"]))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    spec = cell_spec(cell["name"])
    assert spec["workload"]["why"] == cell["why"]
    assert set(spec["workload"]["limits"]) == {"loss_gap", "grad_gap",
                                               "change_gap"}
    # the small traffic the CPU tests run the cell at
    assert set(spec["workload"]["small"]) <= set(spec["traffic"])
    driver = load_module("drivers", spec["workload"]["driver"])
    assert hasattr(driver.Driver, "rate_metric")
    e2e = [m["name"] for m in cell_metrics(BENCH, cell["name"],
                                           "end_to_end")]
    assert "setup_s" in e2e and driver.Driver.rate_metric in e2e
    assert cell_metrics(BENCH, cell["name"], "per_layer")


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_files(metric):
    assert callable(load_module("metrics", metric["name"]).read)
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric["workloads"]) <= cells


@pytest.mark.parametrize("name", sorted(
    f[:-3] for f in os.listdir(os.path.join(ROOT, "counts"))
    if f.endswith(".py") and not f.startswith("_")))
def test_count_files(name):
    mod = load_module("counts", name)
    assert hasattr(mod, "launch") or hasattr(mod, "step")


@pytest.mark.parametrize("name", sorted(
    f[:-5] for f in os.listdir(os.path.join(ROOT, "workloads"))))
def test_workload_files(name):
    """Every cell file, listed in BENCHMARK.json or not yet, names a
    configuration, a traffic mix and a driver that exist."""
    with open(os.path.join(ROOT, "workloads", name + ".json")) as f:
        wl = json.load(f)
    assert wl["name"] == name and wl["chips"] in (1, 4)
    for kind, key in (("configs", "config"), ("traffic", "traffic")):
        assert os.path.isfile(os.path.join(ROOT, kind, wl[key] + ".json"))
    assert hasattr(load_module("drivers", wl["driver"]), "Driver")
