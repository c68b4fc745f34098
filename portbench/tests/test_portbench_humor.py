"""The cell of the fit with HuMoR's dynamics prior (cvh_47x600) on the CPU
at its small traffic: its files, the program's term against the reference's
(reference/nemo_fit_humor.py) on seeded random weights, the planted faults
that turn ``correct`` false (the term left out of the program, half the
batch, a state left unchanged), the control's and faults' readings, the
reference's independence from the program, and its counts and readers on
canned records."""

import json
import os
import time

import pytest
import torch

from portbench.harness.cell import REPO, cell_metrics, cell_spec, run_cell
from portbench.harness.readers import MissingKernel, load_module, peaks
from portbench.reference import nemo_fit_humor
from portbench.tests.test_portbench_imports import FORBIDDEN, \
    top_level_imports
from portbench.tests.test_portbench_reference import files_spec, small

CELL = "cvh_47x600"
with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


def test_cell_files():
    """The configuration is nemo_v3_custom_video's plus the term's two
    settings and the HuMoR block at its published sizes; the cell reuses
    cv_47x600's traffic and limits' names and reports the rate, set-up and
    the new metrics."""
    spec = cell_spec(CELL)
    base = cell_spec("cv_47x600")
    cfg, old = spec["config"], base["config"]
    assert spec["entry"]["traffic"] == base["entry"]["traffic"]
    assert {k: v for k, v in cfg["nemo"].items()
            if k not in ("weight_humor_loss", "humor_fps")} == old["nemo"]
    assert cfg["nemo"]["weight_humor_loss"] == 1.0
    assert cfg["nemo"]["humor_fps"] == 30.0
    assert cfg["humor"] == {"state_dim": 207, "latent_size": 48,
                            "encoder_widths": [1024] * 4,
                            "prior_widths": [1024] * 4, "num_groups": 16,
                            "conditional_prior": True,
                            "group_norm_eps": 1e-5}
    for k in ("body", "vposer", "gmm", "v2v_vjp", "motion_mlp",
              "net_precision"):
        assert cfg[k] == old[k]
    assert cfg["reduced"] == []
    per_layer = {m["name"] for m in cell_metrics(BENCH, CELL, "per_layer")}
    assert {"k7_roofline.fit_humor", "mfu_pct.fit_humor",
            "k1_roofline.fit_humor", "k2_roofline.fit",
            "launches_per_step.fit"} <= per_layer
    assert not {"k1_roofline.fit", "mfu_pct.fit"} & per_layer
    e2e = {m["name"] for m in cell_metrics(BENCH, CELL, "end_to_end")}
    assert e2e == {"fit_steps_per_s", "setup_s"}


@pytest.mark.parametrize("name", ["humor.py", "nemo_fit_humor.py"])
def test_reference_imports_nothing_of_the_program(name):
    path = os.path.join(REPO, "portbench", "reference", name)
    found = top_level_imports(path)
    assert "nemo_tpu_torch" not in found and not found & FORBIDDEN
    with open(path) as f:
        assert "nemo_tpu" not in f.read()


def _driver(seed=2 ** 31 + 21):
    mod, config, traffic, limits = files_spec(CELL)
    torch.manual_seed(0)
    return mod.Driver(config, traffic, seed, torch.device("cpu"), limits)


def test_program_term_against_reference():
    """The program's humor_dynamics_loss on the fitter's parameters after
    its three steps against the reference's humor_term on the same tensors:
    the term within 1e-5 and its gradient of every stepped leaf within
    1e-4 of the largest leaf norm (f32 sums in other orders, and the
    program's rotation conversions and FK against the reference's own)."""
    from nemo_tpu_torch.fit.model import humor_dynamics_loss
    drv = _driver()
    fitter = drv.fitter
    vi, fi = fitter._grid
    params = fitter.params
    params.zero_grad(set_to_none=True)
    got = humor_dynamics_loss(params, fitter.cfg, fitter.assets, vi, fi)
    got.backward()
    P = {k: v.detach().clone().requires_grad_()
         for k, v in params.state_dict().items()}
    want = nemo_fit_humor.humor_term(P, drv.problem, drv.body, drv.humor,
                                     drv.config["nemo"], drv.config["humor"])
    want.backward()
    assert float(got.detach()) == pytest.approx(float(want.detach()),
                                               rel=1e-5)
    named = dict(params.named_parameters())
    stepped = [k for k in ("motion.trunk.W1", "motion.trunk.b3",
                           "motion.W_rot", "motion.W_lin", "instance",
                           "rbf.log_sigmas") if k in named]
    scale = max(float(P[k].grad.norm()) for k in stepped)
    for k in stepped:
        gap = float((named[k].grad - P[k].grad).norm())
        assert gap <= 1e-4 * scale, (k, gap, scale)


def test_humor_weights_stay_frozen():
    """After set-up's three fit steps and a window, HuMoR's tensors in the
    program are the ones drawn, bit for bit, and none holds a gradient."""
    from portbench.drivers.fit_humor import humor_weights
    seed = 2 ** 31 + 23
    drv = _driver(seed)
    drv.window(0.2)
    fresh = humor_weights(torch.Generator().manual_seed(
        (2 * seed + 1) % 2 ** 63), "cpu", drv.config["humor"])
    held = drv.fitter.assets.humor
    assert set(held) == set(fresh) == {"encoder", "prior"}
    for m in fresh:
        for k, v in fresh[m].items():
            assert torch.equal(held[m][k], v), (m, k)
            assert not held[m][k].requires_grad and held[m][k].grad is None


def test_readings_at_small_size():
    """The control cannot fail on the CPU (no TF32 there); every planted
    fault fails a limit, the program none."""
    drv = _driver()
    got = drv.readings()
    assert all(v <= lim for _, v, lim in got["program"])
    for kind in ("fault_half_batch", "fault_no_humor", "fault_unchanged"):
        assert any(v > lim for _, v, lim in got[kind]), (kind, got[kind])


def _run():
    res = run_cell(CELL, 2 ** 31 + 11, 0.5, False, "cpu",
                   time.perf_counter(), small(CELL))["result"]
    return res["correct"], {k: v["value"] for k, v in res["compared"].items()}


def test_term_left_out_is_caught(monkeypatch):
    """The program with the dynamics term left out of its loss: correct is
    false."""
    from nemo_tpu_torch.fit import model
    monkeypatch.setattr(model, "humor_dynamics_loss",
                        lambda params, *a, **k: params.cameras.new_zeros(()))
    correct, compared = _run()
    assert not correct, compared


def test_half_batch_is_caught(monkeypatch):
    """Every other row of the full batch left out, the term's too."""
    from nemo_tpu_torch.fit import loop
    init = loop.NemoFitter.__init__

    def half_grid(self, *a, **k):
        init(self, *a, **k)
        self._grid = tuple(g[::2] for g in self._grid)
    monkeypatch.setattr(loop.NemoFitter, "__init__", half_grid)
    assert not _run()[0]


SHAPES = {"B": 10, "V": 50, "J": 24, "H": 8, "K": 4, "C": 2,
          "vposer_neurons": 8, "vposer_latent": 4, "gmm_components": 2,
          "humor_rows": 10, "humor_state": 3, "humor_latent": 2,
          "humor_encoder": [4, 4], "humor_prior": [4, 4], "humor_width": 128,
          "humor_groups": 16}


def test_k7_counts():
    k7 = load_module("counts", "k7")
    # 10 rows of 128 columns in 16 groups: 2 C + 2 R G = 576 small values
    assert k7.launch(SHAPES) == {"flops": 8 * 1280,
                                 "bytes": 4 * (2 * 1280 + 576)}
    assert k7.launch(SHAPES, backward=True) == {
        "flops": 12 * 1280, "bytes": 4 * (3 * 1280 + 576)}


def test_fit_step_humor_counts():
    base = load_module("counts", "fit_step").step(SHAPES)["flops"]
    k1 = load_module("counts", "k1")
    got = load_module("counts", "fit_step_humor").step(SHAPES)["flops"]
    want = base + 6 * 30 * (6 * 8 + 2 * 64 + 8 * 144 + 8 * 3)
    want += 75 * 23 * 30 + 147 * 23 * 30       # K1 both ways at 3B rows
    assert k1.launch({"B": 30, "J": 24})["flops"] == 75 * 23 * 30
    # encoder 6 -> 4 -> 4 -> 4, prior 3 -> 4 -> 4 -> 4, at 4 B m n
    want += 4 * 10 * (6 * 4 + 16 + 16) + 4 * 10 * (3 * 4 + 16 + 16)
    assert got == want


def _record(**over):
    rec = {"steps": 2, "window_us": 10000.0, "launches": 3000,
           "busy_us": 4000.0, "rate": 5.0, "peak_bytes": 2 ** 30,
           "shapes": SHAPES,
           "launch_counts": {"humor_gn_fwd": 16, "humor_gn_bwd": 16},
           "kernels": [
               ["void (anonymous namespace)::humor_gn_fwd_kernel<8>(int)",
                0.0, 300.0],
               ["void (anonymous namespace)::humor_gn_bwd_kernel<8>(int)",
                0.0, 500.0],
               ["void at::native::elementwise_kernel<128, 2>", 0.0, 5.0]]}
    rec.update(over)
    return rec


def test_k7_roofline_reader():
    rec = _record()
    pk = peaks()
    k7 = load_module("counts", "k7")
    least = 16 * k7.launch(SHAPES)["bytes"] / pk["hbm_bytes_per_s"] + 16 * \
        k7.launch(SHAPES, backward=True)["bytes"] / pk["hbm_bytes_per_s"]
    got = load_module("metrics", "k7_roofline.fit_humor").read(rec)
    assert got == pytest.approx(100 * least / 800e-6)
    with pytest.raises(MissingKernel):
        load_module("metrics", "k7_roofline.fit_humor").read(_record(
            kernels=[k for k in rec["kernels"] if "humor_gn" not in k[0]]))
    # a program without K7 (the parent) has nothing to read
    assert load_module("metrics", "k7_roofline.fit_humor").read(_record(
        launch_counts={}, kernels=[])) is None


def test_k1_roofline_reader():
    """Each traced step's term launches K1 once each way at 3B rows, the
    main step three times forward and twice backward at B."""
    k1, pk = load_module("counts", "k1"), peaks()
    wide = {**SHAPES, "B": 3 * SHAPES["B"]}

    def least(c):
        return max(c["flops"] / pk["tf32_flops"],
                   c["bytes"] / pk["hbm_bytes_per_s"])
    want = 2 * (least(k1.launch(wide)) + least(k1.launch(wide, True))
                + 3 * least(k1.launch(SHAPES))
                + 2 * least(k1.launch(SHAPES, True)))
    rec = _record(launch_counts={"fk_fwd": 8, "fk_bwd": 6}, kernels=[
        ["void fk_fwd_kernel<24>(int)", 0.0, 40.0],
        ["void fk_bwd_kernel<24>(int)", 0.0, 60.0]])
    reader = load_module("metrics", "k1_roofline.fit_humor")
    assert reader.read(rec) == pytest.approx(100 * want / 100e-6)
    with pytest.raises(MissingKernel):
        reader.read({**rec, "kernels": rec["kernels"][:0]})
    assert reader.read(_record(launch_counts={}, kernels=[])) is None


def test_mfu_reader():
    flops = load_module("counts", "fit_step_humor").step(SHAPES)["flops"]
    got = load_module("metrics", "mfu_pct.fit_humor").read(_record())
    assert got == pytest.approx(100 * flops * 5.0 / 495e12)
