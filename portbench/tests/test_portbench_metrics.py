"""Each per-layer metric's reader on a canned record of a traced run, and
the trace reduction that builds records."""

import pytest

from portbench.harness.readers import MissingKernel, load_module, peaks
from portbench.harness.trace import build_record, gaps, union_us

FIT_SHAPES = {"B": 100, "V": 50, "J": 24, "H": 8, "K": 4, "C": 2,
              "vposer_neurons": 8, "vposer_latent": 4, "gmm_components": 2}
V2V = "void (anonymous namespace)::v2v_fused_kernel<float>(int, int)"


def record(**over):
    rec = {"steps": 2, "window_us": 10000.0, "launches": 3000,
           "busy_us": 4000.0, "rate": 50.0, "peak_bytes": 3 * 2 ** 30,
           "shapes": FIT_SHAPES,
           "launch_counts": {"v2v_grad": 2, "fk_fwd": 6, "fk_bwd": 4},
           "kernels": [
               [V2V, 0.0, 1000.0],
               ["void (anonymous namespace)::total_kernel(int)", 0, 10.0],
               ["void (anonymous namespace)::range_reduce_kernel(int)", 0,
                90.0],
               ["fk_fwd_kernel(float const*)", 0.0, 30.0],
               ["fk_bwd_kernel(float const*)", 0.0, 20.0],
               ["sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8", 0,
                300.0],
               ["void gemv2N_kernel<int, int, float>", 0.0, 100.0],
               ["mlp_gemm_kernel<float>", 0.0, 500.0],
               ["void at::native::multi_tensor_apply_kernel<...>", 0.0,
                40.0],
               ["void at::native::elementwise_kernel<128, 2>", 0.0, 5.0]]}
    rec.update(over)
    return rec


def read(name, rec):
    return load_module("metrics", name).read(rec)


def test_step_readers():
    rec = record()
    assert read("launches_per_step.fit", rec) == 1500
    assert read("optimizer_ms_per_step.fit", rec) == pytest.approx(0.02)
    # cuBLAS's GEMM and GEMV, not the program's own K6 GEMM
    assert read("gemm_ms_per_step.fit", rec) == pytest.approx(0.2)
    # busy 2 ms a step at 50 steps a second: 10% busy
    assert read("device_idle_pct.fit", rec) == pytest.approx(90.0)
    assert read("peak_mem_gib.fit", rec) == pytest.approx(3.0)


def test_roofline_readers():
    rec = record()
    pk = peaks()
    k2 = load_module("counts", "k2").launch(FIT_SHAPES)
    least = 2 * max(k2["flops"] / pk["tf32_flops"],
                    k2["bytes"] / pk["hbm_bytes_per_s"])
    # v2v_fused_kernel with its total and range kernels: 1100 us
    assert read("k2_roofline.fit", rec) == pytest.approx(
        100 * least / 1100e-6)
    k1 = load_module("counts", "k1")

    def t(c):
        return max(c["flops"] / pk["tf32_flops"],
                   c["bytes"] / pk["hbm_bytes_per_s"])
    least1 = 6 * t(k1.launch(FIT_SHAPES)) + 4 * t(
        k1.launch(FIT_SHAPES, backward=True))
    assert read("k1_roofline.fit", rec) == pytest.approx(
        100 * least1 / 50e-6)


def test_mfu_readers():
    rec = record()
    flops = load_module("counts", "fit_step").step(FIT_SHAPES)["flops"]
    assert read("mfu_pct.fit", rec) == pytest.approx(
        100 * flops * 50 / 495e12)


@pytest.mark.parametrize("metric,dropped", [
    ("k2_roofline.fit", "v2v_fused_kernel"),
    ("k1_roofline.fit", "fk_")])
def test_renamed_kernel_is_missing(metric, dropped):
    """The counters saw K1 and K2 launch, but no device operation bears
    their names: the readers raise MissingKernel, never read 0. K2's
    helper kernels alone do not stand in for it."""
    rec = record(kernels=[k for k in record()["kernels"]
                          if dropped not in k[0]])
    with pytest.raises(MissingKernel):
        read(metric, rec)


def test_renamed_kernel_reads_null_in_the_line(monkeypatch, capsys):
    """run_cell's traced branch puts a missing kernel's metric in the
    result line as null and names it on standard error."""
    from portbench.harness import cell
    rec = record(kernels=[k for k in record()["kernels"]
                          if "v2v" not in k[0]])

    class Drv:
        rate_metric = "fit_steps_per_s"
        shapes = FIT_SHAPES

        def __init__(self, *a):
            pass

        def window(self, seconds):
            return 10, 0.2, 0

        def check(self):
            return [("loss_gap", 0.0, 1.0)]

    monkeypatch.setattr(cell, "traced_record",
                        lambda drv, device: {**rec, "breakdown": {}})
    real = cell.load_module
    monkeypatch.setattr(cell, "load_module", lambda kind, name: type(
        "M", (), {"Driver": Drv}) if kind == "drivers" else real(kind, name))
    name = cell.load_json(cell.REPO, "BENCHMARK.json")["workloads"][0]["name"]
    res = cell.run_cell(name, 1, 0.1, True, "cpu", 0.0)["result"]
    assert res["metrics"]["k2_roofline.fit"]["value"] is None
    assert res["metrics"]["k1_roofline.fit"]["value"] > 0
    assert "k2_roofline.fit reads null" in capsys.readouterr().err


def test_nothing_to_read_reads_none():
    rec = record(kernels=[], launches=0, busy_us=0.0,
                 launch_counts={}, peak_bytes=0)
    for name in ("launches_per_step.fit", "optimizer_ms_per_step.fit",
                 "gemm_ms_per_step.fit", "k2_roofline.fit",
                 "k1_roofline.fit", "device_idle_pct.fit",
                 "peak_mem_gib.fit"):
        assert read(name, rec) is None, name


def test_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert union_us(iv) == 4.0
    assert gaps(iv, 0.0, 8.0) == [(3.0, 5.0), (6.0, 8.0)]


def test_build_record():
    dev = [("a", 0.0, 2.0), ("b", 1.0, 2.0), ("a", 5.0, 1.0)]
    host = [("cudaLaunchKernel", 0.0, 0.1), ("aten::mul", 2.5, 6.0),
            ("cudaLaunchKernel", 4.9, 5.0), ("aten::add", 6.0, 9.0)]
    rec = build_record(dev, host, 0.0, 8.0, 2)
    assert rec["launches"] == 2 and rec["busy_us"] == 4.0
    assert rec["breakdown"]["device_ops"] == [["a", 3e-6], ["b", 2e-6]]
    # the longest idle stretch, 3 -> 5, began while aten::mul ran
    assert rec["breakdown"]["idle_gaps"][0] == ["aten::mul", 2e-6]
    assert rec["breakdown"]["idle_gaps"][1] == ["aten::add", 2e-6]
