"""The span attribution (harness/spans.py) on canned profiler events of a
traced stretch: owners through the ops spans and the backward's sequence
numbers, the six readings with their None and mismatch cases, the host's
own time, and the trace reductions' indifference to the port's spans and
to device-side annotations."""

from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from portbench.harness import spans
from portbench.harness.trace import MARK, reduce_events

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


class Trace:
    """Canned prof.events(): host events nest by the ``parent`` given,
    device operations carry the correlation id of their launch call."""

    def __init__(self):
        self.events = []

    def host(self, name, start, end, parent=None, thread=1, seq=-1, fwd=0,
             corr=0):
        e = NS(name=name, device_type=CPU, thread=thread, cpu_parent=parent,
               time_range=NS(start=start, end=end), sequence_nr=seq,
               fwd_thread=fwd, id=corr, is_user_annotation=False)
        self.events.append(e)
        return e

    def kernel(self, name, start, dur, corr, annotation=False):
        self.events.append(NS(name=name, device_type=CUDA, thread=0,
                              cpu_parent=None, sequence_nr=-1, fwd_thread=0,
                              time_range=NS(start=start, end=start + dur),
                              id=corr, is_user_annotation=annotation))

    def launch(self, parent, at, corr, kernel, start, dur):
        """A launch call at host time ``at`` under ``parent`` and its
        kernel on the device."""
        self.host("cudaLaunchKernel", at, at + 2, parent,
                  thread=parent.thread, corr=corr)
        self.kernel(kernel, start, dur, corr)


def one_step(t: Trace, mark, t0: float, humor: bool = False):
    """One step at host time t0 (100 us a step on the host, 1000 on the
    device): the MotionNet's product, K1 under the body, K2 under the v2v
    prior, the keypoint loss, a backward on the worker thread (thread 2)
    with the product's and K1's nodes and a gradient accumulation, then
    the optimizer."""
    d0 = 10 * t0
    step = t.host("nemo.fit.step", t0, t0 + 90, mark)
    fwd = t.host("nemo.fit.forward", t0 + 1, t0 + 40, step)
    outer = t.host("nemo.prior.humor", t0 + 2, t0 + 12, fwd) if humor \
        else fwd
    net = t.host("nemo.net.motion", t0 + 2, t0 + 10, outer)
    mm = t.host("aten::addmm", t0 + 3, t0 + 8, net, seq=t0 + 1)
    t.launch(mm, t0 + 4, t0 + 1, "sm80_xmma_gemm_f32", d0, 100)
    body = t.host("nemo.body.smpl", t0 + 12, t0 + 20, fwd)
    fkf = t.host("FkFunction", t0 + 13, t0 + 19, body, seq=t0 + 2)
    ops = t.host("nemo.ops.fk_fwd", t0 + 14, t0 + 18, fkf)
    t.launch(ops, t0 + 15, t0 + 2, "fk_fwd_kernel", d0 + 100, 10)
    v2v = t.host("nemo.prior.v2v", t0 + 21, t0 + 30, fwd)
    k2 = t.host("nemo.ops.v2v_grad", t0 + 22, t0 + 29, v2v)
    t.launch(k2, t0 + 23, t0 + 3, "v2v_fused_kernel", d0 + 110, 600)
    t.launch(k2, t0 + 25, t0 + 4, "total_kernel", d0 + 710, 10)
    kp = t.host("nemo.loss.keypoints", t0 + 31, t0 + 39, fwd)
    add = t.host("aten::add", t0 + 32, t0 + 35, kp, seq=t0 + 5)
    t.launch(add, t0 + 33, t0 + 5, "elementwise_kernel", d0 + 720, 20)
    bwd = t.host("nemo.fit.backward", t0 + 41, t0 + 80, step)
    t.launch(t.host("aten::ones_like", t0 + 42, t0 + 44, bwd), t0 + 43,
             t0 + 6, "fill_kernel", d0 + 740, 5)
    ev = t.host("autograd::engine::evaluate_function: AddmmBackward0",
                t0 + 45, t0 + 60, None, thread=2, seq=t0 + 1, fwd=1)
    node = t.host("AddmmBackward0", t0 + 46, t0 + 59, ev, thread=2,
                  seq=t0 + 1, fwd=1)
    t.launch(t.host("aten::mm", t0 + 47, t0 + 50, node, thread=2), t0 + 48,
             t0 + 7, "cutlass_80_simt_sgemm", d0 + 800, 150)
    ev2 = t.host("autograd::engine::evaluate_function: FkFunctionBackward",
                 t0 + 61, t0 + 70, None, thread=2, seq=t0 + 2, fwd=1)
    ops2 = t.host("nemo.ops.fk_bwd", t0 + 62, t0 + 69, ev2, thread=2)
    t.launch(ops2, t0 + 63, t0 + 8, "fk_bwd_kernel", d0 + 950, 20)
    acc = t.host("torch::autograd::AccumulateGrad", t0 + 71, t0 + 75, None,
                 thread=2)
    t.launch(t.host("aten::add_", t0 + 72, t0 + 74, acc, thread=2), t0 + 73,
             t0 + 9, "add_kernel", d0 + 970, 5)
    opt = t.host("nemo.fit.optimizer", t0 + 81, t0 + 89, step)
    t.launch(t.host("aten::_foreach_add_", t0 + 82, t0 + 88, opt), t0 + 83,
             t0 + 10, "multi_tensor_apply_kernel", d0 + 980, 15)


def stretch(steps: int = 2, humor: bool = False, spans_on: bool = True):
    t = Trace()
    # the device runs 10x later than the host: the mark ends after it
    mark = t.host(MARK, 0, 1000 * (steps + 1))
    for i in range(steps):
        one_step(t, mark, 100 * (i + 1), humor)
    if not spans_on:
        # the parent program: no nemo.* host events; their children take
        # the nearest other ancestor
        def keep(e):
            p = e.cpu_parent
            while p is not None and p.name.startswith("nemo."):
                p = p.cpu_parent
            e.cpu_parent = p
            return not e.name.startswith("nemo.")
        t.events = [e for e in t.events if keep(e)]
    return t


def test_owners_through_ops_spans_and_sequence_numbers():
    sp = spans.reduce_spans(stretch().events, 2)
    owned = {k: v / 2 for k, v in sp["owned_us"].items()}
    # the forward product (100) and its backward node's product (150)
    assert owned["nemo.net.motion"] == 250
    # K1's forward under the body and its backward through FkFunction's
    # sequence number
    assert owned["nemo.body.smpl"] == 30
    assert owned["nemo.prior.v2v"] == 610
    assert owned["nemo.loss.keypoints"] == 20
    assert owned["nemo.fit.optimizer"] == 15
    # the loss's seed gradient and the gradient accumulation
    assert owned[spans.UNATTRIBUTED] == 10
    # cuBLAS's kernels by owner: the MotionNet's xmma GEMM and simt sgemm
    assert sp["cublas_us"] == {"nemo.net.motion": 2 * 250}
    assert sp["spans"]["nemo.ops.fk_bwd"]["device_us"] == 40
    assert sp["spans"]["nemo.ops.v2v_grad"]["device_us"] == 1220
    assert sp["launches"]["nemo.prior.v2v"] == 4
    assert sp["launches"]["nemo.ops.v2v_grad"] == 4
    assert sp["step_spans"] == 2
    assert sp["spans"]["nemo.fit.step"]["calls"] == 2


def test_outermost_owner_span():
    """A layer span inside another (the HuMoR term's predict) is its
    outer span's: each term of the loss has one owner."""
    sp = spans.reduce_spans(stretch(humor=True).events, 2)
    assert "nemo.net.motion" not in sp["owned_us"]
    assert sp["owned_us"]["nemo.prior.humor"] == 2 * 250


def test_host_self_and_own_time():
    sp = spans.reduce_spans(stretch().events, 2)
    # the step's 90 us less forward (39), backward (39), optimizer (8)
    assert sp["spans"]["nemo.fit.step"]["host_self_us"] == 2 * 4
    # forward's 39 less its four layer spans (8 + 8 + 9 + 8)
    assert sp["spans"]["nemo.fit.forward"]["host_self_us"] == 2 * 6
    # each step: 90 us, less its ten launch calls of 2 us
    assert sp["step_host_us"] == 2 * (90 - 20)


def test_readings():
    r = spans.readings(spans.reduce_spans(stretch().events, 2))
    assert r == pytest.approx({"networks_ms_per_step.fit": 0.25,
                               "smpl_ms_per_step.fit": 0.03,
                               "v2v_prior_ms_per_step.fit": 0.61,
                               "priors_ms_per_step.fit": 0.0,
                               "loss_terms_ms_per_step.fit": 0.02,
                               "host_ms_per_step.fit": 0.07})


def test_readings_none_without_spans():
    sp = spans.reduce_spans(stretch(spans_on=False).events, 2)
    assert sp["step_spans"] == 0
    assert set(spans.readings(sp).values()) == {None}
    assert sp["owned_us"] == {spans.UNATTRIBUTED: 2 * 935}


def test_readings_raise_on_a_step_count_mismatch():
    sp = spans.reduce_spans(stretch(steps=3).events, 2)
    with pytest.raises(spans.StepCountMismatch):
        spans.readings(sp)


def test_idle_gaps_name_the_span_that_ends_them():
    sp = spans.reduce_spans(stretch().events, 2)
    # the device starts step 1 1000 us into the mark: the longest gap,
    # ended by the MotionNet's product; the next is the backward's wait
    # for its first node
    (first, ending, caller, _), second = sp["idle_gaps"][:2]
    assert first == pytest.approx(1e-3)
    assert (ending, caller) == ("nemo.net.motion", "aten::addmm")
    assert second[1:3] == ["nemo.net.motion", "aten::mm"]


def test_device_annotations_and_port_spans_leave_the_records_alone():
    """A record_function's range on the device's timeline is no device
    operation; the port's spans, host events only, leave the harness's
    record of the parent's events as it was, but for the names of the
    idle gaps, which now name the span open at each."""
    parent = stretch(spans_on=False)
    port = stretch()
    annotated = stretch()
    annotated.kernel("user.region", 1000, 2000, 999, annotation=True)
    annotated.kernel(MARK, 1000, 3000, 998, annotation=True)
    base = reduce_events(parent.events, 2)
    for t in (port,):
        rec = reduce_events(t.events, 2)
        for key in ("steps", "window_us", "kernels", "launches", "busy_us"):
            assert rec[key] == base[key], key
        assert rec["breakdown"]["device_ops"] == \
            base["breakdown"]["device_ops"]
        assert not any(n.startswith("nemo.")
                       for n, _ in rec["breakdown"]["device_ops"])
    assert spans.reduce_spans(annotated.events, 2) == \
        spans.reduce_spans(port.events, 2)


def test_tool_on_the_cpu(tmp_path, capsys):
    """tools/spans.py traces the cell's stretch at its small traffic on
    the CPU: one step span a traced step, the layer spans, no device
    operation."""
    import importlib.util
    import json
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "spans.py")
    spec = importlib.util.spec_from_file_location("portbench_tool_spans",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = str(tmp_path / "spans.jsonl")
    assert tool.main(["--workload", "cv_47x600", "--seed", str(2 ** 31 + 9),
                      "--device", "cpu", "--small", "--out", out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out) as f:
        assert json.loads(f.read()) == line
    sp = line["spans"]
    assert sp["step_spans"] == sp["steps"] == 2
    assert {"nemo.net.motion", "nemo.body.smpl", "nemo.prior.v2v",
            "nemo.loss.keypoints", "nemo.fit.optimizer"} <= set(sp["spans"])
    assert sp["device_us"] == 0
    assert set(line["readings"]) == set(spans.READINGS) | {
        "host_ms_per_step.fit"}
