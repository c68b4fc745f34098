"""The port's profiler spans and launch counters (utils/trace.py) on the
CPU: a span is a shared no-op with no profiler; under one, a main-stage
step of a tiny NemoFitter records exactly its span set, nested as the
layers nest; a backward node of a product maps by (thread, sequence
number) to the forward operator that made it, inside its layer span;
and a kernel wrapper's counters read the same as before around a CPU
call, while ``launch`` counts and marks a launch."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nemo_tpu_torch.body.assets import synthetic_smpl_model
from nemo_tpu_torch.body.constants import SMPL_PARENTS
from nemo_tpu_torch.data.synthetic import synthetic_problem
from nemo_tpu_torch.fit import NemoConfig, NemoFitter, build_assets
from nemo_tpu_torch.ops import fk_compose, launch_counts, reset_launches
from nemo_tpu_torch.priors.gmm import synthetic_gmm_prior
from nemo_tpu_torch.priors.vposer import init_vposer
from nemo_tpu_torch.utils import trace

torch.set_num_threads(1)

STEP, FWD, BWD, OPT = ("nemo.fit.step", "nemo.fit.forward",
                       "nemo.fit.backward", "nemo.fit.optimizer")
NET = ["nemo.net.phase", "nemo.net.motion", "nemo.body.smpl",
       "nemo.loss.keypoints"]
# the main step's nemo spans in order, each with its nearest nemo parent,
# by model version (V3: the VPoser prior parted around K2, the instance
# codes, the GMM and the 3D loss)
FORWARD = {
    0: NET + ["nemo.prior.gmm"],
    2: NET + ["nemo.prior.gmm"],
    3: NET + ["nemo.prior.vposer", "nemo.prior.v2v", "nemo.prior.vposer",
              "nemo.prior.instance", "nemo.prior.gmm", "nemo.loss.3d"],
}


def _fitter(version: int) -> NemoFitter:
    smpl = synthetic_smpl_model(num_vertices=120, seed=0)
    bundle, _ = synthetic_problem(smpl, num_views=2, num_frames=6, seed=0)
    kw = dict(model_version=version, h_dim=16, monotonic_network_n_nodes=4,
              batch_size=8, full_batch=version == 3, label_type="gt",
              weight_gmm_loss=0.5)
    if version >= 2:
        kw.update(phase_rbf_dim=8, rbf_kernel="quadratic",
                  instance_code_size=4)
    if version == 3:
        kw.update(weight_vp_loss=0.1, weight_vp_z_loss=0.01,
                  weight_instance_loss=0.1, weight_3d_loss=0.1)
    cfg = NemoConfig(**kw)
    assets = build_assets(bundle, smpl, cfg, gmm=synthetic_gmm_prior(8),
                          vposer=init_vposer(
                              generator=torch.Generator().manual_seed(7)))
    return NemoFitter(cfg, assets, seed=0)


def _nemo_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("nemo."):
        p = p.cpu_parent
    return p


def _traced(fitter, steps: int):
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fitter.fit(steps, chunk=steps)
    return prof.events()


def test_span_is_a_shared_noop_with_no_profiler(monkeypatch):
    def no_record(*a, **k):
        raise AssertionError("a record was entered with no profiler")

    assert not torch.autograd._profiler_enabled()
    monkeypatch.setattr(trace, "_RECORD", no_record)
    a, b = trace.span("nemo.x"), trace.span("nemo.y", {"step": 3})
    assert a is b
    with a:
        pass


def test_span_is_a_function_scope_record():
    """Under a profiler a span is a host event of its name, not a user
    annotation (which the profiler would also draw on the device's
    timeline)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("nemo.test"):
            torch.ones(4).sum()
    (e,) = [e for e in prof.events() if e.name == "nemo.test"]
    assert not e.is_user_annotation
    assert any(c.name == "aten::sum" for c in e.cpu_children)


@pytest.mark.parametrize("version", [0, 2, 3])
def test_main_step_span_set(version):
    """Each main step records one nemo.fit.step carrying its index, around
    forward (the layer spans, in order), backward and optimizer; each fit
    chunk ends with one nemo.fit.metrics_copy outside the steps."""
    fitter = _fitter(version)
    fitter.fit(1, chunk=1)
    events = _traced(fitter, 2)
    nemo = sorted((e for e in events if e.name.startswith("nemo.")),
                  key=lambda e: e.time_range.start)
    got = [(e.name, getattr(_nemo_parent(e), "name", None)) for e in nemo]
    step = [(STEP, None), (FWD, STEP)] \
        + [(n, FWD) for n in FORWARD[version]] + [(BWD, STEP), (OPT, STEP)]
    assert got == step + step + [("nemo.fit.metrics_copy", None)]
    assert [e.kwinputs for e in nemo if e.name == STEP] == \
        [{"step": 1}, {"step": 2}]


def test_motion_backward_maps_to_its_forward_span():
    """A backward node of a matrix product carries the sequence number and
    thread of the forward operator that made it, and that operator lies
    inside a layer span, the MotionNet's inside nemo.net.motion: the walk
    that the benchmark's attribution makes (portbench/harness/spans.py)."""
    events = _traced(_fitter(2), 1)
    forward = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.fwd_thread:
            key = (e.thread, e.sequence_nr)
            if key not in forward or \
                    forward[key].time_range.start <= e.time_range.start:
                forward[key] = e
    nodes = [e for e in events if e.name in ("AddmmBackward0",
                                             "MmBackward0")
             and e.fwd_thread]
    assert nodes
    owners = set()
    for node in nodes:
        op = forward[(node.fwd_thread, node.sequence_nr)]
        assert op.name in ("aten::addmm", "aten::mm", "aten::matmul")
        p = _nemo_parent(op)
        owners.add(p.name)
    assert "nemo.net.motion" in owners
    # every product's node maps into a layer span, none to the step's own
    assert all(o.startswith(("nemo.net.", "nemo.body.", "nemo.loss.",
                             "nemo.prior.")) for o in owners), owners


def test_launch_counts_unchanged_around_a_cpu_call():
    """The plain CPU path launches no kernel: the counters read what they
    read before, key for key."""
    reset_launches()
    before = launch_counts()
    R = torch.eye(3).expand(2, 24, 3, 3).contiguous()
    t = torch.zeros(2, 24, 3)
    with profile(activities=[ProfilerActivity.CPU]):
        fk_compose(R, t, SMPL_PARENTS)
    fk_compose(R, t, SMPL_PARENTS)
    assert launch_counts() == before
    assert set(before) and not any(before.values())


def test_launch_counts_and_marks_a_launch():
    counts = {"k": 0}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.launch(counts, "k"):
            torch.ones(2).sum()
    assert counts == {"k": 1}
    assert [e.name for e in prof.events()
            if e.name.startswith("nemo.")] == ["nemo.ops.k"]
    with pytest.raises(RuntimeError):
        with trace.launch(counts, "k"):
            raise RuntimeError("the launch failed")
    assert counts == {"k": 1}
    with trace.launch(counts, "k"):
        pass
    assert counts == {"k": 2}
