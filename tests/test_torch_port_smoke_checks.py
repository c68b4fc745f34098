"""chip_smoke.py's fused-vs-plain MotionNet check (modes_agree with
gate_flips) on the CPU, with K6f's forward replaced by stand-ins.

On the CPU the fused mode's forward is ``ops.mlp.motion_net_mlp_plain``,
so a stand-in patched there is what both the fused fit_loss and
gate_flips read as the kernel, while the plain mode keeps its own products
(``networks.net_dot``). The check must pass on the true forward and on one
whose only change is a pre-activation at 0 rounded the other way (one
sample left out), and must fail on a forward that flips gates far from 0 in
one sample, or in more samples than GATE_FLIP_SHARE allows.
"""

import dataclasses

import pytest
import torch

import chip_smoke
from nemo_tpu_torch import fit as tfit
from nemo_tpu_torch.body.assets import synthetic_smpl_model
from nemo_tpu_torch.data.synthetic import synthetic_problem
from nemo_tpu_torch.ops import mlp

# 200 samples: GATE_FLIP_SHARE lets two of them go
BATCH = 200


def _fitter():
    smpl = synthetic_smpl_model(640, seed=1)
    bundle, _ = synthetic_problem(smpl, num_views=3, num_frames=24,
                                  warp_strength=0.4, seed=3)
    cfg = tfit.NemoConfig(
        model_version=2, h_dim=32, instance_code_size=4, phase_rbf_dim=16,
        rbf_kernel="linear", monotonic_network_n_nodes=10,
        phase_init="linear", batch_size=BATCH, label_type="gt")
    return chip_smoke.make_fitter(torch.device("cpu"), smpl, bundle, cfg,
                                  motion_mlp="fused")


def _stand_in(edit):
    """K6f's forward at 'highest' with edit(pre1) applied to the batch's
    first-layer pre-activations (the B = 1 anchor left as it is)."""
    def fwd(x, W1, b1, W2, b2, W3, b3, Wo, bo, precision="highest"):
        assert precision == "highest"
        pre1 = x @ W1 + b1
        if x.shape[0] > 1:
            pre1 = edit(pre1.clone())
        h1 = torch.relu(pre1)
        h2 = torch.relu(h1 @ W2 + b2)
        z = torch.relu(h2 @ W3 + b3)
        return z @ Wo + bo, h1, h2, z
    return fwd


def _trunk_input(fitter):
    """The trunk's input on modes_agree's batch, from the plain mode."""
    vi, fi = chip_smoke.agree_batch(fitter)
    inputs = []
    hook = fitter.params.motion.trunk.register_forward_pre_hook(
        lambda mod, args: inputs.append(args[0].detach()))
    try:
        with torch.no_grad():
            tfit.fit_loss(fitter.params, fitter.cfg, dataclasses.replace(
                fitter.assets, motion_mlp="plain"), vi, fi)
    finally:
        hook.remove()
    return inputs[0]


def _rows_seen_once(fitter, n):
    """n rows of modes_agree's batch whose (view, frame) no other row has
    (the batch draws with replacement)."""
    vi, fi = chip_smoke.agree_batch(fitter)
    keys = (vi * fitter.assets.num_frames + fi).tolist()
    rows = [r for r, k in enumerate(keys) if keys.count(k) == 1]
    assert len(rows) >= n
    return rows[:n]


def _agree(fitter):
    chip_smoke.modes_agree("test", fitter, "motion_mlp", ("plain", "fused"),
                           1e-5, 1e-4)


def test_modes_agree_passes_the_true_forward(capsys):
    _agree(_fitter())
    assert f"0 of {BATCH} samples left out" in capsys.readouterr().out


def test_modes_agree_leaves_out_a_flip_at_zero(monkeypatch, capsys):
    """One unit's plain pre-activation set to exactly 0 at one sample (its
    bias the negated product), and a stand-in that adds far less than the
    rounding bound to that unit: only that sample flips, it is left out,
    and the rest agree."""
    fitter = _fitter()
    trunk = fitter.params.motion.trunk
    x = _trunk_input(fitter)
    row, unit = _rows_seen_once(fitter, 1)[0], 0
    delta = 1e-9
    with torch.no_grad():
        trunk.b1[unit] = -(x @ trunk.W1)[row, unit]
        pre = (x @ trunk.W1 + trunk.b1)[:, unit]
        assert float(pre[row]) == 0.0
        assert int((pre.abs() < 1e3 * delta).sum()) == 1

    def nudge(pre1):
        pre1[:, unit] += delta
        return pre1

    monkeypatch.setattr(mlp, "motion_net_mlp_plain", _stand_in(nudge))
    _agree(fitter)
    assert f"1 of {BATCH} samples left out" in capsys.readouterr().out


def test_modes_agree_fails_a_flip_far_from_zero(monkeypatch):
    """A stand-in that negates the largest pre-activation of one sample:
    one sample flips (within the count), but outside its rounding bound."""
    def negate_one(pre1):
        u = int(pre1[0].abs().argmax())
        pre1[0, u] = -pre1[0, u]
        return pre1

    monkeypatch.setattr(mlp, "motion_net_mlp_plain", _stand_in(negate_one))
    with pytest.raises(AssertionError, match="rounding bound"):
        _agree(_fitter())


def test_modes_agree_fails_many_flipped_samples(monkeypatch):
    """A stand-in wrong for a few units in every sample, each flip within
    the bound the wrong activations allow downstream but the first layer's
    far outside it: the check fails and keeps no shrunken batch."""
    def negate_units(pre1):
        pre1[:, :4] = -pre1[:, :4]
        return pre1

    monkeypatch.setattr(mlp, "motion_net_mlp_plain", _stand_in(negate_units))
    with pytest.raises(AssertionError, match="gate"):
        _agree(_fitter())


def test_gate_flip_count_is_bounded(monkeypatch):
    """Flips within their rounding bound in more samples than
    GATE_FLIP_SHARE allows: the check fails on the count alone."""
    fitter = _fitter()
    trunk = fitter.params.motion.trunk
    x = _trunk_input(fitter)
    n = int(chip_smoke.GATE_FLIP_SHARE * BATCH) + 1
    rows = _rows_seen_once(fitter, n)
    # units 0..n-1 each exactly 0 at one sample of its own
    with torch.no_grad():
        for u, r in enumerate(rows):
            trunk.b1[u] = -(x @ trunk.W1)[r, u]
        pre = x @ trunk.W1 + trunk.b1
        assert all(float(pre[r, u]) == 0.0 for u, r in enumerate(rows))
        assert int((pre[:, :n].abs() < 1e-6).any(1).sum()) == n

    def nudge(pre1):
        pre1[:, :n] += 1e-9
        return pre1

    monkeypatch.setattr(mlp, "motion_net_mlp_plain", _stand_in(nudge))
    with pytest.raises(AssertionError, match=f"{n} of {BATCH} samples"):
        chip_smoke.modes_agree("test", fitter, "motion_mlp",
                               ("plain", "fused"), 1e-5, 1e-4)
