"""VIBE training in the port against nemo_tpu on the CPU: the motion
discriminator, the loss terms and their gradients, a 5-step train-step
trajectory, evaluate_vibe, the plateau scale, checkpoints both ways, and
the vibe_train and vibe_eval CLIs.

Every comparison starts both packages from the same weights: JAX's train
state, drawn by jax.random and carried into the port with
``vibe_train_state_from_jax`` (its four flat dicts, as a checkpoint holds
them). The networks are small (features 32, B 3, T 5, a 32-wide
discriminator GRU, both pools, 1 and 2 GRU layers, the 96-vertex synthetic
body) except where a CLI fixes them. Tolerances, each relative to the
largest entry of what is compared: discriminator logits 1e-5; every loss
term 2e-5 (fit_loss's house tolerance); gradients 1e-4 of each tensor's
largest entry (or of 1e-4 of the loss's largest gradient entry, where
that is larger: _grads_close); trajectory losses 1e-4 for 5 steps; evaluate_vibe 5e-5;
checkpoints bit for bit. Dropout cannot be matched across RNGs: the port's
is tested by its keep rate and scaling, drawn from an explicit generator.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.models import vibe_train as jvt
from nemo_tpu.models.hmr import init_hmr_head as jinit_head
from nemo_tpu.models.vibe import init_gru as jinit_gru
from nemo_tpu.utils.checkpoint import _flatten_with_paths
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.models import vibe_train as tvt

F, B, T, RNN = 32, 3, 5, 32
W = jvt.VibeLossWeights()
POOLS = [("concat", 1), ("concat", 2), ("attention", 1), ("attention", 2)]


def _close(got, want, rtol, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


@pytest.fixture(scope="module")
def bodies():
    jsmpl = jax_synthetic_smpl(num_vertices=96, seed=0)
    return jsmpl, smpl_from_numpy(jsmpl)


def jax_state(seed, pool, layers, feat=F, rnn=RNN):
    """A JAX train state as init_vibe_train_state builds it, with a
    discriminator of rnn (init_vibe_train_state fixes 1024)."""
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    gen = {"gru": jinit_gru(k[0], feat, feat),
           "head": jinit_head(k[1], feat_dim=feat)}
    disc = jvt.init_motion_discriminator(
        k[2], rnn_size=rnn, feature_pool=pool, num_layers=layers,
        attention_size=rnn, attention_layers=layers + 1)
    return {"gen": gen, "disc": disc, "gen_opt": optax.adam(5e-5).init(gen),
            "disc_opt": optax.adam(1e-4).init(disc)}


def flat(state):
    return {k: _flatten_with_paths(v) for k, v in state.items()}


def make_batch(seed, b=B, t=T, feat=F):
    """A mixed batch: the first row 2D-only (zeroed 3D supervision and
    masks, as merge_2d3d_batch gives), confidences in [0, 1]."""
    rng = np.random.RandomState(seed)
    kp2d = rng.randn(b, t, 49, 3).astype(np.float32) * 0.5
    kp2d[..., 2] = rng.rand(b, t, 49)
    mask = np.ones((b, t), np.float32)
    mask[0] = 0
    batch = {"features": rng.randn(b, t, feat).astype(np.float32),
             "kp_2d": kp2d,
             "kp_3d": 0.2 * rng.randn(b, t, 14, 3).astype(np.float32),
             "pose": 0.2 * rng.randn(b, t, 72).astype(np.float32),
             "betas": 0.1 * rng.randn(b, t, 10).astype(np.float32),
             "has_3d": mask, "has_smpl": mask.copy()}
    for k in ("kp_3d", "pose", "betas"):
        batch[k][0] = 0
    return batch, 0.2 * rng.randn(b, t, 69).astype(np.float32)


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


TARGET_KEYS = ("kp_2d", "kp_3d", "pose", "betas", "has_3d", "has_smpl")


# ---------------------------------------------------------------------------
# discriminator


@pytest.mark.parametrize("pool,layers", POOLS)
def test_discriminator_logits(pool, layers):
    st = jax_state(1, pool, layers)
    disc = tvt.motion_discriminator_from_jax(flat(st)["disc"])
    assert disc.gru.num_layers == layers
    assert (disc.attention is not None) == (pool == "attention")
    seq = np.random.RandomState(2).randn(4, 6, 69).astype(np.float32)
    want = jax.jit(jvt.motion_discriminator)(st["disc"], jnp.asarray(seq))
    with torch.no_grad():
        got = disc(torch.from_numpy(seq))
    _close(got, want, 1e-5, "logits")


def test_discriminator_checks():
    with pytest.raises(ValueError, match="attention_size"):
        tvt.MotionDiscriminator(rnn_size=32, feature_pool="attention",
                                attention_size=64)
    with pytest.raises(ValueError, match="feature_pool"):
        tvt.MotionDiscriminator(feature_pool="mean")
    g = torch.Generator().manual_seed(0)
    d = tvt.init_motion_discriminator(g, rnn_size=16, num_layers=2,
                                      feature_pool="attention",
                                      attention_size=16, attention_layers=3)
    assert d.fc.in_features == 16 and len(d.attention.mlp) == 3
    assert torch.all(d.attention.mlp[0].bias == 0.01)
    assert float(d.attention.mlp[0].weight.detach().abs().max()) <= 0.1
    assert float(d.gru.weight_hh_l1.detach().abs().max()) <= 0.25
    assert tvt.init_motion_discriminator(
        g, rnn_size=16).fc.in_features == 32


def test_dropout_keep_rate_and_scale():
    """The attention pool's dropout: each value kept with probability
    1 - rate and scaled by 1 / (1 - rate), else 0; the draw is the
    generator's, so a seed repeats it and another seed does not."""
    x = torch.ones(400, 500)
    rate = 0.3
    out = tvt._dropout(x, rate, torch.Generator().manual_seed(0))
    kept = out != 0
    assert torch.all(out[kept] == 1.0 / (1.0 - rate))
    share = float(kept.float().mean())
    assert abs(share - (1.0 - rate)) < 0.005, share
    again = tvt._dropout(x, rate, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert not torch.equal(
        out, tvt._dropout(x, rate, torch.Generator().manual_seed(1)))

    disc = tvt.motion_discriminator_from_jax(
        flat(jax_state(3, "attention", 2))["disc"])
    seq = torch.from_numpy(
        np.random.RandomState(4).randn(2, 6, 69).astype(np.float32))
    with torch.no_grad():
        plain = disc(seq)
        assert torch.equal(plain, disc(seq, 0.5))   # no generator: off
        dropped = disc(seq, 0.5, torch.Generator().manual_seed(5))
    assert torch.isfinite(dropped).all() and not torch.equal(plain, dropped)


# ---------------------------------------------------------------------------
# losses and gradients


def _jax_gen_loss(gen, disc, batch, smpl):
    pred = jvt.vibe_predict(gen, smpl, jnp.asarray(batch["features"]))
    target = {k: jnp.asarray(batch[k]) for k in TARGET_KEYS}
    return jvt.vibe_generator_loss(pred, target, disc, W)


def _port_gen_loss(state, batch, smpl):
    b = as_torch(batch)
    pred = tvt.vibe_predict(state["gen"], smpl, b["features"])
    return tvt.vibe_generator_loss(pred, {k: b[k] for k in TARGET_KEYS},
                                   state["disc"], W)


@pytest.mark.parametrize("pool,layers", POOLS)
def test_generator_loss_terms(bodies, pool, layers):
    jsmpl, tsmpl = bodies
    st = jax_state(5, pool, layers)
    ts = tvt.vibe_train_state_from_jax(flat(st))
    batch, _ = make_batch(6)
    _, jm = jax.jit(lambda g, d: _jax_gen_loss(g, d, batch, jsmpl))(
        st["gen"], st["disc"])
    with torch.no_grad():
        _, tm = _port_gen_loss(ts, batch, tsmpl)
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k], jm[k], 2e-5, k)


@pytest.mark.parametrize("pool,layers", POOLS)
def test_discriminator_loss(pool, layers):
    st = jax_state(7, pool, layers)
    disc = tvt.motion_discriminator_from_jax(flat(st)["disc"])
    rng = np.random.RandomState(8)
    real = 0.2 * rng.randn(B, T, 69).astype(np.float32)
    fake = 0.2 * rng.randn(B, T, 69).astype(np.float32)
    want = jvt.vibe_discriminator_loss(st["disc"], jnp.asarray(real),
                                       jnp.asarray(fake))
    with torch.no_grad():
        got = tvt.vibe_discriminator_loss(disc, torch.from_numpy(real),
                                          torch.from_numpy(fake))
    _close(got, want, 2e-5, "disc loss")


def _grads_close(got, want_flat, tensors):
    """Each gradient within 1e-4 of its scale: its largest entry, or 1e-4
    of the loss's largest gradient entry where that is larger. The floor
    is for the attention pool's biases, whose gradients cancel to f32
    rounding (shifting every score leaves the softmax unchanged but for
    tanh's curvature): 3e-7 against 2.5 elsewhere, JAX's own value good to
    a few percent."""
    floor = 1e-4 * max(float(np.abs(v).max()) for v in want_flat.values())
    for (k, (_, transposed)), g in zip(tensors.items(), got):
        g = g.detach().numpy()
        g = g.T if transposed else g
        want = want_flat[k]
        assert g.shape == want.shape, k
        scale = max(float(np.abs(want).max()), floor)
        err = float(np.abs(g - want).max())
        assert err <= 1e-4 * scale, f"{k}: {err} > 1e-4 * {scale}"


@pytest.mark.parametrize("pool,layers", [("concat", 1), ("attention", 2)])
def test_gradients(bodies, pool, layers):
    """The generator loss's gradient into every generator tensor (the
    per-frame betas through K1b's plain version into the shape rows), and
    the discriminator loss's into every discriminator tensor."""
    jsmpl, tsmpl = bodies
    st = jax_state(9, pool, layers)
    ts = tvt.vibe_train_state_from_jax(flat(st))
    batch, real = make_batch(10)
    jg = jax.jit(jax.grad(
        lambda g: _jax_gen_loss(g, st["disc"], batch, jsmpl)[0]))(st["gen"])
    gen_t = tvt._gen_tensors(ts["gen"])
    loss, _ = _port_gen_loss(ts, batch, tsmpl)
    _grads_close(torch.autograd.grad(loss, [t for t, _ in gen_t.values()]),
                 _flatten_with_paths(jg), gen_t)

    fake = np.array(jax.jit(lambda g: jvt.vibe_predict(
        g, jsmpl, jnp.asarray(batch["features"]))["pose_body_seq"])(
            st["gen"]))
    jd = jax.jit(jax.grad(jvt.vibe_discriminator_loss))(
        st["disc"], jnp.asarray(real), jnp.asarray(fake))
    disc_t = tvt._disc_tensors(ts["disc"])
    d_loss = tvt.vibe_discriminator_loss(ts["disc"], torch.from_numpy(real),
                                         torch.from_numpy(fake))
    _grads_close(torch.autograd.grad(d_loss, [t for t, _ in disc_t.values()]),
                 _flatten_with_paths(jd), disc_t)


def test_train_step_trajectory(bodies, pool="attention", layers=2,
                               lr_scale=0.1):
    """Five make_vibe_train_step updates from the same state and batches,
    at a plateau scale of 0.1 (vibe_trainer_fit's 1.0 is run below): every
    loss term within 1e-4 at each step (Adam amplifies rounding
    differences in near-zero gradients, so parameters are not held)."""
    jsmpl, tsmpl = bodies
    st = jax_state(11, pool, layers)
    ts = tvt.vibe_train_state_from_jax(flat(st))
    jstep = jvt.make_vibe_train_step(jsmpl, W)
    tstep = tvt.make_vibe_train_step(tsmpl, W)
    for i in range(5):
        batch, real = make_batch(20 + i)
        st, jm = jstep(st, batch, real, lr_scale=jnp.float32(lr_scale))
        ts, tm = tstep(ts, batch, real, lr_scale=lr_scale)
        assert set(tm) == set(jm)
        for k in jm:
            _close(tm[k], jm[k], 1e-4, f"step {i} {k}")
    assert ts["gen_opt"].count == ts["disc_opt"].count == 5


def test_discriminator_train_step():
    """make_discriminator_train_step: five updates on fixed real and fake
    sequences, the losses within 1e-4 of JAX's."""
    st = jax_state(17, "concat", 2)
    rng = np.random.RandomState(18)
    real = 0.2 * rng.randn(B, T, 69).astype(np.float32)
    fake = 0.6 * rng.randn(B, T, 69).astype(np.float32)
    jopt, jstep = jvt.make_discriminator_train_step(lr=3e-3)
    init, tstep = tvt.make_discriminator_train_step(lr=3e-3)
    jp, js = st["disc"], jopt.init(st["disc"])
    disc = tvt.motion_discriminator_from_jax(flat(st)["disc"])
    opt = init(disc)
    for i in range(5):
        jp, js, jl = jstep(jp, js, real, fake)
        disc, opt, tl = tstep(disc, opt, torch.from_numpy(real),
                              torch.from_numpy(fake))
        _close(tl, jl, 1e-4, f"step {i}")
    with torch.no_grad():
        first = tvt.vibe_discriminator_loss(
            tvt.motion_discriminator_from_jax(flat(st)["disc"]),
            torch.from_numpy(real), torch.from_numpy(fake))
    assert opt.count == 5 and float(tl) < float(first)


def test_train_step_moves_every_tensor(bodies):
    """One step updates every generator tensor (the regressor's mean rows
    too) and every discriminator tensor, with a dropout generator."""
    _, tsmpl = bodies
    ts = tvt.vibe_train_state_from_jax(flat(jax_state(12, "attention", 2)))
    before = tvt.vibe_train_state_to_jax(ts)
    batch, real = make_batch(13)
    step = tvt.make_vibe_train_step(tsmpl, W, disc_dropout=0.2)
    ts, m = step(ts, batch, real, generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in m.values())
    after = tvt.vibe_train_state_to_jax(ts)
    for net in ("gen", "disc"):
        for k, v in before[net].items():
            assert not np.array_equal(v, after[net][k]), (net, k)


# ---------------------------------------------------------------------------
# evaluation and the epoch loop


def test_evaluate_vibe():
    rng = np.random.RandomState(14)
    gt = 0.3 * rng.randn(40, 14, 3)
    pred = gt * 1.1 + 0.05 * rng.randn(40, 14, 3)
    v_gt = rng.randn(40, 20, 3).astype(np.float32)
    v_pred = v_gt + 0.01 * rng.randn(40, 20, 3).astype(np.float32)
    want = jvt.evaluate_vibe(pred, gt, v_pred, v_gt)
    got = tvt.evaluate_vibe(pred, gt, v_pred, v_gt)
    assert list(got) == list(want) == ["mpjpe", "pa-mpjpe", "accel",
                                       "accel_err", "pve"]
    for k in want:
        _close(got[k], want[k], 5e-5, k)
    np.testing.assert_allclose(tvt.compute_accel(gt), jvt.compute_accel(gt),
                               rtol=5e-5)
    np.testing.assert_allclose(tvt.compute_error_accel(gt, pred),
                               jvt.compute_error_accel(gt, pred), rtol=5e-5)


def test_trainer_fit_plateau(monkeypatch):
    """Constant validation performance: with patience 1 both packages cut
    lr_scale by 0.1 at the same epochs (the twin ReduceLROnPlateau), and
    both stop after the first epoch when its MPJPE passes mpjpe_abort."""
    rng = np.random.default_rng(0)
    batch = {"features": rng.standard_normal((2, 3, 8)).astype(np.float32),
             "kp_3d": rng.standard_normal((2, 3, 14, 3)).astype(np.float32)}
    fake_pred = lambda gp, smpl, f, n_iter=3: {
        "kp_2d": np.zeros((2, 3, 49, 2)), "kp_3d": batch["kp_3d"]}

    class FakeSmpl:
        device = torch.device("cpu")

    seen = {}
    for name, mod in (("jax", jvt), ("port", tvt)):
        monkeypatch.setattr(mod, "vibe_predict", fake_pred)
        scales, logs = [], []

        def step_fn(state, b, real, lr_scale=None, _s=scales):
            _s.append(float(lr_scale))
            return state, {}

        mod.vibe_trainer_fit({"gen": {}}, step_fn, FakeSmpl(),
                             lambda: iter([batch]),
                             valid_batches=lambda: iter([batch]),
                             epochs=6, lr_patience=1, log_fn=logs.append)
        seen[name] = (scales, logs)
        # the performance > threshold abort (trainer.py:342): one epoch
        logs = []
        monkeypatch.setattr(mod, "vibe_predict", lambda gp, smpl, f: {
            "kp_3d": 1.5 * batch["kp_3d"]})
        mod.vibe_trainer_fit({"gen": {}}, lambda st, b, r: (st, {}),
                             FakeSmpl(), lambda: iter([batch]),
                             valid_batches=lambda: iter([batch]),
                             epochs=6, mpjpe_abort=1e-9, log_fn=logs.append)
        seen[name + " abort"] = logs
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == pytest.approx(
        [1.0, 1.0, 1.0, 0.1, 0.1, 0.01])
    assert seen["port abort"] == seen["jax abort"]
    assert len(seen["port abort"]) == 2 and "aborting" in \
        seen["port abort"][1]


def test_trainer_fit_against_jax(bodies, tmp_path):
    """vibe_trainer_fit over 2 epochs of 2 batches with validation (and
    the port's debug panel): the best metrics within 1e-4 of JAX's."""
    jsmpl, tsmpl = bodies
    st = jax_state(15, "concat", 1)
    ts = tvt.vibe_train_state_from_jax(flat(st))
    batches = [make_batch(30 + i)[0] for i in range(2)]
    reals = [make_batch(40 + i)[1] for i in range(3)]
    valid = [make_batch(50)[0]]
    runs = {}
    for name, mod, state, smpl, viz in (("jax", jvt, st, jsmpl, 0),
                                        ("port", tvt, ts, tsmpl, 1)):
        _, runs[name] = mod.vibe_trainer_fit(
            state, mod.make_vibe_train_step(smpl, W), smpl,
            lambda: iter(batches), lambda: iter(valid), lambda: iter(reals),
            epochs=2, log_fn=lambda s: None, debug_viz_every=viz,
            debug_viz_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["debug_epoch0000.png",
                                            "debug_epoch0001.png"]
    for k in runs["jax"]:
        _close(runs["port"][k], runs["jax"][k], 1e-4, k)


def test_trainer_fit_debug_panel_without_matplotlib(bodies, tmp_path,
                                                    monkeypatch, capsys):
    """debug_viz_every=1 where matplotlib is not installed: each epoch's
    panel is named as skipped, no file is written, and the epochs train
    through to the same best metrics as with no panel at all."""
    _, tsmpl = bodies
    batches = [make_batch(30 + i)[0] for i in range(2)]
    reals = [make_batch(40 + i)[1] for i in range(3)]
    valid = [make_batch(50)[0]]
    runs = {}
    for viz in (0, 1):
        state = tvt.vibe_train_state_from_jax(flat(jax_state(15, "concat",
                                                             1)))
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "matplotlib", None)
            _, runs[viz] = tvt.vibe_trainer_fit(
                state, tvt.make_vibe_train_step(tsmpl, W), tsmpl,
                lambda: iter(batches), lambda: iter(valid),
                lambda: iter(reals), epochs=2, log_fn=lambda s: None,
                debug_viz_every=viz, debug_viz_dir=str(tmp_path))
    out = capsys.readouterr().out
    for epoch in range(2):
        png = os.path.join(str(tmp_path), f"debug_epoch{epoch:04d}.png")
        assert f"matplotlib is not installed: skipped {png}" in out
    assert os.listdir(tmp_path) == []
    assert runs[1] == runs[0]


# ---------------------------------------------------------------------------
# checkpoints


@pytest.fixture(scope="module")
def trained(bodies):
    """Two train steps of each package from one JAX state: (JAX's state,
    the port's)."""
    jsmpl, tsmpl = bodies
    st = jax_state(16, "attention", 2)
    ts = tvt.vibe_train_state_from_jax(flat(st))
    jstep = jvt.make_vibe_train_step(jsmpl, W)
    tstep = tvt.make_vibe_train_step(tsmpl, W)
    for i in range(2):
        batch, real = make_batch(60 + i)
        st, _ = jstep(st, batch, real)
        ts, _ = tstep(ts, batch, real)
    return st, ts


def test_checkpoint_port_to_jax(trained, tmp_path):
    """The port's save_vibe_state read by JAX's load_vibe_state into a
    template of another draw: every leaf bit for bit the port's."""
    _, ts = trained
    tvt.save_vibe_state(str(tmp_path / "ck"), ts)
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "disc.npz", "disc_opt.npz", "gen.npz", "gen_opt.npz"]
    template = jax_state(99, "attention", 2)
    restored = flat(jvt.load_vibe_state(str(tmp_path / "ck"), template))
    want = tvt.vibe_train_state_to_jax(ts)
    for net in want:
        assert set(restored[net]) == set(want[net]), net
        for k, v in want[net].items():
            assert restored[net][k].dtype == v.dtype, (net, k)
            np.testing.assert_array_equal(restored[net][k], v,
                                          err_msg=f"{net} {k}")
    assert int(want["gen_opt"]["0/.count"]) == 2


def test_checkpoint_jax_to_port(bodies, trained, tmp_path):
    """JAX's save_vibe_state read by the port's load_vibe_state into a
    template of another draw, and written back by the port: both equal
    JAX's arrays bit for bit."""
    _, tsmpl = bodies
    st, _ = trained
    want = flat(st)
    jvt.save_vibe_state(str(tmp_path / "ck"), st)
    template = tvt.init_vibe_train_state(
        torch.Generator().manual_seed(3), tsmpl, feat_size=F,
        feature_pool="attention", disc_num_layers=2, attention_size=1024,
        attention_layers=3)
    ts = tvt.load_vibe_state(str(tmp_path / "ck"), template)
    assert ts["gen_opt"].count == ts["disc_opt"].count == 2
    # the template's 1024-wide discriminator took the checkpoint's shapes
    assert ts["disc"].gru.hidden_size == RNN
    got = tvt.vibe_train_state_to_jax(ts)
    for net in want:
        assert set(got[net]) == set(want[net]), net
        for k, v in want[net].items():
            np.testing.assert_array_equal(got[net][k], v,
                                          err_msg=f"{net} {k}")
    tvt.save_vibe_state(str(tmp_path / "back"), ts)
    for net in want:
        with np.load(tmp_path / "ck" / f"{net}.npz") as a, \
                np.load(tmp_path / "back" / f"{net}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_other_pool_template(bodies, trained, tmp_path):
    """A checkpoint of the attention pool restored into a concat template
    (vibe_eval's default state reading vibe_train's shipped-config
    checkpoint): the template's keys take the file's arrays, as JAX's
    _restore_tree does, and the generator is the checkpoint's."""
    _, tsmpl = bodies
    _, ts = trained
    tvt.save_vibe_state(str(tmp_path / "ck"), ts)
    template = tvt.init_vibe_train_state(torch.Generator().manual_seed(4),
                                         tsmpl, feat_size=F)
    got = tvt.vibe_train_state_to_jax(
        tvt.load_vibe_state(str(tmp_path / "ck"), template))
    want = tvt.vibe_train_state_to_jax(ts)
    assert set(got["disc"]) == {"gru/w_ih", "gru/w_hh", "gru/b_ih",
                                "gru/b_hh", "fc_w", "fc_b"}
    for k, v in got["disc"].items():
        np.testing.assert_array_equal(v, want["disc"][k])
    for k, v in want["gen"].items():
        np.testing.assert_array_equal(got["gen"][k], v)
