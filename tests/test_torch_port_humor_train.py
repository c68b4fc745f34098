"""The HuMoR trainer steps in the port against nemo_tpu on the CPU:
make_humor_full_train_step over three steps (supervised, with and without
weight decay, and scheduled sampling), each with a step past a MultiStepLR
milestone and a NaN batch that the step skips; make_humor_train_step and
humor_train_loss; the Adam state's round trip from and to JAX in both
layouts; GroupAdam's gate.

Both packages start from JAX's state after three warm JAX steps from
init_humor (the reference widths), carried across by
humor_train_state_from_jax, so Adam's moments are past their first steps
(a first step's update is the gradient's sign, which f32 noise can flip
where a gradient entry is near 0). The port is given JAX's draws:
jax.random.normal on the posterior keys and jax.random.bernoulli on the
coin key JAX's step splits from its key. Batches are 16 windows of 4
transitions.

Tolerances: each step's stats within rtol 1e-5 (grad_norm too), lr and
update_skipped equal; the skipped step leaves the parameters bit for bit;
the state converters bit for bit. After the steps every parameter and
Adam moment is held within 1e-6 of its tensor's largest entry in float64
(JAX under enable_x64, the port's tensors in f64; Adam's bias correction
then in f64 in both), and within 1e-5 in float32: the two f32 gradients
differ by about 1e-6 of each tensor's largest entry (XLA's and torch's
summation orders), which Adam's normalisation carries into the updated
tensors, so 1e-6 is f32's noise floor here, not a margin (the f32 cases
fail at 1e-6). Steps on carried predictions are held in float64 only: in
f32 the two packages' predictions part by some 1e-6, and a ReLU gate
that this flips moves a whole GroupNorm group's gradient for its
transition (scripts/torch_humor_grad_spread.py); in f32 the scheduled
steps take the GT past at every transition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.models import humor as jh
from nemo_tpu.models import humor_loss as jl
from nemo_tpu.utils.checkpoint import _flatten_with_paths
from nemo_tpu_torch import models as tmodels
from nemo_tpu_torch.fit.optimizer import GroupAdam
from nemo_tpu_torch.models import humor as th
from nemo_tpu_torch.models import humor_loss as tl

torch.set_num_threads(2)
CFG = jh.HumorConfig()
TCFG = th.HumorConfig()
L = CFG.latent_size
D = jh.STATE_DIM
STAT_RTOL = 1e-5
STATE_RTOL = {"f32": 1e-5, "f64": 1e-6}
DTYPES = {"f32": (np.float32, torch.float32),
          "f64": (np.float64, torch.float64)}
B_WIN, T_WIN = 16, 4


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rtol, what=""):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def numpy_tree(p):
    return {m: {k: np.asarray(v) for k, v in sub.items()}
            for m, sub in p.items()}


def windows(seed, B, T, scale=0.3, dtype="f32"):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T + 1, D)) * scale).astype(
        DTYPES[dtype][0])


def feed(win, scheduled):
    """(x_past, x_t) as the CLI cuts a window batch."""
    if scheduled:
        return win[:, :-1], win[:, 1:]
    return (win[:, :-1].reshape(-1, D), win[:, 1:].reshape(-1, D))


def jax_draws(key, scheduled, use_gt_p, B, T, dtype="f32"):
    """The draws JAX's step takes from key, as the port's step takes
    them."""
    tdt = DTYPES[dtype][1]
    if not scheduled:
        return torch.as_tensor(np.asarray(
            jax.random.normal(key, (B * T, L))), dtype=tdt)
    k_coin, k_eps = jax.random.split(key)
    # JAX's step draws its coins against a float32 probability (a uniform
    # in float32, under enable_x64 too)
    coins = np.asarray(jax.random.bernoulli(
        k_coin, jnp.asarray(use_gt_p, jnp.float32), (T,)))
    eps = np.stack([np.asarray(jax.random.normal(k, (B, L)))
                    for k in jax.random.split(k_eps, T)])
    return torch.from_numpy(coins), torch.as_tensor(eps, dtype=tdt)


MODES = {  # name -> (scheduled sampling's start and end epochs, decay)
    "supervised": (None, 0.0),
    "supervised_decay": (None, 1e-3),
    # GT probability 1 at epoch 0, 0.5 at epoch 1: carried predictions
    "scheduled": ((0, 2), 0.0),
    # GT probability 1 at epochs 0 and 1: every step on the GT past
    "scheduled_gt": ((2, 4), 0.0),
}
LCFG = jl.HumorLossConfig(kl_loss=4e-4, contacts_vel_loss=0.05)
SS = dict(sched_samp_start=0, sched_samp_end=2)


def _steps(mode):
    ss, wd = MODES[mode]
    scheduled = ss is not None
    kw = dict(lr=1e-4, weight_decay=wd, sched_milestones=(1,),
              sched_decay=0.1, **(dict(sched_samp_start=ss[0],
                                       sched_samp_end=ss[1])
                                  if scheduled else {}))
    j = jl.make_humor_full_train_step(CFG, LCFG, **kw)
    t = tl.make_humor_full_train_step(
        TCFG, tl.HumorLossConfig(**LCFG.__dict__), **kw)
    return scheduled, j, t


def jax_warm_state(j_init, j_step, scheduled, dtype="f32", seed=0, n=3):
    p = jh.init_humor(jax.random.PRNGKey(seed), CFG)
    p = jax.tree.map(lambda a: jnp.asarray(a, DTYPES[dtype][0]), p)
    state = j_init(p)
    for i in range(n):
        x_past, x_t = feed(windows(100 + i, B_WIN, T_WIN, dtype=dtype),
                           scheduled)
        p, state, _ = j_step(p, state, jnp.asarray(x_past),
                             jnp.asarray(x_t), jax.random.PRNGKey(200 + i),
                             0)
    return p, state


@pytest.mark.parametrize("mode,dtype", [
    ("supervised", "f32"), ("supervised_decay", "f32"),
    ("scheduled_gt", "f32"), ("supervised", "f64"), ("scheduled", "f64")])
def test_full_train_step_three_steps(mode, dtype):
    """Steps at epochs 0, 1 (a NaN batch) and 1: the milestone at epoch 1
    cuts lr tenfold; the NaN step is skipped in both packages (count up,
    moments decayed, parameters bit for bit)."""
    scheduled, (j_init, j_step), (t_init, t_step) = _steps(mode)
    with jax.enable_x64(dtype == "f64"):
        jp, jstate = jax_warm_state(j_init, j_step, scheduled, dtype)
        tp, opt = th.humor_train_state_from_jax(
            numpy_tree(jp), _flatten_with_paths(jstate),
            dtype=DTYPES[dtype][1])
        assert opt.count == 3
        for i, (epoch, bad) in enumerate(((0, False), (1, True),
                                          (1, False))):
            win = windows(300 + i, B_WIN, T_WIN, dtype=dtype)
            if bad:
                win[1, 0, 5] = np.nan
            x_past, x_t = feed(win, scheduled)
            key = jax.random.PRNGKey(400 + i)
            jp, jstate, js = j_step(jp, jstate, jnp.asarray(x_past),
                                    jnp.asarray(x_t), key, epoch)
            before = {m: {k: v.detach().clone() for k, v in sub.items()}
                      for m, sub in tp.items()}
            ss = MODES[mode][0] or (0, 1)
            gt_p = tl.sched_samp_gt_p(epoch, *ss)
            tp, opt, ts = t_step(tp, opt, torch.from_numpy(x_past),
                                 torch.from_numpy(x_t), epoch,
                                 draws=jax_draws(key, scheduled, gt_p, B_WIN,
                                                 T_WIN, dtype))
            hs = tl.stats_to_host(ts)
            assert sorted(hs) == sorted(js)
            assert hs["update_skipped"] == float(js["update_skipped"]) == bad
            if dtype == "f32":
                assert hs["lr"] == float(js["lr"])
            if bad:
                for m, sub in tp.items():
                    for k, v in sub.items():
                        assert torch.equal(v, before[m][k]), (m, k)
                continue
            for k, v in js.items():
                _close(hs[k], v, STAT_RTOL, f"step {i} {k}")
        want_o = _flatten_with_paths(jstate)
    assert opt.count == 6
    got_p, got_o = th.humor_train_state_to_jax(tp, opt)
    assert sorted(got_o) == sorted(want_o)
    assert int(got_o[".count"]) == int(want_o[".count"]) == 6
    for m, sub in jp.items():
        for k, v in sub.items():
            _close(got_p[m][k], v, STATE_RTOL[dtype], f"{m}.{k}")
    for k, v in want_o.items():
        if k != ".count":
            _close(got_o[k], v, STATE_RTOL[dtype], k)


def test_full_train_step_draws_from_its_generator():
    """Without draws the step takes them from its generator: two ports
    seeded alike agree bit for bit, and the scheduled step's coins at
    GT probability 1 keep every step on the GT past (the loss equals the
    one with all coins true)."""
    p = th.humor_from_numpy(jh.init_humor(jax.random.PRNGKey(1), CFG))
    x_past, x_t = (torch.from_numpy(a) for a in feed(windows(5, 2, 3),
                                                      True))
    runs = []
    for _ in range(2):
        init, step = tl.make_humor_full_train_step(
            TCFG, tl.HumorLossConfig(), generator=torch.Generator()
            .manual_seed(7), **SS)
        q = {m: {k: v.clone() for k, v in sub.items()}
             for m, sub in p.items()}
        _, _, st = step(q, init(q), x_past, x_t, 0)
        runs.append((q, tl.stats_to_host(st)))
    assert runs[0][1] == runs[1][1]
    g = torch.Generator().manual_seed(7)
    coins, eps = tl.scheduled_draws(g, 1.0, 3, 2, L)
    assert bool(coins.all())
    with torch.no_grad():
        loss, _ = tl.humor_step_scheduled(p, TCFG, tl.HumorLossConfig(),
                                          x_past, x_t, coins, eps, 0)
    assert float(loss) == runs[0][1]["loss"]


def test_humor_train_loss_with_contacts():
    """humor_train_loss's reconstruction, KL and contact BCE and its
    gradients, with JAX's posterior draw."""
    jp = jh.init_humor(jax.random.PRNGKey(2), CFG)
    tp = th.humor_from_numpy(jp)
    rng = np.random.default_rng(6)
    past, tgt = (rng.standard_normal((4, D)) * 0.3).astype(np.float32), \
        (rng.standard_normal((4, D)) * 0.3).astype(np.float32)
    cg = (rng.random((4, 9)) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(8)
    (jv, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jh.humor_train_loss(p, CFG, jnp.asarray(past),
                                      jnp.asarray(tgt), key, 4e-4,
                                      jnp.asarray(cg)), has_aux=True))(jp)
    q = {m: {k: v.clone().requires_grad_(True) for k, v in sub.items()}
         for m, sub in tp.items()}
    tv, tm = th.humor_train_loss(q, TCFG, torch.from_numpy(past),
                                 torch.from_numpy(tgt),
                                 torch.from_numpy(np.asarray(
                                     jax.random.normal(key, (4, L)))),
                                 4e-4, torch.from_numpy(cg))
    assert sorted(tm) == sorted(jm) == ["contacts_bce", "kl", "loss", "rec"]
    for k in jm:
        _close(tm[k], jm[k], STAT_RTOL, k)
    leaves = th.humor_leaves(q)
    tg = torch.autograd.grad(tv, [q[m][k] for m, k in leaves])
    for (m, k), g in zip(leaves, tg):
        _close(g, jg[m][k], 1e-4, f"d/d {m}.{k}")


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_make_humor_train_step_from_jax_state(dtype):
    """One optax.adam step of each package from JAX's state after two:
    the metrics within 1e-5, every parameter and moment within the
    three-step test's tolerance, the state in optax.adam's '0/' layout."""
    npdt, tdt = DTYPES[dtype]
    opt, j_step = jh.make_humor_train_step(CFG, lr=1e-4)
    with jax.enable_x64(dtype == "f64"):
        jp = jax.tree.map(lambda a: jnp.asarray(a, npdt),
                          jh.init_humor(jax.random.PRNGKey(3), CFG))
        state = opt.init(jp)
        for i in range(2):
            x_past, x_t = feed(windows(500 + i, B_WIN, T_WIN, dtype=dtype),
                               False)
            jp, state, _ = j_step(jp, state, jnp.asarray(x_past),
                                  jnp.asarray(x_t), jax.random.PRNGKey(i))
        flat = _flatten_with_paths(state)
        assert "0/.count" in flat and "0/.mu/encoder/w0" in flat
        tp, topt = th.humor_train_state_from_jax(numpy_tree(jp), flat,
                                                 lr=1e-4, dtype=tdt)
        x_past, x_t = feed(windows(600, B_WIN, T_WIN, dtype=dtype), False)
        key = jax.random.PRNGKey(9)
        jp, state, jm = j_step(jp, state, jnp.asarray(x_past),
                               jnp.asarray(x_t), key)
        eps = torch.as_tensor(np.asarray(jax.random.normal(
            key, (B_WIN * T_WIN, L))), dtype=tdt)
        want_o = _flatten_with_paths(state)
    _, t_step = th.make_humor_train_step(TCFG, lr=1e-4)
    tp, topt, tm = t_step(tp, topt, torch.from_numpy(x_past),
                          torch.from_numpy(x_t), eps)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k], jm[k], STAT_RTOL, k)
    got_p, got_o = th.humor_train_state_to_jax(tp, topt, prefix="0/")
    assert sorted(got_o) == sorted(want_o) and int(got_o["0/.count"]) == 3
    for m, sub in jp.items():
        for k, v in sub.items():
            _close(got_p[m][k], v, STATE_RTOL[dtype], f"{m}.{k}")
    for k, v in want_o.items():
        if k != "0/.count":
            _close(got_o[k], v, STATE_RTOL[dtype], k)


@pytest.mark.parametrize("layout", ["scale_by_adam", "adam"])
def test_train_state_round_trip(layout):
    """JAX's Adam state into the port and back, bit for bit, in
    make_humor_full_train_step's layout and in optax.adam's."""
    p = jh.init_humor(jax.random.PRNGKey(4), CFG)
    rng = np.random.default_rng(7)
    if layout == "adam":
        import optax
        state, prefix = optax.adam(1e-4).init(p), "0/"
    else:
        state, prefix = jl.make_humor_full_train_step(CFG, LCFG)[0](p), ""
    flat = _flatten_with_paths(state)
    flat = {k: (np.asarray(7, np.int32) if k.endswith(".count") else
                rng.standard_normal(v.shape).astype(np.float32))
            for k, v in flat.items()}
    tp, opt = th.humor_train_state_from_jax(numpy_tree(p), flat)
    assert opt.count == 7
    back_p, back_o = th.humor_train_state_to_jax(tp, opt, prefix=prefix)
    assert sorted(back_o) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back_o[k], v, k)
    for m, sub in p.items():
        for k, v in sub.items():
            np.testing.assert_array_equal(back_p[m][k], np.asarray(v))


def test_group_adam_gate():
    """A false gate: the parameters keep their bits, the count rises and
    the moments decay as for a zero gradient; a true gate is the plain
    step."""
    torch.manual_seed(0)
    p0 = torch.randn(5, 3)
    runs = {}
    for name, gate in (("off", torch.tensor(False)),
                       ("on", torch.tensor(True)), ("plain", None)):
        p = p0.clone()
        opt = GroupAdam([p], 1e-2, weight_decay=0.1)
        p.grad = torch.ones_like(p)
        opt.step()
        p.grad = torch.full_like(p, float("nan")) if name == "off" \
            else torch.ones_like(p)
        before, m = p.clone(), opt.m[0].clone()
        opt.step(gate=gate)
        runs[name] = p.clone()
        if name == "off":
            assert torch.equal(p, before) and opt.count == 2
            assert torch.equal(opt.m[0], m * 0.9)
    assert torch.equal(runs["on"], runs["plain"])


def test_models_exports():
    for name in ("HumorLossConfig", "humor_full_loss", "humor_loss_terms",
                 "humor_step_scheduled", "kl_anneal_weight", "kl_normal",
                 "make_humor_full_train_step", "multistep_lr",
                 "sched_samp_gt_p", "gaussian_kl", "humor_single_step",
                 "humor_train_loss", "make_humor_train_step",
                 "humor_train_state_from_jax", "humor_train_state_to_jax",
                 "fit_state_prior_gmm", "save_state_prior_gmm",
                 "states_from_sequences", "humor_eval_full_test",
                 "humor_eval_metrics", "humor_eval_recon",
                 "humor_eval_sampling"):
        assert hasattr(tmodels, name), name
