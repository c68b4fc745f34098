"""VPoser training in the port against nemo_tpu on the CPU: the train-mode
batch norm with its running statistics, the training encoder, the geodesic
distance, vposer_train_loss (its terms and gradients, with and without the
extra terms, with and without a body model), a train step from JAX's state
after 3 steps through the state converters, a 2-epoch train_vposer, the
AMASS readers and the one-rank mesh.

Both packages start from JAX's init_vposer weights (a 64-wide VPoser) and
get the same numpy inputs; the body is the 96-vertex synthetic SMPL. The
rsample draw cannot be matched across RNGs, so the port is given JAX's own
draws: jax.random.normal on the key JAX's step is handed. Tolerances,
relative to the largest entry of what is compared: batch norm and encoder
1e-5; loss terms 2e-5 (fit_loss's house tolerance) and gradients 3e-4 in
f32 (each package's own distance from the exact gradient: 1e-4 for the
port's, 3e-4 for JAX's), both 1e-10 in f64; a step's updated tensors and moments 1e-4;
train_vposer's history 1e-4, its parameters a tenth of Adam's rate.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.priors import vposer as jvp
from nemo_tpu.priors import vposer_train as jvt
from nemo_tpu.utils.checkpoint import _flatten_with_paths
from nemo_tpu_torch import priors as tpriors
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.body.smpl import _TENSOR_FIELDS
from nemo_tpu_torch.priors import vposer_train as tvt

torch.set_num_threads(2)
VP = jvp.VPoserConfig(num_neurons=64)
LATENT = VP.latent_dim
CFG = jvt.VPoserTrainConfig(batch_size=16,
                            keep_extra_loss_terms_until_epoch=1)
TCFG = tvt.VPoserTrainConfig(**{f: getattr(CFG, f) for f in
                                CFG.__dataclass_fields__})


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


def jax_params(seed=0):
    """JAX's init_vposer weights with non-trivial running statistics."""
    p = jvp.init_vposer(jax.random.PRNGKey(seed), VP)
    rng = np.random.RandomState(seed + 100)
    for name, n in (("bn0", 63), ("bn1", VP.num_neurons)):
        p[f"{name}_mean"] = jnp.asarray(0.1 * rng.randn(n), jnp.float32)
        p[f"{name}_var"] = jnp.asarray(0.5 + rng.rand(n), jnp.float32)
        p[f"{name}_gamma"] = jnp.asarray(1 + 0.1 * rng.randn(n), jnp.float32)
        p[f"{name}_beta"] = jnp.asarray(0.1 * rng.randn(n), jnp.float32)
    return p


def numpy_of(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def torch_of(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def poses(n, seed):
    return (0.3 * np.random.RandomState(seed).randn(n, 63)).astype(np.float32)


# ---------------------------------------------------------------------------
# the pieces


def test_bn_train_with_running_stats():
    rng = np.random.RandomState(1)
    x = (2.0 + rng.randn(16, 40)).astype(np.float32)
    mean, var = rng.randn(40).astype(np.float32), \
        (0.5 + rng.rand(40)).astype(np.float32)
    gamma, beta = rng.randn(40).astype(np.float32), \
        rng.randn(40).astype(np.float32)
    want = jvt._bn_train(*map(jnp.asarray, (x, mean, var, gamma, beta)), 0.1)
    got = tvt._bn_train(*map(torch.from_numpy, (x, mean, var, gamma, beta)),
                        0.1)
    for g, w, what in zip(got, want, ("out", "mean", "var")):
        _close(g, w, 1e-5, what)
    # normalised with the biased variance, the running one the unbiased
    v = x.var(axis=0, dtype=np.float64)
    np.testing.assert_allclose(got[2].numpy(),
                               0.9 * var + 0.1 * v * 16 / 15, rtol=1e-5)


def test_encode_train():
    p = jax_params(2)
    x = poses(16, 3)
    mu, scale, stats = jvt.vposer_encode_train(p, jnp.asarray(x), 0.1)
    tmu, tscale, tstats = tvt.vposer_encode_train(torch_of(p),
                                                  torch.from_numpy(x), 0.1)
    _close(tmu, mu, 1e-5, "mu")
    _close(tscale, scale, 1e-5, "scale")
    assert sorted(tstats) == sorted(stats)
    for k in stats:
        _close(tstats[k], stats[k], 1e-5, k)


def test_geodesic_distance():
    from nemo_tpu.geometry import batch_rodrigues as jrod
    rng = np.random.RandomState(4)
    a, b = (rng.randn(2, 50, 3) * 0.8).astype(np.float32)
    b[:5] = a[:5]                    # identical rotations: clipped at 1
    R1, R2 = np.asarray(jrod(jnp.asarray(a))), np.asarray(jrod(jnp.asarray(b)))
    want = jvt.geodesic_distance(jnp.asarray(R1), jnp.asarray(R2))
    got = tvt.geodesic_distance(torch.from_numpy(R1), torch.from_numpy(R2))
    _close(got, want, 1e-5, "geodesic")


LOSS_CASES = [("smpl", True), ("smpl", False), ("none", True),
              ("none", False)]


def _loss_pair(p, x, key, noise, body, extra, jsmpl, tsmpl, dtype):
    """(JAX's loss, metrics, stats and gradients; the port's loss, metrics,
    stats and parameters with their .grad) at one dtype."""
    js = jsmpl if body == "smpl" else None
    ts = tsmpl if body == "smpl" else None
    (loss, (metrics, stats)), grads = jax.jit(
        lambda p, x, k: jax.value_and_grad(jvt.vposer_train_loss,
                                           has_aux=True)(p, x, k, CFG, js,
                                                         extra))(
        p, jnp.asarray(x), key)
    tp = {k: torch.tensor(np.asarray(v), dtype=dtype).requires_grad_(True)
          for k, v in p.items()}
    tloss, (tmetrics, tstats) = tvt.vposer_train_loss(
        tp, torch.tensor(x, dtype=dtype), torch.tensor(noise, dtype=dtype),
        TCFG, ts, extra)
    tloss.backward()
    return (metrics, stats, grads), (tmetrics, tstats, tp)


def _hold(jax_side, port_side, term_rtol, grad_rtol):
    (metrics, stats, grads), (tmetrics, tstats, tp) = jax_side, port_side
    assert sorted(tmetrics) == sorted(metrics)
    for k in metrics:
        _close(tmetrics[k], metrics[k], term_rtol, k)
    for k in stats:
        _close(tstats[k], stats[k], term_rtol, k)
    for k, g in grads.items():
        tg = tp[k].grad
        if k in tvt._BN_STAT_KEYS:
            assert tg is None and not np.asarray(g).any(), k
            continue
        _close(tg, g, grad_rtol, f"grad {k}")


def _f64(tsmpl):
    return dataclasses.replace(tsmpl, **{
        f: getattr(tsmpl, f).double() for f in _TENSOR_FIELDS})


@pytest.mark.parametrize("body,extra", LOSS_CASES)
def test_train_loss_terms_and_gradients(bodies, body, extra):
    """In f32: every term and the new running statistics within 2e-5 of
    their largest entries (fit_loss's house tolerance). The gradients are
    held against the exact ones, the port's in f64 (equal to JAX's in f64:
    the next test): the port's within 1e-4 of each tensor's largest entry,
    JAX's (jitted, as its train step runs) within 3e-4, and so the two
    within 3e-4 of each other; the running statistics get none in either
    package."""
    jsmpl, tsmpl = bodies
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (16, LATENT)))
    p, x = jax_params(5), poses(16, 6)
    jax_side, port_side = _loss_pair(p, x, key, noise, body, extra, jsmpl,
                                     tsmpl, torch.float32)
    _, _, exact = _loss_pair(p, x, key, noise, body, extra, jsmpl,
                             _f64(tsmpl), torch.float64)[1]
    _hold(jax_side, port_side, 2e-5, 3e-4)
    for k, g in jax_side[2].items():
        if k not in tvt._BN_STAT_KEYS:
            _close(port_side[2][k].grad, exact[k].grad, 1e-4, f"port {k}")
            _close(g, exact[k].grad, 3e-4, f"JAX {k}")


@pytest.mark.parametrize("body,extra", LOSS_CASES)
def test_train_loss_exact_in_f64(bodies, body, extra):
    """In f64 (JAX under enable_x64, the port's tensors and body in f64),
    the same function: every term, statistic and gradient within 1e-10
    of its largest entry."""
    jsmpl, tsmpl = bodies
    t64 = _f64(tsmpl)
    with jax.enable_x64(True):
        p = {k: jnp.asarray(np.asarray(v), jnp.float64)
             for k, v in jax_params(5).items()}
        key = jax.random.PRNGKey(7)
        noise = np.asarray(jax.random.normal(key, (16, LATENT)))
        assert noise.dtype == np.float64
        pair = _loss_pair(p, poses(16, 6).astype(np.float64), key, noise,
                          body, extra, jsmpl, t64, torch.float64)
    _hold(*pair, 1e-10, 1e-10)


# ---------------------------------------------------------------------------
# a step, the state converters, train_vposer


def jax_steps(p, smpl, n, seed=0):
    """n JAX train steps on batches of poses(16, seed + i), each with the
    key split from PRNGKey(seed) as train_vposer splits it: (params,
    opt_state, the last batch's key)."""
    opt, step = jvt.make_vposer_train_step(CFG, smpl, True)
    state = opt.init(p)
    key = jax.random.PRNGKey(seed)
    for i in range(n):
        key, k = jax.random.split(key)
        p, state, _ = step(p, state, jnp.asarray(poses(16, seed + i)), k)
    return p, state


def test_state_converters_round_trip(bodies):
    """JAX's state after 3 steps into the port and back: bit for bit,
    the running statistics' moments zeros."""
    jsmpl, _ = bodies
    p, state = jax_steps(jax_params(8), jsmpl, 3)
    flat = _flatten_with_paths(state)
    assert "0/.count" in flat and "0/.mu/enc_w1" in flat
    tp, opt = tvt.vposer_train_state_from_jax(numpy_of(p), flat)
    assert opt.count == 3
    back_p, back_o = tvt.vposer_train_state_to_jax(tp, opt)
    assert sorted(back_p) == sorted(p) and sorted(back_o) == sorted(flat)
    for k in p:
        np.testing.assert_array_equal(back_p[k], np.asarray(p[k]), k)
    for k in flat:
        np.testing.assert_array_equal(back_o[k], flat[k], k)
    assert not back_o["0/.mu/bn0_mean"].any()


@pytest.mark.parametrize("extra", [True, False])
def test_step_from_jax_state(bodies, extra):
    """One step of each package from JAX's state after 3 steps, with
    JAX's draw: every metric within 2e-5, every parameter (the running
    statistics too) and Adam moment within 1e-4 of its largest entry (the
    f32 gradients' own noise, 1e-5 to 6e-5, moves Adam's normalised update
    by up to 3e-5 of a weight's largest entry)."""
    jsmpl, tsmpl = bodies
    p, state = jax_steps(jax_params(9), jsmpl, 3)
    tp, opt = tvt.vposer_train_state_from_jax(numpy_of(p),
                                              _flatten_with_paths(state))
    x = poses(16, 50)
    key = jax.random.PRNGKey(51)
    _, jstep = jvt.make_vposer_train_step(CFG, jsmpl, extra)
    jp, jstate, jm = jstep(p, state, jnp.asarray(x), key)
    _, tstep = tvt.make_vposer_train_step(TCFG, tsmpl, extra)
    tp, opt, tm = tstep(tp, opt, torch.from_numpy(x),
                        torch.from_numpy(np.asarray(
                            jax.random.normal(key, (16, LATENT)))))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k], jm[k], 2e-5, k)
    got_p, got_o = tvt.vposer_train_state_to_jax(tp, opt)
    for k in jp:
        _close(got_p[k], jp[k], 1e-4, k)
    want_o = _flatten_with_paths(jstate)
    assert int(got_o["0/.count"]) == int(want_o["0/.count"]) == 4
    for k, v in want_o.items():
        if k != "0/.count":
            _close(got_o[k], v, 1e-4, k)


def jax_draws(seed, n):
    """The draws JAX's train_vposer takes, in order."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k, (CFG.batch_size,
                                                    LATENT))))
    return out


@pytest.mark.parametrize("body", ["smpl", "none"])
def test_train_vposer_two_epochs(bodies, body):
    """2 epochs of 3 batches (the remainder dropped; the extra terms only
    in epoch 0) with JAX's draws injected: the history within 1e-4
    relative; every trained entry within a tenth of the rate lr of JAX's
    (six young Adam steps each move an entry by about lr whatever its
    gradient's size, so an entry whose gradient is f32 noise in both
    packages can part by a few percent of lr); the caller's parameters
    untouched."""
    jsmpl, tsmpl = bodies
    js, ts = (jsmpl, tsmpl) if body == "smpl" else (None, None)
    p = jax_params(10)
    data = poses(56, 11)
    jp, jhist = jvt.train_vposer(p, data, CFG, num_epochs=2, seed=3,
                                 smpl=js)
    draws = iter(jax_draws(3, 6))
    start = torch_of(p)
    tp, thist = tvt.train_vposer(start, data, TCFG, num_epochs=2, seed=3,
                                 smpl=ts,
                                 draw=lambda shape: torch.from_numpy(
                                     next(draws)))
    assert next(draws, None) is None
    assert sorted(thist) == sorted(jhist)
    for k, v in jhist.items():
        assert thist[k].shape == v.shape, k
        np.testing.assert_allclose(thist[k], v, rtol=1e-4, err_msg=k)
    assert len(thist["matrot"]) == 1 and len(thist["v2v"]) == 2
    for k in jp:
        err = float(np.abs(tp[k].numpy() - np.asarray(jp[k])).max())
        assert err <= 0.1 * CFG.lr, (k, err)
    for k in p:
        np.testing.assert_array_equal(start[k].numpy(), np.asarray(p[k]))


def test_train_vposer_default_draws_and_refusals(bodies):
    """The default draw is seeded: two runs agree bit for bit, another
    seed does not. Fewer poses than a batch, where JAX's loop leaves its
    metrics unbound, is a ValueError naming the batch size; a one-rank
    mesh= (no process group) trains bit for bit as without one (the
    two-rank mesh is tests/test_torch_port_parallel.py's)."""
    p = torch_of(jax_params(12))
    data = poses(40, 13)
    runs = [tvt.train_vposer(p, data, TCFG, num_epochs=1, seed=s)
            for s in (4, 4, 5)]
    for k in runs[0][0]:
        assert torch.equal(runs[0][0][k], runs[1][0][k])
    assert not torch.equal(runs[0][0]["enc_w1"], runs[2][0]["enc_w1"])
    assert np.isfinite(runs[0][1]["loss_total"]).all()
    with pytest.raises(ValueError, match="batch_size 16"):
        tvt.train_vposer(p, data[:10], TCFG)
    from nemo_tpu_torch.parallel import make_mesh
    meshed = tvt.train_vposer(p, data, TCFG, num_epochs=1, seed=4,
                              mesh=make_mesh())
    for k in runs[0][0]:
        assert torch.equal(runs[0][0][k], meshed[0][k]), k
    for k in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][k], meshed[1][k])


# ---------------------------------------------------------------------------
# the AMASS readers


def _amass_tree(root, rng):
    """Two datasets of a few subjects, sequences of 3 to 200 frames (the
    shortest keep no frame)."""
    for ds, subjects in (("CMU", ("01", "02")), ("KIT", ("05",))):
        for s in subjects:
            d = os.path.join(root, ds, s)
            os.makedirs(d)
            for i, n in enumerate((200, 3, 77)):
                np.savez(os.path.join(d, f"{s}_{i:02d}_poses.npz"),
                         poses=rng.randn(n, 156).astype(np.float32),
                         trans=rng.randn(n, 3).astype(np.float32))


def test_prepare_vposer_dataset_matches_jax(tmp_path):
    from nemo_tpu.data.sharded import ShardedDataset as JDS
    from nemo_tpu_torch.data.sharded import ShardedDataset as TDS
    amass = str(tmp_path / "amass")
    _amass_tree(amass, np.random.RandomState(0))
    splits = {"train": ["CMU"], "vald": ["KIT"], "test": ["none"]}
    out = {}
    for name, mod in (("jax", jvt), ("port", tvt)):
        out[name] = str(tmp_path / name)
        counts = mod.prepare_vposer_dataset(out[name], splits, amass,
                                            keep_rate=0.3, seed=2,
                                            shard_size=50)
        out[name + " counts"] = counts
    assert out["port counts"] == out["jax counts"]
    assert out["jax counts"]["test"] == 0
    for split in ("train", "vald"):
        a, b = (sorted(os.listdir(os.path.join(out[n], split)))
                for n in ("jax", "port"))
        assert a == b and len(a) > 2
        jd, td = JDS(os.path.join(out["jax"], split)), \
            TDS(os.path.join(out["port"], split))
        assert len(jd) == len(td) == out["jax counts"][split]
        for name in a:
            if name.endswith(".npz"):
                with np.load(os.path.join(out["jax"], split, name)) as f, \
                        np.load(os.path.join(out["port"], split, name)) as g:
                    assert sorted(f.files) == sorted(g.files)
                    for k in f.files:
                        np.testing.assert_array_equal(g[k], f[k])


def test_load_amass_pose_data_matches_jax(tmp_path):
    amass = str(tmp_path / "amass")
    _amass_tree(amass, np.random.RandomState(1))
    paths = sorted(str(p) for p in (tmp_path / "amass").rglob("*.npz"))
    for cap in (None, 10):
        want = jvt.load_amass_pose_data(paths, cap)
        got = tvt.load_amass_pose_data(paths, cap)
        assert got.dtype == np.float32 and got.shape[1] == 63
        np.testing.assert_array_equal(got, want)


def test_priors_exports():
    for name in ("VPoserTrainConfig", "load_amass_pose_data",
                 "make_vposer_train_step", "prepare_vposer_dataset",
                 "train_vposer", "vposer_train_loss", "IKConfig", "ik_fit"):
        assert getattr(tpriors, name) is not None, name
        assert name in tpriors.__all__
