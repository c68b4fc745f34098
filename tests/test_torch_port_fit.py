"""The port's fit against nemo_tpu's: losses, gradients, optimizer, slice.

Both sides get the same synthetic assets (the JAX bundle and model arrays,
converted) and the same starting parameters (JAX's init, carried across with
utils/checkpoint.params_from_numpy). The three-stage slice replays the JAX
fitter's batch stream into the port's fitter. Tolerances follow
tests/test_reference_twin.py: rtol 2e-5 on the loss, 5e-5 on metrics,
per-step losses within 1e-4 for the first 5 steps and 1e-3 after.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.data import synthetic_problem as jax_synthetic_problem
from nemo_tpu import fit as jfit
from nemo_tpu.fit.loop import _sample_batch
from nemo_tpu.fit.optimizer import plateau_init as j_plateau_init
from nemo_tpu.fit.optimizer import plateau_update as j_plateau_update
from nemo_tpu.priors import init_vposer as jax_init_vposer
from nemo_tpu.priors import synthetic_gmm_prior as jax_synthetic_gmm
from nemo_tpu.utils.checkpoint import _flatten_with_paths
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch import fit as tfit
from nemo_tpu_torch.fit.optimizer import GroupAdam, plateau_init, plateau_update
from nemo_tpu_torch.priors.gmm import gmm_from_numpy
from nemo_tpu_torch.utils.checkpoint import (params_from_numpy,
                                             params_to_numpy,
                                             vposer_from_numpy)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARMUP, CAM, MAIN = 3, 3, 6


@pytest.fixture(scope="module")
def problem():
    cfg = jfit.NemoConfig(
        model_version=2, h_dim=32, instance_code_size=4, phase_rbf_dim=8,
        rbf_kernel="quadratic", monotonic_network_n_nodes=4, batch_size=16,
        weight_vp_loss=10.0, weight_vp_z_loss=1.0, weight_gmm_loss=0.5,
        label_type="gt", lr_factor=0.5, n_steps=MAIN, warmup_step=WARMUP,
        opt_cam_step=CAM)
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    bundle, _ = jax_synthetic_problem(jm, num_views=2, num_frames=12, seed=0)
    gmm = jax_synthetic_gmm(4)
    vposer = jax_init_vposer(jax.random.PRNGKey(7))
    jassets = jfit.build_assets(bundle, jm, cfg, gmm=gmm, vposer=vposer)
    tcfg = tfit.NemoConfig(**dataclasses.asdict(cfg))
    tassets = tfit.build_assets(
        bundle, smpl_from_numpy(jm), tcfg,
        gmm=gmm_from_numpy(gmm.means, gmm.precisions, gmm.nll_weights),
        vposer=vposer_from_numpy({k: np.asarray(v) for k, v in
                                  vposer.items()}), device="cpu")
    params = jfit.init_params(jax.random.PRNGKey(0), cfg, jassets.num_views,
                              jassets.img_d0)
    return dict(cfg=cfg, tcfg=tcfg, jassets=jassets, tassets=tassets,
                params=params, bundle=bundle)


def _perturbed(params, seed=3, scale=0.05):
    """Move every parameter off its init (rotations off the identity)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.randn(*a.shape).astype(np.float32)), params)


def _port_params(pb, jparams):
    tp = tfit.init_params(pb["tcfg"], pb["tassets"].num_views,
                          pb["tassets"].img_d0)
    return params_from_numpy(tp, _flatten_with_paths(jparams))


def _batch(pb, seed=0, n=16):
    rng = np.random.RandomState(1000 + seed)
    return (rng.randint(0, 2, size=n).astype(np.int32),
            rng.randint(0, 12, size=n).astype(np.int32))


class TestConfigAndWeights:
    def test_config_fields_match(self):
        assert [f.name for f in dataclasses.fields(tfit.NemoConfig)] == \
            [f.name for f in dataclasses.fields(jfit.NemoConfig)]

    def test_params_roundtrip(self, problem):
        flat = _flatten_with_paths(problem["params"])
        tp = _port_params(problem, problem["params"])
        back = params_to_numpy(tp)
        assert sorted(back) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k], k)

    def test_missing_key_raises(self, problem):
        flat = _flatten_with_paths(problem["params"])
        del flat["motion/W_lin"]
        tp = tfit.init_params(problem["tcfg"], 2, problem["tassets"].img_d0)
        with pytest.raises(KeyError, match="motion.W_lin"):
            params_from_numpy(tp, flat)

    @pytest.mark.parametrize("field,value", [("weight_humor_loss", 1.0)])
    def test_unported_settings_raise(self, problem, field, value):
        cfg = dataclasses.replace(problem["tcfg"], **{field: value})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tfit.init_params(cfg, 2, 1000.0)


def _grads_np(tp):
    return {n.replace(".", "/"): (p.grad.numpy() if p.grad is not None
                                  else np.zeros(tuple(p.shape), np.float32))
            for n, p in tp.named_parameters()}


@pytest.mark.parametrize("point", ["init", "perturbed"])
@pytest.mark.parametrize("stage", ["fit", "warmup", "camera"])
def test_stage_loss_and_grads_match_jax(problem, point, stage):
    cfg, jassets = problem["cfg"], problem["jassets"]
    jparams = problem["params"] if point == "init" else _perturbed(
        problem["params"])
    if stage == "camera":
        vi, fi = np.arange(2, dtype=np.int32), np.zeros(2, np.int32)
    else:
        vi, fi = _batch(problem, seed=1 if point == "init" else 2)
    jfn = {"fit": lambda p, v, f: jfit.fit_loss(p, cfg, jassets, v, f,
                                                training=False),
           "warmup": lambda p, v, f: jfit.warmup_loss(p, cfg, jassets, v, f),
           "camera": lambda p, v, f: jfit.camera_stage_loss(p, cfg, jassets,
                                                            v, f)}[stage]
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        jfn, has_aux=True))(jparams, jnp.asarray(vi), jnp.asarray(fi))

    tp = _port_params(problem, jparams)
    tfn = {"fit": tfit.fit_loss, "warmup": tfit.warmup_loss,
           "camera": tfit.camera_stage_loss}[stage]
    loss_t, metrics_t = tfn(tp, problem["tcfg"], problem["tassets"],
                            torch.as_tensor(vi).long(),
                            torch.as_tensor(fi).long())
    loss_t.backward()

    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=2e-5)
    assert sorted(metrics_t) == sorted(metrics_j)
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics_t[k].detach()),
                                   float(metrics_j[k]), rtol=5e-5,
                                   err_msg=k)
    # Gradients of every group: f32 noise amplified through the rotation
    # conversions and the VPoser chain; atol 1e-4 x the tensor's largest
    # entry (a wrong term moves entries by O(1) of that scale).
    # The camera stage trains the cameras only; at frame 0 the other groups'
    # gradients are differences of nearly equal terms (warped phase 0 minus
    # phase 0, per-view code minus zero code), pure f32 cancellation noise.
    flat_j = _flatten_with_paths(grads_j)
    flat_t = _grads_np(tp)
    assert sorted(flat_t) == sorted(flat_j)
    if stage == "camera":
        flat_j = {"cameras": flat_j["cameras"]}
    for k, gj in flat_j.items():
        scale = float(np.abs(gj).max())
        np.testing.assert_allclose(flat_t[k], gj, rtol=1e-3,
                                   atol=1e-4 * scale + 1e-9, err_msg=k)


class TestOptimizer:
    @pytest.mark.parametrize("decoupled", [False, True])
    def test_group_adam_matches_optax(self, decoupled):
        rng = np.random.RandomState(0)
        w0 = rng.randn(7, 5).astype(np.float32)
        grads = [rng.randn(7, 5).astype(np.float32) for _ in range(12)]
        scales = [1.0] * 6 + [0.5] * 6
        lr, wd = 1e-2, 1e-3
        if decoupled:
            opt = optax.chain(optax.scale_by_adam(),
                              optax.add_decayed_weights(wd), optax.scale(-lr))
        else:
            opt = optax.chain(optax.add_decayed_weights(wd),
                              optax.scale_by_adam(), optax.scale(-lr))
        jw = jnp.asarray(w0)
        state = opt.init(jw)
        tw = torch.nn.Parameter(torch.tensor(w0))
        tadam = GroupAdam([tw], lr, weight_decay=wd, decoupled=decoupled)
        for g, s in zip(grads, scales):
            u, state = opt.update(jnp.asarray(g), state, jw)
            jw = jw + u * s
            tw.grad = torch.tensor(g)
            tadam.step(torch.tensor(s))
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw),
                                   atol=2e-6)

    def test_plateau_matches_jax(self):
        losses = np.concatenate([np.linspace(1.0, 0.5, 5), np.full(15, 0.5),
                                 [0.4], np.full(30, 0.4)]).astype(np.float32)
        sj, st = j_plateau_init(), plateau_init()
        for loss in losses:
            sj = j_plateau_update(sj, jnp.asarray(loss), 0.5, 0.1)
            st = plateau_update(st, torch.tensor(loss), 0.5, 0.1)
            assert float(st.scale) == float(sj.scale)
            assert int(st.num_bad) == int(sj.num_bad)
            assert float(st.best) == float(sj.best)
        assert float(st.scale) < 1.0


def _replay(seed, V, F, B):
    """The JAX fitter's batch stream (key threading of fit/loop.py:
    warmup key,k1 = split(key); main key,k1,k2 = split(key, 3))."""
    key = jax.random.PRNGKey(seed)
    _k_init, key = jax.random.split(key)
    out = {"warmup": [], "main": []}
    for _ in range(WARMUP):
        key, k1 = jax.random.split(key)
        out["warmup"].append(_sample_batch(k1, B, V, F))
    for _ in range(MAIN):
        key, k1, _k2 = jax.random.split(key, 3)
        out["main"].append(_sample_batch(k1, B, V, F))
    return out


def test_three_stage_slice_matches_jax(problem):
    """warmup -> camera -> main (two chunks) through both fitters."""
    cfg = problem["cfg"]
    fitter = jfit.NemoFitter(cfg, problem["jassets"], seed=0)
    params0 = fitter.state.params
    wm, cm = fitter.warmup(), fitter.opt_cam()
    fm = fitter.fit(chunk=MAIN // 2)

    batches = _replay(0, 2, 12, cfg.batch_size)
    tf = tfit.NemoFitter(problem["tcfg"], problem["tassets"], seed=0,
                         batch_source=lambda s, i: batches[s][i])
    params_from_numpy(tf.params, _flatten_with_paths(params0))
    twm, tcm = tf.warmup(), tf.opt_cam()
    chunks = []
    tfm = tf.fit(chunk=MAIN // 2, on_chunk=lambda f, s, m: chunks.append(s))
    assert chunks == [MAIN // 2, MAIN]

    for name, j, t in (("warmup", wm["warmup_loss"], twm["warmup_loss"]),
                       ("camera", cm["cam_loss"], tcm["cam_loss"])):
        np.testing.assert_allclose(t, j, rtol=1e-4, err_msg=name)
    for k in ("total_loss", "kp_loss", "vp_recon_loss", "gmm_loss"):
        np.testing.assert_allclose(tfm[k][:5], fm[k][:5], rtol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(tfm[k], fm[k], rtol=1e-3, err_msg=k)
    for g, s in tf.plateau.items():
        assert float(s.scale) == float(fitter.state.plateau[g].scale), g
    ej = fitter.eval_loss()
    et = tf.eval_loss()
    for k in ej:
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-3, err_msg=k)


def test_port_never_imports_jax():
    """Import every nemo_tpu_torch module in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import nemo_tpu_torch\n"
        "for m in pkgutil.walk_packages(nemo_tpu_torch.__path__,"
        " 'nemo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'optax', 'nemo_tpu'))\n"
        "assert not bad, bad\n"
        "print('modules', len([k for k in sys.modules"
        " if k.startswith('nemo_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20
