"""The custom entry's HuMoR dynamics term, the port's against nemo_tpu's.

``humor_infer_seq``, ``predict(want_fk_joints=True)``,
``humor_dynamics_loss`` (with the edge frames 0 and F-1, which clamp to 1
and F-2), ``fit_loss`` with ``weight_humor_loss`` and a 3+3+3-step
three-stage trajectory, on the CPU. Both sides get the same synthetic
assets (the 150-vertex SMPL, the JAX bundle), the same JAX-initialised
parameters and a narrow HuMoR (every hidden layer 128 wide, latent 8, the
reference's GroupNorm of 16 groups) drawn by nemo_tpu and carried across.
Tolerances follow tests/test_reference_twin.py: rtol 2e-5 on losses, 5e-5
on metrics, gradients within 1e-4 of each tensor's largest entry, per-step
losses within 1e-4 for the first 5 steps and 1e-3 after.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu import fit as jfit
from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.data import synthetic_problem as jax_synthetic_problem
from nemo_tpu.fit.loop import _sample_batch
from nemo_tpu.models import humor as jhumor
from nemo_tpu.priors import init_vposer as jax_init_vposer
from nemo_tpu.priors import synthetic_gmm_prior as jax_synthetic_gmm
from nemo_tpu.utils.checkpoint import _flatten_with_paths
from nemo_tpu_torch import fit as tfit
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.models import humor as thumor
from nemo_tpu_torch.priors.gmm import gmm_from_numpy
from nemo_tpu_torch.utils.checkpoint import (params_from_numpy,
                                             vposer_from_numpy)

torch.set_num_threads(1)
V, F, B = 2, 12, 16
WARMUP, CAM, MAIN = 3, 3, 3
LATENT, WIDTH = 8, 128


def narrow_humor(key, cfg):
    """init_humor's layout at hidden width WIDTH (nemo_tpu's init_mlp)."""
    D, L = cfg.input_dim, cfg.latent_size
    ke, kd, kp = jax.random.split(key, 3)
    w = [WIDTH] * 4
    return jax.tree_util.tree_map(np.asarray, {
        "encoder": jhumor.init_mlp(ke, [2 * D] + w + [2 * L], cfg.num_groups),
        "decoder": jhumor.init_mlp(kd, [D + L] + w[:3] + [cfg.output_dim],
                                   cfg.num_groups, skip_size=L),
        "prior": jhumor.init_mlp(kp, [D] + w + [2 * L], cfg.num_groups)})


@pytest.fixture(scope="module")
def problem():
    cfg = jfit.NemoConfig(
        model_version=2, h_dim=32, instance_code_size=4, phase_rbf_dim=8,
        rbf_kernel="quadratic", monotonic_network_n_nodes=4, batch_size=B,
        weight_vp_loss=10.0, weight_vp_z_loss=1.0, weight_gmm_loss=0.5,
        weight_humor_loss=1.0, humor_fps=30.0, label_type="gt",
        lr_factor=0.5, n_steps=MAIN, warmup_step=WARMUP, opt_cam_step=CAM)
    jm = jax_synthetic_smpl(num_vertices=150, seed=0)
    bundle, _ = jax_synthetic_problem(jm, num_views=V, num_frames=F, seed=0)
    gmm = jax_synthetic_gmm(4)
    vposer = jax_init_vposer(jax.random.PRNGKey(7))
    hcfg = jhumor.HumorConfig(latent_size=LATENT)
    hp = narrow_humor(jax.random.PRNGKey(1), hcfg)
    jassets = jfit.build_assets(bundle, jm, cfg, gmm=gmm, vposer=vposer,
                                humor=hp, humor_cfg=hcfg)
    tcfg = tfit.NemoConfig(**dataclasses.asdict(cfg))
    thcfg = thumor.HumorConfig(**dataclasses.asdict(hcfg))
    tassets = tfit.build_assets(
        bundle, smpl_from_numpy(jm), tcfg,
        gmm=gmm_from_numpy(gmm.means, gmm.precisions, gmm.nll_weights),
        vposer=vposer_from_numpy({k: np.asarray(v) for k, v in
                                  vposer.items()}), device="cpu",
        humor=thumor.humor_from_numpy(hp), humor_cfg=thcfg)
    params = jfit.init_params(jax.random.PRNGKey(0), cfg, V, jassets.img_d0)
    return dict(cfg=cfg, tcfg=tcfg, jassets=jassets, tassets=tassets,
                params=_perturbed(params), params0=params, hp=hp,
                hcfg=hcfg, thcfg=thcfg)


def _perturbed(params, seed=3, scale=0.05):
    """Every parameter off its init, so the motion moves between frames."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.randn(*a.shape).astype(np.float32)), params)


def _port_params(pb, jparams):
    tp = tfit.init_params(pb["tcfg"], V, pb["tassets"].img_d0)
    return params_from_numpy(tp, _flatten_with_paths(jparams))


def _batch(seed, edges=False):
    rng = np.random.RandomState(1000 + seed)
    vi = rng.randint(0, V, size=B).astype(np.int32)
    fi = rng.randint(0, F, size=B).astype(np.int32)
    if edges:       # both clamped ends, in both views
        fi[:4] = [0, F - 1, 0, F - 1]
        vi[:4] = [0, 0, 1, 1]
    return vi, fi


def _grads_np(tp):
    return {n.replace(".", "/"): (p.grad.numpy() if p.grad is not None
                                  else np.zeros(tuple(p.shape), np.float32))
            for n, p in tp.named_parameters()}


def _close_grads(tp, grads_j):
    flat_j = _flatten_with_paths(grads_j)
    flat_t = _grads_np(tp)
    assert sorted(flat_t) == sorted(flat_j)
    for k, gj in flat_j.items():
        scale = float(np.abs(gj).max())
        np.testing.assert_allclose(flat_t[k], gj, rtol=1e-3,
                                   atol=1e-4 * scale + 1e-9, err_msg=k)


def test_humor_infer_seq_matches_jax(problem):
    """Posterior, prior and per-transition KL of (3, 4, D) sequences within
    rtol 1e-5 / atol 1e-5; the transition prior loss is their KL's mean."""
    rng = np.random.default_rng(4)
    x = 0.05 * rng.standard_normal((3, 4, jhumor.STATE_DIM))
    x[..., 6:9] = 0.4 * rng.standard_normal((3, 4, 3))
    x[..., 12:75] = 0.2 * rng.standard_normal((3, 4, 63))
    x = x.astype(np.float32)
    jo = jhumor.humor_infer_seq(problem["hp"], problem["hcfg"],
                                jnp.asarray(x))
    tp = thumor.humor_from_numpy(problem["hp"])
    to = thumor.humor_infer_seq(tp, problem["thcfg"], torch.tensor(x))
    assert set(to) == set(jo)
    for k in jo:
        assert to[k].shape == jo[k].shape, k
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    jl = jhumor.humor_transition_prior_loss(problem["hp"], problem["hcfg"],
                                            jnp.asarray(x))
    tl = thumor.humor_transition_prior_loss(tp, problem["thcfg"],
                                            torch.tensor(x))
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)
    assert float(tl) == float(to["kl"].mean())


def test_predict_fk_joints_matches_jax(problem):
    """want_fk_joints adds the translated kinematic-chain joints and the
    root rotation; metre-scale coordinates within atol 2e-5."""
    vi, fi = _batch(5)
    jo = jax.jit(lambda p, v, f: jfit.predict(
        p, problem["cfg"], problem["jassets"], v, f, want_fk_joints=True))(
        problem["params"], jnp.asarray(vi), jnp.asarray(fi))
    tp = _port_params(problem, problem["params"])
    with torch.no_grad():
        to = tfit.predict(tp, problem["tcfg"], problem["tassets"],
                          torch.as_tensor(vi).long(),
                          torch.as_tensor(fi).long(), want_fk_joints=True)
    assert set(to) == set(jo)
    assert to["fk_joints"].shape == (B, 24, 3)
    assert to["orient_rotmat"].shape == (B, 3, 3)
    for k in ("fk_joints", "orient_rotmat", "trans", "j"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   atol=2e-5, err_msg=k)
    plain = tfit.predict(tp, problem["tcfg"], problem["tassets"],
                         torch.as_tensor(vi).long(),
                         torch.as_tensor(fi).long())
    assert "fk_joints" not in plain


@pytest.mark.parametrize("edges", [False, True])
def test_humor_dynamics_loss_and_grads_match_jax(problem, edges):
    vi, fi = _batch(6, edges)
    jfn = lambda p: jfit.model.humor_dynamics_loss(
        p, problem["cfg"], problem["jassets"], jnp.asarray(vi),
        jnp.asarray(fi))
    lj, gj = jax.jit(jax.value_and_grad(jfn))(problem["params"])
    tp = _port_params(problem, problem["params"])
    lt = tfit.model.humor_dynamics_loss(tp, problem["tcfg"],
                                        problem["tassets"],
                                        torch.as_tensor(vi).long(),
                                        torch.as_tensor(fi).long())
    lt.backward()
    assert np.isfinite(float(lj)) and float(lj) > 0
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=2e-5)
    _close_grads(tp, gj)


def test_edge_frames_clamp_to_their_neighbours(problem):
    """Frame 0 is read as frame 1 and F-1 as F-2: the term is the same
    with the edges replaced by their clamped frames."""
    tp = _port_params(problem, problem["params"])
    vi = torch.tensor([0, 1, 0, 1])
    run = lambda fi: float(tfit.model.humor_dynamics_loss(
        tp, problem["tcfg"], problem["tassets"], vi, torch.tensor(fi)))
    with torch.no_grad():
        assert run([0, 0, F - 1, F - 1]) == run([1, 1, F - 2, F - 2])
        assert run([0, 0, F - 1, F - 1]) != run([2, 2, F - 3, F - 3])


@pytest.mark.parametrize("point", ["init", "perturbed"])
def test_fit_loss_with_humor_term_matches_jax(problem, point):
    """fit_loss with weight_humor_loss 1: the total within rtol 2e-5, each
    metric (humor_loss among them) within 5e-5, gradients within 1e-4 of
    each tensor's largest entry."""
    params = problem["params0"] if point == "init" else problem["params"]
    vi, fi = _batch(7, edges=True)
    jfn = lambda p: jfit.fit_loss(p, problem["cfg"], problem["jassets"],
                                  jnp.asarray(vi), jnp.asarray(fi),
                                  training=False)
    (lj, mj), gj = jax.jit(jax.value_and_grad(jfn, has_aux=True))(params)
    tp = _port_params(problem, params)
    lt, mt = tfit.fit_loss(tp, problem["tcfg"], problem["tassets"],
                           torch.as_tensor(vi).long(),
                           torch.as_tensor(fi).long())
    lt.backward()
    assert "humor_loss" in mt and sorted(mt) == sorted(mj)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=2e-5)
    for k in mj:
        np.testing.assert_allclose(float(mt[k].detach()), float(mj[k]),
                                   rtol=5e-5, err_msg=k)
    _close_grads(tp, gj)


def _replay(seed, B):
    """The JAX fitter's batch stream (fit/loop.py's key threading: warmup
    key, k1 = split(key); main key, k1, k2 = split(key, 3))."""
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


def test_three_stage_trajectory_with_humor_term_matches_jax(problem):
    """3 warmup, 3 camera and 3 main steps through both fitters from the
    same init and batches: per-step losses within 1e-4 (1e-3 after the
    fifth step), the final eval within 1e-3."""
    cfg = problem["cfg"]
    fitter = jfit.NemoFitter(cfg, problem["jassets"], seed=0)
    params0 = fitter.state.params
    wm, cm, fm = fitter.warmup(), fitter.opt_cam(), fitter.fit(chunk=MAIN)
    batches = _replay(0, B)
    tf = tfit.NemoFitter(problem["tcfg"], problem["tassets"], seed=0,
                         batch_source=lambda s, i: batches[s][i])
    params_from_numpy(tf.params, _flatten_with_paths(params0))
    twm, tcm, tfm = tf.warmup(), tf.opt_cam(), tf.fit(chunk=MAIN)
    np.testing.assert_allclose(twm["warmup_loss"], wm["warmup_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(tcm["cam_loss"], cm["cam_loss"], rtol=1e-4)
    assert sorted(tfm) == sorted(fm) and "humor_loss" in tfm
    for k in fm:
        np.testing.assert_allclose(tfm[k], fm[k], rtol=1e-4, err_msg=k)
    ej, et = fitter.eval_loss(), tf.eval_loss()
    assert sorted(et) == sorted(ej)
    for k in ej:
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-3, err_msg=k)
