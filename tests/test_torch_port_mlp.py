"""The port's fused MotionNet MLP (K6) against nemo_tpu's, on the CPU.

The JAX side runs ``nemo_tpu/ops/mlp_pallas.py`` as its own tests do
(tests/test_mlp_pallas.py): ``pallas_call`` in interpret mode, and the fused
path of ``apply_motion_net`` forced on by patching ``mlp_pallas_available``
(the path is picked at trace time, so the jit caches are cleared around
it). The port's side runs the plain versions of K6f/K6b, which the CPU
route of ``ops.mlp.motion_net_mlp`` takes. Inputs come from numpy seeds,
parameters from JAX's init carried across with the checkpoint converter.

Tolerances: the op's forward atol 1e-5, its gradients atol 2e-4 and rtol
1e-4 (those of test_mlp_pallas.py); the MotionNet's dicts atol 1e-4
(rotations) and 1e-5 (translation); the fit as tests/test_torch_port_fit.py
holds it (loss rtol 2e-5, metrics 5e-5, gradients 1e-4 of each tensor's
largest entry, a 5-step main-stage trajectory within rtol 1e-4).
"""

import contextlib
import dataclasses
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu import fit as jfit
from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.data import synthetic_problem as jax_synthetic_problem
from nemo_tpu.fit.loop import _sample_batch
from nemo_tpu.modules import networks as jnet
from nemo_tpu.ops import mlp_pallas
from nemo_tpu.priors import init_vposer as jax_init_vposer
from nemo_tpu.priors import synthetic_gmm_prior as jax_synthetic_gmm
from nemo_tpu.utils.checkpoint import _flatten_with_paths
from nemo_tpu_torch import fit as tfit
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.modules import networks as tnet
from nemo_tpu_torch.ops import mlp
from nemo_tpu_torch.priors.gmm import gmm_from_numpy
from nemo_tpu_torch.utils.checkpoint import params_from_numpy, vposer_from_numpy

torch.set_num_threads(1)
D, H, J = 19, 72, 24
MAIN = 5


@contextlib.contextmanager
def jax_fused():
    """nemo_tpu's fused MotionNet path, forced on, its Pallas calls in
    interpret mode; fresh traces inside and after."""
    orig = mlp_pallas.pl.pallas_call

    def call(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    jax.clear_caches()
    try:
        with mock.patch.object(mlp_pallas.pl, "pallas_call", call), \
                mock.patch.object(mlp_pallas, "mlp_pallas_available",
                                  lambda: True):
            yield
    finally:
        jax.clear_caches()


def _motion_from_jax(p):
    """A port MotionNet holding the JAX pytree's weights."""
    m = tnet.MotionNet(D, H, J)
    with torch.no_grad():
        for name, t in m.named_parameters():
            node = p
            for k in name.split("."):
                node = node[k]
            t.copy_(torch.tensor(np.asarray(node)))
    return m


def _jax_motion(seed=0):
    return jnet.init_motion_net(jax.random.PRNGKey(seed), D, H, J,
                                init_last_layer_zero=False)


def _x(B, seed=0):
    return np.random.RandomState(seed).randn(B, D).astype(np.float32)


@pytest.mark.parametrize("B", [13, 1])
def test_op_matches_jax_pallas_interpret(B):
    """ops.mlp.motion_net_mlp (plain versions) against mlp_pallas's
    motion_net_mlp in interpret mode: outputs, and the gradients of every
    raw MotionNet tensor and of x under a random cotangent."""
    p, x = _jax_motion(), _x(B)
    rs = np.random.RandomState(1)
    crot = rs.randn(B, J * 6).astype(np.float32)
    ctr = rs.randn(B, 3).astype(np.float32)

    def loss(p, x):
        r, t = mlp_pallas.motion_net_mlp(p, x, J)
        return jnp.sum(r * crot) + jnp.sum(t * ctr), (r, t)

    with jax_fused():
        (_, (rot_j, tr_j)), grads_j = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))

    m = _motion_from_jax(p)
    xt = torch.tensor(x, requires_grad=True)
    rot, tr = mlp.motion_net_mlp(m, xt)
    ((rot * torch.tensor(crot)).sum() + (tr * torch.tensor(ctr)).sum()
     ).backward()
    np.testing.assert_allclose(rot.detach().numpy(), np.asarray(rot_j),
                               atol=1e-5)
    np.testing.assert_allclose(tr.detach().numpy(), np.asarray(tr_j),
                               atol=1e-5)
    gp, gx = grads_j
    flat = {k.replace("/", "."): v for k, v in _flatten_with_paths(gp).items()}
    got = dict(m.named_parameters())
    assert sorted(flat) == sorted(got)
    for k, want in flat.items():
        np.testing.assert_allclose(got[k].grad.numpy(), want, atol=2e-4,
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("B", [13, 1])
def test_bwd_plain_matches_autograd(B):
    """motion_net_mlp_bwd_plain against torch autograd of the eager
    forward; x has a zero row and b1 zero entries, so some pre-activations
    are exactly 0, where both sides give a zero gradient."""
    g = torch.Generator().manual_seed(B)
    r = lambda *s: torch.randn(s, generator=g)
    x = r(B, D)
    x[0] = 0.0
    args = [x, r(D, H), r(H), r(H, H) / 8, r(H), r(H, H) / 8, r(H),
            r(H, 147) / 8, r(147)]
    args[2][: H // 2] = 0.0
    args = [a.requires_grad_() for a in args]
    out, h1, h2, z = mlp.motion_net_mlp_plain(*args)
    assert bool((h1 == 0).any())
    gout = r(B, 147)
    want = torch.autograd.grad((out * gout).sum(), args)
    got = mlp.motion_net_mlp_bwd_plain(gout, args[0], h1, h2, z, args[1],
                                       args[3], args[5], args[7])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def test_motion_net_fused_matches_jax_apply_motion_net():
    """MotionNet(mlp="fused") against apply_motion_net with the fused path
    forced: rot6d, rotmat and axis-angle of pose and orient, and trans."""
    p, x = _jax_motion(2), _x(13, 2)
    with jax_fused():
        want = jnet.apply_motion_net(p, jnp.asarray(x), J)
    got = _motion_from_jax(p)(torch.tensor(x), mlp="fused")
    for w, g in ((want[0], got[0]), (want[1], got[1])):
        for key in ("rot6d", "rotmat", "pose"):
            np.testing.assert_allclose(g[key].detach().numpy(),
                                       np.asarray(w[key]), atol=1e-4,
                                       err_msg=key)
    np.testing.assert_allclose(got[2].detach().numpy(), np.asarray(want[2]),
                               atol=1e-5)


def test_unknown_mlp_mode_raises():
    with pytest.raises(ValueError, match="mlp"):
        _motion_from_jax(_jax_motion())(torch.zeros(2, D), mlp="pallas")


# ---------------------------------------------------------------------------
# the slice: fit_loss, its gradients and main-stage steps with K6
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    cfg = jfit.NemoConfig(
        model_version=2, h_dim=H, instance_code_size=4, phase_rbf_dim=16,
        rbf_kernel="quadratic", monotonic_network_n_nodes=4, batch_size=16,
        weight_vp_loss=10.0, weight_vp_z_loss=1.0, weight_gmm_loss=0.5,
        label_type="gt", lr_factor=0.5, n_steps=MAIN)
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
                                  vposer.items()}),
        device="cpu", motion_mlp="fused")
    params = jfit.init_params(jax.random.PRNGKey(0), cfg, jassets.num_views,
                              jassets.img_d0)
    # off the init: rotations off the identity, every unit's sign mixed
    rng = np.random.RandomState(3)
    perturbed = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.asarray(rng.randn(*a.shape)
                                         .astype(np.float32)), params)
    return dict(cfg=cfg, tcfg=tcfg, jassets=jassets, tassets=tassets,
                init=params, perturbed=perturbed)


def _port_params(pb, jparams):
    tp = tfit.init_params(pb["tcfg"], pb["tassets"].num_views,
                          pb["tassets"].img_d0)
    return params_from_numpy(tp, _flatten_with_paths(jparams))


def _batch(seed):
    rng = np.random.RandomState(1000 + seed)
    return (rng.randint(0, 2, size=16).astype(np.int32),
            rng.randint(0, 12, size=16).astype(np.int32))


def _port_loss_grads(tp, pb, assets, vi, fi):
    for p in tp.parameters():
        p.grad = None
    loss, metrics = tfit.fit_loss(tp, pb["tcfg"], assets,
                                  torch.as_tensor(vi).long(),
                                  torch.as_tensor(fi).long())
    loss.backward()
    grads = {n.replace(".", "/"): p.grad.numpy().copy()
             for n, p in tp.named_parameters()}
    return float(loss.detach()), {k: float(v.detach())
                                  for k, v in metrics.items()}, grads


def _jax_loss_grads(pb, jparams, vi, fi):
    fn = lambda p, v, f: jfit.fit_loss(p, pb["cfg"], pb["jassets"], v, f,
                                       training=False)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        jparams, jnp.asarray(vi), jnp.asarray(fi))
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        _flatten_with_paths(grads)


def _assert_fit_close(got, want):
    """Loss, metrics and gradients. b_lin's gradient is 0: predict returns
    trans - trans0, where b_lin cancels. What a side computes there is the
    difference of two equal column sums (the batch's and the phase-0
    anchor's), summed in different orders in nemo_tpu's kernel and exactly
    0 in the port; it is held to the scale of W_lin's gradient, whose
    entries are the same cotangents times activations of order 1."""
    (loss_t, m_t, g_t), (loss_j, m_j, g_j) = got, want
    np.testing.assert_allclose(loss_t, loss_j, rtol=2e-5)
    assert sorted(m_t) == sorted(m_j)
    for k in m_j:
        np.testing.assert_allclose(m_t[k], m_j[k], rtol=5e-5, err_msg=k)
    assert sorted(g_t) == sorted(g_j)
    for k, gj in g_j.items():
        scale = g_j["motion/W_lin"] if k == "motion/b_lin" else gj
        np.testing.assert_allclose(
            g_t[k], gj, rtol=1e-3,
            atol=1e-4 * float(np.abs(scale).max()) + 1e-9, err_msg=k)


@pytest.mark.parametrize("point", ["init", "perturbed"])
def test_fused_fit_loss_and_grads_match_jax(problem, point):
    """fit_loss with motion_mlp="fused" (K6 in predict and in the phase-0
    anchor) against nemo_tpu's fit_loss with the fused path forced: loss,
    metrics and the gradients of every group, the RBF widths and instance
    codes (through K6's gx) included."""
    jparams = problem[point]
    vi, fi = _batch(1 if point == "init" else 2)
    with jax_fused():
        want = _jax_loss_grads(problem, jparams, vi, fi)
    got = _port_loss_grads(_port_params(problem, jparams), problem,
                           problem["tassets"], vi, fi)
    _assert_fit_close(got, want)
    for k in ("rbf/log_sigmas", "instance", "motion/trunk/W1"):
        assert np.abs(got[2][k]).max() > 0, k
    np.testing.assert_array_equal(got[2]["motion/b_lin"], 0.0)


def test_one_converted_parameter_set_drives_both_modes(problem):
    """One JAX parameter set, converted once, through the port's plain and
    fused MotionNet: the plain mode matches nemo_tpu's default path, and
    the fused mode the plain one (and nemo_tpu's fused path, above)."""
    jparams = problem["perturbed"]
    vi, fi = _batch(3)
    tp = _port_params(problem, jparams)
    plain_assets = dataclasses.replace(problem["tassets"], motion_mlp="plain")
    plain = _port_loss_grads(tp, problem, plain_assets, vi, fi)
    fused = _port_loss_grads(tp, problem, problem["tassets"], vi, fi)
    _assert_fit_close(plain, _jax_loss_grads(problem, jparams, vi, fi))
    _assert_fit_close(fused, plain)


def test_fused_main_stage_trajectory_matches_jax(problem):
    """Warmup and camera stages (3 steps each), then five main-stage Adam
    steps, from JAX's init through both fitters with the fused MLP, the
    port replaying the JAX fitter's batch stream (fit/loop.py: key, k1 =
    split(key) a warmup step, key, k1, k2 = split(key, 3) a main step).
    Started at the raw init instead, the fifth main step parts from JAX's
    by 1.5e-4 in the plain mode as in the fused one; after the two short
    stages both modes track it within 2e-6."""
    cfg = dataclasses.replace(problem["cfg"], warmup_step=3, opt_cam_step=3)
    with jax_fused():
        jf = jfit.NemoFitter(cfg, problem["jassets"], seed=0)
        params0 = jf.state.params
        wm, cm = jf.warmup(), jf.opt_cam()
        fm = jf.fit(MAIN, chunk=MAIN)
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    batches = {"warmup": [], "main": []}
    for _ in range(cfg.warmup_step):
        key, k1 = jax.random.split(key)
        batches["warmup"].append(_sample_batch(k1, cfg.batch_size, 2, 12))
    for _ in range(MAIN):
        key, k1, _k2 = jax.random.split(key, 3)
        batches["main"].append(_sample_batch(k1, cfg.batch_size, 2, 12))
    tcfg = tfit.NemoConfig(**dataclasses.asdict(cfg))
    tf = tfit.NemoFitter(tcfg, problem["tassets"], seed=0,
                         batch_source=lambda s, i: batches[s][i])
    params_from_numpy(tf.params, _flatten_with_paths(params0))
    twm, tcm = tf.warmup(), tf.opt_cam()
    tfm = tf.fit(MAIN, chunk=MAIN)
    np.testing.assert_allclose(twm["warmup_loss"], wm["warmup_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(tcm["cam_loss"], cm["cam_loss"], rtol=1e-4)
    for k in ("total_loss", "kp_loss", "vp_recon_loss", "gmm_loss"):
        assert tfm[k].shape == (MAIN,)
        np.testing.assert_allclose(tfm[k], fm[k], rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# routing: which calls reach K6, and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("version,calls", [(0, 0), (1, 2), (2, 2)])
def test_predict_reaches_k6_twice_except_v0(version, calls):
    """predict with motion_mlp="fused" sends the batch and the B = 1
    phase-0 anchor through the fused op (two calls), except model version 0,
    whose separate RotNet/FCNN networks stay plain as in JAX; with "plain"
    no call reaches it."""
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    cfg = tfit.NemoConfig(model_version=version, h_dim=16,
                          instance_code_size=4,
                          phase_rbf_dim=8 if version == 2 else 0,
                          monotonic_network_n_nodes=4, batch_size=8,
                          label_type="gt")
    smpl = synthetic_smpl_model(300)
    bundle, _ = synthetic_problem(smpl, num_views=2, num_frames=12)
    params = tfit.init_params(cfg, 2, bundle.img_d0,
                              torch.Generator().manual_seed(0))
    vi, fi = torch.tensor([0, 1, 1]), torch.tensor([0, 5, 11])
    seen = []
    real = mlp.motion_net_mlp

    def spy(motion, x, *precision):
        seen.append(x.shape[0])
        return real(motion, x, *precision)

    with mock.patch.object(tnet, "motion_net_mlp", spy):
        outs = {}
        for mode in ("plain", "fused"):
            assets = tfit.build_assets(bundle, smpl, cfg, device="cpu",
                                       motion_mlp=mode)
            seen.clear()
            outs[mode] = tfit.predict(params, cfg, assets, vi, fi)
            assert seen == ([3, 1] if mode == "fused" and calls else []), mode
    for k in ("j", "poses", "trans"):
        torch.testing.assert_close(outs["fused"][k], outs["plain"][k],
                                   rtol=1e-5, atol=1e-5)


def test_build_assets_refuses_unknown_motion_mlp():
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    smpl = synthetic_smpl_model(300)
    bundle, _ = synthetic_problem(smpl, num_views=2, num_frames=12)
    with pytest.raises(ValueError, match="motion_mlp"):
        tfit.build_assets(bundle, smpl, tfit.NemoConfig(label_type="gt"),
                          device="cpu", motion_mlp="pallas")


def test_cli_fused_motion_mlp_on_cpu(tmp_path):
    """--motion_mlp fused --device cpu through cli/fit.py on synthetic
    assets: the stages run and the eval CSVs are written."""
    from nemo_tpu_torch.cli.fit import main
    flags = ["--synthetic_assets", "--model_version", "2", "--phase_rbf_dim",
             "8", "--rbf_kernel", "quadratic", "--h_dim", "16",
             "--monotonic_network_n_nodes", "4", "--instance_code_size", "4",
             "--batch_size", "16", "--n_steps", "2", "--warmup_step", "1",
             "--opt_cam_step", "1", "--save_every", "2", "--label_type", "gt",
             "--loss", "mse_robust", "--weight_gmm_loss", "0.5",
             "--weight_vp_loss", "1.0", "--motion_mlp", "fused", "--device",
             "cpu", "--out_dir", str(tmp_path)]
    assert main(flags) == 0
    out = tmp_path / "000000"
    for name in ("eval_2d.csv", "eval_3d.csv", "eval_3d_dynamic.csv",
                 "eval_3d_global.csv", "losses.npz"):
        assert (out / name).is_file(), name
    with open(out / "config.json") as f:
        assert json.load(f)["args"]["motion_mlp"] == "fused"
    final = [json.loads(line) for line in open(out / "metrics.jsonl")][-1]
    assert final["phase"] == "final" and np.isfinite(final["kp_loss"])
