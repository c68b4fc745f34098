"""The port's second slice against nemo_tpu: K3, the K2 pair mode, and the
fit's other configurations (model versions 0, 1, 3, 4, the v2v vertex
subset, the 3D and instance losses, code noise, full-batch steps, the V4
camera stage).

Kernels: the port's plain versions (what its wrappers run on a CPU tensor)
against the JAX Pallas kernels run in interpret mode, patched as
tests/test_lbs_pallas.py does, and against the JAX XLA fallbacks. The fit:
the same synthetic assets and starting parameters (JAX's init, carried
across), the JAX code-noise draw injected into the port, the JAX batch
stream replayed into the port's fitter. Tolerances follow
tests/test_lbs_pallas.py for the kernels and tests/test_reference_twin.py
for the fit (loss rtol 2e-5, trajectories 1e-4 for 5 steps and 1e-3 after).
"""

import dataclasses
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu import fit as jfit
from nemo_tpu.body import smpl as jsmpl
from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.data import synthetic_problem as jax_synthetic_problem
from nemo_tpu.fit.loop import _sample_batch
from nemo_tpu.ops import lbs_pallas
from nemo_tpu.priors import init_vposer as jax_init_vposer
from nemo_tpu.priors import synthetic_gmm_prior as jax_synthetic_gmm
from nemo_tpu.utils.checkpoint import _flatten_with_paths
from nemo_tpu_torch import fit as tfit
from nemo_tpu_torch.body import smpl as tsmpl
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.fit.optimizer import GROUPS, GroupOptimizer, version_groups
from nemo_tpu_torch.ops import lbs
from nemo_tpu_torch.priors.gmm import gmm_from_numpy
from nemo_tpu_torch.utils.checkpoint import (params_from_numpy,
                                             params_to_numpy,
                                             vposer_from_numpy)

torch.set_num_threads(1)
T = torch.tensor
NV, NF = 2, 12          # views, frames of the synthetic problem

BASE = dict(h_dim=32, instance_code_size=4, phase_rbf_dim=8,
            rbf_kernel="quadratic", monotonic_network_n_nodes=4,
            batch_size=16, weight_vp_loss=10.0, weight_vp_z_loss=1.0,
            weight_gmm_loss=0.5, label_type="gt", lr_factor=0.5)
V3 = dict(model_version=3, weight_3d_loss=1.0, weight_instance_loss=0.1,
          code_noise=0.05)
NO_VPOSER = dict(weight_vp_loss=0.0, weight_vp_z_loss=0.0)
CONFIGS = {
    "v0": dict(model_version=0, phase_rbf_dim=0, **NO_VPOSER),
    "v1": dict(model_version=1, phase_rbf_dim=0),
    "v3": V3,
    "v3_subset": dict(V3, vp_v2v_n_verts=64),
    "v4": dict(V3, model_version=4, **NO_VPOSER),
}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **kw)


# ---------------------------------------------------------------------------
# K3 and the K2 pair mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def skin_case():
    """pf, A34, vsh as smpl_verts_t builds them (B=8, V=300), the tables
    tiled at tv=128 for the interpret-mode kernels, and a second pose set
    offset by +-10 m per row so no rec - orig difference lies near 0."""
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    rng = np.random.RandomState(3)
    B = 8

    def inputs(scale):
        from scipy.spatial.transform import Rotation
        rot = Rotation.from_rotvec(scale * rng.randn(B * 24, 3)).as_matrix()
        rot = jnp.asarray(rot.reshape(B, 24, 3, 3).astype(np.float32))
        betas = jnp.asarray((0.3 * rng.randn(1, 10)).astype(np.float32))
        v_shaped = jm.v_template + jnp.einsum('bl,mkl->bmk', betas,
                                              jm.shapedirs)
        J = jnp.einsum('jv,bvk->bjk', jm.J_regressor, v_shaped)
        R_g, _, t_rel = jsmpl.fk_rt(rot, J, jm.parents)
        A34 = jnp.concatenate([R_g, t_rel[..., None]], -1).reshape(B, 24, 12)
        pf = (rot[:, 1:] - jnp.eye(3)).reshape(B, 207)
        return (np.asarray(pf), np.asarray(A34),
                np.ascontiguousarray(np.asarray(v_shaped[0]).T))

    pf, A34, vsh = inputs(0.5)
    pf_r, A_r, _ = inputs(0.5)
    A_r = A_r.reshape(B, 24, 3, 4).copy()
    A_r[..., 3] += 10.0 * np.sign(rng.randn(B, 1, 3))
    pd_tiles, w_tiles, V = lbs_pallas.tile_tables(
        jm.posedirs_t, jm.lbs_weights_t, tv=128)
    return dict(V=V, pf=pf, A34=A34, vsh=vsh, pf_r=pf_r,
                A_r=A_r.reshape(B, 24, 12).astype(np.float32),
                pd=np.asarray(jm.posedirs_t), W=np.asarray(jm.lbs_weights_t),
                pd_tiles=jnp.asarray(pd_tiles), w_tiles=jnp.asarray(w_tiles),
                g=rng.randn(B, 3, V).astype(np.float32))


def _interpret():
    orig = lbs_pallas.pl.pallas_call

    def call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)
    return mock.patch.object(lbs_pallas.pl, "pallas_call", call)


def _tables(c):
    return T(c["pd"]), T(c["W"])


class TestK3Plain:
    def test_forward_matches_pallas_interpret_and_xla(self, skin_case):
        c = skin_case
        j_args = [jnp.asarray(c[k]) for k in ("pf", "A34", "vsh")]
        with _interpret():
            got_j = lbs_pallas._fwd_pallas(*j_args, c["pd_tiles"],
                                           c["w_tiles"], c["V"], tb=8)
        xla = lbs_pallas._skin_verts_t_xla(*j_args, jnp.asarray(c["pd"]),
                                           jnp.asarray(c["W"]))
        out = lbs.skin_verts_t_plain(T(c["pf"]), T(c["A34"]), T(c["vsh"]),
                                     *_tables(c))
        # the TPU kernel's own interpret tolerance (test_lbs_pallas.py)
        _close(out, got_j, atol=2e-4)
        # the XLA fallback: the same einsums, metre-scale coordinates
        _close(out, xla, atol=2e-5)

    @pytest.mark.parametrize("stored_vp", [False, True])
    def test_backward_matches_pallas_interpret_and_xla(self, skin_case,
                                                       stored_vp):
        """A general (random normal) cotangent; the stored-vp variant reads
        posed vertices the forward kept (_bwd_kernel_vp)."""
        c = skin_case
        B, V = c["pf"].shape[0], c["V"]
        j_args = [jnp.asarray(c[k]) for k in ("pf", "A34", "vsh")]
        vp = (np.einsum('bp,pkv->bkv', c["pf"], c["pd"]) + c["vsh"]).astype(
            np.float32)
        vp_pad = None
        if stored_vp:
            Vp = c["pd_tiles"].shape[0] * c["pd_tiles"].shape[-1]
            vp_pad = jnp.asarray(np.pad(vp, ((0, 0), (0, 0), (0, Vp - V))))
        with _interpret():
            got_j = lbs_pallas._bwd_pallas(*j_args, c["pd_tiles"],
                                           c["w_tiles"], V,
                                           jnp.asarray(c["g"]), tb=8,
                                           vp=vp_pad)
        xla = lbs_pallas._bwd_xla(*j_args, jnp.asarray(c["pd"]),
                                  jnp.asarray(c["W"]), jnp.asarray(c["g"]))
        got = lbs.skin_bwd_plain(T(c["pf"]), T(c["A34"]), T(c["vsh"]),
                                 *_tables(c), T(c["g"]),
                                 vp=T(vp) if stored_vp else None)
        for name, a, bj, bx in zip(("gpf", "gA", "gvsh"), got, got_j, xla):
            _close(a, bj, atol=3e-3, rtol=1e-3, err_msg=name)
            _close(a, bx, atol=2e-5 * max(1.0, float(np.abs(bx).max())),
                   err_msg=name)

    def test_autograd_matches_jax_custom_vjp(self, skin_case):
        c = skin_case
        V = c["V"]

        def jf(pf, A34, vsh):
            out = lbs_pallas.skin_verts_t(V, pf, A34, vsh, c["pd_tiles"],
                                          c["w_tiles"])
            return jnp.sum(jnp.sin(out))
        val_j, g_j = jax.value_and_grad(jf, argnums=(0, 1, 2))(
            *(jnp.asarray(c[k]) for k in ("pf", "A34", "vsh")))
        t = [T(c[k], requires_grad=True) for k in ("pf", "A34", "vsh")]
        val = torch.sin(lbs.skin_verts_t(V, *t, *_tables(c))).sum()
        val.backward()
        _close(val, val_j, rtol=1e-5)
        for name, a, b in zip(("pf", "A34", "vsh"), t, g_j):
            b = np.asarray(b)
            _close(a.grad, b, atol=2e-5 * np.abs(b).max(), err_msg=name)

    def test_vertex_count_checked(self, skin_case):
        c = skin_case
        with pytest.raises(ValueError, match="vertices"):
            lbs.skin_verts_t(c["V"] + 1, T(c["pf"]), T(c["A34"]),
                             T(c["vsh"]), *_tables(c))


class TestK2PairMode:
    def test_sign_vp_and_grads_match_pallas_interpret(self, skin_case):
        """_v2v_fwd_pallas(want_vp=True) + _bwd_pallas(sign, vp) against
        the port's pair-mode plain forward and K3b plain backward."""
        c = skin_case
        B, V = c["pf"].shape[0], c["V"]
        j_in = [jnp.asarray(c[k]) for k in ("pf", "A34", "pf_r", "A_r",
                                            "vsh")]
        with _interpret():
            total_j, sign_j, vp_j = lbs_pallas._v2v_fwd_pallas(
                *j_in, c["pd_tiles"], c["w_tiles"], V, tb=8, want_vp=True)
            grads_j = lbs_pallas._bwd_pallas(
                j_in[0], j_in[1], j_in[4], c["pd_tiles"], c["w_tiles"], V,
                sign_j.astype(jnp.float32), tb=8, vp=vp_j)
        args = [T(c[k]) for k in ("pf", "A34", "vsh")] + list(_tables(c)) + [
            T(c["pf_r"]), T(c["A_r"])]
        total, sign, vp = lbs.v2v_pair_plain(*args, want_vp=True)
        # 7200 |diff| terms of O(10) summed in another order
        _close(total, total_j, rtol=1e-5)
        # the +-10 m offset keeps every difference far from 0: exact signs
        np.testing.assert_array_equal(
            _np(sign), np.asarray(sign_j, np.float32)[:, :, :V])
        assert set(np.unique(_np(sign))) <= {-1.0, 1.0}
        _close(vp, np.asarray(vp_j)[:B, :, :V], atol=2e-5)
        got = lbs.skin_bwd_plain(*args[:5], sign, vp)
        for name, a, b in zip(("gpf", "gA", "gvsh"), got, grads_j):
            _close(a, b, atol=3e-3, rtol=1e-3, err_msg=name)

    @pytest.mark.parametrize("vjp", lbs.VJP_MODES)
    def test_skin_v2v_l1_grads_match_jax(self, skin_case, vjp):
        c = skin_case
        V = c["V"]
        tiles = (c["pd_tiles"], c["w_tiles"])
        f = lambda pf, A, vsh: lbs_pallas.skin_v2v_l1(
            V, pf, A, vsh, *tiles, jnp.asarray(c["pf_r"]),
            jnp.asarray(c["A_r"]))
        total_j, g_j = jax.value_and_grad(f, argnums=(0, 1, 2))(
            *(jnp.asarray(c[k]) for k in ("pf", "A34", "vsh")))
        t = [T(c[k], requires_grad=True) for k in ("pf", "A34", "vsh")]
        total = lbs.skin_v2v_l1(V, *t, *_tables(c), T(c["pf_r"]),
                                T(c["A_r"]), vjp=vjp)
        (1.5 * total).backward()
        _close(total, total_j, rtol=1e-5)
        for name, a, b in zip(("pf", "A34", "vsh"), t, g_j):
            b = 1.5 * np.asarray(b)
            _close(a.grad, b, atol=1e-5 * np.abs(b).max() + 1e-7,
                   err_msg=name)

    def test_modes_give_identical_plain_grads(self, skin_case):
        c = skin_case
        grads = {}
        for vjp in lbs.VJP_MODES:
            t = [T(c[k], requires_grad=True) for k in ("pf", "A34", "vsh")]
            lbs.skin_v2v_l1(c["V"], *t, *_tables(c), T(c["pf_r"]),
                            T(c["A_r"]), vjp=vjp).backward()
            grads[vjp] = [x.grad for x in t]
        for vjp in ("pair", "pair_vp"):
            assert all(torch.equal(a, b) for a, b in
                       zip(grads[vjp], grads["fused"])), vjp

    def test_unknown_mode_raises(self, skin_case):
        c = skin_case
        with pytest.raises(ValueError, match="vjp"):
            lbs.skin_v2v_l1(c["V"], *(T(c[k]) for k in ("pf", "A34", "vsh")),
                            *_tables(c), T(c["pf_r"]), T(c["A_r"]),
                            vjp="bf16")


# ---------------------------------------------------------------------------
# body model: vertex-major meshes and the vertex subset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    return jm, smpl_from_numpy(jm)


@pytest.mark.parametrize("n", [64, 100, 300, 1000])
def test_subset_skin_tables_match_jax(models, n):
    jm, tm = models
    vidx_j, pd_tiles, w_tiles = jsmpl.subset_skin_tables(jm, n)
    vidx, pd_sub, w_sub = tsmpl.subset_skin_tables(tm, n)
    np.testing.assert_array_equal(_np(vidx), np.asarray(vidx_j))
    assert vidx.dtype == torch.long
    pd_j, w_j = lbs_pallas._untile(pd_tiles, w_tiles, len(vidx))
    np.testing.assert_array_equal(_np(pd_sub), np.asarray(pd_j))
    np.testing.assert_array_equal(_np(w_sub), np.asarray(w_j))
    assert pd_sub.is_contiguous() and w_sub.is_contiguous()


@pytest.mark.parametrize("subset", [False, True])
def test_smpl_verts_t_value_and_grads(models, subset):
    """The mesh and the gradients of sum(sin(mesh)) with respect to the
    betas (through the v_shaped gather for the subset), the body rotations
    and the global orientation."""
    jm, tm = models
    rng = np.random.RandomState(9)
    from scipy.spatial.transform import Rotation
    rot = Rotation.from_rotvec(0.4 * rng.randn(5 * 24, 3)).as_matrix()
    rot = rot.reshape(5, 24, 3, 3).astype(np.float32)
    betas = (0.4 * rng.randn(1, 10)).astype(np.float32)
    body, orient = rot[:, 1:], rot[:, :1]
    if subset:
        sub_j = jsmpl.subset_skin_tables(jm, 64)
        sub_t = tsmpl.subset_skin_tables(tm, 64)
        jf = lambda b, r, o: jsmpl.smpl_verts_t_subset(jm, b, r, o, *sub_j)
        tf = lambda b, r, o: tsmpl.smpl_verts_t_subset(tm, b, r, o, *sub_t)
    else:
        jf = lambda b, r, o: jsmpl.smpl_verts_t(jm, b, r, o)
        tf = lambda b, r, o: tsmpl.smpl_verts_t(tm, b, r, o)
    vj, pull = jax.vjp(jf, *(jnp.asarray(a) for a in (betas, body, orient)))
    gj = pull(jnp.cos(vj))
    t = [T(a, requires_grad=True) for a in (betas, body, orient)]
    vt = tf(*t)
    torch.sin(vt).sum().backward()
    assert vt.shape == vj.shape
    _close(vt, vj, atol=2e-5)
    for name, a, b in zip(("betas", "body_rot", "orient"), t, gj):
        b = np.asarray(b)
        _close(a.grad, b, atol=2e-5 * np.abs(b).max(), err_msg=name)


# ---------------------------------------------------------------------------
# the fit's configurations
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    bundle, _ = jax_synthetic_problem(jm, num_views=NV, num_frames=NF, seed=0)
    spin = bundle.hmr_theta + 0.05 * np.random.RandomState(4).randn(
        *bundle.hmr_theta.shape).astype(np.float32)
    bundle = dataclasses.replace(bundle, spin_theta=spin)
    gmm = jax_synthetic_gmm(4)
    vposer = jax_init_vposer(jax.random.PRNGKey(7))
    return dict(
        jm=jm, tm=smpl_from_numpy(jm), bundle=bundle, gmm=gmm, vposer=vposer,
        tgmm=gmm_from_numpy(gmm.means, gmm.precisions, gmm.nll_weights),
        tvposer=vposer_from_numpy({k: np.asarray(v)
                                   for k, v in vposer.items()}),
        cache={})


def _setup(pb, name, **over):
    """(JAX cfg, port cfg, JAX assets, port assets) for CONFIGS[name]."""
    key = (name, tuple(sorted(over.items())))
    if key not in pb["cache"]:
        cfg = jfit.NemoConfig(**{**BASE, **CONFIGS[name], **over})
        tcfg = tfit.NemoConfig(**dataclasses.asdict(cfg))
        ja = jfit.build_assets(pb["bundle"], pb["jm"], cfg, gmm=pb["gmm"],
                               vposer=pb["vposer"])
        ta = tfit.build_assets(pb["bundle"], pb["tm"], tcfg, gmm=pb["tgmm"],
                               vposer=pb["tvposer"], device="cpu")
        pb["cache"][key] = (cfg, tcfg, ja, ta)
    return pb["cache"][key]


def _perturbed(params, seed=3, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: a + scale * jnp.asarray(
            rng.randn(*a.shape).astype(np.float32)), params)


def _port_params(tcfg, jparams):
    tp = tfit.init_params(tcfg, NV, 1000.0)
    return params_from_numpy(tp, _flatten_with_paths(jparams))


def _grads_np(tp):
    return {n.replace(".", "/"): (p.grad.numpy() if p.grad is not None
                                  else np.zeros(tuple(p.shape), np.float32))
            for n, p in tp.named_parameters()}


def _stage_batch(cfg, stage, seed):
    if stage == "camera" and cfg.model_version < 4:
        return np.arange(NV, dtype=np.int32), np.zeros(NV, np.int32)
    rng = np.random.RandomState(1000 + seed)
    return (rng.randint(0, NV, size=16).astype(np.int32),
            rng.randint(0, NF, size=16).astype(np.int32))


def _jax_stage(pb, name, stage, jparams, vi, fi, key):
    """value_and_grad of one stage's JAX loss, compiled once per stage and
    configuration."""
    ck = ("jit", name, stage)
    if ck not in pb["cache"]:
        cfg, _, ja, _ = _setup(pb, name)
        fn = {"fit": lambda p, v, f, k: jfit.fit_loss(p, cfg, ja, v, f, key=k,
                                                      training=True),
              "warmup": lambda p, v, f, k: jfit.warmup_loss(p, cfg, ja, v, f),
              "camera": lambda p, v, f, k: jfit.camera_stage_loss(
                  p, cfg, ja, v, f, key=k)}[stage]
        pb["cache"][ck] = jax.jit(jax.value_and_grad(fn, has_aux=True))
    return pb["cache"][ck](jparams, jnp.asarray(vi), jnp.asarray(fi), key)


def _check_stage(pb, name, stage, point="perturbed", vjp="fused"):
    """Loss, metrics and every group's gradient of one stage's loss, with
    the JAX code-noise draw injected into the port."""
    cfg, tcfg, _, ta = _setup(pb, name)
    if vjp != "fused":
        ta = dataclasses.replace(ta, v2v_vjp=vjp)
    jparams = jfit.init_params(jax.random.PRNGKey(0), cfg, NV, 1000.0)
    if point == "perturbed":
        jparams = _perturbed(jparams)
    vi, fi = _stage_batch(cfg, stage, seed=2)
    key = jax.random.PRNGKey(11)
    noise = None
    if cfg.code_noise > 0 and cfg.uses_instance_code:
        # the draw fit_loss makes from its key (nemo_tpu/fit/model.py:214)
        noise = T(np.asarray(jax.random.normal(
            key, (len(vi), cfg.instance_code_size))))
    (loss_j, metrics_j), grads_j = _jax_stage(pb, name, stage, jparams,
                                              vi, fi, key)
    tp = _port_params(tcfg, jparams)
    vt, ft = torch.as_tensor(vi).long(), torch.as_tensor(fi).long()
    if stage == "fit":
        loss_t, metrics_t = tfit.fit_loss(tp, tcfg, ta, vt, ft, noise=noise)
    elif stage == "warmup":
        loss_t, metrics_t = tfit.warmup_loss(tp, tcfg, ta, vt, ft)
    else:
        loss_t, metrics_t = tfit.camera_stage_loss(tp, tcfg, ta, vt, ft,
                                                   noise=noise)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=2e-5)
    assert sorted(metrics_t) == sorted(metrics_j)
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics_t[k].detach()),
                                   float(metrics_j[k]), rtol=5e-5, err_msg=k)
    flat_j = _flatten_with_paths(grads_j)
    flat_t = _grads_np(tp)
    assert sorted(flat_t) == sorted(flat_j)
    if stage == "camera" and cfg.model_version < 4:
        # the V0-V3 camera stage trains the cameras only; at frame 0 the
        # other gradients are f32 cancellation noise on both sides
        flat_j = {"cameras": flat_j["cameras"]}
    for k, gj in flat_j.items():
        np.testing.assert_allclose(flat_t[k], gj, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(gj).max()) + 1e-9,
                                   err_msg=k)
    return float(loss_t.detach())


@pytest.mark.parametrize("stage", ["fit", "warmup", "camera"])
@pytest.mark.parametrize("name", ["v0", "v1", "v3", "v4"])
def test_stage_loss_and_grads_match_jax(problem, name, stage):
    _check_stage(problem, name, stage)


@pytest.mark.parametrize("point", ["init", "perturbed"])
def test_vertex_subset_fit_loss_matches_jax(problem, point):
    """vp_v2v_n_verts: the v2v prior on 64 vertices through K3 (the rec
    side forward only, the orig side forward and backward)."""
    _check_stage(problem, "v3_subset", "fit", point)


@pytest.mark.parametrize("vjp", ["pair", "pair_vp"])
def test_pair_vjp_fit_loss_matches_jax(problem, vjp):
    """The full-mesh prior with K2 in pair mode and K3b in the backward."""
    _check_stage(problem, "v1", "fit", vjp=vjp)


def test_code_noise_enters_the_loss(problem):
    """The injected draw moves the V3 loss (so the parity above tests the
    noise path), and no draw gives the noiseless loss."""
    cfg, tcfg, _, ta = _setup(problem, "v3")
    tp = _port_params(tcfg, _perturbed(jfit.init_params(
        jax.random.PRNGKey(0), cfg, NV, 1000.0)))
    vi, fi = (torch.as_tensor(a).long() for a in _stage_batch(cfg, "fit", 2))
    noise = torch.randn((len(vi), cfg.instance_code_size),
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        clean = tfit.fit_loss(tp, tcfg, ta, vi, fi)[0]
        noisy = tfit.fit_loss(tp, tcfg, ta, vi, fi, noise=noise)[0]
        off = tfit.fit_loss(tp, dataclasses.replace(tcfg, code_noise=0.0),
                            ta, vi, fi, noise=noise)[0]
    assert float(noisy) != float(clean)
    assert float(off) == float(clean)


def test_full_batch_grid_and_v4_projection(problem):
    cfg, tcfg, _, ta = _setup(problem, "v4")
    np.testing.assert_array_equal(tcfg.proj_joint_idx, cfg.proj_joint_idx)
    assert list(tcfg.proj_joint_idx) == list(range(25))
    f = tfit.NemoFitter(dataclasses.replace(tcfg, full_batch=True), ta)
    vi, fi = f._grid
    np.testing.assert_array_equal(_np(vi), np.repeat(np.arange(NV), NF))
    np.testing.assert_array_equal(_np(fi), np.tile(np.arange(NF), NV))


class TestWeightsAndGroups:
    @pytest.mark.parametrize("name", ["v0", "v1", "v4"])
    def test_params_roundtrip(self, problem, name):
        cfg, tcfg, _, _ = _setup(problem, name)
        flat = _flatten_with_paths(jfit.init_params(jax.random.PRNGKey(5),
                                                    cfg, NV, 1000.0))
        tp = tfit.init_params(tcfg, NV, 1000.0)
        back = params_to_numpy(params_from_numpy(tp, flat))
        assert sorted(back) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k], k)
        assert {k.split("/")[0] for k in back} <= set(version_groups(tcfg))

    def test_v0_groups_and_decay(self, problem):
        _, tcfg, _, _ = _setup(problem, "v0")
        tp = tfit.init_params(tcfg, NV, 1000.0)
        opt = GroupOptimizer(tp, dataclasses.replace(
            tcfg, wd_human=0.01))
        assert sorted(opt.groups) == ["cameras", "orient", "phase", "poses",
                                      "trans"]
        assert {g: o.wd for g, o in opt.groups.items()} == {
            "cameras": 0.0, "orient": 0.01, "phase": 0.0, "poses": 0.01,
            "trans": 0.0}
        assert set(version_groups(tcfg)) | {"motion", "rbf", "instance"} \
            == set(GROUPS)

    @pytest.mark.parametrize("field,value", [
        ("model_version", 0), ("model_version", 3), ("vp_v2v_n_verts", 64),
        ("weight_3d_loss", 1.0), ("code_noise", 0.1), ("full_batch", True)])
    def test_formerly_unported_settings_build(self, problem, field, value):
        _, tcfg, _, _ = _setup(problem, "v1")
        tfit.init_params(dataclasses.replace(tcfg, **{field: value}), NV,
                         1000.0)


# ---------------------------------------------------------------------------
# trajectories: the three stages with replayed batches
# ---------------------------------------------------------------------------

WARMUP, CAM, MAIN = 3, 4, 6


def _replay(seed, cfg):
    """The JAX fitter's batch stream (fit/loop.py key threading: warmup
    key,k1 = split(key); V4 camera and main key,k1,k2 = split(key, 3))."""
    key = jax.random.PRNGKey(seed)
    _k_init, key = jax.random.split(key)
    B = cfg.batch_size
    out = {"warmup": [], "camera": [], "main": []}
    for _ in range(WARMUP):
        key, k1 = jax.random.split(key)
        out["warmup"].append(_sample_batch(k1, B, NV, NF))
    for _ in range(CAM if cfg.model_version >= 4 else 0):
        key, k1, _k2 = jax.random.split(key, 3)
        out["camera"].append(_sample_batch(k1, B, NV, NF))
    for _ in range(MAIN):
        key, k1, _k2 = jax.random.split(key, 3)
        out["main"].append(_sample_batch(k1, B, NV, NF))
    return out


def _run_both(cfg, tcfg, ja, ta, main_steps):
    """Both fitters through warmup, the camera stage and main_steps main
    steps (two chunks) from the same parameters, the JAX batch stream
    replayed into the port."""
    cfg = dataclasses.replace(cfg, n_steps=main_steps, warmup_step=WARMUP,
                              opt_cam_step=CAM)
    tcfg = tfit.NemoConfig(**dataclasses.asdict(cfg))
    jf = jfit.NemoFitter(cfg, ja, seed=0)
    params0 = jf.state.params
    jm = (jf.warmup(), jf.opt_cam(), jf.fit(chunk=max(1, main_steps // 2)))
    batches = _replay(0, cfg)
    tf = tfit.NemoFitter(tcfg, ta, seed=0,
                         batch_source=lambda s, i: batches[s][i])
    params_from_numpy(tf.params, _flatten_with_paths(params0))
    tm = (tf.warmup(), tf.opt_cam(), tf.fit(chunk=max(1, main_steps // 2)))
    return dict(jax=jm, port=tm, jf=jf, tf=tf)


def _traj_close(t, j, name):
    np.testing.assert_allclose(t[:5], j[:5], rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(t, j, rtol=1e-3, err_msg=name)


@pytest.fixture(scope="module")
def v4_trajectory(problem):
    """The V4 camera stage on random batches, then full-batch main steps
    with the vertex-subset prior. No code noise: the two RNGs cannot
    match."""
    return _run_both(*_setup(problem, "v4", full_batch=True,
                                      code_noise=0.0, vp_v2v_n_verts=64),
                     MAIN)


def test_v4_trajectory_warmup_and_camera_stage(v4_trajectory):
    (jw, jc, _), (tw, tc, _) = v4_trajectory["jax"], v4_trajectory["port"]
    _traj_close(tw["warmup_loss"], jw["warmup_loss"], "warmup")
    assert sorted(tc) == sorted(jc) and "loss_3d" in tc
    for k in jc:
        _traj_close(tc[k], jc[k], f"camera {k}")


def test_v4_trajectory_full_batch_main_stage(v4_trajectory):
    (_, _, jm), (_, _, tm) = v4_trajectory["jax"], v4_trajectory["port"]
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _traj_close(tm[k], jm[k], f"main {k}")
    jf, tf = v4_trajectory["jf"], v4_trajectory["tf"]
    for g, s in tf.plateau.items():
        assert float(s.scale) == float(jf.state.plateau[g].scale), g
    ej, et = jf.eval_loss(), tf.eval_loss()
    for k in ej:
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-3, err_msg=k)


def test_v0_trajectory_warmup_camera_and_first_main_step(problem):
    """V0's fresh warmup Adam over the pose network, the camera stage, and
    the first main step. Later main steps are not compared: V0 subtracts
    trans(0) from trans(warped), so a layer-2 unit active at both gives a
    b2 gradient that is a difference of two equal batch sums, pure f32
    noise on both sides, and Adam's first update maps that noise to +-lr.
    The two frameworks part at the 1e-4 level from the second main step."""
    r = _run_both(*_setup(problem, "v0"), 1)
    (jw, jc, jm), (tw, tc, tm) = r["jax"], r["port"]
    _traj_close(tw["warmup_loss"], jw["warmup_loss"], "warmup")
    _traj_close(tc["cam_loss"], jc["cam_loss"], "camera")
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CSVS = ("eval_2d.csv", "eval_3d.csv", "eval_3d_dynamic.csv",
        "eval_3d_global.csv")


@pytest.mark.parametrize("version", ["0", "3", "4"])
def test_port_cli_configurations_write_every_csv(tmp_path, version):
    """In process; tests/test_torch_port_cli.py runs the CLI in a fresh
    interpreter that must never import jax."""
    from nemo_tpu_torch.cli.fit import main
    flags = ["--synthetic_assets", "--model_version", version,
             "--phase_rbf_dim", "8", "--rbf_kernel", "quadratic",
             "--h_dim", "16", "--monotonic_network_n_nodes", "4",
             "--instance_code_size", "4", "--batch_size", "16",
             "--n_steps", "2", "--warmup_step", "1", "--opt_cam_step", "1",
             "--save_every", "2", "--label_type", "gt", "--loss",
             "mse_robust", "--weight_vp_loss", "1.0", "--full_batch",
             "--weight_3d_loss", "1", "--weight_instance_loss", "0.1",
             "--code_noise", "0.01", "--vp_v2v_n_verts", "64",
             "--device", "cpu", "--out_dir", str(tmp_path)]
    assert main(flags) == 0
    run = tmp_path / "000000"
    for name in ("config.json", "metrics.jsonl", "losses.npz") + CSVS:
        assert (run / name).is_file(), name
    losses = np.load(run / "losses.npz")
    assert np.isfinite(losses["total_loss"]).all()
    if version != "0":
        assert "loss_3d" in losses and "instance_loss" in losses
