"""The port's seed fan-out (parallel.fanout) against nemo_tpu's.

JAX's fit_many_seeds vmaps S main-stage fits; the port steps S NemoFitters
in lockstep. Each port seed starts from JAX's init parameters for that seed
(JAX's make_fanout inputs, in place of the port's make_fanout inputs) and
replays JAX's per-seed batch stream (the key
threading of nemo_tpu/parallel/fanout.py), with no code noise, so the loss
curves must agree: within 1e-4 for the first 5 steps and 1e-3 after (the
twin's tolerances), with and without the VPoser prior (K2's plain version
here). Each seed is also, bit for bit, a lone NemoFitter main stage of the
port from the same start, and make_fanout's program runs again to the
same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu import fit as jfit
from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.data import synthetic_problem as jax_synthetic_problem
from nemo_tpu.fit.loop import _sample_batch
from nemo_tpu.parallel import fit_many_seeds as jax_fit_many_seeds
from nemo_tpu.parallel import make_fanout as jax_make_fanout
from nemo_tpu.priors import init_vposer as jax_init_vposer
from nemo_tpu.utils.checkpoint import _flatten_with_paths
from nemo_tpu_torch import fit as tfit
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.parallel import fit_many_seeds, make_fanout
from nemo_tpu_torch.utils.checkpoint import params_from_numpy, \
    vposer_from_numpy

torch.set_num_threads(2)
S, STEPS, B = 3, 8, 8


def _problem(vposer: bool):
    jm = jax_synthetic_smpl(num_vertices=200, seed=0)
    bundle, _ = jax_synthetic_problem(jm, num_views=2, num_frames=8)
    kw = dict(weight_vp_loss=1.0, weight_vp_z_loss=0.1) if vposer else {}
    cfg = jfit.NemoConfig(model_version=2, h_dim=16, instance_code_size=2,
                          phase_rbf_dim=8, monotonic_network_n_nodes=4,
                          batch_size=B, weight_gmm_loss=0.0,
                          label_type="gt", lr_factor=1.0, **kw)
    vp = jax_init_vposer(jax.random.PRNGKey(0)) if vposer else None
    jassets = jfit.build_assets(bundle, jm, cfg, vposer=vp)
    tcfg = tfit.NemoConfig(**{f: getattr(cfg, f) for f in
                              cfg.__dataclass_fields__})
    tassets = tfit.build_assets(
        bundle, smpl_from_numpy(jm), tcfg, device="cpu",
        vposer=None if vp is None else vposer_from_numpy(
            {k: np.asarray(v) for k, v in vp.items()}))
    return cfg, jassets, tcfg, tassets


def _streams(V, F):
    """Per seed, JAX's fan-out batches: run key fold_in(PRNGKey(s), 1),
    then key, k1, k2 = split(key, 3) and k1's batch each step."""
    out = []
    for s in range(S):
        key = jax.random.fold_in(jax.random.PRNGKey(s), 1)
        steps = []
        for _ in range(STEPS):
            key, k1, _k2 = jax.random.split(key, 3)
            steps.append(tuple(np.asarray(a) for a in
                               _sample_batch(k1, B, V, F)))
        out.append(steps)
    return out


def _sources(streams):
    return [lambda stage, i, st=st: st[i] for st in streams]


@pytest.fixture(scope="module", params=["plain", "vposer"])
def sweep(request):
    cfg, jassets, tcfg, tassets = _problem(request.param == "vposer")
    _, (params0, *_rest) = jax_make_fanout(cfg, jassets, S, steps=STEPS)
    jout = jax_fit_many_seeds(cfg, jassets, S, steps=STEPS)
    start = [{k: np.asarray(v)[s] for k, v in
              _flatten_with_paths(params0).items()} for s in range(S)]
    streams = _streams(2, 8)
    fan, (seeds, params0) = make_fanout(tcfg, tassets, S, steps=STEPS,
                                        batch_sources=_sources(streams))
    assert params0 == [None] * S     # each fitter's own init_params
    names = tfit.init_params(tcfg, tassets.num_views,
                             tassets.img_d0).state_dict()
    params0 = [{n: torch.tensor(start[s][n.replace(".", "/")])
                for n in names} for s in seeds]
    params, losses = fan(seeds, params0)
    tout = {"params": params, "losses": losses.numpy()}
    return dict(jout=jout, tout=tout, start=start, streams=streams,
                cfg=cfg, jassets=jassets, tcfg=tcfg, tassets=tassets)


def test_losses_match_jax(sweep):
    got, want = sweep["tout"]["losses"], sweep["jout"]["losses"]
    assert got.shape == want.shape == (S, STEPS)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, :5], want[:, :5], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    # the seeds are independent fits
    assert not np.allclose(got[0], got[1])


def test_params_match_jax(sweep):
    """The stacked parameters: '/'-keyed like the JAX checkpoint layout,
    (S, ...) each. Entries whose gradients are f32 noise move by about
    Adam's rate either way in both packages, so the parameters are judged
    by what they fit: JAX's full-grid loss at each seed's port parameters
    is its loss at its own within 1e-3."""
    jflat = {k: np.asarray(v) for k, v in
             _flatten_with_paths(sweep["jout"]["params"]).items()}
    got = {k: v.numpy() for k, v in sweep["tout"]["params"].items()}
    assert sorted(got) == sorted(jflat)
    for k, v in jflat.items():
        assert got[k].shape == v.shape, k
    cfg, jassets = sweep["cfg"], sweep["jassets"]
    V, F = jassets.num_views, jassets.num_frames
    vi, fi = jnp.repeat(jnp.arange(V), F), jnp.tile(jnp.arange(F), V)
    loss = jax.jit(lambda p: jfit.fit_loss(p, cfg, jassets, vi, fi,
                                           training=False)[0])

    def tree(flat, s):
        """Seed s of flat '/'-keyed arrays as JAX's parameter tree."""
        return jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(flat["/".join(
                str(getattr(q, "key", getattr(q, "idx", q)))
                for q in path)][s]), sweep["jout"]["params"])

    for s in range(S):
        np.testing.assert_allclose(float(loss(tree(got, s))),
                                   float(loss(tree(jflat, s))), rtol=1e-3)


def test_each_seed_is_a_lone_fitter(sweep):
    """Seed s of the lockstep sweep equals NemoFitter(seed=s)'s main
    stage from the same start on the same batches, bit for bit."""
    tcfg, tassets = sweep["tcfg"], sweep["tassets"]
    for s in range(S):
        f = tfit.NemoFitter(tcfg, tassets, seed=s,
                            batch_source=_sources(sweep["streams"])[s])
        params_from_numpy(f.params, sweep["start"][s])
        m = f.fit(steps=STEPS, chunk=STEPS)
        np.testing.assert_array_equal(sweep["tout"]["losses"][s],
                                      m["total_loss"])
        for n, p in f.params.named_parameters():
            assert torch.equal(sweep["tout"]["params"][n.replace(".", "/")][s],
                               p.detach()), n


def test_make_fanout_runs_again():
    """make_fanout's (fan, inputs): fresh fitters each call, so the same
    inputs give the same bits, and fit_many_seeds is one such call;
    without batch sources each seed draws its own batches from its own
    generator (seed s = NemoFitter(seed=s))."""
    _, _, tcfg, tassets = _problem(False)
    fan, inputs = make_fanout(tcfg, tassets, 2, steps=3, base_seed=5)
    assert list(inputs[0]) == [0, 1]
    p1, l1 = fan(*inputs)
    p2, l2 = fan(*inputs)
    out = fit_many_seeds(tcfg, tassets, 2, steps=3, base_seed=5)
    assert torch.equal(l1, l2)
    np.testing.assert_array_equal(out["losses"], l1.numpy())
    for k in p1:
        assert torch.equal(p1[k], p2[k])
        assert torch.equal(out["params"][k], p1[k])
    lone = tfit.NemoFitter(tcfg, tassets, seed=6)
    m = lone.fit(steps=3, chunk=3)
    np.testing.assert_array_equal(l1[1].numpy(), m["total_loss"])
    assert not torch.equal(l1[0], l1[1])
