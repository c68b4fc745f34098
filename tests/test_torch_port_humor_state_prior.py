"""The HuMoR init-state GMM prior (EM) in the port against nemo_tpu on the
CPU: _component_log_prob, EM from JAX's own k-means++ means against JAX's
fit_state_prior_gmm with the same key, the NaN factors of a covariance
that is not positive definite, the port's own k-means++ recovering a
planted mixture (as tests/test_state_prior_train.py does for JAX),
prior_gmm.npz into load_init_motion_prior in both packages, and
states_from_sequences.

Inputs come from np.random.default_rng. Tolerances: log-probabilities
within rtol 1e-5; EM's log-likelihood curve within rtol 1e-4 (f32
E-steps summed in other orders drift over 30 iterations) and its
weights, means and covariances within 1e-4 of their largest entries;
the init-state NLL within rtol 1e-5; states_from_sequences exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.models import humor_fit as jfit
from nemo_tpu.models import humor_state_prior as jsp
from nemo_tpu_torch.models import humor_fit as tfit
from nemo_tpu_torch.models import humor_state_prior as tsp

torch.set_num_threads(2)


def _close(got, want, rtol, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def mixture(rng, n=1200, d=6, k=3, spread=3.0, noise=0.6):
    means = rng.standard_normal((k, d)) * spread
    comps = rng.choice(k, size=n, p=np.linspace(1, 2, k) / np.linspace(
        1, 2, k).sum())
    x = means[comps] + rng.standard_normal((n, d)) * noise
    return x.astype(np.float32), means


def test_component_log_prob():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 5)).astype(np.float32)
    means = rng.standard_normal((3, 5)).astype(np.float32)
    a = rng.standard_normal((3, 5, 5))
    covs = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(5)).astype(np.float32)
    chols = np.linalg.cholesky(covs).astype(np.float32)
    want = jsp._component_log_prob(jnp.asarray(x), jnp.asarray(means),
                                   jnp.asarray(chols))
    got = tsp._component_log_prob(torch.from_numpy(x),
                                  torch.from_numpy(means),
                                  torch.from_numpy(chols))
    assert got.shape == (50, 3)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("seed,k,n_iter", [(1, 3, 30), (2, 4, 30)])
def test_em_from_jax_kmeans_init(seed, k, n_iter):
    """EM from _kmeans_init(key, x, K)'s means, the ones JAX's
    fit_state_prior_gmm computes from the same key."""
    rng = np.random.default_rng(seed)
    x, _ = mixture(rng, k=k)
    key = jax.random.PRNGKey(seed)
    init = np.asarray(jsp._kmeans_init(key, jnp.asarray(x), k))
    jg, jll = jsp.fit_state_prior_gmm(jnp.asarray(x), n_components=k,
                                      n_iter=n_iter, key=key)
    tg, tll = tsp.fit_state_prior_gmm(x, n_components=k, n_iter=n_iter,
                                      init_means=init)
    assert tll.shape == (n_iter,)
    _close(tll, jll, 1e-4, "log-likelihood curve")
    for name in ("weights", "means", "covariances"):
        _close(tg[name], jg[name], 1e-4, name)


def test_em_nan_where_not_positive_definite():
    """A component that collapses onto fewer points than dimensions makes
    a covariance that is not positive definite: both packages go on with
    NaN factors (no error) and end NaN alike."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal((40, 8)),
                        np.full((2, 8), 50.0)]).astype(np.float32)
    init = np.stack([x[:40].mean(0), x[40]]).astype(np.float32)
    cov = np.eye(8, dtype=np.float32)[None].repeat(2, 0)
    cov[1, 0, 0] = -1.0
    L = tsp._cholesky_nan(torch.from_numpy(cov))
    assert torch.isnan(L[1]).all() and not torch.isnan(L[0]).any()
    jg, jll = jsp.fit_state_prior_gmm(jnp.asarray(x), n_components=2,
                                      n_iter=3, key=jax.random.PRNGKey(0),
                                      reg_covar=0.0)
    tg, tll = tsp.fit_state_prior_gmm(x, n_components=2, n_iter=3,
                                      init_means=init, reg_covar=0.0)
    np.testing.assert_array_equal(np.isnan(tll.numpy()),
                                  np.isnan(np.asarray(jll)))


def test_own_kmeans_recovers_planted_mixture():
    """The port's k-means++ (torch.multinomial on a seeded generator) and
    EM recover the planted components, as the JAX package's test does."""
    rng = np.random.default_rng(0)
    d = 5
    true = np.array([[4.0] * d, [-4.0] * d, [4.0, -4.0] * (d // 2) + [0.0]])
    w = np.array([0.5, 0.3, 0.2])
    comps = rng.choice(3, size=1500, p=w)
    x = (true[comps] + rng.standard_normal((1500, d)) * 0.7).astype(
        np.float32)
    gmm, ll = tsp.fit_state_prior_gmm(
        x, n_components=3, n_iter=60,
        generator=torch.Generator().manual_seed(0))
    ll = ll.numpy()
    assert np.all(np.diff(ll) > -1e-3)
    means, weights = gmm["means"].numpy(), gmm["weights"].numpy()
    order = [int(np.argmin(np.linalg.norm(means - m, axis=1))) for m in true]
    assert sorted(order) == [0, 1, 2]
    for m, o in zip(true, order):
        assert np.linalg.norm(means[o] - m) < 0.3
    np.testing.assert_allclose(weights[order], w, atol=0.05)


def test_kmeans_init_seeds_distinct_points():
    """Each k-means++ seed is a data point; Lloyd keeps an empty cluster's
    centre; the same generator seed gives the same means."""
    rng = np.random.default_rng(4)
    x, _ = mixture(rng, n=300, k=3)
    t = torch.from_numpy(x)
    a = tsp._kmeans_init(t, 3, torch.Generator().manual_seed(5),
                         lloyd_iters=0)
    assert all(bool((t == a[i]).all(1).any()) for i in range(3))
    b = tsp._kmeans_init(t, 3, torch.Generator().manual_seed(5))
    c = tsp._kmeans_init(t, 3, torch.Generator().manual_seed(5))
    assert torch.equal(b, c)


def test_save_load_round_trip(tmp_path):
    """prior_gmm.npz written by the port (float64) loads through both
    packages' load_init_motion_prior; their init-state NLLs agree."""
    rng = np.random.default_rng(5)
    x, _ = mixture(rng, n=800, d=138, k=2, noise=0.8)
    gmm, _ = tsp.fit_state_prior_gmm(x, n_components=2, n_iter=15,
                                     generator=torch.Generator()
                                     .manual_seed(1))
    path = str(tmp_path / "prior_gmm.npz")
    tsp.save_state_prior_gmm(path, gmm)
    with np.load(path) as f:
        assert sorted(f.files) == ["covariances", "means", "weights"]
        assert all(f[k].dtype == np.float64 for k in f.files)
    tp = tfit.load_init_motion_prior(str(tmp_path))
    jp = jfit.load_init_motion_prior(path)
    for s in x[:5]:
        got = tfit.init_state_gmm_nll(torch.from_numpy(s), tp)
        want = jfit.init_state_gmm_nll(jnp.asarray(s), jp)
        assert np.isfinite(float(got))
        _close(got, want, 1e-5)


def test_jax_written_prior_loads_into_port(tmp_path):
    """And the reverse: JAX's save_state_prior_gmm file through the
    port's loader, the factors equal."""
    rng = np.random.default_rng(6)
    x, _ = mixture(rng, n=400, d=7, k=2)
    jg, _ = jsp.fit_state_prior_gmm(jnp.asarray(x), n_components=2,
                                    n_iter=10, key=jax.random.PRNGKey(2))
    path = str(tmp_path / "prior_gmm.npz")
    jsp.save_state_prior_gmm(path, jg)
    tp, jp = tfit.load_init_motion_prior(path), \
        jfit.load_init_motion_prior(path)
    for k in ("log_weights", "means", "chol", "logdet"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_states_from_sequences():
    rng = np.random.default_rng(7)
    seqs = rng.standard_normal((3, 5, 207)).astype(np.float32)
    got = tsp.states_from_sequences(torch.from_numpy(seqs))
    want = jsp.states_from_sequences(jnp.asarray(seqs))
    assert got.shape == (15, 138)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
