"""The HuMoR evaluation functions in the port against nemo_tpu on the CPU:
humor_eval_metrics, humor_eval_full_test, humor_eval_sampling and
humor_eval_recon, and the rollout's injected draws.

Both packages run JAX's init_humor weights (the reference widths) on the
same (N, T, 207) windows from np.random.default_rng: a few sequences of a
few frames. The sampled paths take JAX's own draws (jax.random.normal on
the keys JAX splits), given to the port through ``draw``. Tolerance:
every reported number within rtol 1e-5 (the sampled rollouts' statistics
too), the counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.models import humor as jh
from nemo_tpu.models import humor_eval as je
from nemo_tpu_torch.models import humor as th
from nemo_tpu_torch.models import humor_eval as te

torch.set_num_threads(2)
CFG = jh.HumorConfig()
TCFG = th.HumorConfig()
L = CFG.latent_size
RTOL = 1e-5


@pytest.fixture(scope="module")
def params():
    p = jh.init_humor(jax.random.PRNGKey(0), CFG)
    return p, th.humor_from_numpy(p)


def seqs(seed, N=3, T=5):
    """Smooth random walks, as the CLI's synthetic windows."""
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((N, 1, 207)) * 0.3
    steps = rng.standard_normal((N, T - 1, 207)) * 0.05
    return np.cumsum(np.concatenate([x0, steps], 1), 1).astype(np.float32)


def _dict_close(got, want, rtol=RTOL):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = float(v)
        assert abs(got[k] - v) <= rtol * max(abs(v), 1e-12), (k, got[k], v)


class Draws:
    """draw(shape) handing out precomputed arrays in order."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, shape):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("rollout_steps", [2, 10])
def test_eval_metrics(params, rollout_steps):
    jp, tp = params
    x = seqs(1)
    want = je.humor_eval_metrics(jp, CFG, x, rollout_steps=rollout_steps)
    got = te.humor_eval_metrics(tp, TCFG, x, rollout_steps=rollout_steps)
    _dict_close(got, want)


@pytest.mark.parametrize("batch_size", [2, 8])
def test_eval_full_test(params, batch_size):
    """Mean and std of the one-step training stats over batches, with the
    posterior draw JAX takes for each batch."""
    jp, tp = params
    x = seqs(2, N=5, T=4)
    key = jax.random.PRNGKey(3)
    draws, k = [], key
    for i in range(0, 5, batch_size):
        k, kb = jax.random.split(k)
        n = min(batch_size, 5 - i) * 3
        draws.append(np.asarray(jax.random.normal(kb, (n, L))))
    want = je.humor_eval_full_test(jp, CFG, x, key=key,
                                   batch_size=batch_size)
    got = te.humor_eval_full_test(tp, TCFG, x, batch_size=batch_size,
                                  draw=Draws(draws))
    _dict_close(got, want)
    assert "rec_joints" in got and "loss_std" in got


def jax_sampling_draws(key, num_samples, steps, N):
    """The prior draws humor_eval_sampling's rollouts take, in order."""
    out = []
    for _ in range(num_samples):
        key, k = jax.random.split(key)
        for ks in jax.random.split(k, steps):
            out.append(np.asarray(jax.random.normal(ks, (N, L))))
    return out


@pytest.mark.parametrize("num_samples,samp_len", [(3, None), (2, 6)])
def test_eval_sampling(params, num_samples, samp_len):
    jp, tp = params
    x = seqs(4)
    key = jax.random.PRNGKey(5)
    steps = samp_len or x.shape[1] - 1
    want = je.humor_eval_sampling(jp, CFG, x, key=key,
                                  num_samples=num_samples, samp_len=samp_len)
    got = te.humor_eval_sampling(
        tp, TCFG, x, num_samples=num_samples, samp_len=samp_len,
        draw=Draws(jax_sampling_draws(key, num_samples, steps, 3)))
    _dict_close(got, want)


def test_eval_sampling_own_draws(params):
    """Without draw, a seeded generator: the same seed, the same numbers;
    samples differ from each other."""
    _, tp = params
    x = seqs(6)
    a = te.humor_eval_sampling(tp, TCFG, x, seed=1)
    b = te.humor_eval_sampling(tp, TCFG, x, seed=1)
    assert a == b and a["sample_diversity"] > 0


def test_eval_recon(params):
    jp, tp = params
    x = seqs(7, N=2, T=6)
    _dict_close(te.humor_eval_recon(tp, TCFG, x),
                je.humor_eval_recon(jp, CFG, x))


def test_roll_out_injected_draws(params):
    """humor_roll_out(draw=...) takes each step's prior draw from draw:
    JAX's rollout from the same key gives the same states."""
    jp, tp = params
    x0 = seqs(8)[:, 0]
    key = jax.random.PRNGKey(9)
    want = jh.humor_roll_out(jp, CFG, jnp.asarray(x0), 4, key=key)
    draws = [np.asarray(jax.random.normal(k, (3, L)))
             for k in jax.random.split(key, 4)]
    got = th.humor_roll_out(tp, TCFG, torch.from_numpy(x0), 4,
                            draw=Draws(draws))
    for k in ("states", "z", "prior_var"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert np.abs(g - w).max() <= RTOL * np.abs(w).max(), k
