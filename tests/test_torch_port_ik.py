"""The port's IK engine (priors/ik.py) against nemo_tpu's ik_fit on the CPU.

The problem is the JAX test's (tests/test_ik.py): the 200-vertex synthetic
SMPL, JAX's init_vposer weights (512 wide, latent 32), B = 2 targets posed
from a VPoser draw and a translation. Both packages get the same numpy
arrays. Adam (optax's arithmetic) and L-BFGS (optax.lbfgs with its zoom
linesearch) run a few tens of steps: the loss histories and every output
within FIT_RTOL (1e-4, tests/test_torch_port_smplify.py's) of the largest
entry of what is compared; the joint mask (half the targets corrupted and
masked out), a per-row mask and init= likewise. Adam's runs stop where f32
rounding, amplified step by step, would part the packages past FIT_RTOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.body.smpl import smpl_forward as jax_smpl_forward
from nemo_tpu.geometry.rotations import batch_rodrigues as jax_rodrigues
from nemo_tpu.priors import IKConfig as JIKConfig, ik_fit as jax_ik_fit
from nemo_tpu.priors import init_vposer as jax_init_vposer
from nemo_tpu.priors.vposer import vposer_decode as jax_vposer_decode
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.priors import IKConfig, ik_fit
from nemo_tpu_torch.priors.vposer import vposer_from_numpy

torch.set_num_threads(2)
FIT_RTOL = 1e-4
KEYS = ("z", "betas", "orient", "trans", "pose_body", "joints", "loss")


def _close(got, want, rtol, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size == 0:
        return
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


@pytest.fixture(scope="module")
def problem():
    """tests/test_ik.py's fixture, and the port's copies of its body and
    VPoser."""
    jsmpl = jax_synthetic_smpl(num_vertices=200, seed=0)
    jvp = jax_init_vposer(jax.random.PRNGKey(2))
    rng = np.random.RandomState(0)
    B = 2
    z_true = jnp.asarray(0.5 * rng.randn(B, 32).astype(np.float32))
    trans_true = jnp.asarray(0.3 * rng.randn(B, 3).astype(np.float32))
    dec = jax_vposer_decode(jvp, z_true)
    full = jnp.concatenate([dec["pose_body"].reshape(B, 63),
                            jnp.zeros((B, 6))], 1)
    rot = jax_rodrigues(full.reshape(B, 23, 3))
    orient = jax_rodrigues(jnp.zeros((B, 1, 3)))
    _, target = jax_smpl_forward(jsmpl, jnp.zeros((1, 10)), rot, orient,
                                 want_vertices=False, transl=trans_true)
    return (jsmpl, jvp, np.asarray(target), smpl_from_numpy(jsmpl),
            vposer_from_numpy({k: np.asarray(v) for k, v in jvp.items()}))


def _both(problem, target=None, mask=None, init=None, **cfg):
    jsmpl, jvp, jtarget, tsmpl, tvp = problem
    target = jtarget if target is None else target
    want = jax_ik_fit(jsmpl, jvp, jnp.asarray(target),
                      joint_mask=None if mask is None else jnp.asarray(mask),
                      init=None if init is None else
                      {k: jnp.asarray(v) for k, v in init.items()},
                      cfg=JIKConfig(**cfg))
    stats = {}
    got = ik_fit(tsmpl, tvp, torch.from_numpy(target),
                 joint_mask=None if mask is None else torch.from_numpy(mask),
                 init=None if init is None else
                 {k: torch.from_numpy(v) for k, v in init.items()},
                 cfg=IKConfig(**cfg), stats=stats)
    assert sorted(got) == sorted(want) == sorted(KEYS)
    for k in KEYS:
        _close(got[k], want[k], FIT_RTOL, k)
    return got, want, stats


@pytest.mark.parametrize("optimizer,steps", [("adam", 40), ("lbfgs", 15)])
def test_ik_fit_matches_jax(problem, optimizer, steps):
    """Each optimizer's history and outputs; both descend, and L-BFGS
    gathers its statistics (a loss evaluation, hence one K1f and one K1b
    on the card, at least once a step)."""
    got, _, stats = _both(problem, num_steps=steps, optimizer=optimizer)
    loss = got["loss"].numpy()
    assert np.isfinite(loss).all() and loss[-1] < 0.5 * loss[0]
    if optimizer == "lbfgs":
        assert stats["loss_evals"] >= steps
        assert stats["host_reads"] == stats["linesearch_steps"] >= steps
    else:
        assert stats == {}


def test_ik_joint_mask(problem):
    """Half the targets corrupted by 100 m and masked out: both packages
    fit the rest alike over 15 Adam steps (after that f32 rounding,
    amplified step by step, parts them past FIT_RTOL: 3.7e-4 at 30), and
    over IKConfig's 100 the corrupted joints do not pull the port's fit
    (tests/test_ik.py's criterion)."""
    target = problem[2].copy()
    target[:, 25:] += 100.0
    mask = np.zeros(target.shape[1], np.float32)
    mask[:25] = 1.0
    _both(problem, target=target, mask=mask, num_steps=15)
    got = ik_fit(problem[3], problem[4], torch.from_numpy(target),
                 joint_mask=torch.from_numpy(mask), cfg=IKConfig())
    err = np.abs(got["joints"].numpy()[:, :25] - problem[2][:, :25]).mean()
    assert err < 0.1
    # a per-row (B, 49) mask, the second row's targets all ignored
    rows = np.ones(target.shape[:2], np.float32)
    rows[1] = 0.0
    _both(problem, mask=rows, num_steps=10, optimizer="lbfgs")


def test_ik_init(problem):
    """init= starts from given z, betas, orient and trans (all four, under
    L-BFGS, and trans alone, under Adam): both packages' histories and
    fits alike; with no step, the start returned as it was."""
    rng = np.random.RandomState(3)
    init = {"z": (0.3 * rng.randn(2, 32)).astype(np.float32),
            "betas": (0.2 * rng.randn(1, 10)).astype(np.float32),
            "orient": (0.1 * rng.randn(2, 3)).astype(np.float32),
            "trans": (0.2 * rng.randn(2, 3)).astype(np.float32)}
    _both(problem, init=init, num_steps=10, optimizer="lbfgs")
    _both(problem, init={"trans": init["trans"]}, num_steps=10)
    # no step at all: the start itself and an empty history, as JAX's
    # zero-length scan gives
    got, _, _ = _both(problem, init=init, num_steps=0, optimizer="lbfgs")
    assert got["loss"].shape == (0,)
    for k, v in init.items():
        assert np.array_equal(got[k].numpy(), v), k
