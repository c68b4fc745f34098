"""The HuMoR training loss in the port against nemo_tpu on the CPU:
kl_normal, the KL anneal and cycle weights, multistep_lr,
sched_samp_gt_p, every term of humor_loss_terms (regression, KL, contact
BCE with its accuracies, contact velocity, the SMPL terms through a toy
smpl_fn and through each package's SMPL on the 150-vertex synthetic body,
the refused vertex-consistency term), humor_full_loss and
humor_step_scheduled with their gradients.

Both packages start from JAX's init_humor weights (the reference widths:
HumorConfig fixes 1024-wide GroupNorm MLPs) and get the same numpy inputs
from np.random.default_rng, a few rows each. The draws cannot be matched
across RNGs, so the port is given JAX's own: jax.random.normal on the key
JAX's function is handed, and the scheduled step's coins from
jax.random.bernoulli on its coin key. Tolerances: values within rtol 1e-5;
gradients within 1e-4 of each tensor's largest entry; the host-side
schedules (anneal weight, lr, GT probability) equal to JAX's float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.body.smpl import smpl_forward as jax_smpl_forward
from nemo_tpu.models import humor as jh
from nemo_tpu.models import humor_loss as jl
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.models import humor as th
from nemo_tpu_torch.models import humor_loss as tl

torch.set_num_threads(2)
CFG = jh.HumorConfig()
TCFG = th.HumorConfig()
L = CFG.latent_size
D = jh.STATE_DIM
RTOL = 1e-5
GRAD_RTOL = 1e-4


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rtol, what=""):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def _tcfg(lcfg):
    return tl.HumorLossConfig(**dataclasses.asdict(lcfg))


@pytest.fixture(scope="module")
def params():
    p = jh.init_humor(jax.random.PRNGKey(0), CFG)
    return p, th.humor_from_numpy(p)


def states(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape + (D,)) * scale).astype(np.float32)


def gaussians(rng, B):
    qm = rng.standard_normal((B, L)).astype(np.float32)
    qv = np.exp(0.3 * rng.standard_normal((B, L))).astype(np.float32)
    pm = rng.standard_normal((B, L)).astype(np.float32)
    pv = np.exp(0.3 * rng.standard_normal((B, L))).astype(np.float32)
    return qm, qv, pm, pv


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a)
                                              for a in arrays]


def _stats_close(tstats, jstats, rtol=RTOL):
    assert sorted(tstats) == sorted(jstats)
    for k, v in jstats.items():
        got = tstats[k].detach() if torch.is_tensor(tstats[k]) else tstats[k]
        _close(np.asarray(got, np.float64), v, rtol, k)


# ---------------------------------------------------------------------------
# the pieces


def test_kl_normal_and_gaussian_kl():
    j, t = _both(gaussians(np.random.default_rng(0), 5))
    _close(tl.kl_normal(*t), jl.kl_normal(*j), RTOL)
    _close(th.gaussian_kl(*t), jh.gaussian_kl(*j), RTOL)


@pytest.mark.parametrize("kw", [
    {}, {"kl_loss_anneal_start": 2, "kl_loss_anneal_end": 7},
    {"kl_loss_cycle_len": 6}, {"kl_loss_cycle_len": 5,
                               "kl_loss_anneal_end": 4}])
def test_kl_anneal_weight(kw):
    """The anneal or cycle ramp at every epoch 0-12, float32 as JAX's."""
    lcfg = jl.HumorLossConfig(**kw)
    for e in range(13):
        got = tl.kl_anneal_weight(_tcfg(lcfg), e)
        assert got == float(jl.kl_anneal_weight(lcfg, e)), (kw, e)


@pytest.mark.parametrize("milestones,gamma", [((), 0.1), ((2,), 0.1),
                                              ((1, 3), 0.5)])
def test_multistep_lr(milestones, gamma):
    t_at, j_at = (tl.multistep_lr(1e-4, milestones, gamma),
                  jl.multistep_lr(1e-4, milestones, gamma))
    for e in range(6):
        assert t_at(e) == float(np.float32(j_at(e))), (milestones, e)


@pytest.mark.parametrize("start,end", [(0, 2), (1, 3), (2, 2)])
def test_sched_samp_gt_p(start, end):
    for e in range(6):
        assert tl.sched_samp_gt_p(e, start, end) == float(
            jl.sched_samp_gt_p(e, start, end)), (start, end, e)


# ---------------------------------------------------------------------------
# humor_loss_terms


def _terms(lcfg, rng, B, epoch, contacts=False, gt_contacts=False):
    pred, gt = states(rng, B), states(rng, B)
    g = gaussians(rng, B)
    arrays = [pred, gt, *g]
    if contacts:
        arrays.append(rng.standard_normal((B, 9)).astype(np.float32))
    if gt_contacts:
        arrays.append((rng.random((B, 9)) > 0.5).astype(np.float32))
    j, t = _both(arrays)
    kw = lambda a: dict(contact_logits=a[6] if contacts else None,
                        contacts_gt=a[7] if gt_contacts else None)
    jloss, jstats = jl.humor_loss_terms(lcfg, j[0], j[1], (j[2], j[3]),
                                        (j[4], j[5]), epoch, **kw(j))
    tloss, tstats = tl.humor_loss_terms(_tcfg(lcfg), t[0], t[1],
                                        (t[2], t[3]), (t[4], t[5]), epoch,
                                        **kw(t))
    _close(tloss, jloss, RTOL, "loss")
    _stats_close(tstats, jstats)
    return tstats


@pytest.mark.parametrize("kw,epoch", [
    ({}, 0),
    ({"kl_loss": 4e-4, "kl_loss_anneal_start": 1, "kl_loss_anneal_end": 5},
     3),
    ({"kl_loss": 0.5, "kl_loss_cycle_len": 4}, 5),
    ({"kl_loss": 0.0, "regr_trans_loss": 2.0, "regr_pose_loss": 0.0}, 0)])
def test_loss_terms_regression_and_kl(kw, epoch):
    """Every per-field regression term, the KL with its anneal or cycle
    weight, kl_weighted_loss and reconstr_weighted_loss."""
    stats = _terms(jl.HumorLossConfig(**kw), np.random.default_rng(1), 6,
                   epoch)
    assert ("kl_loss" in stats) == (kw.get("kl_loss", 1.0) > 0)


def test_loss_terms_contact_bce_and_accuracies():
    lcfg = jl.HumorLossConfig(contacts_loss=0.01)
    stats = _terms(lcfg, np.random.default_rng(2), 8, 0, contacts=True,
                   gt_contacts=True)
    for k in ("contacts_loss", "contacts_acc", "contacts_pos_acc",
              "contacts_neg_acc"):
        assert k in stats


def test_loss_terms_contact_velocity():
    lcfg = jl.HumorLossConfig(contacts_vel_loss=0.3)
    stats = _terms(lcfg, np.random.default_rng(3), 5, 0, contacts=True)
    assert "contacts_vel_loss" in stats and "contacts_loss" not in stats


def _smpl_only(**w):
    zero = {f: 0.0 for f in ("kl_loss", "regr_trans_loss",
                             "regr_trans_vel_loss", "regr_root_orient_loss",
                             "regr_root_orient_vel_loss", "regr_pose_loss",
                             "regr_joint_loss", "regr_joint_vel_loss")}
    return jl.HumorLossConfig(**dict(zero, **w))


def test_smpl_terms_toy_body():
    """The three SMPL terms through the JAX test's toy body function."""
    def toy(xp):
        def smpl_fn(trans, orient, pose, betas):
            B = trans.shape[0]
            base = (trans[:, None, :] + orient[:, None, :]
                    + pose.reshape(B, 21, 3).mean(1, keepdims=True))
            joints = base + xp.arange(22)[None, :, None] * 0.1
            verts = base + xp.arange(43)[None, :, None] * 0.01
            return joints, verts
        return smpl_fn

    lcfg = _smpl_only(smpl_joint_loss=2.0, smpl_mesh_loss=3.0,
                      smpl_joint_consistency_loss=5.0)
    rng = np.random.default_rng(10)
    arrays = [states(rng, 4, scale=1.0), states(rng, 4, scale=1.0),
              *gaussians(rng, 4), np.zeros((4, 10), np.float32)]
    j, t = _both(arrays)
    jloss, jstats = jl.humor_loss_terms(lcfg, j[0], j[1], (j[2], j[3]),
                                        (j[4], j[5]), 0, smpl_fn=toy(jnp),
                                        betas=j[6])
    tloss, tstats = tl.humor_loss_terms(_tcfg(lcfg), t[0], t[1],
                                        (t[2], t[3]), (t[4], t[5]), 0,
                                        smpl_fn=toy(torch), betas=t[6])
    _close(tloss, jloss, RTOL)
    _stats_close(tstats, jstats)


@pytest.fixture(scope="module")
def bodies():
    jsmpl = jax_synthetic_smpl(num_vertices=150, seed=0)
    return jsmpl, smpl_from_numpy(jsmpl)


def _jax_smpl_fn(model):
    def smpl_fn(trans, root_orient, pose_body, betas):
        body = jnp.concatenate([pose_body, jnp.zeros((pose_body.shape[0],
                                                      6))], axis=1)
        verts, _, fk = jax_smpl_forward(model, betas, body, root_orient,
                                        pose2rot=True, transl=trans,
                                        want_fk_joints=True)
        return fk, verts
    return smpl_fn


def test_smpl_terms_synthetic_body(bodies):
    """The SMPL terms through each package's SMPL on the 150-vertex body
    (the port's smpl_terms_fn), with the gradient in the predicted state."""
    jsmpl, tsmpl = bodies
    lcfg = _smpl_only(smpl_joint_loss=1.0, smpl_mesh_loss=1.0,
                      smpl_joint_consistency_loss=1.0)
    rng = np.random.default_rng(11)
    arrays = [states(rng, 5), states(rng, 5), *gaussians(rng, 5),
              (0.3 * rng.standard_normal((5, 10))).astype(np.float32)]
    j, t = _both(arrays)

    def jloss(pred):
        return jl.humor_loss_terms(lcfg, pred, j[1], (j[2], j[3]),
                                   (j[4], j[5]), 0,
                                   smpl_fn=_jax_smpl_fn(jsmpl), betas=j[6])
    (jv, jstats), jg = jax.value_and_grad(jloss, has_aux=True)(j[0])
    pred = t[0].clone().requires_grad_(True)
    tv, tstats = tl.humor_loss_terms(_tcfg(lcfg), pred, t[1], (t[2], t[3]),
                                     (t[4], t[5]), 0,
                                     smpl_fn=tl.smpl_terms_fn(tsmpl),
                                     betas=t[6])
    tg, = torch.autograd.grad(tv, pred)
    _close(tv, jv, RTOL)
    _stats_close(tstats, jstats)
    _close(tg, jg, GRAD_RTOL, "d loss / d pred")


def test_smpl_term_guards():
    """The vertex-consistency term raises in both packages (no 'verts'
    field), and the SMPL terms without smpl_fn raise."""
    z = np.zeros((1, D), np.float32)
    g = (np.zeros((1, L), np.float32), np.ones((1, L), np.float32))
    for mod, xp in ((jl, jnp), (tl, torch)):
        zz, gg = xp.asarray(z) if xp is jnp else torch.from_numpy(z), [
            xp.asarray(a) if xp is jnp else torch.from_numpy(a) for a in g]
        for lcfg in (mod.HumorLossConfig(smpl_vert_consistency_loss=1.0),
                     mod.HumorLossConfig(smpl_joint_loss=1.0)):
            with pytest.raises(ValueError):
                mod.humor_loss_terms(lcfg, zz, zz, gg, gg, 0)


# ---------------------------------------------------------------------------
# humor_full_loss and humor_step_scheduled, forward and gradients


def _grads_close(tgrads, jgrads, what):
    for m, sub in jgrads.items():
        for k, v in sub.items():
            _close(tgrads[m][k], v, GRAD_RTOL, f"{what} d/d {m}.{k}")


def _port_value_and_grad(tparams, fn):
    p = {m: {k: v.clone().requires_grad_(True) for k, v in sub.items()}
         for m, sub in tparams.items()}
    loss, stats = fn(p)
    leaves = th.humor_leaves(p)
    gs = torch.autograd.grad(loss, [p[m][k] for m, k in leaves])
    grads = {}
    for (m, k), g in zip(leaves, gs):
        grads.setdefault(m, {})[k] = g
    return loss, stats, grads


@pytest.mark.parametrize("kw,epoch", [
    ({}, 0), ({"contacts_loss": 0.01, "contacts_vel_loss": 0.1,
              "kl_loss": 4e-4}, 1)])
def test_full_loss_and_gradients(params, kw, epoch):
    jp, tp = params
    lcfg = jl.HumorLossConfig(**kw)
    rng = np.random.default_rng(20)
    past, tgt = states(rng, 4), states(rng, 4)
    cg = (rng.random((4, 9)) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(21)
    eps = np.asarray(jax.random.normal(key, (4, L)))

    (jv, js), jg = jax.jit(jax.value_and_grad(
        lambda p: jl.humor_full_loss(p, CFG, lcfg, jnp.asarray(past),
                                     jnp.asarray(tgt), key, epoch,
                                     contacts_gt=jnp.asarray(cg)),
        has_aux=True))(jp)
    tv, ts, tg = _port_value_and_grad(tp, lambda p: tl.humor_full_loss(
        p, TCFG, _tcfg(lcfg), torch.from_numpy(past), torch.from_numpy(tgt),
        torch.from_numpy(eps), epoch, contacts_gt=torch.from_numpy(cg)))
    _close(tv, jv, RTOL)
    _stats_close(ts, js)
    _grads_close(tg, jg, "full loss")


def jax_sched_draws(key, use_gt_p, T, B):
    """humor_step_scheduled's own draws from key: its coins and each
    step's posterior draw."""
    k_coin, k_eps = jax.random.split(key)
    coins = np.asarray(jax.random.bernoulli(k_coin, use_gt_p, (T,)))
    eps = np.stack([np.asarray(jax.random.normal(k, (B, L)))
                    for k in jax.random.split(k_eps, T)])
    return coins, eps


@pytest.mark.parametrize("use_gt_p,seed", [(0.0, 30), (0.5, 31), (1.0, 32)])
def test_step_scheduled_and_gradients(params, use_gt_p, seed):
    """Scheduled sampling over 3 transitions with JAX's coins and draws:
    step 0 always on the GT past, the others on the coin's choice, the
    carried prediction canonicalized and detached; the per-step outputs
    flattened batch-major."""
    jp, tp = params
    lcfg = jl.HumorLossConfig(kl_loss=4e-4, contacts_vel_loss=0.1)
    rng = np.random.default_rng(seed)
    B, T = 2, 3
    past, tgt = states(rng, B, T), states(rng, B, T)
    key = jax.random.PRNGKey(seed)
    coins, eps = jax_sched_draws(key, use_gt_p, T, B)

    (jv, js), jg = jax.jit(jax.value_and_grad(
        lambda p: jl.humor_step_scheduled(p, CFG, lcfg, jnp.asarray(past),
                                          jnp.asarray(tgt), key, use_gt_p,
                                          2), has_aux=True))(jp)
    tv, ts, tg = _port_value_and_grad(tp, lambda p: tl.humor_step_scheduled(
        p, TCFG, _tcfg(lcfg), torch.from_numpy(past), torch.from_numpy(tgt),
        torch.from_numpy(coins), torch.from_numpy(eps), 2))
    _close(tv, jv, RTOL)
    _stats_close(ts, js)
    _grads_close(tg, jg, f"scheduled p={use_gt_p}")
