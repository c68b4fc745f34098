"""K7 (ops/groupnorm.py, csrc/groupnorm.cu) on the CPU: the kernels'
arithmetic (ops/_emulation.py gn_relu_fwd_emulation, gn_relu_bwd_emulation)
against the eager composition (models/humor.py _group_norm and a ReLU) and
its autograd, and against the JAX package's composition
(nemo_tpu/models/humor.py _group_norm and jax.nn.relu) and its jax.vjp:
the output, dx, dgamma and dbeta, at odd row counts, random gamma and beta,
rows with a constant group, and every group layout the kernels take; the op's autograd wiring (GroupNormReLU on CPU tensors runs
the emulations); HuMoR's apply_mlp through K7 against the eager MLP. The
card's kernels are held against the same in tests/test_torch_port_gpu.py.

Tolerances: the kernels sum a group in another order (a butterfly of
shuffles over the lanes that hold it) and multiply by 1 / sqrt(var + eps)
where the composition divides by sqrt(var + eps), so values move by a few
f32 rounding steps of the largest entry: 1e-5 of it, and 1e-4 of it for
the gradients, as tests/test_torch_port_gpu.py holds the other kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.models import humor as jhumor

from nemo_tpu_torch.models import humor
from nemo_tpu_torch.ops import _emulation, groupnorm
from nemo_tpu_torch.ops.groupnorm import (GroupNormReLU, group_norm_relu,
                                          group_norm_relu_plain)

# (R, C, groups): HuMoR's 1024 and 512 widths in 16 groups (q = 16 and 8
# lanes a group), the 128-wide test HuMoR (q = 2), a group of one float4
# per lane (q = 32) and groups across two float4s of every lane (q = 64)
SHAPES = [(37, 1024, 16), (5, 512, 16), (33, 128, 16), (7, 384, 3),
          (9, 1024, 4), (1, 256, 64), (3, 1024, 1)]


def _inputs(R, C, groups, seed, constant_rows=True):
    gen = torch.Generator().manual_seed(seed)
    x = 2.0 * torch.randn((R, C), generator=gen) + 0.5
    if constant_rows and R > 2:
        S = C // groups
        x[1, :S] = 3.25                      # a constant group
        x[R - 1, C - S:] = -0.75
    gamma = 0.5 + torch.rand((C,), generator=gen)
    beta = 0.4 * torch.randn((C,), generator=gen)
    gy = torch.randn((R, C), generator=gen)
    return x, gamma, beta, gy


def _eager(x, gamma, beta, groups):
    return torch.relu(humor._group_norm(x, gamma, beta, groups))


def _close(got, want, rel):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=rel * max(scale, 1e-30),
                               rtol=0)


@pytest.mark.parametrize("R,C,groups", SHAPES)
def test_emulation_against_eager(R, C, groups):
    x, gamma, beta, gy = _inputs(R, C, groups, R + C)
    xs, gs, bs = (t.clone().requires_grad_() for t in (x, gamma, beta))
    want = _eager(xs, gs, bs, groups)
    want.backward(gy)
    y, mean, rstd = _emulation.gn_relu_fwd_emulation(x, gamma, beta, groups)
    _close(y, want.detach(), 1e-5)
    xg = x.reshape(R, groups, C // groups)
    _close(mean, xg.mean(2), 1e-6)
    _close(rstd, 1 / torch.sqrt(xg.var(2, unbiased=False) + 1e-5), 1e-5)
    dx, dg, db = _emulation.gn_relu_bwd_emulation(x, gamma, beta, mean, rstd,
                                                  gy, groups, wgrad=True)
    _close(dx, xs.grad, 1e-4)
    _close(dg, gs.grad, 1e-4)
    _close(db, bs.grad, 1e-4)
    dx_alone, none_g, none_b = _emulation.gn_relu_bwd_emulation(
        x, gamma, beta, mean, rstd, gy, groups)
    assert torch.equal(dx_alone, dx) and none_g is None and none_b is None


@pytest.mark.parametrize("R,C,groups", SHAPES)
def test_emulation_against_jax(R, C, groups):
    """GroupNormReLU on CPU tensors (the forward's emulation) and
    gn_relu_bwd_emulation against relu(_group_norm) of the JAX package and
    its jax.vjp in (x, gamma, beta)."""
    x, gamma, beta, gy = _inputs(R, C, groups, R + C)

    def jax_fn(xj, gj, bj):
        return jax.nn.relu(jhumor._group_norm(xj, gj, bj, groups))
    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(t.numpy())
                                  for t in (x, gamma, beta)))
    want_dx, want_dg, want_db = (torch.from_numpy(np.array(t))
                                 for t in vjp(jnp.asarray(gy.numpy())))
    y = GroupNormReLU.apply(x, gamma, beta, groups, 1e-5)
    _close(y, torch.from_numpy(np.array(want)), 1e-5)
    _, mean, rstd = _emulation.gn_relu_fwd_emulation(x, gamma, beta, groups)
    dx, dg, db = _emulation.gn_relu_bwd_emulation(x, gamma, beta, mean, rstd,
                                                  gy, groups, wgrad=True)
    _close(dx, want_dx, 1e-4)
    _close(dg, want_dg, 1e-4)
    _close(db, want_db, 1e-4)


def test_constant_group():
    """A constant group normalises to 0 (its mean may round off the
    constant): its output is relu(beta), its dx finite."""
    R, C, groups = 3, 128, 16
    x, gamma, beta, gy = _inputs(R, C, groups, 5)
    y, mean, rstd = _emulation.gn_relu_fwd_emulation(x, gamma, beta, groups)
    torch.testing.assert_close(y[1, :8], torch.relu(beta[:8]), atol=1e-3,
                               rtol=0)
    dx, _, _ = _emulation.gn_relu_bwd_emulation(x, gamma, beta, mean, rstd,
                                                gy, groups)
    assert torch.isfinite(dx).all()


@pytest.mark.parametrize("R", [1, 63, 64, 65, 700, 20000])
def test_partial_blocks(R):
    """The dgamma and dbeta partials: one block a run of rows, a function
    of R alone, at most 256 blocks; every row in exactly one block."""
    nb = groupnorm.wgrad_blocks(R)
    assert 1 <= nb <= 256
    rpb = -(-R // nb)
    assert (nb - 1) * rpb < R <= nb * rpb


def test_wgrad_order_over_many_blocks():
    """At 700 rows (11 blocks of 64) the partials' fixed order still agrees
    with autograd's sums."""
    R, C, groups = 700, 128, 16
    x, gamma, beta, gy = _inputs(R, C, groups, 7)
    gs, bs = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
    _eager(x, gs, bs, groups).backward(gy)
    _, mean, rstd = _emulation.gn_relu_fwd_emulation(x, gamma, beta, groups)
    _, dg, db = _emulation.gn_relu_bwd_emulation(x, gamma, beta, mean, rstd,
                                                 gy, groups, wgrad=True)
    _close(dg, gs.grad, 1e-4)
    _close(db, bs.grad, 1e-4)


@pytest.mark.parametrize("wgrad", [False, True])
def test_autograd_function_on_cpu(wgrad):
    """GroupNormReLU's forward and backward (the emulations on CPU tensors)
    against autograd through the plain version; dgamma and dbeta only where
    they are asked for."""
    R, C, groups = 19, 512, 16
    x, gamma, beta, gy = _inputs(R, C, groups, 11)
    a = [t.clone().requires_grad_(k == 0 or wgrad)
         for k, t in enumerate((x, gamma, beta))]
    b = [t.clone().requires_grad_(k == 0 or wgrad)
         for k, t in enumerate((x, gamma, beta))]
    ya = GroupNormReLU.apply(*a, groups, 1e-5)
    yb = group_norm_relu_plain(*b, groups)
    _close(ya.detach(), yb.detach(), 1e-5)
    ya.backward(gy)
    yb.backward(gy)
    _close(a[0].grad, b[0].grad, 1e-4)
    for s, t in zip(a[1:], b[1:]):
        if wgrad:
            _close(s.grad, t.grad, 1e-4)
        else:
            assert s.grad is None


def test_plain_version_is_the_eager_composition():
    """The op's CPU route is the plain version, bit for bit the eager
    composition of models/humor.py."""
    x, gamma, beta, _ = _inputs(13, 1024, 16, 3)
    assert torch.equal(group_norm_relu(x, gamma, beta, 16),
                       _eager(x, gamma, beta, 16))
    assert torch.equal(group_norm_relu_plain(x, gamma, beta, 16),
                       _eager(x, gamma, beta, 16))


@pytest.mark.parametrize("C,groups,ok", [
    (1024, 16, True), (512, 16, True), (128, 16, True), (1024, 4, True),
    (1024, 1, True), (1000, 8, False), (2048, 16, False), (96, 16, False),
    (384, 8, False), (1024, 3, False)])
def test_refusal(C, groups, ok):
    assert (groupnorm.refusal(C, groups) is None) == ok


def test_apply_mlp_through_k7(monkeypatch):
    """HuMoR's encoder through K7's path (the emulations, routed as on the
    card) equals the eager MLP: the output and the gradients of the input,
    the weights and the GroupNorm's gamma and beta, at the published 1024
    widths on 31 rows, gamma and beta not 1 and 0."""
    gen = torch.Generator().manual_seed(0)
    cfg = humor.HumorConfig()
    p = humor.init_mlp(gen, [2 * cfg.input_dim, 1024, 1024, 1024, 1024,
                             2 * cfg.latent_size])
    for i in range(1, 5):
        p[f"gn{i}_g"] = 0.5 + torch.rand(1024, generator=gen)
        p[f"gn{i}_b"] = 0.3 * torch.randn(1024, generator=gen)
    x = torch.randn((31, 2 * cfg.input_dim), generator=gen)

    def run():
        q = {k: v.clone().requires_grad_() for k, v in p.items()}
        xi = x.clone().requires_grad_()
        out = humor.apply_mlp(q, xi, 5, cfg.num_groups)
        out.pow(2).sum().backward()
        return out.detach(), xi.grad, {k: v.grad for k, v in q.items()}

    eager = run()
    k7 = []
    monkeypatch.setattr(humor, "_gn_relu", lambda x, g, b, n: k7.append(1)
                        or GroupNormReLU.apply(x, g, b, n, 1e-5))
    got = run()
    assert len(k7) == 4
    _close(got[0], eager[0], 1e-5)
    _close(got[1], eager[1], 1e-4)
    for k in p:
        _close(got[2][k], eager[2][k], 1e-4)
