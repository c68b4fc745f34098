"""K4's split search (csrc/chamfer.cu), emulated on the CPU, against the
plain version and the JAX package.

``chamfer.nn_one_way_split_emulation`` repeats the kernel's arithmetic:
queries in blocks of 32 q, M in ranges of whole groups, each range's
running minimum taken a group at a time (fminf, then a strict <), the
winning group's first candidate equal to the minimum, and the ranges'
partials folded in order under a strict <. It must give
``nn_one_way_plain``'s distances and indices bit for bit (``torch.equal``)
for every split, on the cases of ``tests/torch_chamfer_cases.py``: M not a
multiple of a range or a group, fewer candidates than ranges, one frame
and one query, ties across group and range boundaries, queries exactly on
candidates, distances gone negative by cancellation 100 m from the origin,
and +inf and NaN distances. Against JAX's ``_nn_one_way_xla`` (the path
the JAX package's tests take off the TPU): distances within rtol 1e-5 /
atol 1e-6 (XLA's HIGHEST-precision matmul sums a.b in its own order),
indices equal on queries whose two nearest candidate positions are
further apart than that. ``chamfer_one_way`` against the first direction
of ``chamfer_distance`` (the same bits, values and both gradients) and
against the JAX op's gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu.models import humor_fit as jfit
from nemo_tpu.ops import chamfer as jchamfer
from nemo_tpu_torch.models import humor_fit as tfit
from nemo_tpu_torch.ops import chamfer as tchamfer
from torch_chamfer_cases import (CASES, STRADDLE_RANGES, brute_force,
                                 chamfer_case)

torch.set_num_threads(1)
D_RTOL, D_ATOL = 1e-5, 1e-6
# (q, ranges, group): the kernel's own splits (group 8; path E's two
# directions, a one-range block and a 16-range one) and other ranges and
# groups, so that the cases' ties and edges fall on every kind of boundary
SPLITS = [(4, 16, 8), (4, 2, 8), (1, 1, 8), (2, 4, 8), (1, 3, 8), (4, 16, 1),
          (2, 2, 4), (1, 16, 3)]


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("split", SPLITS, ids=lambda s: "q%d-r%d-g%d" % s)
@pytest.mark.parametrize("name", CASES)
def test_split_emulation_matches_plain(name, split):
    """The kernel's ranges, group minima and merge give the plain version's
    distances and indices bit for bit."""
    a, b = (_t(x) for x in chamfer_case(name))
    d, i = tchamfer.nn_one_way_plain(a, b)
    q, ranges, group = split
    de, ie = tchamfer.nn_one_way_split_emulation(a, b, q, ranges, group)
    assert de.dtype == d.dtype and ie.dtype == i.dtype == torch.int64
    assert torch.equal(de, d) and torch.equal(ie, i)


@pytest.mark.parametrize("name", [n for n in CASES if n != "far"])
def test_plain_matches_float64_brute_force(name):
    """The plain version's indices are float64 brute force's (the lowest
    index of the minimum, NaN counted as +inf), at any chunk: these cases'
    nearest candidates are separated far beyond f32 rounding."""
    a, b = chamfer_case(name)
    d, i = tchamfer.nn_one_way_plain(_t(a), _t(b))
    d64, i64 = brute_force(a, b)
    np.testing.assert_array_equal(i.numpy(), i64)
    np.testing.assert_allclose(d.numpy(), d64, rtol=D_RTOL, atol=D_ATOL)
    dc, ic = tchamfer.nn_one_way_plain(_t(a), _t(b), chunk=7)
    assert torch.equal(dc, d) and torch.equal(ic, i)


def test_straddling_ties_take_the_lower_index():
    """A candidate repeated across a group or range boundary: a query on it
    gets the first of the two, in the plain version and in every split
    whose range boundary the tie straddles."""
    a, b = (_t(x) for x in chamfer_case("straddle"))
    ties = torch.tensor([7, 39, 151, 199, 303, 399, 455])
    _, i = tchamfer.nn_one_way_plain(a, b)
    assert torch.equal(i[:, :len(ties)], ties.expand(2, -1))
    for ranges in STRADDLE_RANGES:
        _, ie = tchamfer.nn_one_way_split_emulation(a, b, 2, ranges)
        assert torch.equal(ie[:, :len(ties)], ties.expand(2, -1))


def test_nonfinite_distances_never_win():
    """NaN distances count as +inf: a query's finite match wins over a NaN
    in its group or chunk; a query with no finite distance gets +inf and
    index 0, in the plain version (any chunk) and the emulation."""
    a, b = (_t(x) for x in chamfer_case("nonfinite"))
    for d, i in (tchamfer.nn_one_way_plain(a, b),
                 tchamfer.nn_one_way_plain(a, b, chunk=16),
                 tchamfer.nn_one_way_split_emulation(a, b, 4, 16)):
        assert torch.equal(i[0, :4], torch.tensor([16, 18, 21, 4]))
        assert bool(torch.isfinite(d[0]).all())
        for t, n in ((1, slice(None)), (2, slice(0, 3))):
            assert bool((d[t, n] == float("inf")).all())
            assert bool((i[t, n] == 0).all())


def test_far_case_goes_negative():
    """The far case exercises what it is for: expanded distances below 0."""
    a, b = (_t(x) for x in chamfer_case("far"))
    d, _ = tchamfer.nn_one_way_plain(a, b)
    assert float(d.min()) < 0.0


@pytest.mark.parametrize("shape", [(60, 512, 6890), (60, 6890, 512),
                                   (1, 1, 1), (1, 512, 6890), (8, 2048, 6890),
                                   (60, 6890, 6890), (3, 37, 5)])
def test_nn_split_rule(shape):
    """The host's split: q of 1, 2 or 4, a power of two of ranges up to 16,
    ranges of whole groups that cover M; path E's directions as the source
    note states them."""
    T, N, M = shape
    s = tchamfer.nn_split(T, N, M)
    assert s.q in (1, 2, 4) and s.ranges in (1, 2, 4, 8, 16)
    assert s.range % tchamfer.GROUP == 0 and s.range * s.ranges >= M
    assert (s.range - tchamfer.GROUP) * s.ranges < M
    want = {(60, 512, 6890): (4, 16, 432), (60, 6890, 512): (4, 2, 256)}
    if shape in want:
        assert tuple(s) == want[shape]


@pytest.fixture(scope="module")
def jax_nn():
    nn = jax.jit(jax.vmap(jchamfer._nn_one_way_xla))
    return {name: tuple(np.asarray(x) for x in nn(
        *(jnp.asarray(v) for v in chamfer_case(name))))
        for name in ("ragged", "few", "single", "straddle", "exact")}


def _separated(a, b, d):
    """Queries whose best and second-best distinct candidate positions are
    further apart than the distance tolerance (float64)."""
    d64 = ((a[:, :, None].astype(np.float64) - b[:, None]) ** 2).sum(-1)
    best = d64.argmin(-1)
    same = (b[np.arange(b.shape[0])[:, None, None], best[..., None]]
            == b[:, None]).all(-1)
    second = np.where(same, np.inf, d64).min(-1)
    return second - d64.min(-1) > D_ATOL + D_RTOL * np.abs(d)


@pytest.mark.parametrize("name", ["ragged", "few", "single", "straddle",
                                  "exact"])
def test_split_emulation_matches_jax(jax_nn, name):
    """The kernel's split (path E's scan -> mesh split and a 3-range one)
    against JAX's XLA path: distances within rtol 1e-5 / atol 1e-6, indices
    equal on separated queries (every query of these cases)."""
    a, b = chamfer_case(name)
    jd, ji = jax_nn[name]
    sep = _separated(a, b, jd)
    assert sep.all(), f"{int((~sep).sum())} queries excluded"
    for q, ranges in ((4, 16), (1, 3)):
        d, i = tchamfer.nn_one_way_split_emulation(_t(a), _t(b), q, ranges)
        np.testing.assert_allclose(d.numpy(), jd, rtol=D_RTOL, atol=D_ATOL)
        np.testing.assert_array_equal(i.numpy(), ji)


@pytest.mark.parametrize("name", ["ragged", "straddle", "exact", "far"])
def test_chamfer_one_way_equals_first_direction(name):
    """chamfer_one_way's value and gradients (both inputs, under a random
    cotangent) are chamfer_distance(...)[0]'s, bit for bit."""
    a, b = chamfer_case(name)
    w = _t(np.random.default_rng(3).random(a.shape[:2]))
    outs = []
    for op in (tchamfer.chamfer_one_way,
               lambda x, y: tchamfer.chamfer_distance(x, y)[0]):
        x, y = _t(a).requires_grad_(), _t(b).requires_grad_()
        d = op(x, y)
        (d * w).sum().backward()
        outs.append((d.detach(), x.grad, y.grad))
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    d0 = tchamfer.chamfer_one_way(_t(a[0]), _t(b[0]))
    assert torch.equal(d0, outs[0][0][0])


@pytest.mark.parametrize("name", ["ragged", "straddle", "exact"])
def test_chamfer_one_way_matches_jax(name):
    """chamfer_one_way against the first direction of the JAX op: values
    rtol 1e-5 / atol 1e-6, gradients of sum(w d1) with respect to both
    inputs atol 1e-5 (a few 2 (x - y) terms a point)."""
    a, b = chamfer_case(name)
    w = np.random.default_rng(4).random(a.shape[:2]).astype(np.float32)

    def jloss(x, y):
        return (jnp.asarray(w) * jax.vmap(jchamfer.chamfer_distance)(
            x, y)[0]).sum()

    jd = jax.vmap(jchamfer.chamfer_distance)(jnp.asarray(a),
                                             jnp.asarray(b))[0]
    jga, jgb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a),
                                               jnp.asarray(b))
    x, y = _t(a).requires_grad_(), _t(b).requires_grad_()
    d = tchamfer.chamfer_one_way(x, y)
    (d * _t(w)).sum().backward()
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd),
                               rtol=D_RTOL, atol=D_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jga), atol=1e-5)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(jgb), atol=1e-5)


def test_points3d_loss_runs_one_search(monkeypatch):
    """points3d_loss searches scan -> mesh once (chamfer_one_way), and its
    value and vertex gradient match the JAX package's points3d_loss (value
    rtol 1e-5, gradient atol 1e-5 x its largest entry)."""
    calls = []
    real = tchamfer.nn_one_way

    def counting(x, y):
        calls.append((tuple(x.shape), tuple(y.shape)))
        return real(x, y)
    monkeypatch.setattr(tchamfer, "nn_one_way", counting)
    rng = np.random.default_rng(12)
    obs = rng.standard_normal((3, 48, 3)).astype(np.float32)
    verts = (0.8 * rng.standard_normal((3, 60, 3))).astype(np.float32)
    jl, jg = jax.value_and_grad(
        lambda v: jfit.points3d_loss(jnp.asarray(obs), v))(
            jnp.asarray(verts))
    v = _t(verts).requires_grad_()
    loss = tfit.points3d_loss(_t(obs), v)
    loss.backward()
    assert calls == [((3, 48, 3), (3, 60, 3))]
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg),
                               atol=1e-5 * float(np.abs(jg).max()))
