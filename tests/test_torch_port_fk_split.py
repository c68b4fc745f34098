"""K1's level-by-level order and arithmetic on the CPU, before a card runs it.

csrc/fk.cu walks the kinematic tree level by level over a batch tile in
shared memory, and its backward folds each joint's children into the
joint's accumulator in reverse topological order. ``fk.kinematic_tree``
builds the levels and child lists the kernels read, once per tree, and
``fk.fk_fwd_emulation`` / ``fk.fk_bwd_emulation`` repeat the kernels'
arithmetic step for step (each multiply-add an fmaf in the kernel's order).

``kinematic_tree`` is checked on SMPL's tree, a 23-deep chain, a star (every
joint a child of the root), a lone root and seeded random trees up to
J = 64. The emulation is held against the port's plain versions, JAX's
``_fk_xla`` and ``_bwd_xla``, the forward Pallas kernel in interpret mode at
tb=8 (as tests/test_fk_pallas.py runs it) and an f64 numpy chain, at B = 1,
8 and 37. Tolerances, absolute, as chip_smoke.py holds K1 on the card: 1e-5 on
the forward (a chain of up to 23 f32 3x3 products of O(1) entries, offsets
of 0.3) and 1e-4 on the backward (N(0, 1) cotangents summed over up to 63
descendants, entries up to ~35); the two sides differ only in rounding.
"""

import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from nemo_tpu.ops import fk_pallas
from nemo_tpu_torch.body.constants import SMPL_PARENTS
from nemo_tpu_torch.ops import fk

torch.set_num_threads(1)
FWD_TOL, BWD_TOL = 1e-5, 1e-4


def _random_tree(seed, J):
    rng = np.random.RandomState(seed)
    return (-1,) + tuple(int(rng.randint(0, j)) for j in range(1, J))


TREES = {
    "smpl": tuple(int(p) for p in SMPL_PARENTS),
    "chain": (-1,) + tuple(range(23)),
    "star": (-1,) + (0,) * 23,
    "root": (-1,),
    "random64": _random_tree(64, 64),
    "random37": _random_tree(37, 37),
    "random9": _random_tree(9, 9),
    "star64": (-1,) + (0,) * 63,
}
EMULATED = ("smpl", "chain", "star", "random64", "root")


@pytest.mark.parametrize("name", sorted(TREES))
class TestLevels:
    def test_every_joint_once(self, name):
        tree = fk.kinematic_tree(TREES[name])
        J = len(TREES[name])
        assert tree.levels[0] == (0,)
        assert sorted(tree.order) == list(range(J))
        assert sorted(j for ch in tree.children for j in ch) == \
            list(range(1, J))

    def test_parent_in_the_level_before(self, name):
        parents = TREES[name]
        tree = fk.kinematic_tree(parents)
        level_of = {j: d for d, lev in enumerate(tree.levels) for j in lev}
        for j in range(1, len(parents)):
            assert level_of[parents[j]] == level_of[j] - 1
        assert all(tree.levels)

    def test_children_in_reverse_topological_order(self, name):
        parents = TREES[name]
        tree = fk.kinematic_tree(parents)
        pos = {j: n for n, j in enumerate(tree.order)}
        for p, ch in enumerate(tree.children):
            assert all(parents[j] == p for j in ch)
            assert [pos[j] for j in ch] == sorted((pos[j] for j in ch),
                                                  reverse=True)
            # the order in which fk_bwd_plain folds them into p
            assert list(ch) == [j for j in reversed(fk.topo_order(parents))
                                if parents[j] == p]

    def test_order_is_jax_topo_order(self, name):
        parents = TREES[name]
        assert fk.topo_order(parents) == fk_pallas._topo_order(parents)

    def test_packed_layout(self, name):
        """The int array csrc/fk.cu's make_tree unpacks: J, levels,
        parent[J], order[J], level_start[levels + 1], child_start[J + 1],
        child[J - 1]."""
        parents = TREES[name]
        tree = fk.kinematic_tree(parents)
        J, L = len(parents), len(tree.levels)
        flat = list(tree.packed)
        assert flat[:2] == [J, L] and len(flat) == 2 + 4 * J + L + 1
        rest = flat[2:]
        par, order, rest = rest[:J], rest[J:2 * J], rest[2 * J:]
        level_start, rest = rest[:L + 1], rest[L + 1:]
        child_start, child = rest[:J + 1], rest[J + 1:]
        assert par == [0] + list(parents[1:])
        assert order == list(tree.order)
        assert [order[level_start[d]:level_start[d + 1]]
                for d in range(L)] == [list(lev) for lev in tree.levels]
        assert [child[child_start[p]:child_start[p + 1]]
                for p in range(J)] == [list(ch) for ch in tree.children]
        assert fk.kinematic_tree(parents) is tree    # built once per tree


def test_refuses_a_parent_after_its_child():
    with pytest.raises(ValueError, match="must come before"):
        fk.kinematic_tree((-1, 2, 0))


def _inputs(name, B):
    parents = TREES[name]
    J = len(parents)
    rng = np.random.RandomState(1000 * J + B)
    R = Rotation.from_rotvec(0.7 * rng.randn(B * J, 3)).as_matrix()
    R = R.reshape(B, J, 3, 3).astype(np.float32)
    t = (0.3 * rng.randn(B, J, 3)).astype(np.float32)
    gR = rng.randn(B, J, 3, 3).astype(np.float32)
    gt = rng.randn(B, J, 3).astype(np.float32)
    return parents, R, t, gR, gt


def _f64_chain(R, t, parents):
    R, t = R.astype(np.float64), t.astype(np.float64)
    Rg, tg = R.copy(), t.copy()
    for j in range(1, len(parents)):
        p = parents[j]
        Rg[:, j] = Rg[:, p] @ R[:, j]
        tg[:, j] = np.einsum('bik,bk->bi', Rg[:, p], t[:, j]) + tg[:, p]
    return Rg, tg


def _f64_reverse(R, t, Rg, gR, gt, parents):
    R, t, Rg = (a.astype(np.float64) for a in (R, t, Rg))
    accR, acct = gR.astype(np.float64), gt.astype(np.float64)
    gRl, gtl = np.empty_like(accR), np.empty_like(acct)
    for j in range(len(parents) - 1, 0, -1):
        p = parents[j]
        accR[:, p] += accR[:, j] @ np.swapaxes(R[:, j], -1, -2) \
            + acct[:, j][:, :, None] * t[:, j][:, None, :]
        acct[:, p] += acct[:, j]
        gRl[:, j] = np.swapaxes(Rg[:, p], -1, -2) @ accR[:, j]
        gtl[:, j] = np.einsum('bki,bk->bi', Rg[:, p], acct[:, j])
    gRl[:, 0], gtl[:, 0] = accR[:, 0], acct[:, 0]
    return gRl, gtl


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0, atol=tol)


@pytest.mark.parametrize("B", [1, 8, 37])
@pytest.mark.parametrize("name", EMULATED)
class TestEmulation:
    def test_forward_matches_plain_and_jax(self, name, B):
        parents, R, t, _, _ = _inputs(name, B)
        got = fk.fk_fwd_emulation(torch.tensor(R), torch.tensor(t), parents)
        plain = fk.fk_fwd_plain(torch.tensor(R), torch.tensor(t), parents)
        xla = fk_pallas._fk_xla(jnp.asarray(R), jnp.asarray(t), parents)
        for g, p, x in zip(got, plain, xla):
            assert g.dtype == torch.float32
            _close(g, p, FWD_TOL)
            _close(g, np.asarray(x), FWD_TOL)

    def test_forward_matches_f64(self, name, B):
        parents, R, t, _, _ = _inputs(name, B)
        got = fk.fk_fwd_emulation(torch.tensor(R), torch.tensor(t), parents)
        for g, w in zip(got, _f64_chain(R, t, parents)):
            _close(g, w, FWD_TOL)

    def test_backward_matches_plain_and_jax(self, name, B):
        parents, R, t, gR, gt = _inputs(name, B)
        Rg = fk.fk_fwd_plain(torch.tensor(R), torch.tensor(t), parents)[0]
        args = [torch.tensor(R), torch.tensor(t), Rg, torch.tensor(gR),
                torch.tensor(gt)]
        got = fk.fk_bwd_emulation(*args, parents)
        plain = fk.fk_bwd_plain(*args, parents)
        xla = fk_pallas._bwd_xla(*(jnp.asarray(a.numpy()) for a in args),
                                 parents)
        for g, p, x in zip(got, plain, xla):
            assert g.dtype == torch.float32
            _close(g, p, BWD_TOL)
            _close(g, np.asarray(x), BWD_TOL)

    def test_backward_matches_f64(self, name, B):
        parents, R, t, gR, gt = _inputs(name, B)
        Rg64, _ = _f64_chain(R, t, parents)
        Rg = torch.tensor(Rg64.astype(np.float32))
        got = fk.fk_bwd_emulation(torch.tensor(R), torch.tensor(t), Rg,
                                  torch.tensor(gR), torch.tensor(gt), parents)
        for g, w in zip(got, _f64_reverse(R, t, Rg64, gR, gt, parents)):
            _close(g, w, BWD_TOL)


@pytest.mark.parametrize("name,B", [(name, 37) for name in EMULATED]
                         + [("smpl", 1), ("smpl", 8)])
def test_forward_matches_pallas_interpret(name, B):
    """The TPU kernel itself, interpreted (~40 s at J = 64, so at B = 37,
    ragged against tb=8, on every tree, and at SMPL's B = 1 and 8)."""
    parents, R, t, _, _ = _inputs(name, B)
    orig = fk_pallas.pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(fk_pallas.pl, "pallas_call", interp):
        want = fk_pallas._fk_fwd_pallas(jnp.asarray(R), jnp.asarray(t),
                                        parents, tb=8)
    got = fk.fk_fwd_emulation(torch.tensor(R), torch.tensor(t), parents)
    for g, w in zip(got, want):
        _close(g, np.asarray(w), FWD_TOL)
