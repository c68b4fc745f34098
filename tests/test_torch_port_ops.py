"""Port kernels K1 (fk_compose) and K2 (skin_v2v_l1) against nemo_tpu.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its XLA fallbacks (the path the JAX package's own tests take off
TPU). Both get the same numpy inputs. Tolerances: f32 sums taken in
different orders by two frameworks, stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.ops.fk_pallas import fk_compose as jax_fk_compose
from nemo_tpu.ops.lbs_pallas import skin_v2v_l1 as jax_skin_v2v_l1
from nemo_tpu_torch import resolve_device
from nemo_tpu_torch.body.constants import SMPL_PARENTS
from nemo_tpu_torch.ops import _build, fk, lbs
from nemo_tpu_torch.ops import fk_compose, launch_counts, skin_v2v_l1

torch.set_num_threads(1)
PARENTS = tuple(int(p) for p in SMPL_PARENTS)


def _rotations(rng, B, J, scale=0.7):
    from scipy.spatial.transform import Rotation
    aa = scale * rng.randn(B * J, 3)
    return Rotation.from_rotvec(aa).as_matrix().reshape(B, J, 3, 3).astype(
        np.float32)


@pytest.fixture(scope="module")
def fk_inputs():
    rng = np.random.RandomState(0)
    B, J = 16, 24
    return dict(R=_rotations(rng, B, J),
                t=(0.3 * rng.randn(B, J, 3)).astype(np.float32),
                gR=rng.randn(B, J, 3, 3).astype(np.float32),
                gt=rng.randn(B, J, 3).astype(np.float32))


class TestFKCompose:
    def test_forward_matches_jax(self, fk_inputs):
        Rj, tj = jax_fk_compose(jnp.asarray(fk_inputs["R"]),
                                jnp.asarray(fk_inputs["t"]), PARENTS)
        Rt, tt = fk_compose(torch.tensor(fk_inputs["R"]),
                            torch.tensor(fk_inputs["t"]), PARENTS)
        # 8-level chains of O(1) 3x3 products: f32 ordering noise ~1e-6
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)

    def test_vjp_matches_jax(self, fk_inputs):
        _, vjp = jax.vjp(lambda R, t: jax_fk_compose(R, t, PARENTS),
                         jnp.asarray(fk_inputs["R"]),
                         jnp.asarray(fk_inputs["t"]))
        gRj, gtj = vjp((jnp.asarray(fk_inputs["gR"]),
                        jnp.asarray(fk_inputs["gt"])))
        R = torch.tensor(fk_inputs["R"], requires_grad=True)
        t = torch.tensor(fk_inputs["t"], requires_grad=True)
        Rg, tg = fk_compose(R, t, PARENTS)
        torch.autograd.backward(
            (Rg, tg), (torch.tensor(fk_inputs["gR"]),
                       torch.tensor(fk_inputs["gt"])))
        # cotangents of N(0,1) summed over up to 23 descendants: O(10)
        np.testing.assert_allclose(R.grad.numpy(), np.asarray(gRj), atol=5e-5)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gtj), atol=5e-5)

    def test_plain_backward_matches_autograd(self, fk_inputs):
        """The explicit reverse accumulation equals autograd through the
        plain forward (the kernel's two references agree)."""
        R = torch.tensor(fk_inputs["R"], requires_grad=True)
        t = torch.tensor(fk_inputs["t"], requires_grad=True)
        Rg, tg = fk.fk_fwd_plain(R, t, PARENTS)
        gR, gt = torch.tensor(fk_inputs["gR"]), torch.tensor(fk_inputs["gt"])
        torch.autograd.backward((Rg, tg), (gR, gt))
        gRl, gtl = fk.fk_bwd_plain(R.detach(), t.detach(), Rg.detach(), gR,
                                   gt, PARENTS)
        np.testing.assert_allclose(gRl.numpy(), R.grad.numpy(), atol=2e-5)
        np.testing.assert_allclose(gtl.numpy(), t.grad.numpy(), atol=2e-5)

    def test_topo_order_parents_first(self):
        order = fk.topo_order(PARENTS)
        seen = {0}
        for j in order:
            assert PARENTS[j] in seen
            seen.add(j)
        assert sorted(order) == list(range(1, 24))


@pytest.fixture(scope="module")
def v2v_case():
    """Orig and rec sides built like smpl_v2v_l1_sum. The rec side gets a
    +-10 m per-row offset so no vertex difference lies near 0, where
    sign(rec - orig) could flip between two summation orders."""
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    rng = np.random.RandomState(1)
    B, V = 8, 300
    parents = np.asarray(jm.parents)

    def side(R):
        pf = (R[:, 1:] - np.eye(3, dtype=np.float32)).reshape(B, 207)
        Jr = np.asarray(jm.J_regressor) @ np.asarray(jm.v_template)
        Rg, tg = (np.asarray(a) for a in jax_fk_compose(
            jnp.asarray(R), jnp.asarray(np.broadcast_to(
                np.concatenate([Jr[:1], Jr[1:] - Jr[parents[1:]]]),
                (B, 24, 3))), PARENTS))
        t_rel = tg - np.einsum('bnij,nj->bni', Rg, Jr)
        return pf, np.concatenate([Rg, t_rel[..., None]], -1).reshape(
            B, 24, 12).astype(np.float32)

    pf_o, A_o = side(_rotations(rng, B, 24))
    pf_r, A_r = side(_rotations(rng, B, 24))
    A_r = A_r.reshape(B, 24, 3, 4)
    A_r[..., 3] += 10.0 * np.sign(rng.randn(B, 1, 3))
    A_r = A_r.reshape(B, 24, 12).astype(np.float32)
    vsh = np.ascontiguousarray(np.asarray(jm.v_template).T)
    return dict(jm=jm, V=V, pf_o=pf_o, A_o=A_o, pf_r=pf_r, A_r=A_r, vsh=vsh)


def _jax_v2v(c):
    jm = c["jm"]
    f = lambda pf_o, A_o, vsh, pf_r, A_r: jax_skin_v2v_l1(
        c["V"], pf_o, A_o, vsh, jm.pd_tiles, jm.w_tiles, pf_r, A_r)
    return jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(c[k]) for k in ("pf_o", "A_o", "vsh", "pf_r", "A_r")))


class TestSkinV2VL1:
    def test_total_and_grads_match_jax(self, v2v_case):
        c = v2v_case
        total_j, grads_j = _jax_v2v(c)
        jm = c["jm"]
        t = {k: torch.tensor(c[k], requires_grad=True)
             for k in ("pf_o", "A_o", "vsh", "pf_r", "A_r")}
        total = skin_v2v_l1(c["V"], t["pf_o"], t["A_o"], t["vsh"],
                            torch.tensor(np.asarray(jm.posedirs_t)),
                            torch.tensor(np.asarray(jm.lbs_weights_t)),
                            t["pf_r"], t["A_r"])
        (2.5 * total).backward()
        # total: 7200 |diff| terms of O(10) summed in another order
        np.testing.assert_allclose(float(total.detach()), float(total_j),
                                   rtol=1e-5)
        for k, gj in zip(("pf_o", "A_o", "vsh"), grads_j[:3]):
            gj = 2.5 * np.asarray(gj)
            # sums over V=300 (gA, gpf) or B=8 (gvsh) f32 products
            np.testing.assert_allclose(t[k].grad.numpy(), gj,
                                       atol=1e-5 * np.abs(gj).max() + 1e-7,
                                       err_msg=k)
        # the rec side is a constant: no gradient at all
        assert t["pf_r"].grad is None and t["A_r"].grad is None
        assert not np.asarray(grads_j[3]).any()
        assert not np.asarray(grads_j[4]).any()

    def test_forward_only_mode_under_no_grad(self, v2v_case):
        c = v2v_case
        jm = c["jm"]
        args = [torch.tensor(c[k]) for k in ("pf_o", "A_o", "vsh")] + [
            torch.tensor(np.asarray(jm.posedirs_t)),
            torch.tensor(np.asarray(jm.lbs_weights_t)),
            torch.tensor(c["pf_r"]), torch.tensor(c["A_r"])]
        total_fwd, grads = lbs.v2v_l1_plain(*args, grad=False)
        total_grad, _ = lbs.v2v_l1_plain(*args, grad=True)
        assert grads is None
        assert torch.equal(total_fwd, total_grad)
        with torch.no_grad():
            total = skin_v2v_l1(c["V"], *args)
        assert torch.equal(total, total_fwd)

    def test_sign_of_zero_is_zero(self, v2v_case):
        """rec == orig gives total 0 and zero gradients (sign(0) = 0)."""
        c = v2v_case
        jm = c["jm"]
        pf = torch.tensor(c["pf_o"], requires_grad=True)
        A = torch.tensor(c["A_o"], requires_grad=True)
        total = skin_v2v_l1(c["V"], pf, A, torch.tensor(c["vsh"]),
                            torch.tensor(np.asarray(jm.posedirs_t)),
                            torch.tensor(np.asarray(jm.lbs_weights_t)),
                            torch.tensor(c["pf_o"]), torch.tensor(c["A_o"]))
        total.backward()
        assert float(total.detach()) == 0.0
        assert not pf.grad.any() and not A.grad.any()

    def test_vertex_count_checked(self, v2v_case):
        c = v2v_case
        with pytest.raises(ValueError, match="vertices"):
            skin_v2v_l1(c["V"] + 1, *(torch.tensor(c[k]) for k in
                                      ("pf_o", "A_o", "vsh")),
                        torch.zeros(207, 3, c["V"]), torch.zeros(24, c["V"]),
                        torch.tensor(c["pf_r"]), torch.tensor(c["A_r"]))


class TestDeviceRouting:
    """A tensor off the CPU is never routed to the plain version: on a
    machine without CUDA a CUDA tensor makes the wrapper raise."""

    def test_fake_cuda_tensors_raise_in_fk(self):
        before = dict(launch_counts())
        with FakeTensorMode(allow_non_fake_inputs=True):
            R = torch.empty(4, 24, 3, 3, device="cuda")
            t = torch.empty(4, 24, 3, device="cuda")
            with pytest.raises(RuntimeError, match="CUDA"):
                fk_compose(R, t, PARENTS)
        assert launch_counts() == before

    def test_fake_cuda_tensors_raise_in_v2v(self):
        with FakeTensorMode(allow_non_fake_inputs=True):
            cu = lambda *s: torch.empty(*s, device="cuda")
            with pytest.raises(RuntimeError, match="CUDA"):
                skin_v2v_l1(10, cu(2, 207), cu(2, 24, 12), cu(3, 10),
                            cu(207, 3, 10), cu(24, 10), cu(2, 207),
                            cu(2, 24, 12))

    @pytest.mark.parametrize("kind", ["meta", "mixed"])
    def test_other_devices_raise(self, kind):
        R = torch.empty(2, 24, 3, 3, device="meta")
        t = torch.empty(2, 24, 3, device="meta" if kind == "meta" else "cpu")
        with pytest.raises(ValueError, match="expected all on"):
            fk_compose(R, t, PARENTS)

    def test_resolve_device(self):
        assert resolve_device("cpu") == torch.device("cpu")
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
        with pytest.raises(ValueError):
            resolve_device("mps")

    def test_library_requires_cuda(self):
        with pytest.raises(RuntimeError, match="CUDA"):
            _build.library()

    def test_check_input(self):
        dev = torch.device("cpu")
        _build.check_input("x", torch.zeros(2, 3), (2, None), dev)
        with pytest.raises(TypeError):
            _build.check_input("x", torch.zeros(2, 3, dtype=torch.float64),
                               (2, 3), dev)
        with pytest.raises(ValueError, match="shape"):
            _build.check_input("x", torch.zeros(2, 4), (2, 3), dev)
        with pytest.raises(ValueError, match="contiguous"):
            _build.check_input("x", torch.zeros(3, 2).t(), (2, 3), dev)
