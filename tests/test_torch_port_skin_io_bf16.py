"""bf16 meshes (``--skin_io_bf16``) on the CPU, against nemo_tpu.

With ``out_dtype=torch.bfloat16`` the port's ``skin_verts_t`` is the JAX
package's ``skin_verts_t`` under NEMO_TPU_SKIN_IO_BF16=1: the f32 vertices
rounded to bf16 (nearest even; ``acc.astype(out_ref.dtype)`` in
``_fwd_kernel``, ``.astype(skin_io_dtype())`` on the XLA route), and a
backward that reads the bf16 cotangent widened to f32 (``_bwd_kernel``'s
``g.astype(f32)``). Both JAX routes are run: the XLA one (the CPU's
default) and the Pallas kernels in interpret mode with ``_use_pallas``
forced on, with f32 and with bf16 tables (the Pallas route; JAX's XLA route
rounds only the tables, not pf and A, so with bf16 tables it computes
another function and is checked for the knob's shape alone). The variable
is read when a JAX function is traced, so each JAX computation is traced
fresh under it.

Tolerances: a bf16 vertex within one bf16 step (2^-7) of the other side's
(each rounds its own f32 sum; where the two sums straddle a rounding point
the rounded values are a step apart), plus 1e-6 of the largest entry near
0; gradients under the same bf16 cotangent 1e-5 of each tensor's largest
entry (the f32 kernels' and test_torch_port_skin_bf16.py's); the subset
v2v prior's loss rtol 1e-4 and its gradients 1e-4 of the largest entry (a
vertex a step apart moves one |difference| of the mean by 2^-8 of a
vertex). With f32 meshes every op gives the bits it gave before.
"""

import dataclasses
import functools
import types
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nemo_tpu import fit as jfit
from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.data import synthetic_problem as jax_synthetic_problem
from nemo_tpu.fit import model as jmodel
from nemo_tpu.ops import lbs_pallas
from nemo_tpu.priors import init_vposer as jax_init_vposer
from nemo_tpu_torch import fit as tfit
from nemo_tpu_torch.body.assets import smpl_from_numpy
from nemo_tpu_torch.fit import model as tmodel
from nemo_tpu_torch.ops import lbs
from nemo_tpu_torch.priors.vposer import vposer_from_numpy

torch.set_num_threads(1)
BF = torch.bfloat16
CASES = [(300, 8), (640, 13)]
IDS = [f"V{v}-B{b}" for v, b in CASES]
TABLES = ("f32", "bf16")


def _interpret():
    orig = lbs_pallas.pl.pallas_call

    def call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)
    return mock.patch.object(lbs_pallas.pl, "pallas_call", call)


@functools.lru_cache(maxsize=None)
def _case(V, B):
    """numpy inputs: pf and A of random rotations (the shapes of
    smpl_verts_t's), v_shaped_t, the tables and a cotangent in bf16."""
    jm = jax_synthetic_smpl(num_vertices=V, seed=0)
    rng = np.random.RandomState(V + B)
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(0.7 * rng.randn(B * 24, 3)).as_matrix()
    R = R.reshape(B, 24, 3, 3).astype(np.float32)
    t = 0.1 * rng.randn(B, 24, 3, 1).astype(np.float32)
    A = np.concatenate([R, t], -1).reshape(B, 24, 12)
    pf = (R[:, 1:] - np.eye(3, dtype=np.float32)).reshape(B, 207)
    g = torch.tensor(rng.randn(B, 3, V).astype(np.float32)).to(BF)
    return dict(V=V, B=B, pf=pf, A=A.astype(np.float32),
                vsh=np.ascontiguousarray(np.asarray(jm.v_template).T),
                pd=np.asarray(jm.posedirs_t), W=np.asarray(jm.lbs_weights_t),
                g=g)


def _jax_skin(c, tables, route, monkeypatch):
    """(mesh, (gpf, gA, gvsh)) of nemo_tpu's skin_verts_t under
    NEMO_TPU_SKIN_IO_BF16=1 on ``route`` ("xla" or "pallas"), the
    cotangent c["g"] in bf16; numpy, the mesh widened to f32."""
    dtype = jnp.bfloat16 if tables == "bf16" else jnp.float32
    pd_tiles, w_tiles = (jnp.asarray(t) for t in lbs_pallas.tile_tables(
        c["pd"], c["W"], tv=128, dtype=dtype)[:2])
    monkeypatch.setenv("NEMO_TPU_SKIN_IO_BF16", "1")
    jax.clear_caches()
    f = lambda pf, A, vsh: lbs_pallas.skin_verts_t(c["V"], pf, A, vsh,
                                                   pd_tiles, w_tiles)
    g = jnp.asarray(c["g"].float().numpy(), jnp.bfloat16)
    args = [jnp.asarray(c[k]) for k in ("pf", "A", "vsh")]
    try:
        if route == "pallas":
            with _interpret(), mock.patch.object(lbs_pallas, "_use_pallas",
                                                 lambda: True):
                out, vjp = jax.vjp(f, *args)
                grads = vjp(g)
        else:
            out, vjp = jax.vjp(f, *args)
            grads = vjp(g)
    finally:
        monkeypatch.delenv("NEMO_TPU_SKIN_IO_BF16")
        jax.clear_caches()
    assert out.dtype == jnp.bfloat16
    return (np.asarray(out.astype(jnp.float32)),
            tuple(np.asarray(x) for x in grads))


def _port_skin(c, tables, out_dtype=BF):
    """(mesh, (gpf, gA, gvsh)) of the port's skin_verts_t on the CPU under
    the cotangent c["g"] (bf16, or widened for an f32 mesh)."""
    dtype = BF if tables == "bf16" else torch.float32
    pd, W = (torch.tensor(c[k]).to(dtype) for k in ("pd", "W"))
    leaves = [torch.tensor(c[k], requires_grad=True)
              for k in ("pf", "A", "vsh")]
    out = lbs.skin_verts_t(c["V"], *leaves, pd, W, out_dtype=out_dtype)
    assert out.dtype == out_dtype
    out.backward(c["g"].to(out_dtype))
    return out.detach(), tuple(x.grad for x in leaves)


def _close(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{name}: {err:.3e} > {rel:g} x {scale:.3e}"


def _within_bf16_step(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 2.0 ** -7 * np.abs(want) + 1e-6 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), name


@pytest.mark.parametrize("tables,route", [("f32", "xla"), ("f32", "pallas"),
                                          ("bf16", "pallas")])
@pytest.mark.parametrize("V,B", CASES, ids=IDS)
def test_skin_verts_t_io_bf16_matches_jax(V, B, tables, route, monkeypatch):
    """K3f's bf16 mesh and K3b's gradients under a bf16 cotangent against
    nemo_tpu's skin_verts_t under NEMO_TPU_SKIN_IO_BF16=1, on the route and
    with the tables given: each vertex within one bf16 step, each gradient
    within 1e-5 of its tensor's largest entry."""
    c = _case(V, B)
    out_j, grads_j = _jax_skin(c, tables, route, monkeypatch)
    out, grads = _port_skin(c, tables)
    _within_bf16_step(out.float(), out_j, "verts")
    for name, a, b in zip(("gpf", "gA", "gvsh"), grads, grads_j):
        _close(a, b, 1e-5, name)


@pytest.mark.parametrize("tables", TABLES)
@pytest.mark.parametrize("V,B", CASES, ids=IDS)
def test_bf16_mesh_is_the_f32_mesh_rounded(V, B, tables, monkeypatch):
    """On both sides the knob rounds the f32 mesh and widens the cotangent,
    nothing more: the port's bf16 mesh is its f32 mesh rounded to nearest
    even, bit for bit, and its gradients under a bf16 cotangent are those
    under the widened cotangent, bit for bit; JAX's XLA route does the same
    (with bf16 tables too, where it rounds the tables only)."""
    c = _case(V, B)
    out, grads = _port_skin(c, tables)
    out32, grads32 = _port_skin(c, tables, torch.float32)
    assert torch.equal(out, out32.to(BF))
    assert all(torch.equal(a, b) for a, b in zip(grads, grads32))
    out_j, grads_j = _jax_skin(c, tables, "xla", monkeypatch)
    dtype = jnp.bfloat16 if tables == "bf16" else jnp.float32
    pd_tiles, w_tiles = (jnp.asarray(t) for t in lbs_pallas.tile_tables(
        c["pd"], c["W"], tv=128, dtype=dtype)[:2])
    jax.clear_caches()
    out32_j = lbs_pallas.skin_verts_t(
        V, *(jnp.asarray(c[k]) for k in ("pf", "A", "vsh")), pd_tiles,
        w_tiles)
    assert out32_j.dtype == jnp.float32
    np.testing.assert_array_equal(
        out_j, np.asarray(out32_j.astype(jnp.bfloat16).astype(jnp.float32)))


def test_f32_mesh_gives_the_same_bits():
    """out_dtype f32 (the default) is the op as it was: the plain forward
    and backward, bit for bit."""
    c = _case(300, 8)
    out, grads = _port_skin(c, "f32", torch.float32)
    args = [torch.tensor(c[k]) for k in ("pf", "A", "vsh", "pd", "W")]
    assert torch.equal(out, lbs.skin_verts_t_plain(*args))
    want = lbs.skin_bwd_plain(*args, c["g"].float())
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def test_mesh_dtype_is_checked():
    c = _case(300, 8)
    args = [torch.tensor(c[k]) for k in ("pf", "A", "vsh", "pd", "W")]
    with pytest.raises(TypeError, match="mesh dtype"):
        lbs.skin_verts_t(300, *args, out_dtype=torch.float16)


# ---------------------------------------------------------------------------
# the subset v2v prior under the knob
# ---------------------------------------------------------------------------

def _problem(tables, monkeypatch):
    """JAX and port assets with the 64-vertex v2v subset, the tables in
    ``tables`` (JAX: NEMO_TPU_SKIN_BF16 at build time), the port's meshes
    in bf16."""
    monkeypatch.setenv("NEMO_TPU_SKIN_BF16", "1" if tables == "bf16" else "0")
    cfg = jfit.NemoConfig(model_version=2, h_dim=16, instance_code_size=4,
                          phase_rbf_dim=8, monotonic_network_n_nodes=4,
                          batch_size=16, weight_vp_loss=1.0,
                          vp_v2v_n_verts=64, label_type="gt")
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    bundle, _ = jax_synthetic_problem(jm, num_views=2, num_frames=12, seed=0)
    vposer = jax_init_vposer(jax.random.PRNGKey(7))
    jassets = jfit.build_assets(bundle, jm, cfg, vposer=vposer)
    monkeypatch.delenv("NEMO_TPU_SKIN_BF16")
    tassets = tfit.build_assets(
        bundle, smpl_from_numpy(jm), tfit.NemoConfig(**dataclasses.asdict(
            cfg)), device="cpu", skin_io_bf16=True,
        vposer=vposer_from_numpy({k: np.asarray(v)
                                  for k, v in vposer.items()}))
    want = BF if tables == "bf16" else torch.float32
    assert tassets.v2v_posedirs_t.dtype == want
    assert tassets.skin_io_dtype == BF
    return jassets, tassets


@pytest.mark.parametrize("tables,route", [("f32", "xla"), ("f32", "pallas"),
                                          ("bf16", "pallas")])
def test_subset_v2v_matches_jax_vposer_losses(tables, route, monkeypatch):
    """The subset v2v loss (both meshes bf16, widened before their
    difference) and its gradients in poses, orient and betas against
    nemo_tpu's vposer_losses under NEMO_TPU_SKIN_IO_BF16=1: the loss within
    rtol 1e-4, the KL within 1e-5, each gradient within 1e-4 of its
    tensor's largest entry."""
    jassets, tassets = _problem(tables, monkeypatch)
    rs = np.random.RandomState(2)
    poses = (0.3 * rs.randn(16, 69)).astype(np.float32)
    orient = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (16, 1)) + \
        (0.1 * rs.randn(16, 6)).astype(np.float32)
    betas = (0.5 * rs.randn(1, 10)).astype(np.float32)

    def jloss(p, o, b):
        v2v, kl = jmodel.vposer_losses({"betas": b}, jassets, p, o)
        return v2v + kl, (v2v, kl)

    monkeypatch.setenv("NEMO_TPU_SKIN_IO_BF16", "1")
    jax.clear_caches()
    try:
        fn = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)
        if route == "pallas":
            with _interpret(), mock.patch.object(lbs_pallas, "_use_pallas",
                                                 lambda: True):
                (_, (v2v_j, kl_j)), grads_j = fn(poses, orient, betas)
        else:
            (_, (v2v_j, kl_j)), grads_j = fn(poses, orient, betas)
    finally:
        monkeypatch.delenv("NEMO_TPU_SKIN_IO_BF16")
        jax.clear_caches()
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (poses, orient, betas)]
    v2v, kl = tmodel.vposer_losses(types.SimpleNamespace(betas=leaves[2]),
                                   tassets, leaves[0], leaves[1])
    (v2v + kl).backward()
    assert float(v2v_j) > 0
    np.testing.assert_allclose(float(v2v.detach()), float(v2v_j), rtol=1e-4)
    np.testing.assert_allclose(float(kl.detach()), float(kl_j), rtol=1e-5)
    for name, x, gj in zip(("poses", "orient", "betas"), leaves, grads_j):
        _close(x.grad, gj, 1e-4, name)


def test_subset_v2v_f32_meshes_give_the_same_bits(monkeypatch):
    """With f32 meshes the subset v2v prior is the formula it was before
    the knob, bit for bit: |rec - orig| summed over the f32 meshes."""
    _, tassets = _problem("f32", monkeypatch)
    tassets = dataclasses.replace(tassets, skin_io_dtype=torch.float32)
    rs = np.random.RandomState(4)
    poses = torch.tensor((0.3 * rs.randn(16, 69)).astype(np.float32))
    orient = torch.tensor(np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32),
                                  (16, 1)))
    betas = torch.zeros(1, 10)
    v2v, _ = tmodel.vposer_losses(types.SimpleNamespace(betas=betas),
                                  tassets, poses, orient)
    from nemo_tpu_torch.body.smpl import smpl_verts_t_subset
    from nemo_tpu_torch.geometry.rotations import (batch_rodrigues,
                                                   rot6d_to_rotmat)
    from nemo_tpu_torch.priors.vposer import vposer_decode, vposer_encode
    vp = tassets.vposer
    mu, _ = vposer_encode(vp, poses[:, :63])
    recon = torch.cat([vposer_decode(vp, mu)["pose_body"].reshape(16, 63),
                       poses[:, 63:]], 1)
    orient_rot = rot6d_to_rotmat(orient)[:, None]
    sub = (tassets.v2v_vidx, tassets.v2v_posedirs_t,
           tassets.v2v_lbs_weights_t)
    vo = smpl_verts_t_subset(tassets.smpl, betas,
                             batch_rodrigues(poses.reshape(16, 23, 3)),
                             orient_rot, *sub)
    vr = smpl_verts_t_subset(tassets.smpl, betas,
                             batch_rodrigues(recon.reshape(16, 23, 3)),
                             orient_rot, *sub)
    assert torch.equal(v2v, (vr - vo).abs().sum() / (16 * 3 * sub[0].shape[0]))
