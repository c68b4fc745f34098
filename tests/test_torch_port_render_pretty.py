"""The port's pretty renderer against nemo_tpu's, on the CPU.

blue_spectrum and checkerboard_plane are held exactly. render_pretty (two
people and the checkerboard ground in one z-buffer, both shadings, over an
image with alpha, and without the ground) goes through the port's K5 plain
version and through the JAX package's Pallas rasterizer in interpret mode
(reached by monkeypatching the JAX package in the test only, as
tests/test_torch_port_render.py does). Pixels agree within atol 1e-5, but
for those whose face ids differ on ulp-level depth ties, which may be at
most 0.1% of the image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nemo_tpu.ops.raster_pallas as jraster
from nemo_tpu.body import synthetic_smpl_model as jax_synthetic_smpl
from nemo_tpu.data import synthetic_problem as jax_synthetic_problem
from nemo_tpu.geometry.camera import Camera as JCamera
from nemo_tpu.render import mesh as jmesh
from nemo_tpu_torch.ops import raster
from nemo_tpu_torch.render import mesh

torch.set_num_threads(2)
HW = (64, 96)


def _jax_rasterizer(monkeypatch):
    monkeypatch.setattr(jraster, "raster_pallas_available", lambda: True)
    fn = jraster.rasterize_triangles_pallas
    monkeypatch.setattr(jraster, "rasterize_triangles_pallas",
                        lambda *a, **k: fn(*a, interpret=True, **k))


@pytest.fixture(scope="module")
def people():
    """Two 300-vertex synthetic bodies in two poses, side by side 10 m in
    front of the camera (the pretty figures' layout)."""
    from nemo_tpu.body.smpl import smpl_forward
    from nemo_tpu.geometry.rotations import batch_rodrigues
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    _, truth = jax_synthetic_problem(jm, num_views=2, num_frames=6)
    rot = batch_rodrigues(jnp.asarray(truth["pose"][:2]).reshape(-1, 3))
    rot = rot.reshape(2, 24, 3, 3)
    v, _ = smpl_forward(jm, jnp.zeros((1, 10)), rot[:, 1:], rot[:, :1],
                        want_vertices=True)
    v = np.asarray(v)
    out = []
    for i in range(2):
        p = v[i] - v[i].mean(0, keepdims=True)
        p[:, 0] += -0.5 + i
        p[:, 2] += 10.0
        out.append(p.astype(np.float32))
    return out, np.asarray(jm.faces)


def _camera():
    H, W = HW
    return JCamera(rotation=np.eye(3, dtype=np.float32),
                   translation=np.zeros(3, np.float32),
                   focal_length=np.float32(5.0 * min(H, W)),
                   center=np.array([W / 2.0, H / 2.0], np.float32))


@pytest.mark.parametrize("n", [0, 1, 6, 13])
def test_blue_spectrum_exact(n):
    np.testing.assert_array_equal(mesh.blue_spectrum(n),
                                  jmesh.blue_spectrum(n))


@pytest.mark.parametrize("args", [(), (8.0,), (2.0, 3, -0.4, 2)])
def test_checkerboard_plane_exact(args):
    v, f, c = mesh.checkerboard_plane(*args)
    jv, jf, jc = jmesh.checkerboard_plane(*args)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert v.dtype == torch.float32 and f.dtype == np.int64


CASES = {
    "pbr": dict(shading="pbr"),
    "diffuse": dict(shading="diffuse"),
    "image_alpha": dict(shading="pbr", alpha=0.7, image=True),
    "colors": dict(shading="diffuse", person_colors=[0.8, 0.3, 0.2]),
    "no_ground": dict(shading="pbr", add_ground=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_pretty_matches_jax(people, monkeypatch, case):
    _jax_rasterizer(monkeypatch)
    kw = dict(CASES[case])
    if kw.pop("image", False):
        kw["image"] = np.random.RandomState(5).rand(*HW, 3).astype(
            np.float32)
    verts, faces = people
    want = np.asarray(jmesh.render_pretty(verts, faces, _camera(), HW, **kw))
    got = mesh.render_pretty(verts, faces, _camera(), HW, device="cpu",
                             **kw)
    assert got.shape == HW + (3,) and got.dtype == np.float32
    bad = np.abs(got - want).max(-1) > 1e-5
    assert bad.mean() <= 1e-3, bad.sum()
    # the render covers the people (and the ground where it is drawn)
    cover = np.abs(got - (kw.get("image") if "image" in kw
                          else np.ones(HW + (3,)))).max(-1) > 1e-3
    assert cover.mean() > (0.3 if kw.get("add_ground", True) else 0.02)


def test_render_pretty_is_one_fold(people, monkeypatch):
    """The people and the plane go through one rasterizer call (one K5s
    launch on a CUDA device), with a span sized for the plane's faces."""
    calls = []
    fn = raster.rasterize_triangles_batched

    def spy(verts_cam, faces, *a, **k):
        calls.append((tuple(verts_cam.shape), k.get("span")))
        return fn(verts_cam, faces, *a, **k)

    monkeypatch.setattr(raster, "rasterize_triangles_batched", spy)
    monkeypatch.setattr(mesh, "rasterize_triangles_batched", spy)
    verts, faces = people
    mesh.render_pretty(verts, faces, _camera(), HW, device="cpu")
    n_ground = mesh.checkerboard_plane()[0].shape[0]
    assert len(calls) == 1
    assert calls[0][0] == (1, 2 * verts[0].shape[0] + n_ground, 3)
    assert calls[0][1] != 2
