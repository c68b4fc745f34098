"""The port's rendering against nemo_tpu's, on the CPU.

The same numpy inputs, made from a seed, go through both packages. K5's
plain version (``ops.raster.rasterize_plain``, both modes) is held against
``rasterize_triangles_pallas(..., interpret=True)`` on the cases of
tests/test_raster_pallas.py, with that file's contract: coverage equal,
z within rtol 1e-6, face ids equal on more than 99.9% of covered pixels
(ulp-level depth ties), bary within atol 1e-5 where the ids match. The
shading, normals, splat and upsampling helpers agree within 1e-5 (f32 sums
taken in another order). The mesh overlay and the batched panel function
are compared with JAX's rasterizer path, reached by monkeypatching the JAX
package in the test only.
"""

import io

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
from nemo_tpu_torch.render import figures, mesh, video

torch.set_num_threads(2)


def _random_mesh(rng, F=120, spread=0.8, size=0.12):
    """Small triangles around random centres (tests/test_raster_pallas.py)."""
    centers = np.stack([rng.uniform(-spread, spread, F),
                        rng.uniform(-spread, spread, F),
                        rng.uniform(3, 5, F)], 1)
    offs = rng.uniform(-size, size, size=(F, 3, 3))
    verts = (centers[:, None] + offs).reshape(-1, 3).astype(np.float32)
    return verts, np.arange(3 * F).reshape(F, 3)


def _case(name):
    """(verts, faces, focal, center, img_hw, th, tw, faces_per_tile)."""
    rng = np.random.RandomState(0)
    if name == "random":
        v, f = _random_mesh(rng)
        return v, f, 100.0, (64.0, 48.0), (96, 128), 32, 32, 512
    if name == "lane_tiles":
        v, f = _random_mesh(rng, F=200, size=0.3)
        return v, f, 100.0, (64.0, 48.0), (96, 128), 32, 128, 512
    if name == "empty_behind":
        v = np.array([[0, 0, -1.0], [1, 0, -1.0], [0, 1, -1.0]], np.float32)
        return v, np.array([[0, 1, 2]]), 100.0, (32.0, 32.0), (64, 64), \
            32, 32, 8
    if name == "one_busy_tile":
        v, f = _random_mesh(rng, F=40, spread=0.05, size=0.03)
        return v, f, 100.0, (32.0, 48.0), (128, 256), 32, 128, 256
    if name == "tiny":
        v = np.array([[0, 0, 4.0], [0.5, 0, 4.0], [0, 0.5, 4.0],
                      [-0.5, 0, 5.0], [0, -0.5, 5.0], [-0.5, -0.5, 5.0]],
                     np.float32)
        return v, np.array([[0, 1, 2], [3, 4, 5]]), 100.0, (32.0, 32.0), \
            (64, 64), 32, 32, 4096
    if name == "ragged":
        v, f = _random_mesh(rng, F=300, spread=1.2, size=0.2)
        return v, f, 120.0, (95.0, 50.0), (100, 190), 32, 128, 4096
    raise KeyError(name)


CASES = ["random", "lane_tiles", "empty_behind", "one_busy_tile", "tiny",
         "ragged"]


def _jax_raster(verts, faces, focal, center, hw, th, tw, fpt, stream):
    return [np.asarray(a) for a in jraster.rasterize_triangles_pallas(
        jnp.asarray(verts), faces, focal, center, hw, th=th, tw=tw,
        faces_per_tile=fpt, interpret=True, stream=stream)]


def _assert_raster_close(got, want):
    (zt, ft, bt), (zj, fj, bj) = got, want
    cov = np.isfinite(zj)
    np.testing.assert_array_equal(np.isfinite(zt), cov)
    np.testing.assert_allclose(zt[cov], zj[cov], rtol=1e-6)
    same = ft == fj
    if cov.any():
        assert same[cov].mean() > 0.999
    assert (ft[~cov] == -1).all() and (bt[~cov] == 0).all()
    np.testing.assert_allclose(bt[same], bj[same], atol=1e-5)


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_rasterize_plain_matches_pallas(case, stream):
    verts, faces, focal, center, hw, th, tw, fpt = _case(case)
    want = _jax_raster(verts, faces, focal, center, hw, th, tw, fpt, stream)
    got = [a.numpy() for a in raster.rasterize_triangles(
        torch.tensor(verts), faces, focal, center, hw, th=th, tw=tw,
        faces_per_tile=fpt, stream=stream)]
    assert got[1].dtype == np.int32 and got[0].shape == hw
    _assert_raster_close(got, want)
    if case == "empty_behind":
        assert not np.isfinite(got[0]).any()
    if case in ("tiny", "one_busy_tile"):
        assert np.isfinite(got[0]).any()


def test_gather_overflow_drops_like_jax():
    """A busy tile over faces_per_tile: the overflow count is JAX's, and
    the gather mode drops the same entries (its output is JAX's gather
    output, not the stream output)."""
    rng = np.random.RandomState(1)
    verts, faces = _random_mesh(rng, F=60, spread=0.1, size=0.1)
    args = (verts, faces, 100.0, (32.0, 48.0), (64, 128))
    fpt = 16
    n_j = jraster.gather_mode_overflow(*args, th=32, tw=32,
                                       faces_per_tile=fpt)
    n_t = raster.gather_mode_overflow(*args, th=32, tw=32,
                                      faces_per_tile=fpt)
    assert n_t == n_j > 0
    assert raster.gather_mode_overflow(*args, th=32, tw=32) == 0
    want = _jax_raster(*args, 32, 32, fpt, stream=False)
    got = [a.numpy() for a in raster.rasterize_triangles(
        torch.tensor(verts), faces, *args[2:], th=32, tw=32,
        faces_per_tile=fpt, stream=False)]
    _assert_raster_close(got, want)
    stream = [a.numpy() for a in raster.rasterize_triangles(
        torch.tensor(verts), faces, *args[2:], th=32, tw=32)]
    assert (stream[1] != got[1]).any()


def test_batched_panels_match_single():
    """Two panels with their own intrinsics in one fold equal two
    single-panel folds, bit for bit."""
    verts, faces, *_ = _case("ragged")
    v2 = verts + np.float32([0.1, -0.05, 0.3])
    vs = torch.tensor(np.stack([verts, v2]))
    foc, ctr = [120.0, 90.0], [(95.0, 50.0), (60.0, 70.0)]
    for stream in (True, False):
        zb, fb, bb = raster.rasterize_triangles_batched(
            vs, faces, foc, ctr, (100, 190), stream=stream)
        for i in range(2):
            z, f, b = raster.rasterize_triangles(vs[i], faces, foc[i],
                                                 ctr[i], (100, 190),
                                                 stream=stream)
            assert torch.equal(zb[i], z) and torch.equal(fb[i], f)
            assert torch.equal(bb[i], b)


@pytest.fixture(scope="module")
def posed_mesh():
    """A 300-vertex synthetic SMPL, posed by the synthetic problem's first
    frame, in front of a camera at 3.5 m."""
    jm = jax_synthetic_smpl(num_vertices=300, seed=0)
    bundle, truth = jax_synthetic_problem(jm, num_views=2, num_frames=6)
    from nemo_tpu.body.smpl import smpl_forward
    from nemo_tpu.geometry.rotations import batch_rodrigues
    rot = batch_rodrigues(jnp.asarray(truth["pose"][:2]).reshape(-1, 3))
    rot = rot.reshape(2, 24, 3, 3)
    v, _ = smpl_forward(jm, jnp.zeros((1, 10)), rot[:, 1:], rot[:, :1],
                        want_vertices=True)
    verts = np.asarray(v) + np.float32([0.0, 0.2, 3.5])
    return dict(model=jm, bundle=bundle, verts=verts,
                faces=np.asarray(jm.faces))


@pytest.mark.parametrize("shading", ["pbr", "diffuse"])
def test_shade_vertices_matches_jax(posed_mesh, shading):
    v, f = posed_mesh["verts"][0], posed_mesh["faces"]
    want = np.asarray(jmesh.shade_vertices(jnp.asarray(v), f, (0.65, 0.74,
                                                               0.86), shading))
    got = mesh.shade_vertices(torch.tensor(v), f, (0.65, 0.74, 0.86),
                              shading).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    per_vertex = np.random.RandomState(0).rand(len(v), 3).astype(np.float32)
    np.testing.assert_allclose(
        mesh.shade_vertices(torch.tensor(v), f, per_vertex, shading).numpy(),
        np.asarray(jmesh.shade_vertices(jnp.asarray(v), f, per_vertex,
                                        shading)), atol=1e-5)


def test_normals_and_upsample_match_jax(posed_mesh):
    v, f = posed_mesh["verts"][0], posed_mesh["faces"]
    np.testing.assert_allclose(
        mesh.vertex_normals(torch.tensor(v), f).numpy(),
        np.asarray(jmesh.vertex_normals(jnp.asarray(v), f)), atol=1e-5)
    cols = np.random.RandomState(1).rand(len(v), 3).astype(np.float32)
    pj, cj = jmesh.upsample_faces(jnp.asarray(v), jnp.asarray(cols), f, 8)
    pt, ct = mesh.upsample_faces(torch.tensor(v), torch.tensor(cols), f, 8)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)


def test_splat_render_matches_jax():
    """Mask and z-buffer winners exactly; the image where no splat pass
    has two candidates on one pixel (elsewhere the scatter's winner among
    duplicates is undefined in both frameworks)."""
    rng = np.random.RandomState(2)
    V = 400
    verts = np.stack([rng.uniform(-0.4, 0.4, V), rng.uniform(-0.3, 0.3, V),
                      rng.uniform(2, 4, V)], 1).astype(np.float32)
    verts[:5, 2] = -1.0                               # behind the camera
    cols = rng.rand(V, 3).astype(np.float32)
    args = (100.0, (64.0, 48.0), (96, 128))
    ij, mj = (np.asarray(a) for a in jmesh.splat_render(
        jnp.asarray(verts), jnp.asarray(cols), *args))
    it, mt = (a.numpy() for a in mesh.splat_render(
        torch.tensor(verts), torch.tensor(cols), *args))
    np.testing.assert_array_equal(mt, mj)
    z = verts[:, 2]
    u = np.round(100.0 * verts[:, 0] / z + 64.0).astype(int)
    w = np.round(100.0 * verts[:, 1] / z + 48.0).astype(int)
    multi = np.zeros(96 * 128, bool)
    for dx in range(2):
        for dy in range(2):
            ok = (z > 1e-3) & (u + dx >= 0) & (u + dx < 128) & \
                (w + dy >= 0) & (w + dy < 96)
            lin = (w + dy)[ok] * 128 + (u + dx)[ok]
            multi |= np.bincount(lin, minlength=96 * 128) > 1
    single = (~multi.reshape(96, 128)) & (mj > 0)
    assert single.sum() > 100
    np.testing.assert_allclose(it[single], ij[single], atol=1e-6)


def _jax_rasterizer(monkeypatch):
    """Route the JAX package's raster_render to its Pallas rasterizer in
    interpret mode (the CPU's own path there is the scan rasterizer)."""
    monkeypatch.setattr(jraster, "raster_pallas_available", lambda: True)
    fn = jraster.rasterize_triangles_pallas
    monkeypatch.setattr(jraster, "rasterize_triangles_pallas",
                        lambda *a, **k: fn(*a, interpret=True, **k))


def _camera(R, t, f, c):
    return JCamera(rotation=np.asarray(R, np.float32),
                   translation=np.asarray(t, np.float32),
                   focal_length=np.float32(f),
                   center=np.asarray(c, np.float32))


def test_mesh_overlay_raster_matches_jax(posed_mesh, monkeypatch):
    _jax_rasterizer(monkeypatch)
    v, f = posed_mesh["verts"][0], posed_mesh["faces"]
    cam = _camera(np.eye(3), [0.02, -0.01, 0.1], 150.0, (70.0, 45.0))
    image = np.random.RandomState(3).rand(96, 140, 3).astype(np.float32)
    want = jmesh.render_mesh_overlay(jnp.asarray(v), f, cam, image,
                                     (96, 140), method="raster")
    got = mesh.render_mesh_overlay(v, f, cam, image, (96, 140),
                                   method="raster", device="cpu")
    assert got.shape == (96, 140, 3) and got.dtype == np.float32
    covered = np.abs(got - image).max(-1) > 1e-3
    assert covered.mean() > 0.02
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_panel_fn_matches_jax(posed_mesh, monkeypatch):
    """All views of a frame in one batched call, each view with its own
    intrinsics, against JAX's jitted per-view panels."""
    _jax_rasterizer(monkeypatch)
    v, f = posed_mesh["verts"], posed_mesh["faces"]
    c = np.cos(0.3)
    cams = [_camera(np.eye(3), [0.0, 0.0, 0.0], 150.0, (70.0, 45.0)),
            _camera([[c, 0, np.sin(0.3)], [0, 1, 0], [-np.sin(0.3), 0, c]],
                    [0.1, 0.05, 0.2], 120.0, (60.0, 50.0))]
    R = np.stack([np.asarray(cm.rotation) for cm in cams])
    t = np.stack([np.asarray(cm.translation) for cm in cams])
    ij, mj = jmesh.make_mesh_panel_fn(f, cams, (96, 140), method="raster")(
        jnp.asarray(v), jnp.asarray(R), jnp.asarray(t))
    it, mt = mesh.make_mesh_panel_fn(f, cams, (96, 140), method="raster",
                                     device="cpu")(v, R, t)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), atol=1e-5)
    assert (mt.numpy().reshape(2, -1).mean(1) > 0.02).all()


def test_auto_method_is_splat_on_cpu(posed_mesh):
    v, f = posed_mesh["verts"][0], posed_mesh["faces"]
    cam = _camera(np.eye(3), [0, 0, 0], 150.0, (70.0, 45.0))
    auto = mesh.render_mesh_overlay(v, f, cam, None, (96, 140), device="cpu")
    splat = mesh.render_mesh_overlay(v, f, cam, None, (96, 140),
                                     method="splat", device="cpu")
    np.testing.assert_array_equal(auto, splat)


def test_face_window_params_match_jax(posed_mesh):
    v, f = posed_mesh["verts"][0], posed_mesh["faces"]
    for hw in ((96, 140), (1000, 1900)):
        assert mesh.face_window_params(v, f, 900.0, (70.0, 45.0), hw) == \
            jmesh.face_window_params(v, f, 900.0, (70.0, 45.0), hw)


class _Bundle:
    """The fields of a bundle the renders read."""

    def __init__(self, V, F, hw):
        self.num_views, self.num_frames = V, F
        self.img_d0, self.img_d1 = hw
        self.frame_paths = None


def test_video_and_figure_shapes(posed_mesh, tmp_path):
    """render_mesh_video writes one frame per every-th frame (a .frames
    directory without ffmpeg); the figure grids have JAX's shapes."""
    from nemo_tpu.render import figures as jfigures
    from nemo_tpu_torch.geometry.camera import camera_from_params_np
    V, F, hw = 2, 6, (48, 64)
    b = _Bundle(V, F, hw)
    base = posed_mesh["verts"][0] + np.float32([0, 0, 6.0])
    verts = np.stack([np.stack([base + 0.01 * i for i in range(F)])] * V)
    cams = [camera_from_params_np(
        np.float32([0, 0, 0, 1, 0, 0, 1, 0, 0]), hw[0], hw[1], 100.0)] * V
    out = video.render_mesh_video(str(tmp_path / "mesh.mp4"), verts,
                                  posed_mesh["faces"], cams, b, every=4,
                                  device="cpu")
    frames = sorted(p.name for p in (tmp_path / "mesh.mp4.frames").iterdir()) \
        if out.endswith(".frames") else None
    if frames is not None:
        assert frames == ["000000.png", "000001.png"]
    grid = figures.render_rollout_figure(str(tmp_path / "r.png"), verts,
                                         posed_mesh["faces"], cams, b,
                                         num_frames=4, device="cpu")
    jgrid = jfigures.render_rollout_figure(str(tmp_path / "rj.png"), verts,
                                           posed_mesh["faces"], cams, b,
                                           num_frames=4)
    assert grid.shape == jgrid.shape == (2 * 48, 4 * 64, 3)
    comp = figures.render_comparison_figure(str(tmp_path / "c.png"), 0,
                                            verts[0], posed_mesh["faces"],
                                            cams[0], b, num_frames=3,
                                            device="cpu")
    jcomp = jfigures.render_comparison_figure(str(tmp_path / "cj.png"), 0,
                                              verts[0], posed_mesh["faces"],
                                              cams[0], b, num_frames=3)
    assert comp.shape == jcomp.shape == (2 * 48, 3 * 64, 3)
    assert (tmp_path / "r.png").stat().st_size > 0


@pytest.mark.parametrize("shape", [(37, 53, 3), (1, 1, 3)])
def test_png_writer_round_trip(tmp_path, shape):
    """The standard-library PNG writer, decoded by PIL and by matplotlib,
    gives back the uint8 array bit for bit."""
    from PIL import Image
    import matplotlib.pyplot as plt
    rng = np.random.RandomState(4)
    arr = rng.randint(0, 256, size=shape).astype(np.uint8)
    data = video.encode_png(arr)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  arr)
    path = tmp_path / "a.png"
    img = arr.astype(np.float32) / 255.0
    video._write_png(str(path), img)
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    got = plt.imread(str(path))
    got = np.round(got * 255).astype(np.uint8) if got.dtype != np.uint8 \
        else got
    np.testing.assert_array_equal(got, want)
