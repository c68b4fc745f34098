"""Mesh overlay rendering: vertex shading, splat and triangle rasterization.

Port of nemo_tpu/render/mesh.py (the part the fit's outputs use). Vertices
are transformed and shaded in PyTorch on the render device, drawn by the
tile rasterizer (``ops.raster``, K5s on the card) or by the vertex-splat
z-buffer, and alpha-composited over the frame with numpy on the host.

``method="auto"`` picks the rasterizer where its kernel runs (a CUDA
device) and the splat renderer on the CPU, as the JAX package picks its
Pallas rasterizer only on a TPU. The JAX package's scan and binned
rasterizers (XLA paths, no kernel) have no counterpart: on the CPU
``method="raster"`` runs K5's plain version.

Entry points that take numpy (``render_mesh_overlay``,
``make_mesh_panel_fn``) take a ``device``, "cuda" unless the caller asks for
the CPU.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.raster import rasterize_triangles_batched

BASE_COLOR = (0.65, 0.74, 0.86)
LIGHT_DIR = (0.0, -0.4, -1.0)


def _faces_tensor(faces, device) -> torch.Tensor:
    if isinstance(faces, torch.Tensor):
        return faces.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(faces, np.int64), device=device)


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def vertex_normals(verts: torch.Tensor, faces) -> torch.Tensor:
    """Area-weighted vertex normals of (..., V, 3) vertices, faces (F, 3)."""
    f = _faces_tensor(faces, verts.device)
    v0, v1, v2 = (verts[..., f[:, i], :] for i in range(3))
    fn = torch.cross(v1 - v0, v2 - v0, dim=-1)
    n = torch.zeros_like(verts)
    for i in range(3):
        n.index_add_(-2, f[:, i], fn)
    return n / (n.norm(dim=-1, keepdim=True) + 1e-8)


def splat_render(verts_cam: torch.Tensor, colors: torch.Tensor,
                 focal_length: float, center: Tuple[float, float],
                 img_hw: Tuple[int, int], splat: int = 2
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V, 3) camera-space vertices -> (H, W, 3) image and (H, W) coverage
    mask: scatter-min z-buffer, each vertex covering a splat x splat block.
    Every vertex of a pass writes (its color where it holds the z-buffer,
    else the pixel's old color), and among vertices on one pixel the last
    one's write stands, so repeated renders are identical. The JAX
    package's scatter leaves that winner undefined."""
    H, W = img_hw
    z = verts_cam[:, 2]
    u = focal_length * verts_cam[:, 0] / z + center[0]
    v = focal_length * verts_cam[:, 1] / z + center[1]
    px = torch.round(u).to(torch.int64)
    py = torch.round(v).to(torch.int64)
    dev = verts_cam.device
    zbuf = torch.full((H * W,), float("inf"), device=dev)
    img = torch.zeros((H * W, 3), device=dev)
    inf = torch.full_like(z, float("inf"))
    order = torch.arange(z.shape[0], device=dev)
    last0 = torch.full((H * W,), -1, dtype=torch.int64, device=dev)
    for dx in range(splat):
        for dy in range(splat):
            x = torch.clamp(px + dx, 0, W - 1)
            y = torch.clamp(py + dy, 0, H - 1)
            lin = y * W + x
            valid = (z > 1e-3) & (px + dx >= 0) & (px + dx < W) & \
                (py + dy >= 0) & (py + dy < H)
            zv = torch.where(valid, z, inf)
            zbuf = zbuf.scatter_reduce(0, lin, zv, reduce="amin")
            won = (zbuf[lin] == zv) & valid
            last = last0.scatter_reduce(0, lin, order, reduce="amax")
            keep = last[lin] == order
            img[lin[keep]] = torch.where(won[:, None], colors,
                                         img[lin])[keep]
    mask = torch.isfinite(zbuf).to(torch.float32)
    return img.reshape(H, W, 3), mask.reshape(H, W)


def upsample_faces(verts: torch.Tensor, colors: torch.Tensor, faces,
                   samples_per_face: int = 8
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The vertices plus samples_per_face barycentric interior samples of
    every triangle (positions and colors), on a fixed golden-ratio
    pattern: dense point splatting closes up the mesh."""
    k = np.arange(1, samples_per_face + 1)
    u = (k * 0.618033988749895) % 1.0
    v = (k * 0.754877666246693) % 1.0
    flip = u + v > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    bary = _f32(np.stack([1 - u - v, u, v], 1), verts.device)   # (S, 3)
    f = _faces_tensor(faces, verts.device)
    pts = torch.einsum('sk,fkd->fsd', bary, verts[f]).reshape(-1, 3)
    cols = torch.einsum('sk,fkd->fsd', bary, colors[f]).reshape(-1, 3)
    return torch.cat([verts, pts]), torch.cat([colors, cols])


def _shade_raster(z, fidx, bary, colors, faces) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Per-pixel Gouraud colors of N rasterized panels: bary-weighted
    vertex colors (N, V, 3) of each pixel's face; (imgs, masks)."""
    N = colors.shape[0]
    tri_c = colors[:, faces]                              # (N, F, 3, 3)
    fid = torch.clamp(fidx, min=0).long()
    panel = torch.arange(N, device=colors.device)[:, None, None]
    pix_c = torch.einsum('nhwk,nhwkc->nhwc', bary, tri_c[panel, fid])
    mask = (fidx >= 0).to(torch.float32)
    return pix_c * mask[..., None], mask


def raster_render(verts_cam: torch.Tensor, colors: torch.Tensor, faces,
                  focal_length: float, center: Tuple[float, float],
                  img_hw: Tuple[int, int], span=2
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filled triangles with per-pixel barycentric (Gouraud) shading and
    correct occlusion: (H, W, 3) image and (H, W) mask, through the tile
    rasterizer (K5s on a CUDA tensor). ``span`` bounds the tiles a face is
    binned into per axis (face_window_params sizes it for large faces)."""
    f = _faces_tensor(faces, verts_cam.device)
    z, fidx, bary = rasterize_triangles_batched(
        verts_cam[None], f, [float(focal_length)],
        [(float(center[0]), float(center[1]))], img_hw, span=span)
    img, mask = _shade_raster(z, fidx, bary, colors[None], f)
    return img[0], mask[0]


def face_window_params(verts_cam: np.ndarray, faces: np.ndarray,
                       focal_length: float, center: Tuple[float, float],
                       img_hw: Tuple[int, int], near: float = 1e-3
                       ) -> Tuple[int, Tuple[int, int]]:
    """(patch, (span_y, span_x)) sized so the largest face's screen box
    fits: span counts (32, 128) tiles per axis, up to the image's own tile
    grid, so no face clips. patch is the window of the JAX package's scan
    rasterizer, returned for the same contract (host-side numpy)."""
    H, W = img_hw
    v = np.asarray(verts_cam, np.float32)
    z = np.where(np.abs(v[:, 2]) > near, v[:, 2], near)
    u = focal_length * v[:, 0] / z + center[0]
    w = focal_length * v[:, 1] / z + center[1]
    pix = np.stack([np.clip(u, -W, 2 * W), np.clip(w, -H, 2 * H)], -1)
    tri = pix[np.asarray(faces)]
    ok = (v[:, 2][np.asarray(faces)] > near).all(1)
    if not ok.any():
        return 32, (2, 2)
    ext_xy = tri[ok].max(1) - tri[ok].min(1)
    ext = float(ext_xy.max())
    patch = int(np.clip(1 << int(np.ceil(np.log2(max(ext, 1) + 2))),
                        32, max(32, min(H, W))))
    span_y = int(np.clip(np.ceil(float(ext_xy[:, 1].max()) / 32) + 1, 2,
                         -(-H // 32)))
    span_x = int(np.clip(np.ceil(float(ext_xy[:, 0].max()) / 128) + 1, 2,
                         -(-W // 128)))
    return patch, (span_y, span_x)


def combine_meshes(verts_list, faces_list):
    """Concatenate meshes for one correctly occluding render: (verts
    (sum V_i, 3) tensor, faces (sum F_i, 3) numpy)."""
    verts_list = list(verts_list)
    faces_list = [np.asarray(f) for f in faces_list]
    off = np.cumsum([0] + [v.shape[0] for v in verts_list])[:-1]
    faces = np.concatenate([f + o for f, o in zip(faces_list, off)], 0)
    return torch.cat(verts_list, dim=0), faces


def shade_vertices(verts_cam: torch.Tensor, faces, base_color,
                   shading: str = "pbr", light_dir=LIGHT_DIR,
                   ambient: float = 0.5, metallic: float = 0.2,
                   roughness: float = 1.0, n_lights: int = 3,
                   intensity: float = 1.0) -> torch.Tensor:
    """Per-vertex colors of (..., V, 3) camera-space vertices under the
    reference's pyrender light rig (nemo_tpu's shade_vertices has the
    derivation): 'pbr' is the glTF metallic-roughness BRDF under three
    headlights along -z plus an ambient term; 'diffuse' a single
    Lambertian light along light_dir with a floor of 0.2. base_color: (3,)
    or per-vertex (..., V, 3) in [0, 1]."""
    dev = verts_cam.device
    n = vertex_normals(verts_cam, faces)
    base = _f32(base_color, dev)
    if shading == "diffuse":
        l = _f32(light_dir, dev)
        l = l / l.norm()
        return torch.clamp(-(n @ l), 0.2, 1.0)[..., None] * base
    l = torch.tensor([0.0, 0.0, -1.0], device=dev)        # to the light
    v = -verts_cam / verts_cam.norm(dim=-1, keepdim=True)  # to the camera
    h = l + v
    h = h / torch.clamp(h.norm(dim=-1, keepdim=True), min=1e-9)
    ndl = torch.clamp(n @ l, min=0.0)
    ndv = torch.clamp((n * v).sum(-1), min=1e-4)
    ndh = torch.clamp((n * h).sum(-1), min=0.0)
    vdh = torch.clamp((v * h).sum(-1), min=0.0)
    alpha2 = (roughness * roughness) ** 2
    d = alpha2 / (math.pi * (ndh * ndh * (alpha2 - 1.0) + 1.0) ** 2)
    vis = 0.5 / torch.clamp(
        ndl * torch.sqrt(ndv * ndv * (1 - alpha2) + alpha2)
        + ndv * torch.sqrt(ndl * ndl * (1 - alpha2) + alpha2), min=1e-6)
    f0 = 0.04 * (1.0 - metallic) + base * metallic
    fres = f0 + (1.0 - f0) * (1.0 - vdh[..., None]) ** 5
    c_diff = base * (1.0 - metallic)
    diffuse = (1.0 - fres) * c_diff / math.pi
    spec = fres * (d * vis)[..., None]
    radiance = n_lights * intensity * (diffuse + spec) * ndl[..., None]
    return torch.clamp(ambient * base + radiance, 0.0, 1.0)


def _resolve_method(method: str, device: torch.device) -> str:
    if method == "auto":
        return "raster" if device.type == "cuda" else "splat"
    return method


def _panel_device(verts_world, faces, R, t, focal_length, center, img_hw,
                  method, base_color, light_dir, samples_per_face,
                  shading="pbr"):
    """Device half of render_mesh_overlay for one panel: world -> camera,
    vertex shading, z-buffered render; (img (H, W, 3), mask (H, W))."""
    verts_cam = verts_world @ R.T + t
    colors = shade_vertices(verts_cam, faces, base_color, shading, light_dir)
    if method == "raster" and len(faces):
        return raster_render(verts_cam, colors, faces, focal_length, center,
                             img_hw)
    if samples_per_face > 0 and len(faces):
        verts_cam, colors = upsample_faces(verts_cam, colors, faces,
                                           samples_per_face)
    return splat_render(verts_cam, colors, focal_length, center, img_hw)


def composite_panel(img: np.ndarray, mask: np.ndarray,
                    image: Optional[np.ndarray], img_hw: Tuple[int, int],
                    alpha: float = 0.9) -> np.ndarray:
    """Host half: alpha-composite a rendered (img, mask) over a frame (a
    white one when image is None)."""
    H, W = img_hw
    if image is None:
        image = np.ones((H, W, 3), np.float32)
    out = (img * mask[..., None] * alpha
           + np.asarray(image) * (1 - alpha * mask[..., None]))
    return out.astype(np.float32)


def render_mesh_overlay(verts_world, faces, camera,
                        image: Optional[np.ndarray], img_hw: Tuple[int, int],
                        base_color=BASE_COLOR, light_dir=LIGHT_DIR,
                        alpha: float = 0.9,
                        samples_per_face: int = 8, method: str = "auto",
                        shading: str = "pbr", device="cuda") -> np.ndarray:
    """Render one mesh over a frame (Renderer.__call__ semantics):
    verts_world (V, 3); camera a Camera of numpy fields with batch dims
    stripped; image (H, W, 3) float in [0, 1] or None for white. method:
    "raster" (the tile rasterizer), "splat" or "auto". Returns the (H, W, 3)
    composite as numpy."""
    dev = resolve_device(device)
    img_hw = (int(img_hw[0]), int(img_hw[1]))
    img, mask = _panel_device(
        _f32(verts_world, dev), faces, _f32(camera.rotation, dev),
        _f32(camera.translation, dev), float(camera.focal_length),
        (float(camera.center[0]), float(camera.center[1])), img_hw,
        _resolve_method(method, dev), base_color, light_dir,
        samples_per_face, shading)
    return composite_panel(img.cpu().numpy(), mask.cpu().numpy(), image,
                           img_hw, alpha)


def make_mesh_panel_fn(faces, cameras, img_hw: Tuple[int, int],
                       base_color=BASE_COLOR, light_dir=LIGHT_DIR,
                       samples_per_face: int = 8, method: str = "auto",
                       shading: str = "pbr", device="cuda"):
    """All views' panels of a frame in one call: returns fn(verts_stack
    (N, V, 3), R_stack (N, 3, 3), t_stack (N, 3)) -> (imgs (N, H, W, 3),
    masks (N, H, W)) as tensors on the device, panel i through
    cameras[i]'s intrinsics. With the rasterizer the N panels are one
    batched fold (one kernel launch)."""
    dev = resolve_device(device)
    method = _resolve_method(method, dev)
    img_hw = (int(img_hw[0]), int(img_hw[1]))
    f = _faces_tensor(faces, dev)
    intr = [(float(c.focal_length), (float(c.center[0]), float(c.center[1])))
            for c in cameras]
    focals = [foc for foc, _ in intr]
    centers = [ctr for _, ctr in intr]

    def panels(verts_stack, R_stack, t_stack):
        verts = _f32(verts_stack, dev)
        R, t = _f32(R_stack, dev), _f32(t_stack, dev)
        if method == "raster":
            verts_cam = verts @ R.transpose(-1, -2) + t[:, None]
            colors = shade_vertices(verts_cam, f, base_color, shading,
                                    light_dir)
            z, fidx, bary = rasterize_triangles_batched(
                verts_cam, f, focals[:len(verts)], centers[:len(verts)],
                img_hw)
            return _shade_raster(z, fidx, bary, colors, f)
        out = [_panel_device(verts[i], f, R[i], t[i], foc, ctr, img_hw,
                             method, base_color, light_dir,
                             samples_per_face, shading)
               for i, (foc, ctr) in enumerate(intr[:len(verts)])]
        return (torch.stack([o[0] for o in out]),
                torch.stack([o[1] for o in out]))

    return panels


def rasterize_triangles(verts_cam: torch.Tensor, faces,
                        focal_length: float, center: Tuple[float, float],
                        img_hw: Tuple[int, int], patch: int = 32):
    """One panel's (zbuf (H, W), fidx (H, W), bary (H, W, 3)) through the
    tile rasterizer (K5s on a CUDA tensor, its plain version on the CPU).
    The JAX package's function of this name is its scan rasterizer, which
    clips a face to a patch x patch window; here a face is binned into the
    (32, 128) tiles such a window can touch, so faces up to patch pixels
    draw whole and larger ones clip."""
    from ..ops.raster import rasterize_triangles as _raster
    span = (-(-patch // 32) + 1, -(-patch // 128) + 1)
    return _raster(_f32(verts_cam, verts_cam.device), faces, focal_length,
                   center, img_hw, span=span)


# ---------------------------------------------------------------------------
# the pretty renderer: a checkerboard ground plane and blue-spectrum people
# (reference pretty_renderer.py:11-137)
# ---------------------------------------------------------------------------

def blue_spectrum(n: int) -> np.ndarray:
    """(n, 3) colours in [0, 1]: red and green fixed at 60, blue ramping
    from 90 towards 255."""
    R = np.full(n, 60.0)
    G = np.full(n, 60.0)
    interval = (255.0 - 90.0) / max(n, 1)
    B = 90.0 + interval * np.arange(n)
    return np.stack([R, G, B], axis=1) / 255.0


def checkerboard_plane(plane_width: float = 4.0, num_boxes: int = 9,
                       y: float = 0.0, subdiv: int = 4):
    """A flat checkerboard in the x-z plane at height y: num_boxes^2
    squares alternating dark (35) and light (220), each cut into subdiv x
    subdiv quads so that no face grows too large for the rasterizer's
    windows. Returns (verts (N, 3) tensor, faces (F, 3) int64 numpy,
    colors (N, 3) tensor in [0, 1])."""
    pw = plane_width / num_boxes
    white = np.array([220, 220, 220], np.float32) / 255.0
    black = np.array([35, 35, 35], np.float32) / 255.0
    sw = pw / subdiv
    verts, faces, colors = [], [], []
    for i in range(num_boxes):
        for j in range(num_boxes):
            c = black if (i + j) % 2 == 0 else white
            for si in range(subdiv):
                for sj in range(subdiv):
                    x0 = i * pw + si * sw - plane_width / 2
                    z0 = j * pw + sj * sw - plane_width / 2
                    base = len(verts)
                    verts += [[x0, y, z0], [x0 + sw, y, z0],
                              [x0 + sw, y, z0 + sw], [x0, y, z0 + sw]]
                    faces += [[base, base + 1, base + 2],
                              [base, base + 2, base + 3]]
                    colors += [c] * 4
    return (torch.tensor(np.array(verts, np.float32)),
            np.array(faces, np.int64),
            torch.tensor(np.stack(colors)))


def render_pretty(verts_list, faces, camera, img_hw: Tuple[int, int],
                  image: Optional[np.ndarray] = None,
                  add_ground: bool = True, ground_width: float = 8.0,
                  light_dir=LIGHT_DIR, alpha: float = 1.0,
                  person_colors: Optional[np.ndarray] = None,
                  shading: str = "pbr", device="cuda") -> np.ndarray:
    """Several people over a checkerboard ground plane in one z-buffer:
    the people and the plane are concatenated into one mesh and drawn by
    one raster_render call (one K5s launch on a CUDA device).

    verts_list: (V, 3) camera-frame vertex sets; person_colors: optional
    (n_people, 3) base colours instead of the blue spectrum. shading "pbr"
    is shade_vertices' light rig (the plane, grazed by the headlights, is
    lit by the ambient term alone); "diffuse" one Lambertian light along
    light_dir with a floor of 0.25. The plane lies at the people's lowest
    point (largest camera y) and their mean depth; the rasterizer's
    per-face window is sized for its large faces. Returns the (H, W, 3)
    float32 composite over image (white when None)."""
    dev = resolve_device(device)
    H, W = int(img_hw[0]), int(img_hw[1])
    n = len(verts_list)
    spectrum = (blue_spectrum(n) if person_colors is None
                else np.broadcast_to(np.asarray(person_colors, np.float32),
                                     (n, 3)))
    faces = np.asarray(faces)
    all_v, all_c, all_f = [], [], []
    off = 0
    for i, v in enumerate(verts_list):
        v = _f32(v, dev)
        if shading == "diffuse":
            l = _f32(light_dir, dev)
            l = l / l.norm()
            c = torch.clamp(-(vertex_normals(v, faces) @ l), 0.25,
                            1.0)[:, None] * _f32(spectrum[i], dev)
        else:
            c = shade_vertices(v, faces, spectrum[i], "pbr")
        all_v.append(v)
        all_c.append(c)
        all_f.append(faces + off)
        off += v.shape[0]
    if add_ground and all_v:
        people = torch.cat(all_v)
        floor_y = float(people[:, 1].max())          # +y points down
        gv, gf, gc = checkerboard_plane(ground_width, y=floor_y)
        gv = gv.to(dev) + torch.tensor([0.0, 0.0, float(people[:, 2].mean())],
                                       device=dev)
        gc = gc.to(dev)
        all_v.append(gv)
        all_c.append(gc if shading == "diffuse"
                     else shade_vertices(gv, gf, gc, "pbr"))
        all_f.append(gf + off)
    verts = torch.cat(all_v)
    colors = torch.cat(all_c)
    faces_all = np.concatenate(all_f)
    focal = float(camera.focal_length)
    center = (float(camera.center[0]), float(camera.center[1]))
    _, span = face_window_params(verts.cpu().numpy(), faces_all, focal,
                                 center, (H, W))
    img, mask = raster_render(verts, colors, faces_all, focal, center,
                              (H, W), span=span)
    if image is None:
        image = np.ones((H, W, 3), np.float32)
    m = mask.cpu().numpy()[..., None]
    return (img.cpu().numpy() * m * alpha
            + np.asarray(image) * (1 - alpha * m)).astype(np.float32)
