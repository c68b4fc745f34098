"""Tile rasterizer: kernels K5s (stream mode) and K5g (gather mode).

Replaces nemo_tpu/ops/raster_pallas.py: ``_rasterize_stream_jit``
(``_raster_stream_kernel``) and ``_rasterize_pallas_jit``
(``_raster_kernel``), behind ``rasterize_triangles`` with the contract of
``rasterize_triangles_pallas``: (zbuf (H, W) f32, inf where empty; fidx
(H, W) int32, -1 where empty; bary (H, W, 3) perspective-correct weights of
the winning face). ``rasterize_triangles_batched`` takes N panels at once
(the views of a frame, each with its own intrinsics), one launch for all.

Two phases, as in the JAX package:

1. Prep, in PyTorch on the tensors' device, with no host synchronisation:
   the projection, each face's screen bounding box scattered into up to
   span_y x span_x tiles of (th, tw) pixels (faces behind the near plane go
   to the sentinel tile T), a *stable* sort of the entries by (panel, tile)
   (the entry order inside a tile decides depth ties, and ``jnp.argsort``
   is stable) and ``searchsorted`` for each tile's start and count.
2. The fold, per tile, over the tile's entries in sorted order
   (``csrc/raster_common.cuh`` has the math). Stream mode (the default)
   reads each tile's slice of the flat sorted entry array, with no
   capacity cap. Gather mode reads the (T, K) per-tile face table that
   ``bin_faces`` builds, K = min(faces_per_tile, max(8, ceil8(entries))),
   and drops the entries past K exactly as JAX's gather mode does
   (``gather_mode_overflow`` counts them). Both give the same output when
   nothing overflows.

On a CUDA tensor the fold launches ``csrc/raster.cu`` (one block per tile
and panel); on a CPU tensor it runs the plain version below, which loops
over the entry index and is vectorised over tiles and pixels. The kernels
and the plain version evaluate every operation in the same order with
correct rounding, so on the card they agree bit for bit. The face id is an
int32 array beside the f32 attributes (the TPU kernel carried it as an f32
column so one gather built its whole input). Render only: there is no VJP.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build

LAUNCHES = {"raster_stream": 0, "raster_gather": 0}
GROUP = 8   # gather mode's floor on K, as in the JAX package

Raster = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _span_yx(span) -> Tuple[int, int]:
    """A span as (row tiles, column tiles): an int or a (rows, cols) pair."""
    if isinstance(span, (tuple, list)):
        return int(span[0]), int(span[1])
    return int(span), int(span)


class Entries(NamedTuple):
    """The binned entries of N panels (prep's output)."""
    attr_face: torch.Tensor  # (N*F, 9) f32: x0 y0 x1 y1 x2 y2 1/z0 1/z1 1/z2
    face: torch.Tensor       # (N*E,) int64: row of attr_face, in sorted order
    starts: torch.Tensor     # (N*T,) int64: first sorted entry of each tile
    counts: torch.Tensor     # (N*T,) int64: entries of each tile
    N: int
    F: int
    E: int                   # entries a panel: span_y * span_x * F
    nty: int
    ntx: int


def _as_panel_floats(x, shape, device) -> torch.Tensor:
    """Per-panel intrinsics as an f32 tensor on ``device``, filled in on the
    device (no host-to-device copy)."""
    vals = np.asarray(x, np.float64).reshape(-1)
    return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                   device=device)
                        for v in vals]).reshape(shape)


def project_faces(verts_cam: torch.Tensor, faces: torch.Tensor,
                  focal_length: torch.Tensor, center: torch.Tensor,
                  near: float) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(tri (N, F, 3, 2) pixels, tz (N, F, 3) camera z, ok (N, F) all three
    vertices in front of the near plane) for verts_cam (N, V, 3),
    focal_length (N,) and center (N, 2)."""
    z = verts_cam[..., 2]
    safe_z = torch.where(z.abs() > near, z, torch.full_like(z, near))
    f = focal_length[:, None]
    u = f * verts_cam[..., 0] / safe_z + center[:, 0:1]
    v = f * verts_cam[..., 1] / safe_z + center[:, 1:2]
    pix = torch.stack([u, v], dim=-1)
    tri = pix[:, faces]
    tz = z[:, faces]
    return tri, tz, (tz > near).all(dim=-1)


def bin_entries(tri: torch.Tensor, tz: torch.Tensor, ok: torch.Tensor,
                img_hw: Tuple[int, int], th: int, tw: int, span) -> Entries:
    """Phase 1: each face's bounding box scattered into tile bins, sorted
    stably by (panel, tile), with each tile's start and count. Duplicate
    entries of a face (a box narrower than the span) stay, as in JAX: the
    fold is idempotent per face."""
    H, W = img_hw
    N, F = ok.shape
    nty, ntx = -(-H // th), -(-W // tw)
    T = nty * ntx
    dev = tri.device
    fx0 = torch.clamp(torch.floor(tri[..., 0].amin(-1) / tw), 0, ntx - 1)
    fx1 = torch.clamp(torch.floor(tri[..., 0].amax(-1) / tw), 0, ntx - 1)
    fy0 = torch.clamp(torch.floor(tri[..., 1].amin(-1) / th), 0, nty - 1)
    fy1 = torch.clamp(torch.floor(tri[..., 1].amax(-1) / th), 0, nty - 1)
    sy, sx = _span_yx(span)
    sentinel = torch.full((N, F), T, dtype=torch.int64, device=dev)
    tile_ids = []
    for dy in range(sy):
        for dx in range(sx):
            ty = torch.minimum(fy0 + dy, fy1)
            tx = torch.minimum(fx0 + dx, fx1)
            tile_ids.append(torch.where(ok, (ty * ntx + tx).to(torch.int64),
                                        sentinel))
    E = sy * sx * F
    panel = torch.arange(N, device=dev)
    key = (torch.cat(tile_ids, dim=1) + (T + 1) * panel[:, None]).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    bounds = ((T + 1) * panel[:, None]
              + torch.arange(T, device=dev)[None]).reshape(-1)
    starts = torch.searchsorted(sorted_key, bounds)
    ends = torch.searchsorted(sorted_key, bounds, right=True)
    face = (order // E) * F + order % F
    attr_face = torch.cat([tri.reshape(N, F, 6), 1.0 / tz], dim=-1)
    return Entries(attr_face.reshape(N * F, 9), face, starts, ends - starts,
                   N, F, E, nty, ntx)


def bin_faces(ent: Entries, faces_per_tile: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather mode's (N*T, K) per-tile face table (a valid prefix per row,
    entries past it arbitrary) and the counts capped at K. A tile never
    holds more entries than the whole scatter made, so K = min(
    faces_per_tile, max(8, ceil8(E)))."""
    K = min(faces_per_tile, max(GROUP, -(-ent.E // GROUP) * GROUP))
    gidx = torch.clamp(ent.starts[:, None]
                       + torch.arange(K, device=ent.face.device)[None],
                       max=ent.face.numel() - 1)
    tbl = (ent.face % ent.F)[gidx].to(torch.int32)
    return tbl, torch.clamp(ent.counts, max=K)


def gather_mode_overflow(verts_cam, faces, focal_length: float,
                         center: Tuple[float, float],
                         img_hw: Tuple[int, int], th: int = 32,
                         tw: int = 128, faces_per_tile: int = 4096,
                         span=2, near: float = 1e-3) -> int:
    """Entries gather mode would drop for one panel: the sum over tiles of
    max(0, bounding-box entries - faces_per_tile). Numpy on the host (the
    JAX package's own check, line for line); stream mode never drops."""
    H, W = img_hw
    faces = np.asarray(faces)
    v = np.asarray(verts_cam, np.float32)
    z = v[:, 2]
    safe_z = np.where(np.abs(z) > near, z, near)
    u = focal_length * v[:, 0] / safe_z + center[0]
    w = focal_length * v[:, 1] / safe_z + center[1]
    tri = np.stack([u, w], -1)[faces]
    ok = (z[faces] > near).all(1)
    nty, ntx = -(-H // th), -(-W // tw)
    sy, sx = _span_yx(span)
    fx0 = np.clip(np.floor(tri[:, :, 0].min(1) / tw), 0, ntx - 1)
    fx1 = np.clip(np.floor(tri[:, :, 0].max(1) / tw), 0, ntx - 1)
    fy0 = np.clip(np.floor(tri[:, :, 1].min(1) / th), 0, nty - 1)
    fy1 = np.clip(np.floor(tri[:, :, 1].max(1) / th), 0, nty - 1)
    counts = np.zeros(nty * ntx, np.int64)
    for dy in range(sy):
        for dx in range(sx):
            ty = np.minimum(fy0 + dy, fy1)
            tx = np.minimum(fx0 + dx, fx1)
            tid = (ty * ntx + tx).astype(np.int64)[ok]
            np.add.at(counts, tid, 1)
    return int(np.maximum(counts - faces_per_tile, 0).sum())


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def _fold_plain(ent: Entries, counts: torch.Tensor, entry, img_hw,
                th: int, tw: int) -> Raster:
    """The sequential fold of every tile, vectorised over tiles and pixels:
    step k folds entry k of each tile that holds more than k entries.
    entry(tiles, k) -> (attrs (n, 9), face ids (n,)). Busy tiles are sorted
    by count, so the tiles still folding at step k are a prefix."""
    H, W = img_hw
    N, nty, ntx = ent.N, ent.nty, ent.ntx
    T = nty * ntx
    dev = counts.device
    cnt = counts.cpu()
    busy = torch.nonzero(cnt > 0).reshape(-1)
    busy = busy[torch.argsort(cnt[busy], descending=True, stable=True)]
    n_busy = busy.numel()
    n_live = [int((cnt[busy] > k).sum()) for k in
              range(int(cnt.max()) if n_busy else 0)]
    tiles = busy.to(dev)
    t = tiles % T
    X = ((t % ntx) * tw).float()[:, None, None] + torch.arange(
        tw, device=dev, dtype=torch.float32)[None, None, :]
    Y = ((t // ntx) * th).float()[:, None, None] + torch.arange(
        th, device=dev, dtype=torch.float32)[None, :, None]
    izb = torch.zeros((n_busy, th, tw), device=dev)
    fi = torch.full((n_busy, th, tw), -1, dtype=torch.int32, device=dev)
    q = torch.zeros((3, n_busy, th, tw), device=dev)
    for k, n in enumerate(n_live):
        a, fid = entry(tiles[:n], k)
        x0, y0, x1, y1, x2, y2, iz0, iz1, iz2 = (a[:, c, None, None]
                                                 for c in range(9))
        Xk, Yk = X[:n], Y[:n]
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        w0 = (x2 - x1) * (Yk - y1) - (y2 - y1) * (Xk - x1)
        w1 = (x0 - x2) * (Yk - y2) - (y0 - y2) * (Xk - x2)
        w2 = (x1 - x0) * (Yk - y0) - (y1 - y0) * (Xk - x0)
        s = torch.sign(area)
        cover = ((w0 * s >= 0) & (w1 * s >= 0) & (w2 * s >= 0)
                 & (area.abs() > 1e-8))
        inv_area = s / torch.clamp(area.abs(), min=1e-8)
        q0, q1, q2 = (w0 * inv_area) * iz0, (w1 * inv_area) * iz1, \
            (w2 * inv_area) * iz2
        iz = torch.where(cover, q0 + q1 + q2, torch.zeros_like(q0))
        win = iz > izb[:n]
        izb[:n] = torch.where(win, iz, izb[:n])
        fi[:n] = torch.where(win, fid.to(torch.int32)[:, None, None], fi[:n])
        q[:, :n] = torch.where(win, torch.stack([q0, q1, q2]), q[:, :n])
    hit = izb > 0
    zw = 1.0 / torch.clamp(izb, min=1e-37)
    z_t = torch.full((N * T, th, tw), float("inf"), device=dev)
    f_t = torch.full((N * T, th, tw), -1, dtype=torch.int32, device=dev)
    b_t = torch.zeros((N * T, th, tw, 3), device=dev)
    z_t[tiles] = torch.where(hit, zw, torch.full_like(zw, float("inf")))
    f_t[tiles] = fi
    b_t[tiles] = (q * torch.where(hit, zw, torch.zeros_like(zw))).permute(
        1, 2, 3, 0)

    def untile(a):
        a = a.reshape((N, nty, ntx, th, tw) + a.shape[3:]).transpose(2, 3)
        return a.reshape((N, nty * th, ntx * tw) + a.shape[5:])[:, :H, :W]

    return untile(z_t), untile(f_t), untile(b_t)


def rasterize_plain(ent: Entries, img_hw, th: int = 32, tw: int = 128,
                    faces_per_tile: int = 4096, stream: bool = True
                    ) -> Raster:
    """The plain version of K5s (stream) and K5g (gather) on binned
    entries: (z (N, H, W), fid (N, H, W) int32, bary (N, H, W, 3))."""
    if stream:
        def entry(tiles, k):
            e = ent.face[ent.starts[tiles] + k]
            return ent.attr_face[e], e % ent.F
        return _fold_plain(ent, ent.counts, entry, img_hw, th, tw)
    tbl, counts = bin_faces(ent, faces_per_tile)
    T = ent.nty * ent.ntx

    def entry(tiles, k):
        face = tbl[tiles, k].long()
        return ent.attr_face[(tiles // T) * ent.F + face], face
    return _fold_plain(ent, counts, entry, img_hw, th, tw)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/raster.cu)
# ---------------------------------------------------------------------------

def _outputs(ent: Entries, img_hw):
    H, W = img_hw
    dev = ent.attr_face.device
    return (torch.empty((ent.N, H, W), dtype=torch.float32, device=dev),
            torch.empty((ent.N, H, W), dtype=torch.int32, device=dev),
            torch.empty((ent.N, H, W, 3), dtype=torch.float32, device=dev))


def _check_tile(th: int, tw: int) -> None:
    if th <= 0 or tw <= 0 or th * tw > 4096:
        raise ValueError(f"tiles of ({th}, {tw}) pixels: the kernels take "
                         "at most 4096 pixels a tile")


class StreamInputs(NamedTuple):
    """K5s's operands: the flat sorted entry arrays and the tile segments."""
    attr: torch.Tensor    # (N*E, 9) f32, in sorted order
    fid: torch.Tensor     # (N*E,) int32 face id within the panel
    starts: torch.Tensor  # (N*T,) int32
    counts: torch.Tensor  # (N*T,) int32


class GatherInputs(NamedTuple):
    """K5g's operands: the per-face attributes and the (T, K) face table."""
    attr_face: torch.Tensor  # (N*F, 9) f32
    tbl: torch.Tensor        # (N*T, K) int32
    counts: torch.Tensor     # (N*T,) int32, at most K


def stream_inputs(ent: Entries) -> StreamInputs:
    return StreamInputs(ent.attr_face[ent.face].contiguous(),
                        (ent.face % ent.F).to(torch.int32),
                        ent.starts.to(torch.int32), ent.counts.to(torch.int32))


def gather_inputs(ent: Entries, faces_per_tile: int = 4096) -> GatherInputs:
    tbl, counts = bin_faces(ent, faces_per_tile)
    return GatherInputs(ent.attr_face.contiguous(), tbl,
                        counts.to(torch.int32))


def raster_stream_cuda(ent: Entries, inp: StreamInputs, img_hw,
                       th: int = 32, tw: int = 128) -> Raster:
    """Launch K5s (CUDA tensors only) on prepared entries."""
    _check_tile(th, tw)
    dev = inp.attr.device
    _build.check_input("attr", inp.attr, (None, 9), dev)
    z, fid, bary = _outputs(ent, img_hw)
    lib = _build.library()
    err = lib.nemo_raster_stream(
        ent.N, ent.nty * ent.ntx, int(img_hw[0]), int(img_hw[1]), th, tw,
        ent.ntx, inp.attr.data_ptr(), inp.fid.data_ptr(),
        inp.starts.data_ptr(), inp.counts.data_ptr(), z.data_ptr(),
        fid.data_ptr(), bary.data_ptr(), _build.stream_handle(dev))
    _build.check(err, "nemo_raster_stream")
    LAUNCHES["raster_stream"] += 1
    return z, fid, bary


def raster_gather_cuda(ent: Entries, inp: GatherInputs, img_hw,
                       th: int = 32, tw: int = 128) -> Raster:
    """Launch K5g (CUDA tensors only) on prepared entries."""
    _check_tile(th, tw)
    dev = inp.attr_face.device
    _build.check_input("attr_face", inp.attr_face, (ent.N * ent.F, 9), dev)
    z, fid, bary = _outputs(ent, img_hw)
    lib = _build.library()
    err = lib.nemo_raster_gather(
        ent.N, ent.nty * ent.ntx, int(img_hw[0]), int(img_hw[1]), th, tw,
        ent.ntx, ent.F, inp.tbl.shape[1], inp.attr_face.data_ptr(),
        inp.tbl.data_ptr(), inp.counts.data_ptr(), z.data_ptr(),
        fid.data_ptr(), bary.data_ptr(), _build.stream_handle(dev))
    _build.check(err, "nemo_raster_gather")
    LAUNCHES["raster_gather"] += 1
    return z, fid, bary


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

def prepare(verts_cam: torch.Tensor, faces, focal_length: Sequence[float],
            center: Sequence[Tuple[float, float]], img_hw: Tuple[int, int],
            th: int = 32, tw: int = 128, span=2,
            near: float = 1e-3) -> Entries:
    """Prep for N panels: verts_cam (N, V, 3) f32, faces (F, 3), one focal
    length (N,) and one principal point (N, 2) per panel."""
    if verts_cam.dtype != torch.float32 or verts_cam.dim() != 3 or \
            verts_cam.shape[-1] != 3:
        raise ValueError(f"verts_cam: expected (N, V, 3) float32, got "
                         f"{tuple(verts_cam.shape)} {verts_cam.dtype}")
    dev = verts_cam.device
    faces = torch.as_tensor(np.asarray(faces) if not isinstance(
        faces, torch.Tensor) else faces, device=dev).long()
    if faces.dim() != 2 or faces.shape[1] != 3 or faces.shape[0] == 0:
        raise ValueError(f"faces: expected (F, 3) with F > 0, got "
                         f"{tuple(faces.shape)}")
    N = verts_cam.shape[0]
    tri, tz, ok = project_faces(verts_cam, faces,
                                _as_panel_floats(focal_length, (N,), dev),
                                _as_panel_floats(center, (N, 2), dev), near)
    return bin_entries(tri, tz, ok, (int(img_hw[0]), int(img_hw[1])), th,
                       tw, span)


def rasterize_triangles_batched(verts_cam: torch.Tensor, faces,
                                focal_length: Sequence[float],
                                center: Sequence[Tuple[float, float]],
                                img_hw: Tuple[int, int], th: int = 32,
                                tw: int = 128, faces_per_tile: int = 4096,
                                span=2, near: float = 1e-3,
                                stream: bool = True) -> Raster:
    """N panels in one fold: (z (N, H, W), fid (N, H, W), bary (N, H, W,
    3)). A CUDA tensor launches K5s (stream) or K5g (gather) once; a CPU
    tensor takes the plain version."""
    img_hw = (int(img_hw[0]), int(img_hw[1]))
    ent = prepare(verts_cam, faces, focal_length, center, img_hw, th, tw,
                  span, near)
    if _build.route(verts_cam) == "cpu":
        return rasterize_plain(ent, img_hw, th, tw, faces_per_tile, stream)
    if stream:
        return raster_stream_cuda(ent, stream_inputs(ent), img_hw, th, tw)
    return raster_gather_cuda(ent, gather_inputs(ent, faces_per_tile),
                              img_hw, th, tw)


def rasterize_triangles(verts_cam: torch.Tensor, faces, focal_length: float,
                        center: Tuple[float, float], img_hw: Tuple[int, int],
                        th: int = 32, tw: int = 128,
                        faces_per_tile: int = 4096, span=2,
                        near: float = 1e-3, stream: bool = True) -> Raster:
    """One panel, the contract of nemo_tpu's ``rasterize_triangles_pallas``:
    verts_cam (V, 3) camera-space vertices, faces (F, 3). Returns (zbuf
    (H, W) inf-empty, fidx (H, W) int32 -1-empty, bary (H, W, 3)).

    Faces whose bounding box spans more than ``span`` tiles on an axis only
    rasterize into its corner and edge tiles (``span`` is an int or a (rows,
    cols) pair). ``stream=False`` selects gather mode, whose tiles drop the
    entries past ``faces_per_tile``."""
    z, fid, bary = rasterize_triangles_batched(
        verts_cam[None], faces, [float(focal_length)],
        [(float(center[0]), float(center[1]))], img_hw, th, tw,
        faces_per_tile, span, near, stream)
    return z[0], fid[0], bary[0]
