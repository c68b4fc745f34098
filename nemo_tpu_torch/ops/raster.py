"""Tile rasterizer: kernels K5s (stream mode) and K5g (gather mode).

Replaces nemo_tpu/ops/raster_pallas.py: ``_rasterize_stream_jit``
(``_raster_stream_kernel``) and ``_rasterize_pallas_jit``
(``_raster_kernel``), behind ``rasterize_triangles`` with the contract of
``rasterize_triangles_pallas``: (zbuf (H, W) f32, inf where empty; fidx
(H, W) int32, -1 where empty; bary (H, W, 3) perspective-correct weights of
the winning face). ``rasterize_triangles_batched`` takes N panels at once
(the views of a frame, each with its own intrinsics), one call for all.

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
   ``_table_rows`` builds, K = min(faces_per_tile, max(8, ceil8(entries))),
   and drops the entries past K exactly as JAX's gather mode does
   (``gather_mode_overflow`` counts them). Both give the same output when
   nothing overflows.

On a CUDA tensor the fold launches ``csrc/raster.cu``: each busy tile's
entries split into work items of ``CHUNK`` (64) entries, folded by a
persistent grid over the whole card, and merged per pixel by an
``atomicMax`` of a 64-bit key (depth, then the first position) that
does not depend on the order the items arrive in, with an exact cull of
the 8 x 32 sub-tiles an entry provably misses; ``raster_split_emulation``
repeats that design on the CPU for the tests. On a CPU tensor the public
op runs the plain version below, which loops over the entry index and is
vectorised over tiles and pixels. The kernels and the plain version
evaluate every operation in the same order with correct rounding, so on
the card they agree bit for bit. The kernels read each entry's face id as
an int32 code beside the f32 attributes (the TPU kernel carried it as an
f32 column so one gather built its whole input), negated (~face) where
``bin_entries`` marked the entry a repeat of an earlier entry of its face
in its tile, which the kernels skip. Render only: there is no VJP.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build
from ..utils.trace import launch

LAUNCHES = {"raster_stream": 0, "raster_gather": 0}
GROUP = 8   # gather mode's floor on K, as in the JAX package
# mirrors of csrc/raster_common.cuh's constants: kChunk, the entries a work
# item; a warp's sub-tile; the cull's margin (relative to the edge
# function's magnitude, absolute) and the magnitude from which it never
# culls
CHUNK = 64
SUB_ROWS, SUB_COLS = 8, 32
CULL_REL, CULL_ABS, CULL_MAX = 2.0 ** -21, 1e-30, 1e30

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
    repeat: torch.Tensor     # (N*E,) bool: the sorted entry repeats an
                             # earlier entry of its face in its tile
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
    fold is idempotent per face. A duplicate is a slot clamped onto the
    tile of an earlier slot (fy0 + dy > fy1 or fx0 + dx > fx1); the stable
    sort keeps the earlier slot first, so it is marked ``repeat``, and the
    kernels skip it (it never wins a pixel)."""
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
    tile_ids, repeats = [], []
    for dy in range(sy):
        for dx in range(sx):
            ty = torch.minimum(fy0 + dy, fy1)
            tx = torch.minimum(fx0 + dx, fx1)
            tile_ids.append(torch.where(ok, (ty * ntx + tx).to(torch.int64),
                                        sentinel))
            repeats.append((fy0 + dy > fy1) | (fx0 + dx > fx1))
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
                   torch.cat(repeats, dim=1).reshape(-1)[order], N, F, E,
                   nty, ntx)


def _table_rows(ent: Entries, faces_per_tile: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather mode's (N*T, K) table of sorted-entry rows (a valid prefix per
    row, entries past it arbitrary) and the counts capped at K. A tile
    never holds more entries than the whole scatter made, so K = min(
    faces_per_tile, max(8, ceil8(E)))."""
    K = min(faces_per_tile, max(GROUP, -(-ent.E // GROUP) * GROUP))
    gidx = torch.clamp(ent.starts[:, None]
                       + torch.arange(K, device=ent.face.device)[None],
                       max=ent.face.numel() - 1)
    return gidx, torch.clamp(ent.counts, max=K)



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

def _face_pixels(a: torch.Tensor, X: torch.Tensor, Y: torch.Tensor):
    """(iz, q0, q1, q2) of the faces a (..., 9, ...) (attributes on dim 1,
    broadcast against X and Y) at pixels (X, Y); iz is 0 where a face does
    not cover its pixel."""
    x0, y0, x1, y1, x2, y2, iz0, iz1, iz2 = a.unbind(1)
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    w0 = (x2 - x1) * (Y - y1) - (y2 - y1) * (X - x1)
    w1 = (x0 - x2) * (Y - y2) - (y0 - y2) * (X - x2)
    w2 = (x1 - x0) * (Y - y0) - (y1 - y0) * (X - x0)
    s = torch.sign(area)
    cover = ((w0 * s >= 0) & (w1 * s >= 0) & (w2 * s >= 0)
             & (area.abs() > 1e-8))
    inv_area = s / torch.clamp(area.abs(), min=1e-8)
    q0, q1, q2 = (w0 * inv_area) * iz0, (w1 * inv_area) * iz1, \
        (w2 * inv_area) * iz2
    return torch.where(cover, q0 + q1 + q2, torch.zeros_like(q0)), q0, q1, q2


def _untile(ent: Entries, a: torch.Tensor, img_hw, th: int, tw: int
            ) -> torch.Tensor:
    """(N*T, th, tw, ...) per-tile images as (N, H, W, ...)."""
    N, nty, ntx = ent.N, ent.nty, ent.ntx
    a = a.reshape((N, nty, ntx, th, tw) + a.shape[3:]).transpose(2, 3)
    return a.reshape((N, nty * th, ntx * tw) + a.shape[5:])[
        :, :img_hw[0], :img_hw[1]]


def _tile_pixels(ent: Entries, tiles: torch.Tensor, th: int, tw: int):
    """Pixel coordinates (X (n, 1, tw), Y (n, th, 1)) of the tiles."""
    t = tiles % (ent.nty * ent.ntx)
    dev = tiles.device
    X = ((t % ent.ntx) * tw).float()[:, None, None] + torch.arange(
        tw, device=dev, dtype=torch.float32)[None, None, :]
    Y = ((t // ent.ntx) * th).float()[:, None, None] + torch.arange(
        th, device=dev, dtype=torch.float32)[None, :, None]
    return X, Y


def _fold_plain(ent: Entries, counts: torch.Tensor, entry, img_hw,
                th: int, tw: int) -> Raster:
    """The sequential fold of every tile, vectorised over tiles and pixels:
    step k folds entry k of each tile that holds more than k entries.
    entry(tiles, k) -> (attrs (n, 9), face ids (n,)). Busy tiles are sorted
    by count, so the tiles still folding at step k are a prefix."""
    N, T = ent.N, ent.nty * ent.ntx
    dev = counts.device
    cnt = counts.cpu()
    busy = torch.nonzero(cnt > 0).reshape(-1)
    busy = busy[torch.argsort(cnt[busy], descending=True, stable=True)]
    n_busy = busy.numel()
    n_live = [int((cnt[busy] > k).sum()) for k in
              range(int(cnt.max()) if n_busy else 0)]
    tiles = busy.to(dev)
    X, Y = _tile_pixels(ent, tiles, th, tw)
    izb = torch.zeros((n_busy, th, tw), device=dev)
    fi = torch.full((n_busy, th, tw), -1, dtype=torch.int32, device=dev)
    q = torch.zeros((3, n_busy, th, tw), device=dev)
    for k, n in enumerate(n_live):
        a, fid, _ = entry(tiles[:n], k)
        iz, q0, q1, q2 = _face_pixels(a[:, :, None, None], X[:n], Y[:n])
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
    return tuple(_untile(ent, a, img_hw, th, tw) for a in (z_t, f_t, b_t))


def _entries(ent: Entries, stream: bool, faces_per_tile: int):
    """(counts (N*T,), entry(tiles, k)) of a mode: entry k (an int, or a
    tensor beside ``tiles``) of each tile as (attrs (n, 9), face ids (n,),
    repeat marks (n,)). Gather mode reads its (N*T, K) table, whose
    counts are capped at K."""
    if stream:
        def entry(tiles, k):
            e = ent.starts[tiles] + k
            return ent.attr_face[ent.face[e]], ent.face[e] % ent.F, \
                ent.repeat[e]
        return ent.counts, entry
    gidx, counts = _table_rows(ent, faces_per_tile)

    def entry(tiles, k):
        e = gidx[tiles, k]
        return ent.attr_face[ent.face[e]], ent.face[e] % ent.F, \
            ent.repeat[e]
    return counts, entry


def rasterize_plain(ent: Entries, img_hw, th: int = 32, tw: int = 128,
                    faces_per_tile: int = 4096, stream: bool = True
                    ) -> Raster:
    """The plain version of K5s (stream) and K5g (gather) on binned
    entries: (z (N, H, W), fid (N, H, W) int32, bary (N, H, W, 3))."""
    counts, entry = _entries(ent, stream, faces_per_tile)
    return _fold_plain(ent, counts, entry, img_hw, th, tw)


# ---------------------------------------------------------------------------
# the kernels' design, emulated (tests and chip_smoke.py's figures)
# ---------------------------------------------------------------------------

class WorkList(NamedTuple):
    """The kernels' work items: chunk c of busy tile b is the entries
    [c * CHUNK, min((c + 1) * CHUNK, count)) of tile busy[b]."""
    busy: torch.Tensor        # (n_busy,) tiles (n*T + t) holding entries
    item_busy: torch.Tensor   # (n_items,) each item's slot in busy
    item_first: torch.Tensor  # (n_items,) each item's first position


def work_list(counts: torch.Tensor) -> WorkList:
    """The list csrc/raster.cu's list kernel builds from the tile counts:
    busy tiles in tile order, ceil(count / CHUNK) items each."""
    counts = counts.long()
    busy = torch.nonzero(counts > 0).reshape(-1)
    per = (counts[busy] + CHUNK - 1) // CHUNK
    item_busy = torch.repeat_interleave(
        torch.arange(busy.numel(), device=counts.device), per)
    first_item = torch.cumsum(per, 0) - per
    item_first = (torch.arange(item_busy.numel(), device=counts.device)
                  - first_item[item_busy]) * CHUNK
    return WorkList(busy, item_busy, item_first)


def _subtile_rects(ent: Entries, tiles: torch.Tensor, th: int, tw: int):
    """(Xa, Xb, Ya, Yb), each (n, n_sub) float64: the pixel rectangle of
    every kSubRows x kSubCols sub-tile of the tiles (the whole sub-tile, as
    the kernel tests it, also where the tile or the image ends inside it),
    and sub (th, tw): each pixel's sub-tile."""
    sub_cols = -(-tw // SUB_COLS)
    n_sub = -(-th // SUB_ROWS) * sub_cols
    t = tiles % (ent.nty * ent.ntx)
    dev = tiles.device
    s = torch.arange(n_sub, device=dev)
    x0 = ((t % ent.ntx) * tw)[:, None] + (s % sub_cols)[None] * SUB_COLS
    y0 = ((t // ent.ntx) * th)[:, None] + (s // sub_cols)[None] * SUB_ROWS
    Xa, Ya = x0.double(), y0.double()
    sub = (torch.arange(th, device=dev)[:, None] // SUB_ROWS * sub_cols
           + torch.arange(tw, device=dev)[None] // SUB_COLS)
    return (Xa, Xa + (SUB_COLS - 1), Ya, Ya + (SUB_ROWS - 1)), sub


def _edge_outside(ex, ey, px, py, s, Xa, Xb, Ya, Yb) -> torch.Tensor:
    """raster_common.cuh's edge_outside: s w < -(margin) at the corner of
    the rectangle where the exact affine s w is largest, in float64."""
    a, c = s * ex, s * ey
    Y = torch.where(a > 0, Yb, Ya)
    X = torch.where(c > 0, Xa, Xb)
    wmax = a * (Y - py) - c * (X - px)
    mag = ex.abs() * torch.maximum((Ya - py).abs(), (Yb - py).abs()) \
        + ey.abs() * torch.maximum((Xa - px).abs(), (Xb - px).abs())
    return (mag < CULL_MAX) & (wmax < -(CULL_REL * mag + CULL_ABS))


def cull_outside(a: torch.Tensor, rects) -> torch.Tensor:
    """(n, n_sub) bool: entry i (attributes a (n, 9) f32) provably covers no
    pixel of sub-tile j of its tile (rects from _subtile_rects), which the
    kernel then skips. Entries with |area| <= 1e-8 count as outside."""
    x0, y0, x1, y1, x2, y2 = (a[:, c] for c in range(6))
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    s = torch.sign(area).double()[:, None]
    Xa, Xb, Ya, Yb = rects
    out = ~(area.abs() > 1e-8)[:, None]
    for ex, ey, px, py in ((x2 - x1, y2 - y1, x1, y1),
                           (x0 - x2, y0 - y2, x2, y2),
                           (x1 - x0, y1 - y0, x0, y0)):
        out = out | _edge_outside(*(v.double()[:, None] for v in
                                    (ex, ey, px, py)), s, Xa, Xb, Ya, Yb)
    return out


def raster_split_emulation(ent: Entries, img_hw, th: int = 32,
                           tw: int = 128, faces_per_tile: int = 4096,
                           stream: bool = True, cull: bool = True
                           ) -> Raster:
    """csrc/raster.cu's design on the CPU (tests only): the same work
    items, each chunk folded with the plain math into its own per-pixel
    (iz, first winning position), repeated entries (``Entries.repeat``)
    and the entries the exact cull rules out (``cull``) skipped per
    sub-tile,
    the chunks merged by the maximum of the 64-bit key (bits(iz) << 32) |
    (0xFFFFFFFF - position), and q0, q1, q2 recomputed from each pixel's
    winning entry. Equal to rasterize_plain bit for bit."""
    counts, entry = _entries(ent, stream, faces_per_tile)
    N, T = ent.N, ent.nty * ent.ntx
    dev = counts.device
    wl = work_list(counts)
    n_busy, n_items = wl.busy.numel(), wl.item_busy.numel()
    item_tile = wl.busy[wl.item_busy]
    m = torch.clamp(counts.long()[item_tile] - wl.item_first, max=CHUNK)
    X, Y = _tile_pixels(ent, item_tile, th, tw)
    rects, sub = _subtile_rects(ent, item_tile, th, tw)
    izb = torch.zeros((n_items, th, tw), device=dev)
    pos = torch.zeros((n_items, th, tw), dtype=torch.int64, device=dev)
    for k in range(int(m.max()) if n_items else 0):
        idx = torch.nonzero(m > k).reshape(-1)
        p = wl.item_first[idx] + k
        a, _, rep = entry(item_tile[idx], p)
        iz, *_ = _face_pixels(a[:, :, None, None], X[idx], Y[idx])
        win = (iz > izb[idx]) & ~rep[:, None, None]
        if cull:
            out = cull_outside(a, tuple(r[idx] for r in rects))
            win &= ~out[:, sub]
        izb[idx] = torch.where(win, iz, izb[idx])
        pos[idx] = torch.where(win, p[:, None, None], pos[idx])
    key = torch.where(izb > 0, (izb.view(torch.int32).long() << 32)
                      | (0xFFFFFFFF - pos), torch.zeros_like(pos))
    keys = torch.zeros((n_busy, th, tw), dtype=torch.int64, device=dev)
    keys.scatter_reduce_(0, wl.item_busy[:, None, None].expand_as(key), key,
                         "amax")
    z_t = torch.full((N * T, th, tw), float("inf"), device=dev)
    f_t = torch.full((N * T, th, tw), -1, dtype=torch.int32, device=dev)
    b_t = torch.zeros((N * T, th, tw, 3), device=dev)
    b, r, c = torch.nonzero(keys).unbind(1)
    if b.numel():
        k = keys[b, r, c]
        tiles = wl.busy[b]
        a, face, _ = entry(tiles, 0xFFFFFFFF - (k & 0xFFFFFFFF))
        t = tiles % T
        _, q0, q1, q2 = _face_pixels(a, ((t % ent.ntx) * tw + c).float(),
                                     ((t // ent.ntx) * th + r).float())
        zw = 1.0 / torch.clamp((k >> 32).to(torch.int32).view(
            torch.float32), min=1e-37)
        z_t[tiles, r, c] = zw
        f_t[tiles, r, c] = face.to(torch.int32)
        b_t[tiles, r, c] = torch.stack([q0, q1, q2], -1) * zw[:, None]
    return tuple(_untile(ent, a, img_hw, th, tw) for a in (z_t, f_t, b_t))


def raster_work(ent: Entries, th: int = 32, tw: int = 128,
                faces_per_tile: int = 4096, stream: bool = True) -> dict:
    """What the kernels' fold of ``ent`` does (on the entries' device):
    busy tiles, work items, entries, the busiest tile's entries, the
    entries that repeat an earlier one of their face in their tile, and
    the (entry, sub-tile) pairs folded of those tested (the repeated ones
    and the ones the cull rules out skipped)."""
    counts, entry = _entries(ent, stream, faces_per_tile)
    wl = work_list(counts)
    cnt = counts.long()[wl.busy]
    tiles = torch.repeat_interleave(wl.busy, cnt)
    first = torch.cumsum(cnt, 0) - cnt
    k = torch.arange(tiles.numel(), device=cnt.device) \
        - torch.repeat_interleave(first, cnt)
    a, _, rep = entry(tiles, k)
    rects, _ = _subtile_rects(ent, tiles, th, tw)
    out = cull_outside(a, rects) | rep[:, None]
    return {"busy_tiles": wl.busy.numel(), "items": wl.item_busy.numel(),
            "entries": tiles.numel(),
            "busiest_tile": int(cnt.max()) if cnt.numel() else 0,
            "repeated": int(rep.sum()), "subtile_tests": out.numel(),
            "subtiles_folded": int((~out).sum())}


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/raster.cu)
# ---------------------------------------------------------------------------

def _outputs(ent: Entries, img_hw):
    H, W = img_hw
    dev = ent.attr_face.device
    return (torch.empty((ent.N, H, W), dtype=torch.float32, device=dev),
            torch.empty((ent.N, H, W), dtype=torch.int32, device=dev),
            torch.empty((ent.N, H, W, 3), dtype=torch.float32, device=dev))


def _workspace(ent: Entries, th: int, tw: int, dev):
    """The kernels' work list (4 + 3 N T int32, then one int32 for each
    work item: at most N T + N E / CHUNK) and merge keys (N T th tw int64).
    Both are allocated at these bounds since the busy tiles and items are
    counted on the device; only the busy tiles' keys are cleared and
    used."""
    NT = ent.N * ent.nty * ent.ntx
    items = NT + -(-ent.face.numel() // CHUNK)
    return (torch.empty((4 + 3 * NT + items,), dtype=torch.int32,
                        device=dev),
            torch.empty((NT * th * tw,), dtype=torch.int64, device=dev))


def _check_tile(th: int, tw: int) -> None:
    if th <= 0 or tw <= 0 or th * tw > 4096:
        raise ValueError(f"tiles of ({th}, {tw}) pixels: the kernels take "
                         "at most 4096 pixels a tile")


class StreamInputs(NamedTuple):
    """K5s's operands: the flat sorted entry arrays and the tile segments.
    An entry's code is its face id within the panel, ~face where the entry
    is a repeat."""
    attr: torch.Tensor    # (N*E, 9) f32, in sorted order
    fid: torch.Tensor     # (N*E,) int32 code
    starts: torch.Tensor  # (N*T,) int32
    counts: torch.Tensor  # (N*T,) int32


class GatherInputs(NamedTuple):
    """K5g's operands: the per-face attributes and the (T, K) table of
    entry codes (face, or ~face for a repeat)."""
    attr_face: torch.Tensor  # (N*F, 9) f32
    tbl: torch.Tensor        # (N*T, K) int32 code
    counts: torch.Tensor     # (N*T,) int32, at most K


def _codes(ent: Entries) -> torch.Tensor:
    face = (ent.face % ent.F).to(torch.int32)
    return torch.where(ent.repeat, ~face, face)


def stream_inputs(ent: Entries) -> StreamInputs:
    return StreamInputs(ent.attr_face[ent.face].contiguous(), _codes(ent),
                        ent.starts.to(torch.int32), ent.counts.to(torch.int32))


def gather_inputs(ent: Entries, faces_per_tile: int = 4096) -> GatherInputs:
    gidx, counts = _table_rows(ent, faces_per_tile)
    return GatherInputs(ent.attr_face.contiguous(), _codes(ent)[gidx],
                        counts.to(torch.int32))


def raster_stream_cuda(ent: Entries, inp: StreamInputs, img_hw,
                       th: int = 32, tw: int = 128) -> Raster:
    """Launch K5s (CUDA tensors only) on prepared entries: the list, clear,
    fold and finalise kernels, one public call."""
    _check_tile(th, tw)
    dev = inp.attr.device
    _build.check_input("attr", inp.attr, (None, 9), dev)
    z, fid, bary = _outputs(ent, img_hw)
    ints, keys = _workspace(ent, th, tw, dev)
    lib = _build.library()
    with launch(LAUNCHES, "raster_stream"):
        err = lib.nemo_raster_stream(
            ent.N, ent.nty * ent.ntx, int(img_hw[0]), int(img_hw[1]), th,
            tw, ent.ntx, inp.attr.data_ptr(), inp.fid.data_ptr(),
            inp.starts.data_ptr(), inp.counts.data_ptr(), ints.data_ptr(),
            keys.data_ptr(), z.data_ptr(), fid.data_ptr(), bary.data_ptr(),
            _build.stream_handle(dev))
        _build.check(err, "nemo_raster_stream")
    return z, fid, bary


def raster_gather_cuda(ent: Entries, inp: GatherInputs, img_hw,
                       th: int = 32, tw: int = 128) -> Raster:
    """Launch K5g (CUDA tensors only) on prepared entries: the list, clear,
    fold and finalise kernels, one public call."""
    _check_tile(th, tw)
    dev = inp.attr_face.device
    _build.check_input("attr_face", inp.attr_face, (ent.N * ent.F, 9), dev)
    z, fid, bary = _outputs(ent, img_hw)
    ints, keys = _workspace(ent, th, tw, dev)
    lib = _build.library()
    with launch(LAUNCHES, "raster_gather"):
        err = lib.nemo_raster_gather(
            ent.N, ent.nty * ent.ntx, int(img_hw[0]), int(img_hw[1]), th,
            tw, ent.ntx, ent.F, inp.tbl.shape[1], inp.attr_face.data_ptr(),
            inp.tbl.data_ptr(), inp.counts.data_ptr(), ints.data_ptr(),
            keys.data_ptr(), z.data_ptr(), fid.data_ptr(), bary.data_ptr(),
            _build.stream_handle(dev))
        _build.check(err, "nemo_raster_gather")
    return z, fid, bary


def raster_attributes() -> dict:
    """Registers a thread, shared memory and spills (local memory) of the
    kernels of both modes, as the CUDA runtime reports them for the built
    library."""
    names = ("stream fold", "gather fold", "stream finalise",
             "gather finalise", "list")
    return {name: _build.kernel_attributes("nemo_raster_attributes", which)
            for which, name in enumerate(names)}


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
    3)). A CUDA tensor calls K5s (stream) or K5g (gather) once; a CPU
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
