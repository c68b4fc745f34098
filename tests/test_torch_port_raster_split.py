"""K5s/K5g's split fold on the CPU, before any card runs it.

``raster.raster_split_emulation`` repeats what csrc/raster.cu does: the
same work items (CHUNK entries of a busy tile each), each folded with the
plain math into its own per-pixel (iz, first winning position), the
entries the exact sub-tile cull rules out skipped, the items merged by the
maximum of the 64-bit key (bits(iz) << 32) | (0xFFFFFFFF - position), and
q0, q1, q2 recomputed from the winner. It must equal the plain sequential
fold (``rasterize_plain``) bit for bit in both modes, with the cull and
without it: on the render tests' cases, one tile of many work items, equal
depths in two work items of a tile, a panel with every face behind the
near plane, a gather-mode overflow and slivers far from the origin. It is
also held against nemo_tpu's ``rasterize_triangles_pallas(...,
interpret=True)`` with tests/test_raster_pallas.py's contract.
"""

import numpy as np
import pytest
import torch

import test_torch_port_render as render_cases
import torch_raster_cases as split_cases
from nemo_tpu_torch.ops import raster

torch.set_num_threads(2)


def _equal(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


def _entries(verts, faces, focal, center, hw, th, tw):
    verts = torch.tensor(np.asarray(verts, np.float32))
    if verts.dim() == 2:
        verts, focal, center = verts[None], [focal], [center]
    return raster.prepare(verts, faces, focal, center, hw, th, tw)


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("case", render_cases.CASES)
def test_split_equals_plain_on_render_cases(case, stream):
    v, f, focal, center, hw, th, tw, fpt = render_cases._case(case)
    ent = _entries(v, f, focal, center, hw, th, tw)
    want = raster.rasterize_plain(ent, hw, th, tw, fpt, stream)
    for cull in (True, False):
        _equal(raster.raster_split_emulation(ent, hw, th, tw, fpt, stream,
                                             cull), want)


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("case", sorted(split_cases.CASES))
def test_split_equals_plain_on_split_cases(case, stream):
    v, f, focal, center, hw, th, tw = split_cases.CASES[case]()
    ent = _entries(v, f, focal, center, hw, th, tw)
    want = raster.rasterize_plain(ent, hw, th, tw, stream=stream)
    assert (want[1] >= 0).any()
    for cull in (True, False):
        _equal(raster.raster_split_emulation(ent, hw, th, tw, stream=stream,
                                             cull=cull), want)
    if case == "all_behind":
        assert not (want[1][0] >= 0).any()


def test_work_items():
    """One tile of 2800 entries is ceil(2800 / CHUNK) work items; the list
    holds only busy tiles, in tile order."""
    v, f, focal, center, hw, th, tw = split_cases.many_chunks()
    ent = _entries(v, f, focal, center, hw, th, tw)
    wl = raster.work_list(ent.counts)
    assert torch.equal(wl.busy, torch.nonzero(ent.counts > 0).reshape(-1))
    assert wl.busy.numel() == 1 and int(ent.counts.max()) == 2800
    items = -(-2800 // raster.CHUNK)
    assert items > 4
    assert wl.item_first.tolist() == [k * raster.CHUNK for k in range(items)]
    work = raster.raster_work(ent, th, tw)
    assert (work["items"], work["busiest_tile"]) == (items, 2800)
    assert 0 < work["subtiles_folded"] < work["subtile_tests"] / 2


def test_first_of_equal_depths_wins_across_items():
    """Each front face's twin, 300 faces later in the same tile (another
    work item: CHUNK = 64), never wins a pixel; the output is the single
    mesh's."""
    v, f, focal, center, hw, th, tw = split_cases.cross_chunk_tie()
    ent = _entries(v, f, focal, center, hw, th, tw)
    z, fid, bary = raster.raster_split_emulation(ent, hw, th, tw)
    assert ((fid >= 0) & (fid < 20)).any()
    assert not ((fid >= 300) & (fid < 320)).any()
    single = _entries(v[:, :900], f[:300], focal, center, hw, th, tw)
    _equal((z, fid, bary), raster.rasterize_plain(single, hw, th, tw))


def test_gather_overflow_split():
    """Gather mode over faces_per_tile drops what the plain gather drops."""
    rng = np.random.RandomState(1)
    verts, faces = render_cases._random_mesh(rng, F=60, spread=0.1, size=0.1)
    ent = _entries(verts, faces, 100.0, (32.0, 48.0), (64, 128), 32, 32)
    want = raster.rasterize_plain(ent, (64, 128), 32, 32, 16, stream=False)
    _equal(raster.raster_split_emulation(ent, (64, 128), 32, 32, 16,
                                         stream=False), want)
    stream = raster.rasterize_plain(ent, (64, 128), 32, 32)
    assert not torch.equal(stream[1], want[1])


@pytest.mark.parametrize("span", [2, (3, 1)])
def test_repeated_entries_are_the_later_copies(span):
    """In every tile, the first entry of each face is kept and every later
    entry of the same face (the span scatter's clamped slots) is marked
    repeated by bin_entries, in both modes' entries and in the kernels'
    codes (~face): skipping those changes nothing."""
    v, f, focal, center, hw, th, tw, _ = render_cases._case("ragged")
    verts = torch.tensor(v)[None]
    ent = raster.prepare(verts, f, [focal], [center], hw, th, tw, span)
    counts, entry = raster._entries(ent, True, 4096)
    _, gather_entry = raster._entries(ent, False, 4096)
    codes = raster._codes(ent)
    assert torch.equal(codes < 0, ent.repeat)
    assert torch.equal(torch.where(codes < 0, ~codes, codes).long(),
                       ent.face % ent.F)
    n_rep = 0
    for tile in torch.nonzero(counts > 0).reshape(-1).tolist():
        k = torch.arange(int(counts[tile]))
        _, face, rep = entry(torch.full_like(k, tile), k)
        assert torch.equal(gather_entry(torch.full_like(k, tile), k)[2], rep)
        first = {}
        for i, fc in enumerate(face.tolist()):
            assert bool(rep[i]) == (fc in first)
            first.setdefault(fc, i)
        n_rep += int(rep.sum())
    assert n_rep > 0


def test_merge_key_orders_as_the_sequential_fold():
    """The largest key over random (iz, position) pairs, ties in iz
    included, is the sequential fold's winner: the largest iz, the first
    position among equals."""
    rng = np.random.RandomState(2)
    for _ in range(50):
        n = rng.randint(1, 40)
        iz = rng.choice(np.float32([0.25, 0.5, 1e-30, 3.0, np.inf]), n)
        pos = rng.permutation(100000)[:n]
        key = (torch.tensor(iz).view(torch.int32).long() << 32) \
            | (0xFFFFFFFF - torch.tensor(pos))
        win = int(torch.argmax(key))
        best = iz.max()
        assert iz[win] == best
        assert pos[win] == pos[iz == best].min()


def test_cull_keeps_rounding_coverage():
    """The cull never rules out an entry at a pixel the f32 edge functions
    cover: on the slivers, every covered pixel's winner was folded in its
    sub-tile, and the cull still rules out most (entry, sub-tile) pairs."""
    v, f, focal, center, hw, th, tw = split_cases.sliver()
    ent = _entries(v, f, focal, center, hw, th, tw)
    work = raster.raster_work(ent, th, tw)
    assert work["subtiles_folded"] < work["subtile_tests"] / 4
    z, fid, bary = raster.rasterize_plain(ent, hw, th, tw)
    ys, xs = torch.nonzero(fid[0] >= 0, as_tuple=True)
    assert ys.numel() > 0
    tri = torch.tensor(v[0, :, :2]).reshape(-1, 6)[fid[0][ys, xs]]
    a = torch.cat([tri, torch.ones(ys.numel(), 3)], 1)
    tiles = (ys // th) * ent.ntx + xs // tw
    rects, sub = raster._subtile_rects(ent, tiles, th, tw)
    out = raster.cull_outside(a, rects)
    assert not out[torch.arange(ys.numel()), sub[ys % th, xs % tw]].any()


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("case", ["lane_tiles", "one_busy_tile"])
def test_split_matches_pallas(case, stream):
    """The emulation against the JAX kernel in interpret mode, with
    tests/test_raster_pallas.py's contract."""
    v, f, focal, center, hw, th, tw, fpt = render_cases._case(case)
    want = render_cases._jax_raster(v, f, focal, center, hw, th, tw, fpt,
                                    stream)
    ent = _entries(v, f, focal, center, hw, th, tw)
    got = raster.raster_split_emulation(ent, hw, th, tw, fpt, stream)
    render_cases._assert_raster_close([a[0].numpy() for a in got], want)
