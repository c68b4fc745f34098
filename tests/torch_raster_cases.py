"""Rasterizer inputs that stress the split fold of K5s/K5g (tests only).

Each function returns (verts (N, V, 3) float32 camera-space vertices, faces
(F, 3), focal lengths (N,), principal points (N, 2), img_hw, th, tw) as
numpy data made from a seed, for the plain version, the emulation, the
kernels and the JAX package alike.
"""

import numpy as np


def _blob(rng, F, center, spread, size, z0, z1):
    c = np.stack([rng.uniform(-spread, spread, F) + center[0],
                  rng.uniform(-spread, spread, F) + center[1],
                  rng.uniform(z0, z1, F)], 1)
    offs = rng.uniform(-size, size, size=(F, 3, 3))
    return (c[:, None] + offs).reshape(-1, 3).astype(np.float32)


def many_chunks(seed=0):
    """One tile holds 700 faces' 2800 entries: many work items."""
    rng = np.random.RandomState(seed)
    v = _blob(rng, 700, (0.0, 0.0), 0.06, 0.03, 3.0, 5.0)
    return v[None], np.arange(v.shape[0]).reshape(-1, 3), [300.0], \
        [(64.0, 16.0)], (64, 256), 32, 128


def cross_chunk_tie(seed=0):
    """Twenty faces, each with an identical twin 300 faces later in the same
    tile (equal depth at every pixel, in another work item), over 280
    smaller filler faces behind them: the earlier twin must win."""
    rng = np.random.RandomState(seed)
    front = _blob(rng, 20, (0.0, 0.0), 0.05, 0.04, 3.0, 3.5)
    filler = _blob(rng, 280, (0.0, 0.0), 0.07, 0.02, 4.0, 5.0)
    v = np.concatenate([front, filler, front])
    return v[None], np.arange(v.shape[0]).reshape(-1, 3), [300.0], \
        [(64.0, 16.0)], (64, 256), 32, 128


def sliver(seed=0, F=300):
    """Edge-on faces far from the origin: vertices a few ulps around pixel
    centres at x up to 1000 on sub-tile borders, |area| in (1e-8, 3e-8),
    all at depth 1 (so equal depths tie too). With focal length 1 and the
    principal point at 0 the projection is exact."""
    rng = np.random.RandomState(seed)
    tri = []
    while len(tri) < F:
        P = np.array([rng.choice([31, 32, 63, 64, 95, 96, 127, 128])
                      + 128 * rng.randint(3, 8),
                      rng.choice([7, 8, 15, 16, 23, 24, 31, 32])
                      + 32 * rng.randint(0, 2)], np.float32)
        t = (P[None] + rng.randint(-40, 41, (3, 2)).astype(np.float32)
             * np.spacing(P)[None]).astype(np.float32)
        (x0, y0), (x1, y1), (x2, y2) = t
        area = np.float32(np.float32((x1 - x0) * (y2 - y0))
                          - np.float32((y1 - y0) * (x2 - x0)))
        if 1e-8 < abs(area) < 3e-8:
            tri.append(t)
    uv = np.concatenate(tri)
    v = np.concatenate([uv, np.ones((uv.shape[0], 1), np.float32)], 1)
    return v[None], np.arange(v.shape[0]).reshape(-1, 3), [1.0], \
        [(0.0, 0.0)], (96, 1024), 32, 128


def all_behind(seed=0):
    """Two panels: every face of the first lies behind the near plane (no
    busy tile), the second is a normal blob."""
    rng = np.random.RandomState(seed)
    v = _blob(rng, 200, (0.0, 0.0), 0.5, 0.1, 3.0, 5.0)
    behind = v.copy()
    behind[:, 2] = -behind[:, 2]
    return np.stack([behind, v]), np.arange(v.shape[0]).reshape(-1, 3), \
        [200.0, 200.0], [(64.0, 48.0), (64.0, 48.0)], (96, 200), 32, 128


CASES = {"many_chunks": many_chunks, "cross_chunk_tie": cross_chunk_tie,
         "sliver": sliver, "all_behind": all_behind}
