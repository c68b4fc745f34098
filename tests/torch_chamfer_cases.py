"""Nearest-neighbour inputs that stress K4's split search (tests only).

``chamfer_case(name)`` returns (a (T, N, 3), b (T, M, 3)) float32 numpy
arrays made from a seed, for the plain version, the emulation, the kernel
and the JAX package alike. The tie positions sit on the boundaries of the
ranges that ``STRADDLE_RANGES`` and the kernel's default split cut M = 600
into, and on group boundaries (multiples of 8).
"""

import numpy as np

# ranges for which "straddle" puts a tie across a range boundary: M = 600
# in 2, 3, 4 and 16 ranges gives ranges of 304, 200, 152 and 40 candidates
STRADDLE_RANGES = (2, 3, 4, 16)
# candidate p is repeated at p + 1: 7 -> 8 and 39 -> 40 cross a group (and
# for 16 ranges a range), 151 -> 152, 199 -> 200, 303 -> 304, 399 -> 400
# and 455 -> 456 a range of one of STRADDLE_RANGES
_TIES = (7, 39, 151, 199, 303, 399, 455)

CASES = ("ragged", "few", "single", "straddle", "exact", "far", "nonfinite")


def chamfer_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    if name == "ragged":
        # M neither a multiple of a range nor of a group
        return f(3, 37, 3), f(3, 101, 3)
    if name == "few":
        # fewer candidates than ranges
        return f(2, 9, 3), f(2, 5, 3)
    if name == "single":
        # one frame, one query
        return f(1, 1, 3), f(1, 300, 3)
    if name == "straddle":
        # ties across group and range boundaries; queries on the tied
        # candidates, the lower index must win
        b = f(2, 600, 3)
        for p in _TIES:
            b[:, p + 1] = b[:, p]
        a = np.concatenate([b[:, list(_TIES)], f(2, 41, 3)], axis=1)
        return a, b
    if name == "exact":
        # every query exactly on a distinct candidate
        b = f(2, 200, 3)
        return b[:, rng.permutation(200)[:30]].copy(), b
    if name == "far":
        # 100 m from the origin, queries 0.1 mm from a candidate: the
        # expanded distance cancels, some go negative
        b = (100.0 + 0.3 * rng.standard_normal((2, 300, 3))).astype(
            np.float32)
        a = (b[:, :40] + 1e-4 * rng.standard_normal((2, 40, 3))).astype(
            np.float32)
        return a, b
    if name == "nonfinite":
        # +inf and NaN distances: frame 0 has candidates with an infinite
        # or NaN coordinate, some in the group of a query's true match;
        # frame 1's candidates are all NaN (every query: +inf, index 0);
        # frame 2 has queries with an infinite coordinate (+inf, 0)
        b, a = f(3, 90, 3), f(3, 20, 3)
        b[0, 10, 0], b[0, 20, 1], b[0, 5, 2] = np.inf, np.nan, -np.inf
        b[0, 17] = np.nan
        a[0, :4] = b[0, [16, 18, 21, 4]]
        b[1] = np.nan
        a[2, :3, 0] = np.inf
        return a, b
    raise KeyError(name)


def brute_force(a, b):
    """float64 (dist, idx) of the same search: the lowest index of the
    minimum, NaN distances counted as +inf (idx 0 where none is finite)."""
    d = ((a[:, :, None].astype(np.float64) - b[:, None]) ** 2).sum(-1)
    d = np.where(np.isnan(d), np.inf, d)
    return d.min(-1), d.argmin(-1)
