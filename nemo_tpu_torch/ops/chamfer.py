"""One-way nearest-neighbour chamfer: kernel K4 and its autograd ops.

Replaces nemo_tpu/ops/chamfer.py's ``_nn_one_way_pallas``
(``_chamfer_kernel``) behind the same public ops: ``nn_one_way`` (min
squared distance and argmin from each point of ``a`` to the set ``b``),
``chamfer_one_way`` (one direction, with the CUDA extension's backward),
``chamfer_distance`` (both directions, one ``chamfer_one_way`` each) and
``chamfer_loss``.

The port takes a leading frame axis where the JAX package vmaps: ``a (T, N,
3)`` and ``b (T, M, 3)``, one kernel launch for all T frames; 2-D inputs are
one frame. On a CUDA tensor ``nn_one_way`` launches ``csrc/chamfer.cu``, an
instruction-bound kernel (8 instructions a pair: M split over the warps of
a block, several queries a thread, the running minimum taken a group at a
time, the ranges merged in a fixed order; the source note has the details
and :func:`nn_split` picks the split). On a CPU tensor it runs
``nn_one_way_plain``, chunked over M as ``_nn_one_way_xla`` is, which
evaluates every sum in the kernel's order (no matmul, whose K=3 summation
order is unspecified), so the two agree bit for bit on the card;
:func:`nn_one_way_split_emulation` repeats the kernel's ranges, group
minima and merge on the CPU. A NaN distance never wins in either, where
the JAX XLA path skips the whole chunk that holds it. The backward is
plain PyTorch, as the JAX backward is plain XLA.

``chamfer_distance`` returns each matched pair's squared distance computed
directly, |x - y|^2, as the reference's CUDA extension does and as its
backward differentiates it; the search's expansion (|x|^2 + |y|^2 - 2 x.y)
loses up to a few ulp of |x|^2 to cancellation and goes negative for a
point sub-millimetre from its match a few metres from the origin, where
the JAX package's value (and its points3d loss, through sqrt) is NaN.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from . import _build
from ..utils.trace import launch

LAUNCHES = {"chamfer_nn": 0}

# csrc/chamfer.cu: candidates a group minimum covers, warps a block at most
GROUP = 8
MAX_RANGES = 16
# nn_split: the warps a frame's work should put on each SM (4 blocks of 8),
# and the fewest candidates a range should hold
WARPS_PER_SM = 32
MIN_RANGE = 64


class Split(NamedTuple):
    """How K4 cuts a call: ``q`` queries a thread (blocks of 32 q queries),
    ``ranges`` warps a block, each walking ``range`` candidates."""
    q: int
    ranges: int
    range: int


def _range_len(M: int, ranges: int, group: int = GROUP) -> int:
    """Candidates a range: ceil(M / ranges), rounded up to whole groups."""
    per = -(-M // ranges)
    return -(-per // group) * group


def nn_split(T: int, N: int, M: int, sms: int = 132) -> Split:
    """The kernel's split at (T, N, M) on a card of ``sms`` SMs: the most
    queries a thread (4, 2, 1) that still give every SM a block, then the
    fewest ranges (a power of two up to 16) that put WARPS_PER_SM warps on
    each SM, while a range keeps MIN_RANGE candidates. Path E's scan ->
    mesh (60, 512, 6890) gets (4, 16, 432), mesh -> scan (60, 6890, 512)
    (4, 2, 256)."""
    for q in (4, 2, 1):
        blocks = -(-N // (32 * q)) * T
        if blocks >= sms:
            break
    ranges = 1
    while (ranges < MAX_RANGES and blocks * ranges < WARPS_PER_SM * sms
           and M >= 2 * ranges * MIN_RANGE):
        ranges *= 2
    return Split(q, ranges, _range_len(M, ranges))


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """(x0 x0 + x1 x1) + x2 x2 over the last axis, in the kernel's order."""
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + \
        x[..., 2] * x[..., 2]


def _distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """d (T, N, M) = (|a|^2 + |b|^2) - (2a).b in the kernel's order. The
    query is doubled first: (2a).b is 2 (a.b) exactly unless a product is
    subnormal or overflows."""
    a2 = 2.0 * a
    b0, b1, b2 = (b[..., k][:, None] for k in range(3))
    dot2 = (a2[..., 0:1] * b0 + a2[..., 1:2] * b1) + a2[..., 2:3] * b2
    return (_sq_norm(a)[..., None] + _sq_norm(b)[:, None]) - dot2


def nn_one_way_plain(a: torch.Tensor, b: torch.Tensor, chunk: int = 1024
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min squared distance (T, N), argmin (T, N) int64) from each
    a[t, n] to the set b[t]; the plain version of K4. A running minimum
    over chunks of M under a strict <, the first minimum within a chunk:
    the lowest index wins a tie. A NaN distance counts as +inf, so it never
    wins, and a query with no finite distance gets +inf and index 0.
    Memory is (T, N, chunk) at a time."""
    T, N, _ = a.shape
    M = b.shape[1]
    best = torch.full((T, N), float("inf"), dtype=a.dtype, device=a.device)
    best_idx = torch.zeros((T, N), dtype=torch.int64, device=a.device)
    for m0 in range(0, M, chunk):
        d = _distances(a, b[:, m0:m0 + chunk])
        d.masked_fill_(d.isnan(), float("inf"))
        idx = d.argmin(-1)
        val = d.gather(-1, idx[..., None])[..., 0]
        take = val < best
        best = torch.where(take, val, best)
        best_idx = torch.where(take, idx + m0, best_idx)
    return best, best_idx


def nn_one_way_split_emulation(a: torch.Tensor, b: torch.Tensor, q: int,
                               ranges: int, group: int = GROUP
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """csrc/chamfer.cu's search on CPU tensors, step for step (tests only):
    queries in blocks of 32 q (the last padded with zeros), M in ``ranges``
    ranges of whole groups, each range's running minimum taken a group at a
    time (fminf over the group, then a strict < against the running best,
    keeping the group), the winning group's first candidate equal to the
    minimum, and the ranges' partials folded in range order under a strict
    <. Distances and indices equal nn_one_way_plain's."""
    T, N, _ = a.shape
    M = b.shape[1]
    R = _range_len(M, ranges, group)
    Np = -(-N // (32 * q)) * 32 * q
    ap = torch.cat([a, a.new_zeros((T, Np - N, 3))], dim=1)
    inf = float("inf")
    d = _distances(ap, b)
    d = torch.cat([d, d.new_full((T, Np, ranges * R - M), inf)], dim=2)
    d = d.reshape(T, Np, ranges, R // group, group)
    gmin = d[..., 0]
    for k in range(1, group):
        gmin = torch.fmin(gmin, d[..., k])
    best = torch.full((T, Np, ranges), inf)
    win = torch.full((T, Np, ranges), -1, dtype=torch.int64)
    for g in range(R // group):
        take = gmin[..., g] < best
        best = torch.where(take, gmin[..., g], best)
        win = torch.where(take, g, win)
    vals = d.gather(3, win.clamp(min=0)[..., None, None].expand(
        T, Np, ranges, 1, group))[..., 0, :]
    first = (vals == best[..., None]).to(torch.uint8).argmax(-1)
    found = win >= 0
    pd = torch.where(found, vals.gather(-1, first[..., None])[..., 0], inf)
    start = torch.arange(ranges)[None, None] * R
    pm = torch.where(found, start + win * group + first, 0)
    bd = torch.full((T, Np), inf)
    bm = torch.zeros((T, Np), dtype=torch.int64)
    for w in range(ranges):
        take = pd[..., w] < bd
        bd = torch.where(take, pd[..., w], bd)
        bm = torch.where(take, pm[..., w], bm)
    return bd[:, :N], bm[:, :N]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _card_split(T: int, N: int, M: int, device) -> Split:
    """nn_split's for the card that holds ``device``."""
    return nn_split(T, N, M, _sm_count(torch.device(device)))


def nn_one_way_cuda(a: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 (CUDA tensors only): a (T, N, 3), b (T, M, 3), cut as
    :func:`nn_split` picks for the card."""
    T, N = a.shape[:2]
    dev = a.device
    _build.check_input("a", a, (T, N, 3), dev)
    _build.check_input("b", b, (T, None, 3), dev)
    M = b.shape[1]
    if min(T, N, M) < 1 or T > 65535:
        raise ValueError(f"nn_one_way: T={T}, N={N}, M={M} (need each >= 1 "
                         "and T <= 65535)")
    sp = _card_split(T, N, M, dev)
    lib = _build.library()
    dist = torch.empty((T, N), dtype=torch.float32, device=dev)
    idx = torch.empty((T, N), dtype=torch.int64, device=dev)
    with launch(LAUNCHES, "chamfer_nn"):
        err = lib.nemo_chamfer_nn(a.data_ptr(), b.data_ptr(), T, N, M, sp.q,
                                  sp.ranges, sp.range, dist.data_ptr(),
                                  idx.data_ptr(), _build.stream_handle(dev))
        _build.check(err, "nemo_chamfer_nn")
    return dist, idx


def nn_empty_cuda(T: int, N: int, M: int, device) -> None:
    """Launch an empty kernel on K4's grid, block and shared memory at (T,
    N, M): its device time is the launch floor beside K4's (not counted in
    LAUNCHES)."""
    sp = _card_split(T, N, M, device)
    _build.check(_build.library().nemo_chamfer_empty(
        T, N, M, sp.q, sp.ranges,
        _build.stream_handle(torch.device(device))), "nemo_chamfer_empty")


def nn_attributes(q: int = 4) -> dict:
    """The q-query kernel's registers a thread, shared memory (the dynamic
    bytes at 16 ranges) and spills (local memory)."""
    return _build.kernel_attributes("nemo_chamfer_attributes", q)


def nn_one_way(a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min squared distances, argmin indices) from each point of a to the
    set b: a (T, N, 3) and b (T, M, 3) frame by frame, or one frame (N, 3)
    and (M, 3). The kernel on CUDA tensors (a strided view copied once,
    contiguous), the plain version on CPU ones."""
    if a.dim() == 2:
        d, i = nn_one_way(a[None], b[None])
        return d[0], i[0]
    if _build.route(a, b) == "cpu":
        return nn_one_way_plain(a, b)
    return nn_one_way_cuda(_build.kernel_operand(a), _build.kernel_operand(b))


def _matched_sq_dist(x: torch.Tensor, y: torch.Tensor, i: torch.Tensor
                     ) -> torch.Tensor:
    """|x[t, n] - y[t, i[t, n]]|^2 (T, N), never negative."""
    d = x - torch.gather(y, 1, i[..., None].expand(*i.shape, 3))
    return _sq_norm(d)


def _flat_index(i: torch.Tensor, size: int) -> torch.Tensor:
    """(T, K) per-frame indices into a (T, size) axis -> (T*K,) flat."""
    off = torch.arange(i.shape[0], device=i.device)[:, None] * size
    return (i + off).reshape(-1)


class ChamferOneWay(torch.autograd.Function):
    """Forward: K4 from xyz1 to xyz2 (the plain version on the CPU), then
    the matched pairs' squared distances d1[n] = |x1[n] - x2[i1[n]]|^2;
    backward: the CUDA extension's (nemo_tpu ``_chamfer_bwd``) for one
    direction, 2 g1 (x1 - x2[i1]) to x1 and its negative onto x2[i1]. The
    scatter is index_add over the flattened (T*M) indices (atomics on
    CUDA: sums onto a vertex are order-nondeterministic at the ulp
    level)."""

    @staticmethod
    def forward(ctx, xyz1, xyz2):
        x1, x2 = xyz1.contiguous(), xyz2.contiguous()
        _, i1 = nn_one_way(x1, x2)
        ctx.save_for_backward(x1, x2, i1)
        return _matched_sq_dist(x1, x2, i1)

    @staticmethod
    def backward(ctx, g1):
        x1, x2, i1 = ctx.saved_tensors
        T, N, _ = x1.shape
        M = x2.shape[1]
        x2_nn = torch.gather(x2, 1, i1[..., None].expand(T, N, 3))
        grad1 = g1[..., None] * (2.0 * (x1 - x2_nn))     # (T, N, 3)
        gx2 = x2.new_zeros((T * M, 3)).index_add(0, _flat_index(i1, M),
                                                 -grad1.reshape(T * N, 3))
        return grad1, gx2.reshape(T, M, 3)


def chamfer_one_way(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Each point of xyz1 (T, N, 3)'s squared distance to its nearest
    neighbour in xyz2 (T, M, 3), (T, N), with one search: the first
    direction of :func:`chamfer_distance`, for a loss that reads only it;
    2-D inputs are one frame."""
    if xyz1.dim() == 2:
        return ChamferOneWay.apply(xyz1[None], xyz2[None])[0]
    return ChamferOneWay.apply(xyz1, xyz2)


def chamfer_distance(xyz1: torch.Tensor, xyz2: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional squared chamfer distances: xyz1 (T, N, 3), xyz2 (T, M,
    3) -> (dist1 (T, N), dist2 (T, M)), each point's squared distance to its
    nearest neighbour in the other set; 2-D inputs are one frame. One
    search a direction; autograd sums the two directions' gradients, as
    the CUDA extension's backward does."""
    return chamfer_one_way(xyz1, xyz2), chamfer_one_way(xyz2, xyz1)


def chamfer_loss(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Scalar symmetric chamfer loss (mean of both directions)."""
    d1, d2 = chamfer_distance(xyz1, xyz2)
    return d1.mean() + d2.mean()
