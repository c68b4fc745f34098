"""Linear blend skinning: kernels K3 (plain skinning) and K2 (the v2v prior).

Replaces nemo_tpu/ops/lbs_pallas.py:

- ``skin_verts_t`` (K3): ``_fwd_pallas``/``_fwd_kernel`` forward and
  ``_bwd_pallas``/``_bwd_kernel`` backward, on ``csrc/skin.cu``.
- ``skin_v2v_l1`` (K2): in its default ``vjp="fused"`` mode
  ``_v2v_fwdbwd_pallas`` (``_v2v_fwdbwd_kernel``); in the ``"pair"`` and
  ``"pair_vp"`` modes ``_v2v_fwd_pallas`` (``_v2v_fwd_kernel`` and
  ``_v2v_fwd_kernel_vp``) followed by K3b's ``_bwd_kernel``/``_bwd_kernel_vp``
  on the stored sign (and posed vertices); undifferentiated, the total that
  ``_v2v_fwd_pallas`` computes. On ``csrc/v2v.cu``.

``skin_v2v_l1`` returns sum |skin(pf_r, A_r) - skin(pf_o, A_o)| without
building either mesh. The rec side is a constant (zero gradient), as in the
reference's detached reconstruction. The orig-side gradients are those of
the raw cotangent sign(rec - orig), scaled by -ghat in the backward, exactly
like the TPU kernel's ``_v2v_fwd``/``_v2v_bwd``. The ``vjp`` argument takes
the place of the JAX package's NEMO_TPU_SKIN_FUSED_VJP and
NEMO_TPU_SKIN_VP_RES environment knobs; all three modes give the same
gradients.

Layouts are the logical vertex-major tables: posedirs_t (207, 3, V),
W_t (24, V), v_shaped_t (3, V), verts (B, 3, V); K2's fused and
forward-only modes with f32 tables read, in place of posedirs_t, its copy
with rows padded to a multiple of 16 vertices (``padded_posedirs``, made
once at set-up). On a CUDA tensor a wrapper
launches its kernel, each one pass with the posedirs contractions on the
tensor cores in 3xTF32: K2's fused and forward-only modes, K3b, and one
forward kernel for K3f and K2's pair mode (the source notes have the counts
and the designs). On a CPU tensor it runs the plain versions below, which
mirror ``_skin_verts_t_xla`` and ``_bwd_xla``; ``v2v_l1_split_emulation``,
``skin_bwd_split_emulation``, ``skin_fwd_split_emulation`` and
``v2v_pair_split_emulation`` repeat the one-pass kernels' arithmetic for
the tests.

bf16 tables. The table dtype picks the computation, as the tiled tables'
dtype does in the JAX package (``skin_tables_dtype``, NEMO_TPU_SKIN_BF16):
with posedirs_t and W_t in bfloat16 every op computes the TPU kernels' bf16
function. pf and A are rounded to bf16 (round to nearest even); the
posedirs and blend contractions multiply bf16 values, exactly, and sum in
f32; the backward rounds gm = g . [vp; 1] and gvp to bf16 before its gA
and gpf contractions, and gvsh sums the unrounded gvp; the pair mode
stores vp in bf16. v_shaped_t, the cotangents and every other output stay
f32. On a CUDA tensor the ``_bf16`` kernels run it, the posedirs
contractions on ``mma.sync`` bf16 in one pass, and count their launches
under the ``_bf16`` keys of LAUNCHES; on the CPU the plain versions below
do. With f32 tables nothing changes.

bf16 meshes. ``skin_verts_t(..., out_dtype=torch.bfloat16)`` is the JAX
package's NEMO_TPU_SKIN_IO_BF16 (``skin_io_dtype``): K3f rounds the f32
vertices to bf16 (nearest even) as it stores them, and K3b reads the bf16
cotangent its autograd hands back, as ``_bwd_kernel`` upcasts it; either
table type. On a CUDA tensor the bf16-mesh instantiations run it (the C
entry points' mesh_bf16 = 1) and count under the ``_io_bf16`` keys of
LAUNCHES (after the tables' suffix); on the CPU the plain versions round
the output and widen the cotangent.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ..utils.trace import launch
from ._emulation import in_order as _in_order
from ._emulation import mm_3xtf32 as _mm_3xtf32
from ._emulation import tf32 as _tf32

NUM_POSE_FEATURES = 207
NUM_JOINTS = 24
VJP_MODES = ("fused", "pair", "pair_vp")

_KERNELS = ("v2v_grad", "v2v_fwd", "v2v_pair", "skin_fwd", "skin_bwd",
            "skin_bwd_vp")
BF16 = "_bf16"   # the bf16 tables' kernels: C entry points and counters
IO_BF16 = "_io_bf16"  # K3's bf16-mesh kernels, after the tables' suffix
LAUNCHES = {k + sfx: 0 for sfx in ("", BF16) for k in _KERNELS}
LAUNCHES.update({k + sfx + IO_BF16: 0 for sfx in ("", BF16)
                 for k in ("skin_fwd", "skin_bwd")})
MESH_DTYPES = (torch.float32, torch.bfloat16)

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def is_bf16(table: torch.Tensor) -> bool:
    """Whether a table (posedirs_t) selects the bf16 computation."""
    return table.dtype == torch.bfloat16


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bf16 (ties to even), back in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _operands(pf, A34, posedirs_t, W_t):
    """(pf, A34, posedirs_t, W_t) as the kernels multiply them: as given
    with f32 tables; with bf16 tables pf and A34 rounded to bf16 and all
    four in f32, where a product of two bf16 values is exact."""
    if not is_bf16(posedirs_t):
        return pf, A34, posedirs_t, W_t
    return bf16_round(pf), bf16_round(A34), posedirs_t.float(), W_t.float()


def _posed(pf, posedirs_t, v_shaped_t) -> torch.Tensor:
    """Posed rest vertices vp (B, 3, V)."""
    return torch.einsum('bp,pkv->bkv', pf, posedirs_t) + v_shaped_t


def _blend(A34, W_t) -> torch.Tensor:
    """Blended transforms M (B, 3, 4, V)."""
    return torch.einsum('bjl,jv->blv', A34, W_t).reshape(
        A34.shape[0], 3, 4, -1)


def _homogeneous(vposed) -> torch.Tensor:
    B, _, V = vposed.shape
    return torch.cat([vposed, vposed.new_ones((B, 1, V))], dim=1)


def skin_verts_t_plain(pf, A34, v_shaped_t, posedirs_t, W_t) -> torch.Tensor:
    """verts_t (B, 3, V) from pf (B, 207), A34 (B, 24, 12), v_shaped_t
    (3, V), posedirs_t (207, 3, V), W_t (24, V) (f32 or bf16 tables)."""
    pf, A34, posedirs_t, W_t = _operands(pf, A34, posedirs_t, W_t)
    vph = _homogeneous(_posed(pf, posedirs_t, v_shaped_t))
    return torch.einsum('bikv,bkv->biv', _blend(A34, W_t), vph)


def skin_bwd_plain(pf, A34, v_shaped_t, posedirs_t, W_t, g,
                   vp: Optional[torch.Tensor] = None) -> Grads:
    """(gpf, gA, gvsh) of skin_verts_t_plain under the cotangent g (B,3,V).
    vp: the posed vertices stored by the forward (in the tables' dtype), or
    None to recompute. With bf16 tables gm = g . [vp; 1] and gvp are
    rounded to bf16 before the gA and gpf contractions."""
    return _skin_bwd(pf, A34, v_shaped_t, posedirs_t, W_t, g, vp, None)


def _skin_bwd(pf, A34, v_shaped_t, posedirs_t, W_t, g, vp, moved) -> Grads:
    """skin_bwd_plain, or with bf16 tables skin_bwd_misrounded's variant."""
    B = pf.shape[0]
    lowp = is_bf16(posedirs_t)
    pf_in, A_in = pf, A34
    pf, A34, posedirs_t, W_t = _operands(pf, A34, posedirs_t, W_t)
    if moved == "pf":
        pf = pf_in
    elif moved == "A":
        A34 = A_in
    if vp is None:
        vposed = _posed(pf, posedirs_t, v_shaped_t)
    else:
        vposed = vp.float() if is_bf16(vp) else vp
    M4 = _blend(A34, W_t)
    gM4 = torch.einsum('biv,bkv->bikv', g, _homogeneous(vposed))
    if lowp and moved != "gm":
        gM4 = bf16_round(gM4)
    ga = torch.einsum('bikv,jv->bjik', gM4, W_t).reshape(B, NUM_JOINTS, 12)
    gvposed = torch.einsum('bikv,biv->bkv', M4[:, :, :3], g)
    gpf = torch.einsum('bkv,pkv->bp',
                       bf16_round(gvposed) if lowp and moved != "gvp"
                       else gvposed, posedirs_t)
    gvsh = (bf16_round(gvposed) if moved == "gvsh" else gvposed).sum(dim=0)
    return gpf, ga, gvsh


def v2v_l1_plain(pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r, A_r,
                 grad: bool) -> Tuple[torch.Tensor, Optional[Grads]]:
    """(total, orig-side grads under sign(rec - orig) or None)."""
    total, sign, _ = v2v_pair_plain(pf_o, A_o, v_shaped_t, posedirs_t, W_t,
                                    pf_r, A_r, want_vp=False)
    if not grad:
        return total, None
    return total, skin_bwd_plain(pf_o, A_o, v_shaped_t, posedirs_t, W_t, sign)


def v2v_pair_plain(pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r, A_r,
                   want_vp: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(total, sign(rec - orig) (B, 3, V), orig-side vp (B, 3, V) or None;
    vp in the tables' dtype, as the kernel stores it)."""
    r = skin_verts_t_plain(pf_r, A_r, v_shaped_t, posedirs_t, W_t)
    table_dtype = posedirs_t.dtype
    pf_o, A_o, posedirs_t, W_t = _operands(pf_o, A_o, posedirs_t, W_t)
    vp_o = _posed(pf_o, posedirs_t, v_shaped_t)
    o = torch.einsum('bikv,bkv->biv', _blend(A_o, W_t), _homogeneous(vp_o))
    diff = r - o
    return diff.abs().sum(), torch.sign(diff), \
        (vp_o.to(table_dtype) if want_vp else None)


# ---------------------------------------------------------------------------
# the one-pass kernels' arithmetic, emulated (tests only)
# ---------------------------------------------------------------------------

FUSED_ROWS, FUSED_VERTS = 32, 16   # csrc/skin_common.cuh's kFB and kFV
# K2's fused kernel with f32 tables (csrc/v2v.cu's kWR, kWHalf): 16-row
# batch tiles of 16-vertex tiles, and the features of its two vph halves
# (207: the end, less the zero pad row)
WS_ROWS = 16
WS_HALVES = (0, 104, NUM_POSE_FEATURES)


def fused_ranges(B: int, V: int, num_sms: int) -> int:
    """K3b's one-pass kernel's vertex ranges, and the bf16 tables' K2
    fused kernel's (csrc/skin_common.cuh: fused_ranges)."""
    n_bt = -(-B // FUSED_ROWS)
    return min(2 * max(1, num_sms // n_bt), -(-V // FUSED_VERTS))


def _blocks(B: int, V: int, num_sms: int):
    """The one-pass kernels' (batch tiles, vertex ranges) as index pairs."""
    rows = [(b, min(B, b + FUSED_ROWS)) for b in range(0, B, FUSED_ROWS)]
    return rows, _ranges(V, fused_ranges(B, V, num_sms))


def _fewest_tile_times(n_bt: int, n_tiles: int, cap: int,
                       num_sms: int) -> int:
    """Of R = 1 .. cap vertex ranges, the smallest with the fewest tile
    times at one block an SM, each wave of blocks counted as its longest
    range plus 2 tile times of set-up."""
    cost = lambda R: -(-(n_bt * R) // num_sms) * (-(-n_tiles // R) + 2)
    return min(range(1, cap + 1), key=lambda R: (cost(R), R))


def ws_ranges(B: int, V: int, num_sms: int) -> int:
    """K2's fused kernel's vertex ranges with f32 tables (csrc/v2v.cu:
    ws_ranges): _fewest_tile_times over 16-row batch tiles and 16-vertex
    tiles, up to 4 SMs / batch tiles ranges, at least 2 (while there are 2
    vertex tiles)."""
    n_bt, n_tiles = -(-B // WS_ROWS), -(-V // FUSED_VERTS)
    cap = min(max(2, 4 * num_sms // n_bt), n_tiles)
    return _fewest_tile_times(n_bt, n_tiles, cap, num_sms)


def _ws_blocks(B: int, V: int, num_sms: int):
    """K2's fused kernel's (batch tiles, vertex ranges) as index pairs."""
    rows = [(b, min(B, b + WS_ROWS)) for b in range(0, B, WS_ROWS)]
    return rows, _ranges(V, ws_ranges(B, V, num_sms))


FWD_SIDE_ROWS = 32   # csrc/skin_fwd.cuh's kXR: 32 rows of one side, or 16 of two


def fwd_ranges(B: int, V: int, sides: int, num_sms: int) -> int:
    """The forward kernel's vertex ranges (csrc/skin_fwd.cuh: fwd_ranges)
    for K3f (sides=1) or K2's pair mode (sides=2): _fewest_tile_times over
    16-vertex tiles, up to 4 SMs / batch tiles ranges."""
    n_bt = -(-B // (FWD_SIDE_ROWS // sides))
    n_tiles = -(-V // FUSED_VERTS)
    cap = min(max(1, 4 * num_sms // n_bt), n_tiles)
    return _fewest_tile_times(n_bt, n_tiles, cap, num_sms)


def _ranges(V: int, R: int):
    """The vertex ranges [lo, hi) of R (csrc/skin_common.cuh:range_tiles)."""
    n_t = -(-V // FUSED_VERTS)
    cut = [min(V, r * n_t // R * FUSED_VERTS) for r in range(R + 1)]
    return list(zip(cut[:-1], cut[1:]))


def _posed_3xtf32(pf, posedirs_t, v_shaped_t) -> torch.Tensor:
    """vp (B, 3, V) with the posedirs contraction in 3xTF32."""
    B, V = pf.shape[0], v_shaped_t.shape[-1]
    pd2 = posedirs_t.reshape(NUM_POSE_FEATURES, 3 * V)
    return _mm_3xtf32(pf, pd2).reshape(B, 3, V) + v_shaped_t


def _posed_halves(pf, posedirs_t, v_shaped_t) -> torch.Tensor:
    """vp (B, 3, V) as K2's fused kernel sums it: the posedirs contraction
    in 3xTF32 over each of WS_HALVES' feature halves, the halves added in
    order, then v_shaped."""
    B, V = pf.shape[0], v_shaped_t.shape[-1]
    pd2 = posedirs_t.reshape(NUM_POSE_FEATURES, 3 * V)
    return _in_order([_mm_3xtf32(pf[:, lo:hi], pd2[lo:hi])
                      for lo, hi in zip(WS_HALVES[:-1], WS_HALVES[1:])]
                     ).reshape(B, 3, V) + v_shaped_t


def _split_grads(M4, vp, g, posedirs_t, W_t, rows, ranges) -> Grads:
    """(gpf, gA, gvsh) as the one-pass kernels form them from the blend M4
    (B, 3, 4, V), the posed vertices vp and the cotangent g: gvp in f32,
    gpf in 3xTF32, and the per-block partials (gpf and gA a vertex range of
    ``ranges``, gvsh a batch tile of ``rows``) summed in the kernels' fixed
    order."""
    B = g.shape[0]
    gvp = torch.einsum('bikv,biv->bkv', M4[:, :, :3], g)
    gM4 = torch.einsum('biv,bkv->bikv', g, _homogeneous(vp))
    gpf = _in_order([_mm_3xtf32(gvp[:, :, lo:hi].reshape(B, -1),
                                posedirs_t[:, :, lo:hi].reshape(
                                    NUM_POSE_FEATURES, -1).t())
                     for lo, hi in ranges])
    gA = _in_order([torch.einsum('bikv,jv->bjik', gM4[..., lo:hi],
                                 W_t[:, lo:hi]).reshape(B, NUM_JOINTS, 12)
                    for lo, hi in ranges])
    gvsh = _in_order([gvp[b0:b1].sum(0) for b0, b1 in rows])
    return gpf, gA, gvsh


def v2v_l1_split_emulation(pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r,
                           A_r, num_sms: int = 132
                           ) -> Tuple[torch.Tensor, Grads]:
    """(total, (gpf, gA, gvsh)) in the arithmetic of K2's fused kernel with
    f32 tables (csrc/v2v.cu: v2v_fused_kernel_ws): both sides' vp in
    3xTF32 by feature half (_posed_halves), gpf in 3xTF32, and the
    per-block partials of its
    blocks (16-row batch tiles x ws_ranges' ranges of 16-vertex tiles:
    |diff| a block, gpf and gA a range, gvsh a batch tile) summed in the
    kernel's fixed order. Nothing on the main path calls it: the tests hold
    it against the JAX kernel and v2v_l1_plain to show that the split and
    the reduction order stay inside the tolerances."""
    B, V = pf_o.shape[0], v_shaped_t.shape[-1]
    rows, ranges = _ws_blocks(B, V, num_sms)
    vp_o, M_o = _posed_halves(pf_o, posedirs_t, v_shaped_t), _blend(A_o, W_t)
    o = torch.einsum('bikv,bkv->biv', M_o, _homogeneous(vp_o))
    r = torch.einsum('bikv,bkv->biv', _blend(A_r, W_t),
                     _homogeneous(_posed_halves(pf_r, posedirs_t,
                                                v_shaped_t)))
    diff = r - o
    total = _in_order([diff[b0:b1, :, lo:hi].abs().sum()
                       for b0, b1 in rows for lo, hi in ranges])
    return total, _split_grads(M_o, vp_o, torch.sign(diff), posedirs_t, W_t,
                               rows, ranges)


def skin_bwd_split_emulation(pf, A34, v_shaped_t, posedirs_t, W_t, g,
                             vp: Optional[torch.Tensor] = None,
                             num_sms: int = 132) -> Grads:
    """(gpf, gA, gvsh) under the cotangent g (B, 3, V) in the one-pass K3b
    kernel's arithmetic: the posed vertices recomputed in 3xTF32 (or the
    stored ``vp`` read), gpf in 3xTF32, and the per-block partials summed in
    the kernel's fixed order. Nothing on the main path calls it: the tests
    hold it against the JAX kernel and skin_bwd_plain to show that the
    split and the reduction order stay inside the tolerances."""
    if vp is None:
        vp = _posed_3xtf32(pf, posedirs_t, v_shaped_t)
    B, V = g.shape[0], g.shape[-1]
    return _split_grads(_blend(A34, W_t), vp, g, posedirs_t, W_t,
                        *_blocks(B, V, num_sms))


def skin_fwd_split_emulation(pf, A34, v_shaped_t, posedirs_t, W_t
                             ) -> torch.Tensor:
    """verts_t (B, 3, V) in the forward kernel's arithmetic (K3f): the
    posed vertices in 3xTF32, the blend and the vertices in f32. Nothing on
    the main path calls it: the tests hold it against the JAX kernel and
    skin_verts_t_plain to show that the split stays inside the
    tolerances."""
    vph = _homogeneous(_posed_3xtf32(pf, posedirs_t, v_shaped_t))
    return torch.einsum('bikv,bkv->biv', _blend(A34, W_t), vph)


def v2v_pair_split_emulation(pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r,
                             A_r, want_vp: bool, num_sms: int = 132
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        Optional[torch.Tensor]]:
    """(total, sign, vp or None) in the forward kernel's arithmetic for
    K2's pair mode: both sides skinned as skin_fwd_split_emulation does,
    and the |diff| partials of its blocks (16-row batch tiles x
    fwd_ranges' vertex ranges) summed in block order. Nothing on the main
    path calls it (tests only, as skin_fwd_split_emulation)."""
    B, V = pf_o.shape[0], v_shaped_t.shape[-1]
    vp = _posed_3xtf32(pf_o, posedirs_t, v_shaped_t)
    o = torch.einsum('bikv,bkv->biv', _blend(A_o, W_t), _homogeneous(vp))
    r = skin_fwd_split_emulation(pf_r, A_r, v_shaped_t, posedirs_t, W_t)
    diff = r - o
    rows = FWD_SIDE_ROWS // 2
    total = _in_order([diff[b:b + rows, :, lo:hi].abs().sum()
                       for b in range(0, B, rows)
                       for lo, hi in _ranges(V, fwd_ranges(B, V, 2,
                                                           num_sms))])
    return total, torch.sign(diff), (vp if want_vp else None)


# skin_bwd_misrounded's variants: "pf" and "A" left in f32, "gm" and "gvp"
# not rounded before their contractions, "gvsh" summing the rounded gvp
MISROUNDINGS = ("pf", "A", "gm", "gvp", "gvsh")
# the most misrounding_shares may read for gradients that round where the
# plain version does, their f32 sums taken in another order
MISROUNDED_SHARE = 0.2


def skin_bwd_misrounded(pf, A34, v_shaped_t, posedirs_t, W_t, g,
                        vp: Optional[torch.Tensor], moved: str) -> Grads:
    """skin_bwd_plain with bf16 tables and one rounding point moved
    (MISROUNDINGS). Nothing on the main path calls it: the card tests hold
    each bf16 kernel much nearer skin_bwd_plain than to every variant that
    changes a gradient, so a kernel that rounds at another point than the
    TPU kernel does not pass."""
    if moved not in MISROUNDINGS or not is_bf16(posedirs_t):
        raise ValueError(f"moved {moved!r} with {posedirs_t.dtype} tables")
    return _skin_bwd(pf, A34, v_shaped_t, posedirs_t, W_t, g, vp, moved)


def misrounding_shares(got: Grads, pf, A34, v_shaped_t, posedirs_t, W_t, g,
                       vp: Optional[torch.Tensor] = None) -> dict:
    """{(moved, gradient name): ||got - plain|| / ||variant - plain||} for
    bf16 gradients ``got`` under the cotangent g, over every
    skin_bwd_misrounded variant that changes that gradient (one that leaves
    it bit-identical, as "pf" does with a stored vp, cannot tell the points
    apart). Frobenius norms: the rare bf16 flips where two f32 sums taken
    in other orders straddle a rounding boundary weigh little, a moved
    rounding point shifts every term. Tests only."""
    args = (pf, A34, v_shaped_t, posedirs_t, W_t, g)
    plain = skin_bwd_plain(*args, vp=vp)
    shares = {}
    for moved in MISROUNDINGS:
        variant = skin_bwd_misrounded(*args, vp, moved)
        for name, k, p, w in zip(("gpf", "gA", "gvsh"), got, plain, variant):
            dist = float((w - p).norm())
            if dist > 0:
                shares[moved, name] = float((k - p).norm()) / dist
    return shares


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/skin.cu, csrc/v2v.cu)
# ---------------------------------------------------------------------------

def _check_skin_inputs(pf, A34, v_shaped_t, posedirs_t, W_t, **extra):
    """Validate the shared operands (and ``extra`` (B, 3, V) tensors: a
    cotangent ``g`` in f32 or bf16, a stored ``vp`` in the tables' dtype);
    returns
    (B, V, device, the kernels' suffix: "" for f32 tables, BF16 for bf16
    ones)."""
    B = pf.shape[0]
    V = v_shaped_t.shape[-1]
    dev = pf.device
    P, J = NUM_POSE_FEATURES, NUM_JOINTS
    tables = posedirs_t.dtype
    if tables not in (torch.float32, torch.bfloat16):
        raise TypeError(f"posedirs_t: expected float32 or bfloat16 tables, "
                        f"got {tables}")
    f32 = torch.float32
    for name, t, shape, dtype in (
            ("pf", pf, (B, P), f32), ("A34", A34, (B, J, 12), f32),
            ("v_shaped_t", v_shaped_t, (3, V), f32),
            ("posedirs_t", posedirs_t, (P, 3, V), tables),
            ("W_t", W_t, (J, V), tables),
            *((k, t, (B, 3, V), tables if k == "vp" else
               t.dtype if t.dtype in MESH_DTYPES else f32)
              for k, t in extra.items())):
        _build.check_input(name, t, shape, dev, dtype)
    return B, V, dev, BF16 if is_bf16(posedirs_t) else ""


def _check_mesh_dtype(dtype: torch.dtype) -> None:
    if dtype not in MESH_DTYPES:
        raise TypeError(f"mesh dtype {dtype}: expected one of {MESH_DTYPES}")


def skin_fwd_cuda(pf, A34, v_shaped_t, posedirs_t, W_t,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch K3f (CUDA tensors only; f32 or bf16 tables): verts_t (B, 3,
    V) in out_dtype (bf16: the f32 vertices rounded to nearest even). A34
    must start on a 16-byte boundary and the tables, where V is even, on a
    boundary of two of their elements."""
    _check_mesh_dtype(out_dtype)
    B, V, dev, sfx = _check_skin_inputs(pf, A34, v_shaped_t, posedirs_t, W_t)
    _check_alignment("K3f", V, A34=A34, v_shaped_t=v_shaped_t,
                     posedirs_t=posedirs_t, W_t=W_t)
    mesh_bf16 = out_dtype == torch.bfloat16
    lib = _build.library()
    verts = torch.empty((B, 3, V), dtype=out_dtype, device=dev)
    with launch(LAUNCHES, "skin_fwd" + sfx + (IO_BF16 if mesh_bf16 else "")):
        err = getattr(lib, "nemo_skin_fwd" + sfx)(
            int(mesh_bf16), B, V, pf.data_ptr(), A34.data_ptr(),
            v_shaped_t.data_ptr(), posedirs_t.data_ptr(), W_t.data_ptr(),
            verts.data_ptr(), _build.stream_handle(dev))
        _build.check(err, "nemo_skin_fwd" + sfx)
    return verts


def _alignment(name: str, t: torch.Tensor, V: int) -> int:
    """The byte boundary the kernels read an operand at: A as float4, the
    tables (v_shaped_t, posedirs_t, W_t) two elements at a time where V is
    even (8 bytes in f32, 4 in bf16), the rest (pose features, cotangents,
    a stored vp) one element at a time."""
    if name.startswith("A"):
        return 16
    if name in ("v_shaped_t", "posedirs_t", "W_t"):
        return t.element_size() * (2 if V % 2 == 0 else 1)
    return t.element_size()


def _kernel_operands(names, args):
    """The public ops' operands as the kernels read them: each tensor
    itself when it is contiguous and aligned, else one aligned copy."""
    V = args[names.index("W_t")].shape[-1]
    return tuple(_build.kernel_operand(t, _alignment(n, t, V))
                 for n, t in zip(names, args))


def _check_alignment(kernel: str, V: int, **tensors):
    """A misaligned address would end the CUDA context, so refuse views the
    kernels cannot read (_alignment; a contiguous slice whose offset is not
    a multiple of 4 floats for A, of 2 elements for the tables)."""
    for name, t in tensors.items():
        align = _alignment(name, t, V)
        if t.data_ptr() % align:
            raise ValueError(f"{name} must start on a {align}-byte boundary "
                             f"for the {kernel} kernel")


def skin_bwd_cuda(pf, A34, v_shaped_t, posedirs_t, W_t, g,
                  vp: Optional[torch.Tensor] = None) -> Grads:
    """Launch K3b (CUDA tensors only; f32 or bf16 tables): (gpf, gA, gvsh)
    under the cotangent g (B, 3, V), recomputing the posed vertices or
    reading the stored ``vp`` (B, 3, V, in the tables' dtype). g is f32, or
    bf16 (the bf16 mesh's cotangent, read in bf16; no stored vp). One pass and
    a fixed-order reduction of its per-block partials (about 17.5 MB of
    scratch at (512, 6890) on 132 SMs); no (B, 3, V) tensor. g and vp may
    start on any boundary of one of their elements; A34 must start on a
    16-byte one and the tables, where V is even, on one of two elements."""
    extra = {"g": g} if vp is None else {"g": g, "vp": vp}
    B, V, dev, sfx = _check_skin_inputs(pf, A34, v_shaped_t, posedirs_t,
                                        W_t, **extra)
    _check_alignment("K3b", V, A34=A34, v_shaped_t=v_shaped_t,
                     posedirs_t=posedirs_t, W_t=W_t)
    mesh_bf16 = g.dtype == torch.bfloat16
    if mesh_bf16 and vp is not None:
        raise ValueError("K3b takes a bf16 cotangent only recomputing vp")
    lib = _build.library()
    n_scratch = lib.nemo_skin_bwd_scratch_floats(B, V)
    if n_scratch < 0:
        raise ValueError(f"nemo_skin_bwd refuses B={B}, V={V}")
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = torch.empty((n_scratch,), **f32)
    gpf = torch.empty((B, NUM_POSE_FEATURES), **f32)
    gA = torch.empty((B, NUM_JOINTS, 12), **f32)
    gvsh = torch.empty((3, V), **f32)
    key = (("skin_bwd" if vp is None else "skin_bwd_vp") + sfx
           + (IO_BF16 if mesh_bf16 else ""))
    with launch(LAUNCHES, key):
        err = getattr(lib, "nemo_skin_bwd" + sfx)(
            int(mesh_bf16), B, V, pf.data_ptr(), A34.data_ptr(),
            v_shaped_t.data_ptr(), posedirs_t.data_ptr(), W_t.data_ptr(),
            g.data_ptr(), None if vp is None else vp.data_ptr(),
            scratch.data_ptr(), gpf.data_ptr(), gA.data_ptr(),
            gvsh.data_ptr(), _build.stream_handle(dev))
        _build.check(err, "nemo_skin_bwd" + sfx)
    return gpf, gA, gvsh


def skin_fwd_attributes(pair: bool = False, bf16: bool = False,
                        io_bf16: bool = False) -> dict:
    """The forward kernel's registers a thread, shared memory and spills:
    K3f's instantiation, or (pair) K2's pair mode's; of the f32 or (bf16)
    the bf16 tables; (io_bf16) K3f's bf16-mesh one."""
    if io_bf16 and pair:
        raise ValueError("the pair mode writes no mesh")
    return _build.kernel_attributes(
        "nemo_skin_fwd_attributes" + (BF16 if bf16 else ""), 2 if pair else 1,
        int(io_bf16))


def skin_bwd_attributes(stored_vp: bool = False, bf16: bool = False,
                        io_bf16: bool = False) -> dict:
    """The one-pass K3b kernel's registers a thread, shared memory and
    spills, recomputing vp or (stored_vp) reading it; of the f32 or (bf16)
    the bf16 tables; (io_bf16) the bf16-cotangent one (recomputing vp)."""
    if io_bf16 and stored_vp:
        raise ValueError("K3b takes a bf16 cotangent only recomputing vp")
    return _build.kernel_attributes(
        "nemo_skin_bwd_attributes" + (BF16 if bf16 else ""),
        2 if stored_vp else 1, int(io_bf16))


def padded_posedirs(posedirs_t: torch.Tensor) -> torch.Tensor:
    """A copy of posedirs_t (207, 3, V) f32 as K2's fused kernel reads it:
    each row padded with zeros to a multiple of 16 vertices (FUSED_VERTS),
    so every 16-vertex tile of a row is one aligned 64-byte segment. Made
    once, at set-up, beside the table (SMPLModel.posedirs_pad; about 17 MB
    for SMPL)."""
    P, K, V = posedirs_t.shape
    pad = posedirs_t.new_zeros((P, K, -(-V // FUSED_VERTS) * FUSED_VERTS))
    pad[..., :V] = posedirs_t
    return pad


def _v2v_launch(pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r, A_r,
                mode: int, want_vp: bool, posedirs_pad=None):
    """One nemo_v2v_l1 call: mode 0 total, 1 fused grads, 2 pair. Returns
    (total, sign, vp, (gpf, gA, gvsh)), with None for what the mode skips.
    Modes 0 and 1 take only the per-block partials as scratch (mode 1:
    about 6.7 MB at B=512 and 258 MB at B=28200 on 132 SMs, f32 tables);
    no (B, 3, V) tensor. With f32 tables they read posedirs_pad
    (padded_posedirs of posedirs_t) in place of posedirs_t; None: one is
    made for this call."""
    B, V, dev, sfx = _check_skin_inputs(pf_o, A_o, v_shaped_t, posedirs_t,
                                        W_t)
    _check_skin_inputs(pf_r, A_r, v_shaped_t, posedirs_t, W_t)
    lib = _build.library()
    _check_alignment("K2", V, A_o=A_o, A_r=A_r, v_shaped_t=v_shaped_t,
                     posedirs_t=posedirs_t, W_t=W_t)
    pad_args = ()
    if not sfx:
        if mode < 2 and posedirs_pad is None:
            posedirs_pad = padded_posedirs(posedirs_t)
        if posedirs_pad is not None:
            if (posedirs_pad.shape[:2] != posedirs_t.shape[:2]
                    or posedirs_pad.dtype != torch.float32
                    or posedirs_pad.device != dev
                    or not posedirs_pad.is_contiguous()):
                raise ValueError("posedirs_pad must be padded_posedirs("
                                 "posedirs_t), on the tables' device")
            pad_args = (posedirs_pad.data_ptr(), posedirs_pad.shape[-1])
        else:
            pad_args = (None, 0)
    f32 = dict(dtype=torch.float32, device=dev)
    empty = lambda *shape, on=True: torch.empty(shape, **f32) if on else None
    n_scratch = getattr(lib, "nemo_v2v_scratch_floats" + sfx)(B, V, mode)
    if n_scratch < 0:
        raise ValueError(f"nemo_v2v_l1{sfx} refuses B={B}, V={V}")
    scratch = empty(n_scratch)
    total = empty()
    sign = empty(B, 3, V, on=mode == 2)
    vp = torch.empty((B, 3, V), dtype=posedirs_t.dtype, device=dev) \
        if mode == 2 and want_vp else None
    grads = (empty(B, NUM_POSE_FEATURES), empty(B, NUM_JOINTS, 12),
             empty(3, V)) if mode == 1 else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with launch(LAUNCHES, ("v2v_fwd", "v2v_grad", "v2v_pair")[mode] + sfx):
        err = getattr(lib, "nemo_v2v_l1" + sfx)(
            B, V, pf_o.data_ptr(), A_o.data_ptr(), pf_r.data_ptr(),
            A_r.data_ptr(), v_shaped_t.data_ptr(), posedirs_t.data_ptr(),
            W_t.data_ptr(), *pad_args, mode, scratch.data_ptr(), ptr(sign),
            ptr(vp),
            total.data_ptr(), *(ptr(t) for t in (grads or (None,) * 3)),
            _build.stream_handle(dev))
        _build.check(err, "nemo_v2v_l1" + sfx)
    return total, sign, vp, grads


def v2v_fused_attributes(bf16: bool = False) -> dict:
    """The fused K2 kernel's registers a thread, shared memory and spills;
    of the f32 or (bf16) the bf16 tables."""
    return _build.kernel_attributes(
        "nemo_v2v_fused_attributes" + (BF16 if bf16 else ""))


def v2v_l1_cuda(pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r, A_r,
                grad: bool, posedirs_pad: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Grads]]:
    """Launch K2 (CUDA tensors only): fused grad mode or total only.
    posedirs_pad: padded_posedirs(posedirs_t), made once by a caller that
    launches repeatedly; None (or bf16 tables): made for this call (or not
    needed)."""
    total, _, _, grads = _v2v_launch(pf_o, A_o, v_shaped_t, posedirs_t, W_t,
                                     pf_r, A_r, int(grad), want_vp=False,
                                     posedirs_pad=posedirs_pad)
    return total, grads


def v2v_pair_cuda(pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r, A_r,
                  want_vp: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Launch K2 in pair mode (CUDA tensors only): (total, sign, vp or
    None; vp in the tables' dtype), the counterpart of v2v_pair_plain."""
    total, sign, vp, _ = _v2v_launch(pf_o, A_o, v_shaped_t, posedirs_t, W_t,
                                     pf_r, A_r, 2, want_vp=want_vp)
    return total, sign, vp


# ---------------------------------------------------------------------------
# public ops
# ---------------------------------------------------------------------------

class SkinVertsT(torch.autograd.Function):
    """K3f forward, K3b backward (recomputing the posed vertices), the mesh
    and its cotangent in the dtype given last. A transposed or misaligned
    CUDA view is copied once before the kernels (_kernel_operands)."""

    @staticmethod
    def forward(ctx, pf, A34, v_shaped_t, posedirs_t, W_t, out_dtype):
        args = (pf, A34, v_shaped_t, posedirs_t, W_t)
        if _build.route(*args) == "cpu":
            ctx.save_for_backward(*args)
            return skin_verts_t_plain(*args).to(out_dtype)
        args = _kernel_operands(("pf", "A34", "v_shaped_t", "posedirs_t",
                                 "W_t"), args)
        ctx.save_for_backward(*args)
        return skin_fwd_cuda(*args, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        g = g.contiguous()
        if _build.route(*args, g) == "cpu":
            grads = skin_bwd_plain(*args, g.float())
        else:
            grads = skin_bwd_cuda(*args, g)
        return (*grads, None, None, None)


def skin_verts_t(V: int, pf: torch.Tensor, A34: torch.Tensor,
                 v_shaped_t: torch.Tensor, posedirs_t: torch.Tensor,
                 W_t: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Pose blend shapes + skinning, vertex-major: verts_t (B, 3, V).

    V: the vertex count (checked against the tables). pf: (B, 207) pose
    features; A34: (B, 24, 12) top three rows of the FK transforms;
    v_shaped_t (3, V); posedirs_t (207, 3, V) and W_t (24, V) are frozen
    tables. Gradients flow to pf, A34 and v_shaped_t. out_dtype: the
    mesh's (MESH_DTYPES; bf16 is the f32 mesh rounded to nearest even,
    the JAX package's NEMO_TPU_SKIN_IO_BF16), and so its cotangent's.
    """
    if v_shaped_t.shape[-1] != V or W_t.shape[-1] != V:
        raise ValueError(f"tables hold {W_t.shape[-1]} vertices, expected {V}")
    _check_mesh_dtype(out_dtype)
    return SkinVertsT.apply(pf, A34, v_shaped_t, posedirs_t, W_t, out_dtype)


class SkinV2VL1(torch.autograd.Function):
    """Fused mode saves (gpf, gA, gvsh) from the forward and the backward
    scales them; the pair modes save sign (and vp) and run K3b backward.
    A transposed or misaligned CUDA view is copied once before the
    kernels (_kernel_operands)."""

    @staticmethod
    def forward(ctx, vjp, pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r, A_r,
                posedirs_pad):
        grad = any(ctx.needs_input_grad[1:4])
        args = (pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r, A_r)
        cpu = _build.route(*args) == "cpu"
        if not cpu:
            args = _kernel_operands(("pf_o", "A_o", "v_shaped_t",
                                     "posedirs_t", "W_t", "pf_r", "A_r"),
                                    args)
        ctx.fused = vjp == "fused"
        if not grad or ctx.fused:
            total, grads = v2v_l1_plain(*args, grad=grad) if cpu else \
                v2v_l1_cuda(*args, grad=grad, posedirs_pad=posedirs_pad)
            if grad:
                ctx.save_for_backward(*grads)
            return total
        total, sign, vp = (v2v_pair_plain if cpu else v2v_pair_cuda)(
            *args, want_vp=vjp == "pair_vp")
        ctx.save_for_backward(*args[:5], sign, vp)
        return total

    @staticmethod
    def backward(ctx, ghat):
        if ctx.fused:
            gpf, gA, gvsh = ctx.saved_tensors
        else:
            *args, sign, vp = ctx.saved_tensors
            bwd = skin_bwd_plain if _build.route(*args) == "cpu" \
                else skin_bwd_cuda
            gpf, gA, gvsh = bwd(*args, sign, vp)
        s = -ghat
        return None, gpf * s, gA * s, gvsh * s, None, None, None, None, None


def skin_v2v_l1(V: int, pf_o: torch.Tensor, A_o: torch.Tensor,
                v_shaped_t: torch.Tensor, posedirs_t: torch.Tensor,
                W_t: torch.Tensor, pf_r: torch.Tensor,
                A_r: torch.Tensor, vjp: str = "fused",
                posedirs_pad: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum |skin(pf_r, A_r) - skin(pf_o, A_o)| (a 0-d tensor).

    V: the vertex count (checked against the tables). pf_*: (B, 207) pose
    features; A_*: (B, 24, 12) top three rows of the FK transforms.
    Gradients flow to pf_o, A_o and v_shaped_t only. vjp: "fused" (one K2
    call computes the loss and the gradients), "pair" (K2 stores the sign,
    K3b computes the gradients in the backward) or "pair_vp" (K2 also
    stores the posed vertices, and K3b reads them instead of recomputing).
    posedirs_pad: the table's padded_posedirs copy, which the "fused" mode
    and the undifferentiated call read with f32 tables on the card, made
    once at set-up (SMPLModel.posedirs_pad); None: made for each call.
    """
    if vjp not in VJP_MODES:
        raise ValueError(f"vjp {vjp!r}: expected one of {VJP_MODES}")
    if v_shaped_t.shape[-1] != V or W_t.shape[-1] != V:
        raise ValueError(f"tables hold {W_t.shape[-1]} vertices, expected {V}")
    return SkinV2VL1.apply(vjp, pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r,
                           A_r, posedirs_pad)
