"""The VPoser v2v-L1 skinning prior: kernel K2 (grad and forward-only modes).

Replaces nemo_tpu/ops/lbs_pallas.py ``skin_v2v_l1``: in grad mode
``_v2v_fwdbwd_pallas`` (``_v2v_fwdbwd_kernel``), in forward-only mode the
total that ``_v2v_fwd_pallas`` computes for the undifferentiated call in
``eval_loss``.

``skin_v2v_l1`` returns sum |skin(pf_r, A_r) - skin(pf_o, A_o)| without
building either mesh. The rec side is a constant (zero gradient), as in the
reference's detached reconstruction. When any of pf_o, A_o, v_shaped_t needs
a gradient, the forward computes the orig-side gradients under the raw
cotangent sign(rec - orig) in the same call and the backward only scales them
by -ghat, exactly like the TPU kernel's ``_v2v_fwd``/``_v2v_bwd``.

Layouts are the logical vertex-major tables: posedirs_t (207, 3, V),
W_t (24, V), v_shaped_t (3, V). On a CUDA tensor the wrapper launches
``csrc/v2v.cu``: f32 arithmetic on the CUDA cores bounds it on the H100
(~19.5 GFLOP per grad-mode call at B=512, V=6890, 13 of them forward; the
17 MB posedirs table sits in L2). Its tile kernel keeps both skinnings in registers and shares
the table loads between them; second-pass kernels reduce the gradients
across tiles in a fixed order (no atomics). The source note there has the
details. On a CPU tensor the wrapper runs the plain versions below, which
mirror ``_skin_verts_t_xla`` and ``_bwd_xla``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

NUM_POSE_FEATURES = 207
NUM_JOINTS = 24

LAUNCHES = {"v2v_grad": 0, "v2v_fwd": 0}

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path and the kernel's reference)
# ---------------------------------------------------------------------------

def skin_verts_t_plain(pf, A34, v_shaped_t, posedirs_t, W_t) -> torch.Tensor:
    """verts_t (B, 3, V) from pf (B, 207), A34 (B, 24, 12), v_shaped_t
    (3, V), posedirs_t (207, 3, V), W_t (24, V)."""
    B = pf.shape[0]
    V = v_shaped_t.shape[-1]
    vposed = torch.einsum('bp,pkv->bkv', pf, posedirs_t) + v_shaped_t
    vph = torch.cat([vposed, vposed.new_ones((B, 1, V))], dim=1)
    M4 = torch.einsum('bjl,jv->blv', A34, W_t).reshape(B, 3, 4, V)
    return torch.einsum('bikv,bkv->biv', M4, vph)


def skin_bwd_plain(pf, A34, v_shaped_t, posedirs_t, W_t, g) -> Grads:
    """(gpf, gA, gvsh) of skin_verts_t_plain under the cotangent g (B,3,V)."""
    B = pf.shape[0]
    vposed = torch.einsum('bp,pkv->bkv', pf, posedirs_t) + v_shaped_t
    vph = torch.cat([vposed, vposed.new_ones((B, 1, vposed.shape[-1]))], dim=1)
    M4 = torch.einsum('bjl,jv->blv', A34, W_t).reshape(B, 3, 4, -1)
    gM4 = torch.einsum('biv,bkv->bikv', g, vph)
    ga = torch.einsum('bikv,jv->bjik', gM4, W_t).reshape(B, NUM_JOINTS, 12)
    gvposed = torch.einsum('bikv,biv->bkv', M4[:, :, :3], g)
    gpf = torch.einsum('bkv,pkv->bp', gvposed, posedirs_t)
    gvsh = gvposed.sum(dim=0)
    return gpf, ga, gvsh


def v2v_l1_plain(pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r, A_r,
                 grad: bool) -> Tuple[torch.Tensor, Optional[Grads]]:
    """(total, orig-side grads under sign(rec - orig) or None)."""
    o = skin_verts_t_plain(pf_o, A_o, v_shaped_t, posedirs_t, W_t)
    r = skin_verts_t_plain(pf_r, A_r, v_shaped_t, posedirs_t, W_t)
    diff = r - o
    total = diff.abs().sum()
    if not grad:
        return total, None
    return total, skin_bwd_plain(pf_o, A_o, v_shaped_t, posedirs_t, W_t,
                                 torch.sign(diff))


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/v2v.cu)
# ---------------------------------------------------------------------------

def v2v_l1_cuda(pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r, A_r,
                grad: bool) -> Tuple[torch.Tensor, Optional[Grads]]:
    """Launch K2 (CUDA tensors only): grad mode or forward-only mode."""
    B = pf_o.shape[0]
    V = v_shaped_t.shape[-1]
    dev = pf_o.device
    P, J = NUM_POSE_FEATURES, NUM_JOINTS
    for name, t, shape in (("pf_o", pf_o, (B, P)), ("A_o", A_o, (B, J, 12)),
                           ("pf_r", pf_r, (B, P)), ("A_r", A_r, (B, J, 12)),
                           ("v_shaped_t", v_shaped_t, (3, V)),
                           ("posedirs_t", posedirs_t, (P, 3, V)),
                           ("W_t", W_t, (J, V))):
        _build.check_input(name, t, shape, dev)
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=dev)
    partial = torch.empty(lib.nemo_v2v_num_partials(B, V), **f32)
    total = torch.empty((), **f32)
    if grad:
        sign, vp, gvp = (torch.empty((B, 3, V), **f32) for _ in range(3))
        gpf = torch.empty((B, P), **f32)
        gA = torch.empty((B, J, 12), **f32)
        gvsh = torch.empty((3, V), **f32)
        ptrs = [t.data_ptr() for t in (sign, vp, gvp, total, gpf, gA, gvsh)]
    else:
        ptrs = [None, None, None, total.data_ptr(), None, None, None]
    err = lib.nemo_v2v_l1(B, V, pf_o.data_ptr(), A_o.data_ptr(),
                          pf_r.data_ptr(), A_r.data_ptr(),
                          v_shaped_t.data_ptr(), posedirs_t.data_ptr(),
                          W_t.data_ptr(), int(grad), partial.data_ptr(),
                          *ptrs, _build.stream_handle(dev))
    _build.check(err, "nemo_v2v_l1")
    LAUNCHES["v2v_grad" if grad else "v2v_fwd"] += 1
    return total, ((gpf, gA, gvsh) if grad else None)


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

class SkinV2VL1(torch.autograd.Function):
    """Grad mode saves (gpf, gA, gvsh) from the forward; backward scales."""

    @staticmethod
    def forward(ctx, pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r, A_r):
        grad = any(ctx.needs_input_grad[:3])
        args = (pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r, A_r)
        if _build.route(*args) == "cpu":
            total, grads = v2v_l1_plain(*args, grad=grad)
        else:
            total, grads = v2v_l1_cuda(*args, grad=grad)
        if grad:
            ctx.save_for_backward(*grads)
        return total

    @staticmethod
    def backward(ctx, ghat):
        gpf, gA, gvsh = ctx.saved_tensors
        s = -ghat
        return gpf * s, gA * s, gvsh * s, None, None, None, None


def skin_v2v_l1(V: int, pf_o: torch.Tensor, A_o: torch.Tensor,
                v_shaped_t: torch.Tensor, posedirs_t: torch.Tensor,
                W_t: torch.Tensor, pf_r: torch.Tensor,
                A_r: torch.Tensor) -> torch.Tensor:
    """sum |skin(pf_r, A_r) - skin(pf_o, A_o)| (a 0-d tensor).

    V: the vertex count (checked against the tables). pf_*: (B, 207) pose
    features; A_*: (B, 24, 12) top three rows of the FK transforms.
    Gradients flow to pf_o, A_o and v_shaped_t only.
    """
    if v_shaped_t.shape[-1] != V or W_t.shape[-1] != V:
        raise ValueError(f"tables hold {W_t.shape[-1]} vertices, expected {V}")
    return SkinV2VL1.apply(pf_o, A_o, v_shaped_t, posedirs_t, W_t, pf_r, A_r)
