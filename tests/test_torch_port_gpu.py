"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so these tests skip on a machine without a
GPU. Run them on one (the repository's conftest imports jax, which the GPU
machine need not have, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_port_gpu.py

Shapes are small and ragged (B and V not multiples of the kernels' tiles)
so the edge masking is exercised; chip_smoke.py checks the full-width shapes.
Tolerances: f32 sums over 207 pose features, 24 joints and up to 3V
vertex terms taken in another order than the plain version's; 1e-5 (values)
or 1e-4 (gradients) of the tensor's largest entry. The rasterizer (K5s,
K5g) and the chamfer (K4) round every operation as their plain versions do:
their outputs must be identical.
"""

import numpy as np
import pytest
import torch

import torch_chamfer_cases as chamfer_cases
import torch_raster_cases as raster_cases
from nemo_tpu_torch.body.constants import SMPL_PARENTS
from nemo_tpu_torch.ops import fk, lbs, launch_counts, reset_launches

pytestmark = pytest.mark.gpu
PARENTS = tuple(int(p) for p in SMPL_PARENTS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rot(gen, B, J):
    from nemo_tpu_torch.geometry.rotations import batch_rodrigues
    return batch_rodrigues(0.7 * torch.randn((B, J, 3), generator=gen))


_RNG = np.random.RandomState(64)
FK_TREES = {"smpl": PARENTS, "chain": (-1,) + tuple(range(23)),
            "star": (-1,) + (0,) * 23,
            "random64": (-1,) + tuple(int(_RNG.randint(0, j))
                                      for j in range(1, 64))}


def _fk_inputs(B, J, seed, cuda):
    gen = torch.Generator().manual_seed(seed)
    return (_rot(gen, B, J).to(cuda),
            torch.randn((B, J, 3), generator=gen).to(cuda),
            torch.randn((B, J, 3, 3), generator=gen).to(cuda),
            torch.randn((B, J, 3), generator=gen).to(cuda))


@pytest.mark.parametrize("tree", sorted(FK_TREES))
@pytest.mark.parametrize("B", [1, 37, 60, 300, 512, 960])
def test_fk_kernels_match_plain(cuda, B, tree):
    """K1f and K1b against the plain versions (1e-5 / 1e-4 absolute, as
    chip_smoke.py holds them) on SMPL, a 23-deep chain, a star and a random
    64-joint tree; a rerun gives the same bits (no atomics)."""
    parents = FK_TREES[tree]
    R, t, gR, gt = _fk_inputs(B, len(parents), B, cuda)
    Rk, tk = fk.fk_fwd_cuda(R, t, parents)
    Rp, tp = fk.fk_fwd_plain(R, t, parents)
    torch.testing.assert_close(Rk, Rp, atol=1e-5, rtol=0)
    torch.testing.assert_close(tk, tp, atol=1e-5, rtol=0)
    gRk, gtk = fk.fk_bwd_cuda(R, t, Rk, gR, gt, parents)
    gRp, gtp = fk.fk_bwd_plain(R, t, Rp, gR, gt, parents)
    torch.testing.assert_close(gRk, gRp, atol=1e-4, rtol=0)
    torch.testing.assert_close(gtk, gtp, atol=1e-4, rtol=0)
    again = fk.fk_fwd_cuda(R, t, parents) + fk.fk_bwd_cuda(R, t, Rk, gR, gt,
                                                           parents)
    assert all(torch.equal(a, b) for a, b in zip(again, (Rk, tk, gRk, gtk)))


def test_fk_kernel_resources(cuda):
    """Both K1 kernels: no spills, and the shared memory of a 64-joint
    tree's tile within the 48 KB a block gets without opting in."""
    for backward in (False, True):
        for J in (24, 64):
            res = fk.fk_attributes(backward, J)
            assert res["local_bytes"] == 0, res
            assert 0 < res["registers"] <= 255, res
            assert res["static_smem_bytes"] + res["dynamic_smem_bytes"] \
                <= 48 * 1024, res


def test_fk_bwd_allocates_no_scratch(cuda):
    """K1b keeps its accumulators on-chip: a call allocates its two
    outputs and nothing else."""
    R, t, gR, gt = _fk_inputs(512, 24, 3, cuda)
    Rg, _ = fk.fk_fwd_cuda(R, t, PARENTS)
    fk.fk_bwd_cuda(R, t, Rg, gR, gt, PARENTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    out = fk.fk_bwd_cuda(R, t, Rg, gR, gt, PARENTS)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) - before == \
        sum(o.untyped_storage().nbytes() for o in out)


def test_fk_kernels_refuse_what_they_cannot_take(cuda):
    """More than 64 joints, or an empty batch: the launch is refused."""
    parents = (-1,) + tuple(range(64))
    R, t, gR, gt = _fk_inputs(2, 65, 4, cuda)
    with pytest.raises(RuntimeError, match="nemo_fk_fwd"):
        fk.fk_fwd_cuda(R, t, parents)
    with pytest.raises(RuntimeError, match="nemo_fk_bwd"):
        fk.fk_bwd_cuda(R, t, R, gR, gt, parents)
    R, t, gR, gt = _fk_inputs(0, 24, 4, cuda)
    with pytest.raises(RuntimeError, match="nemo_fk_fwd"):
        fk.fk_fwd_cuda(R, t, PARENTS)


@pytest.mark.parametrize("V", [5, 300, 1000, 6890])
@pytest.mark.parametrize("B", [1, 37, 70, 300, 960])
def test_v2v_kernel_matches_plain(cuda, B, V):
    """K2's fused kernel (modes 0 and 1) against the plain version at
    ragged shapes: B not a multiple of the 16-row batch tile, V leaving the
    last 16-vertex tile and the last vertex range partial; a second run
    bit-identical (fixed-order partials, no atomics); the forward-only
    total equal to the fused one bit for bit."""
    _v2v_kernel_matches_plain(cuda, B, V)


@pytest.mark.parametrize("B", [3000, 4224])
def test_v2v_kernel_matches_plain_at_long_ranges(cuda, B):
    """The same where each block walks as many vertex tiles as at the
    benchmark cell's 28200 rows (3000: lbs.ws_ranges gives 2 ranges of 431
    tiles, as there) or all of them (4224: one range), so the tables' ring
    and the double buffers turn over hundreds of times."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert lbs.ws_ranges(B, 6890, sms) == (2 if B == 3000 else 1)
    _v2v_kernel_matches_plain(cuda, B, 6890)


def _v2v_kernel_matches_plain(cuda, B, V):
    gen = torch.Generator().manual_seed(V)
    f = lambda *s: torch.randn(s, generator=gen)
    pf_o, pf_r = 0.1 * f(B, 207), 0.1 * f(B, 207)
    A_o, A_r = f(B, 24, 12), f(B, 24, 12)
    A_r.view(B, 24, 3, 4)[..., 3] += 10.0 * torch.sign(f(B, 1, 3))
    W = torch.rand((24, V), generator=gen)
    W = W / W.sum(0, keepdim=True)
    args = [x.to(cuda).contiguous() for x in
            (pf_o, A_o, f(3, V), 0.01 * f(207, 3, V), W, pf_r, A_r)]
    pad = lbs.padded_posedirs(args[3])
    tot_k, gk = lbs.v2v_l1_cuda(*args, grad=True, posedirs_pad=pad)
    tot_p, gp = lbs.v2v_l1_plain(*args, grad=True)
    tot_f, none = lbs.v2v_l1_cuda(*args, grad=False, posedirs_pad=pad)
    assert none is None
    torch.testing.assert_close(tot_k, tot_p, rtol=1e-5, atol=0)
    assert torch.equal(tot_f, tot_k)
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    tot_2, g2 = lbs.v2v_l1_cuda(*args, grad=True)   # a pad of its own
    assert torch.equal(tot_2, tot_k)
    assert all(torch.equal(a, b) for a, b in zip(g2, gk))


def test_v2v_fused_kernel_reads_the_padded_table_it_is_given(cuda):
    """Modes 0 and 1 read posedirs_pad at its own row pitch: a copy padded
    16 vertices wider gives the same bits; one of another shape or device,
    or a pitch the kernel's 16-byte copies cannot take, is refused."""
    from nemo_tpu_torch.ops import _build
    B, V = 37, 300
    gen = torch.Generator().manual_seed(2)
    f = lambda *s: torch.randn(s, generator=gen).to(cuda)
    W = torch.rand((24, V), generator=gen)
    args = (0.1 * f(B, 207), f(B, 24, 12), f(3, V), 0.01 * f(207, 3, V),
            (W / W.sum(0, keepdim=True)).to(cuda), 0.1 * f(B, 207),
            f(B, 24, 12))
    pad = lbs.padded_posedirs(args[3])
    wide = torch.zeros((207, 3, pad.shape[-1] + 16), device=cuda)
    wide[..., :V] = args[3]
    for grad in (False, True):
        tot, g = lbs.v2v_l1_cuda(*args, grad=grad, posedirs_pad=pad)
        tot_w, g_w = lbs.v2v_l1_cuda(*args, grad=grad, posedirs_pad=wide)
        assert torch.equal(tot_w, tot)
        assert g is None or all(torch.equal(a, b) for a, b in zip(g_w, g))
        for bad in (pad[:100], pad.cpu(), pad.double()):
            with pytest.raises(ValueError, match="posedirs_pad"):
                lbs.v2v_l1_cuda(*args, grad=grad, posedirs_pad=bad)
    lib = _build.library()
    f32 = lambda *s: torch.empty(s, device=cuda)
    out = [f32(1), f32(B, 207), f32(B, 24, 12), f32(3, V)]
    scratch = f32(lib.nemo_v2v_scratch_floats(B, V, 1))
    for ldv in (V, pad.shape[-1] - 16, pad.shape[-1] + 2):
        err = lib.nemo_v2v_l1(
            B, V, *(args[i].data_ptr() for i in (0, 1, 5, 6, 2, 3, 4)),
            pad.data_ptr(), ldv, 1, scratch.data_ptr(), None, None,
            *(t.data_ptr() for t in out), _build.stream_handle(cuda))
        assert err != 0, ldv


def test_v2v_fused_kernel_scratch_and_resources(cuda):
    """K2's fused mode at B=512, V=6890 allocates only its per-block
    partials (well under one (B, 3, V) f32 tensor's 42 MB, and under
    32 MB), and the one-pass kernel spills nothing."""
    B, V = 512, 6890
    gen = torch.Generator().manual_seed(0)
    f = lambda *s: torch.randn(s, generator=gen).to(cuda)
    W = torch.rand((24, V), generator=gen)
    args = (0.1 * f(B, 207), f(B, 24, 12), f(3, V), 0.01 * f(207, 3, V),
            (W / W.sum(0, keepdim=True)).to(cuda), 0.1 * f(B, 207),
            f(B, 24, 12))
    lbs.v2v_l1_cuda(*args, grad=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    total, grads = lbs.v2v_l1_cuda(*args, grad=True)
    torch.cuda.synchronize()
    outputs = 4 * (1 + B * 207 + B * 288 + 3 * V)
    scratch = torch.cuda.max_memory_allocated() - base - outputs
    assert scratch < 32e6 and scratch < 4 * B * 3 * V
    res = lbs.v2v_fused_attributes()
    assert res["local_bytes"] == 0, res
    assert res["dynamic_smem_bytes"] <= 232448, res


@pytest.mark.parametrize("B,V", [(1, 5), (37, 300), (512, 6890), (960, 6890),
                                 (4096, 100)])
def test_v2v_fused_ranges_match_kernel(cuda, B, V):
    """lbs.ws_ranges, which the CPU emulation of K2's reduction order uses,
    gives the f32 kernel's own ranges, and lbs.fused_ranges the bf16
    kernel's: the scratch the library asks for in modes 0 and 1 follows
    from them."""
    from nemo_tpu_torch.ops import _build
    lib = _build.library()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for fn, R, rows in (
            (lib.nemo_v2v_scratch_floats, lbs.ws_ranges(B, V, sms),
             lbs.WS_ROWS),
            (lib.nemo_v2v_scratch_floats_bf16, lbs.fused_ranges(B, V, sms),
             lbs.FUSED_ROWS)):
        n_bt = -(-B // rows)
        assert fn(B, V, 0) == n_bt * R
        assert fn(B, V, 1) == n_bt * R + R * B * (207 + 24 * 12) + \
            n_bt * 3 * V


@pytest.mark.parametrize("name", ["A_o", "A_r", "posedirs_t", "W_t",
                                  "v_shaped_t"])
def test_v2v_fused_kernel_refuses_misaligned_views(cuda, name):
    """A contiguous view of A off a 16-byte boundary, or of a table off an
    8-byte one (V even), raises ValueError instead of reaching the kernel's
    vector loads; the context stays usable."""
    B, V = 37, 300
    gen = torch.Generator().manual_seed(1)
    W = torch.rand((24, V), generator=gen)
    args = dict(pf_o=0.1 * torch.randn((B, 207), generator=gen),
                A_o=torch.randn((B, 24, 12), generator=gen),
                v_shaped_t=torch.randn((3, V), generator=gen),
                posedirs_t=0.01 * torch.randn((207, 3, V), generator=gen),
                W_t=W / W.sum(0, keepdim=True),
                pf_r=0.1 * torch.randn((B, 207), generator=gen),
                A_r=torch.randn((B, 24, 12), generator=gen))
    args = {k: v.to(cuda) for k, v in args.items()}
    t = args[name]
    shifted = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 8 == 4
    for grad in (False, True):
        with pytest.raises(ValueError, match="boundary"):
            lbs.v2v_l1_cuda(**{**args, name: shifted}, grad=grad)
    total, _ = lbs.v2v_l1_cuda(**args, grad=False)
    torch.testing.assert_close(total, lbs.v2v_l1_plain(**args, grad=False)[0],
                               rtol=1e-5, atol=0)


def _skin_args(B, V, cuda, seed):
    gen = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=gen)
    W = torch.rand((24, V), generator=gen)
    W = W / W.sum(0, keepdim=True)
    args = [x.to(cuda).contiguous() for x in
            (0.1 * f(B, 207), f(B, 24, 12), f(3, V), 0.01 * f(207, 3, V), W)]
    return args, f(B, 3, V).to(cuda)


def _close_scaled(a, b, rel):
    torch.testing.assert_close(a, b, rtol=0,
                               atol=rel * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("B,V", [(1, 5), (37, 300), (300, 1000), (512, 6890),
                                 (960, 1024)])
def test_skin_kernels_match_plain(cuda, B, V):
    """K3f, and K3b recomputing vp and reading a stored vp, under a random
    (not +-1) cotangent, at ragged shapes and at the paths' (512, 6890) and
    (960, 1024); K3b's second run bit-identical (fixed-order partials, no
    atomics)."""
    args, g = _skin_args(B, V, cuda, seed=B + V)
    _close_scaled(lbs.skin_fwd_cuda(*args), lbs.skin_verts_t_plain(*args),
                  1e-5)
    want = lbs.skin_bwd_plain(*args, g)
    vp = (torch.einsum('bp,pkv->bkv', args[0], args[3]) + args[2]).contiguous()
    for stored in (None, vp):
        got = lbs.skin_bwd_cuda(*args, g, vp=stored)
        for a, b in zip(got, want):
            _close_scaled(a, b, 1e-4)
        again = lbs.skin_bwd_cuda(*args, g, vp=stored)
        assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_skin_bwd_scratch_and_resources(cuda):
    """K3b at (512, 6890) allocates only its per-block partials (under
    32 MB, well under one (B, 3, V) f32 tensor's 42 MB), and the one-pass
    kernel fits one block an SM in both modes without spilling."""
    B, V = 512, 6890
    args, g = _skin_args(B, V, cuda, seed=0)
    vp = (torch.einsum('bp,pkv->bkv', args[0], args[3]) + args[2]).contiguous()
    for stored in (None, vp):
        lbs.skin_bwd_cuda(*args, g, vp=stored)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lbs.skin_bwd_cuda(*args, g, vp=stored)
        torch.cuda.synchronize()
        outputs = 4 * (B * 207 + B * 288 + 3 * V)
        scratch = torch.cuda.max_memory_allocated() - base - outputs
        assert scratch < 32e6 and scratch < 4 * B * 3 * V
    for stored_vp in (False, True):
        res = lbs.skin_bwd_attributes(stored_vp)
        assert res["local_bytes"] == 0, res
        assert 0 < res["registers"] <= 255, res
        smem = res["static_smem_bytes"] + res["dynamic_smem_bytes"]
        assert smem <= 232448, res


@pytest.mark.parametrize("B,V", [(1, 5), (37, 300), (512, 6890), (960, 1024),
                                 (4096, 100)])
def test_skin_bwd_scratch_follows_fused_ranges(cuda, B, V):
    """K3b's scratch is the per-block partials of lbs.fused_ranges' vertex
    ranges, the rule its CPU emulation uses."""
    from nemo_tpu_torch.ops import _build
    lib = _build.library()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    R = lbs.fused_ranges(B, V, sms)
    n_bt = -(-B // lbs.FUSED_ROWS)
    assert lib.nemo_skin_bwd_scratch_floats(B, V) == \
        R * B * (207 + 24 * 12) + n_bt * 3 * V


@pytest.mark.parametrize("name", ["A34", "posedirs_t", "W_t", "v_shaped_t"])
def test_skin_bwd_refuses_misaligned_views(cuda, name):
    """A contiguous view of A34 off a 16-byte boundary, or of a table off an
    8-byte one (V even), raises ValueError instead of reaching the
    kernel's vector loads; the context stays usable."""
    args, g = _skin_args(37, 300, cuda, seed=2)
    names = ("pf", "A34", "v_shaped_t", "posedirs_t", "W_t")
    kw = dict(zip(names, args))
    t = kw[name]
    shifted = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 8 == 4
    for vp in (None, torch.zeros_like(g)):
        with pytest.raises(ValueError, match="boundary"):
            lbs.skin_bwd_cuda(**{**kw, name: shifted}, g=g, vp=vp)
    for a, b in zip(lbs.skin_bwd_cuda(*args, g), lbs.skin_bwd_plain(*args, g)):
        _close_scaled(a, b, 1e-4)


@pytest.mark.parametrize("V", [300, 301])
def test_skin_bwd_takes_offset_cotangent(cuda, V):
    """A cotangent (and a stored vp) starting 4 bytes off an 8-byte
    boundary is taken, copied 4 bytes at a time, and matches the plain
    version."""
    args, g = _skin_args(37, V, cuda, seed=V)
    vp = torch.einsum('bp,pkv->bkv', args[0], args[3]) + args[2]

    def offset(t):
        out = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 8 == 4
        return out
    for stored in (None, vp):
        want = lbs.skin_bwd_plain(*args, g, vp=stored)
        got = lbs.skin_bwd_cuda(*args, offset(g),
                                vp=None if stored is None else offset(stored))
        for a, b in zip(got, want):
            _close_scaled(a, b, 1e-4)


@pytest.mark.parametrize("B,V", [(1, 5), (37, 300), (300, 1000)])
def test_v2v_pair_mode_matches_plain(cuda, B, V):
    """K2 pair mode: sign (exact, the rec side offset by +-10 m), vp, total,
    and the gradients K3b computes from them against the fused mode."""
    args, _ = _skin_args(B, V, cuda, seed=V)
    gen = torch.Generator().manual_seed(B)
    pf_r = (0.1 * torch.randn((B, 207), generator=gen)).to(cuda)
    A_r = torch.randn((B, 24, 12), generator=gen)
    A_r.view(B, 24, 3, 4)[..., 3] += 10.0 * torch.sign(
        torch.randn((B, 1, 3), generator=gen))
    full = args + [pf_r, A_r.to(cuda).contiguous()]
    tot_k, sign_k, vp_k = lbs.v2v_pair_cuda(*full, want_vp=True)
    tot_p, sign_p, vp_p = lbs.v2v_pair_plain(*full, want_vp=True)
    torch.testing.assert_close(tot_k, tot_p, rtol=1e-5, atol=0)
    assert torch.equal(sign_k, sign_p)
    _close_scaled(vp_k, vp_p, 1e-5)
    tot_n, sign_n, none = lbs.v2v_pair_cuda(*full, want_vp=False)
    assert none is None and torch.equal(sign_n, sign_k)
    assert torch.equal(tot_n, tot_k)
    _, fused = lbs.v2v_l1_cuda(*full, grad=True)
    for got in (lbs.skin_bwd_cuda(*args, sign_k),
                lbs.skin_bwd_cuda(*args, sign_k, vp=vp_k)):
        for a, b in zip(got, fused):
            _close_scaled(a, b, 1e-5)


def _pair_args(B, V, cuda, seed):
    """K2 pair-mode inputs: _skin_args' orig side and a rec side offset by
    +-10 m, so every sign is exact."""
    args, _ = _skin_args(B, V, cuda, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    A_r = torch.randn((B, 24, 12), generator=gen)
    A_r.view(B, 24, 3, 4)[..., 3] += 10.0 * torch.sign(
        torch.randn((B, 1, 3), generator=gen))
    pf_r = (0.1 * torch.randn((B, 207), generator=gen)).to(cuda)
    return args, args + [pf_r, A_r.to(cuda).contiguous()]


@pytest.mark.parametrize("V", [5, 300, 1024, 6890])
@pytest.mark.parametrize("B", [1, 37, 512, 960])
def test_skin_fwd_kernel_matches_plain(cuda, B, V):
    """The one-pass forward kernel, K3f and the pair mode, against the
    plain versions at ragged shapes (B off the 32- and 16-row batch tiles,
    V off the 16-vertex tile, odd V copied 4 bytes at a time): vertices and
    vp within 1e-5 of the largest entry, the total within rtol 1e-5, the
    sign exact; a second run bit-identical, and the pair mode without vp
    giving the same total and sign."""
    args, full = _pair_args(B, V, cuda, seed=B + V)
    out = lbs.skin_fwd_cuda(*args)
    _close_scaled(out, lbs.skin_verts_t_plain(*args), 1e-5)
    assert torch.equal(lbs.skin_fwd_cuda(*args), out)
    got = lbs.v2v_pair_cuda(*full, want_vp=True)
    tot_p, sign_p, vp_p = lbs.v2v_pair_plain(*full, want_vp=True)
    torch.testing.assert_close(got[0], tot_p, rtol=1e-5, atol=0)
    assert torch.equal(got[1], sign_p)
    _close_scaled(got[2], vp_p, 1e-5)
    again = lbs.v2v_pair_cuda(*full, want_vp=True)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    tot_n, sign_n, none = lbs.v2v_pair_cuda(*full, want_vp=False)
    assert none is None and torch.equal(tot_n, got[0])
    assert torch.equal(sign_n, got[1])


@pytest.mark.parametrize("name", ["A34", "posedirs_t", "W_t", "v_shaped_t"])
def test_skin_fwd_refuses_misaligned_views(cuda, name):
    """K3f and the pair mode read A as float4 and copy the tables 8 bytes at
    a time (V even): a contiguous view of A34 (or A_o, A_r) off a 16-byte
    boundary, or of a table off an 8-byte one, raises ValueError instead of
    reaching the kernel; the context stays usable."""
    args, full = _pair_args(37, 300, cuda, seed=3)
    names = ("pf", "A34", "v_shaped_t", "posedirs_t", "W_t")
    kw = dict(zip(names, args))

    def shifted(t):
        out = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 8 == 4
        return out
    with pytest.raises(ValueError, match="boundary"):
        lbs.skin_fwd_cuda(**{**kw, name: shifted(kw[name])})
    pair_names = ("pf_o", "A_o", "v_shaped_t", "posedirs_t", "W_t", "pf_r",
                  "A_r")
    pkw = dict(zip(pair_names, full))
    for key in (("A_o", "A_r") if name == "A34" else (name,)):
        with pytest.raises(ValueError, match="boundary"):
            lbs.v2v_pair_cuda(**{**pkw, key: shifted(pkw[key])},
                              want_vp=True)
    _close_scaled(lbs.skin_fwd_cuda(*args), lbs.skin_verts_t_plain(*args),
                  1e-5)


def _strided(t, kind, cuda):
    """(leaf on the card, the view of it an op receives) holding t's values:
    transposed (not contiguous) or offset (contiguous, 4 bytes past an
    8-byte boundary: A off 16 bytes, a table off 8)."""
    if kind == "transposed":
        leaf = t.transpose(0, -1).contiguous().to(cuda).requires_grad_()
        view = leaf.transpose(0, -1)
        assert not view.is_contiguous()
    else:
        leaf = torch.cat([torch.zeros(1, dtype=t.dtype),
                          t.reshape(-1)]).to(cuda)
        leaf.requires_grad_()
        view = leaf[1:].view(t.shape)
        assert view.is_contiguous() and \
            view.data_ptr() % 8 == t.element_size()
    return leaf, view


def _grad_of(leaf, kind, shape):
    g = leaf.grad
    return g.transpose(0, -1) if kind == "transposed" else g[1:].view(shape)


@pytest.mark.parametrize("kind", ["transposed", "offset"])
def test_fk_compose_takes_strided_views(cuda, kind):
    """fk_compose on transposed or offset CUDA views of R_l and t_l, under
    cotangents that are such views too, matches the plain version forward
    and backward (the public op copies what the kernels refuse)."""
    gen = torch.Generator().manual_seed(11)
    B = 37
    R, t = _rot(gen, B, 24), torch.randn((B, 24, 3), generator=gen)
    gR, gt = torch.randn((B, 24, 3, 3), generator=gen), \
        torch.randn((B, 24, 3), generator=gen)
    (lR, vR), (lt, vt) = (_strided(x, kind, cuda) for x in (R, t))
    Rg, tg = fk.fk_compose(vR, vt, PARENTS)
    cot = [_strided(x, kind, cuda)[1].detach() for x in (gR, gt)]
    torch.autograd.backward((Rg, tg), cot)
    Rp, tp = fk.fk_fwd_plain(R, t, PARENTS)
    gRp, gtp = fk.fk_bwd_plain(R, t, Rp, gR, gt, PARENTS)
    for got, want, tol in ((Rg, Rp, 1e-5), (tg, tp, 1e-5),
                           (_grad_of(lR, kind, R.shape), gRp, 1e-4),
                           (_grad_of(lt, kind, t.shape), gtp, 1e-4)):
        torch.testing.assert_close(got.detach().cpu(), want, atol=tol,
                                   rtol=0)


@pytest.mark.parametrize("kind", ["transposed", "offset"])
def test_skin_verts_t_takes_strided_views(cuda, kind):
    """skin_verts_t (K3f, then K3b) on transposed or offset views of every
    operand matches the plain version, forward and gradients."""
    args, g = _skin_args(37, 300, cuda, seed=12)
    args = [a.cpu() for a in args]
    leaves = [_strided(a, kind, cuda) for a in args]
    out = lbs.skin_verts_t(300, *(v for _, v in leaves))
    out.backward(g)
    want = lbs.skin_verts_t_plain(*args)
    _close_scaled(out.detach().cpu(), want, 1e-5)
    for (leaf, _), a, w in zip(leaves, args,
                               lbs.skin_bwd_plain(*args, g.cpu())):
        _close_scaled(_grad_of(leaf, kind, a.shape).cpu(), w, 1e-4)


@pytest.mark.parametrize("vjp", lbs.VJP_MODES)
@pytest.mark.parametrize("kind", ["transposed", "offset"])
def test_skin_v2v_l1_takes_strided_views(cuda, kind, vjp):
    """skin_v2v_l1 in every vjp mode on transposed or offset views of every
    operand matches the plain version: the total and its gradients."""
    _, full = _pair_args(37, 300, cuda, seed=13)
    full = [a.cpu() for a in full]
    leaves = [_strided(a, kind, cuda) for a in full]
    total = lbs.skin_v2v_l1(300, *(v for _, v in leaves), vjp=vjp)
    total.backward()
    want, grads = lbs.v2v_l1_plain(*full, grad=True)
    torch.testing.assert_close(total.detach().cpu(), want, rtol=1e-5,
                               atol=0)
    for (leaf, _), a, w in zip(leaves[:3], full[:3], grads):
        _close_scaled(_grad_of(leaf, kind, a.shape).cpu(), -w, 1e-4)


def test_public_ops_pass_aligned_operands_uncopied(cuda, monkeypatch):
    """Contiguous, aligned operands reach the kernels as they are: no copy,
    so the fit's steps keep their launch count."""
    seen = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            seen[name] = [t.data_ptr() for t in a
                          if isinstance(t, torch.Tensor)]
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    for mod, name in ((fk, "fk_fwd_cuda"), (lbs, "skin_fwd_cuda"),
                      (lbs, "v2v_l1_cuda"), (lbs, "v2v_pair_cuda")):
        spy(mod, name)
    gen = torch.Generator().manual_seed(14)
    R, t = _rot(gen, 37, 24).to(cuda), torch.randn((37, 24, 3),
                                                   generator=gen).to(cuda)
    fk.fk_compose(R, t, PARENTS)
    assert seen["fk_fwd_cuda"] == [R.data_ptr(), t.data_ptr()]
    args, full = _pair_args(37, 300, cuda, seed=14)
    lbs.skin_verts_t(300, *args)
    assert seen["skin_fwd_cuda"] == [a.data_ptr() for a in args]
    full[0] = full[0].detach().requires_grad_()    # the pair modes' path
    for vjp, name in (("fused", "v2v_l1_cuda"), ("pair", "v2v_pair_cuda")):
        lbs.skin_v2v_l1(300, *full, vjp=vjp)
        assert seen[name] == [a.data_ptr() for a in full]


def test_skin_fwd_resources_and_scratch(cuda):
    """The forward kernel fits one block an SM without spilling in both
    instantiations, and the pair mode's scratch is one |diff| partial a
    block of lbs.fwd_ranges' grid, the rule its CPU emulation uses."""
    from nemo_tpu_torch.ops import _build
    for pair in (False, True):
        res = lbs.skin_fwd_attributes(pair)
        assert res["local_bytes"] == 0, res
        assert 0 < res["registers"] <= 255, res
        assert res["static_smem_bytes"] + res["dynamic_smem_bytes"] <= 232448
    lib = _build.library()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B, V in ((1, 5), (37, 300), (512, 6890), (960, 6890), (4096, 100)):
        n_bt = -(-B // (lbs.FWD_SIDE_ROWS // 2))
        assert lib.nemo_v2v_scratch_floats(B, V, 2) == \
            n_bt * lbs.fwd_ranges(B, V, 2, sms)


def _tiny_fitter(cuda, v2v_vjp="fused", motion_mlp="plain",
                 skin_dtype=torch.float32, net_precision="highest",
                 skin_io_bf16=False, **over):
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    from nemo_tpu_torch.fit import NemoConfig, NemoFitter, build_assets
    from nemo_tpu_torch.priors.gmm import synthetic_gmm_prior
    from nemo_tpu_torch.priors.vposer import init_vposer
    cfg = NemoConfig(**{**dict(
        model_version=2, h_dim=32, instance_code_size=4, phase_rbf_dim=8,
        rbf_kernel="quadratic", monotonic_network_n_nodes=4, batch_size=16,
        weight_vp_loss=10.0, weight_vp_z_loss=1.0, label_type="gt"), **over})
    smpl = synthetic_smpl_model(300, device=cuda, skin_dtype=skin_dtype)
    bundle, _ = synthetic_problem(smpl, num_views=2, num_frames=12)
    assets = build_assets(bundle, smpl, cfg, gmm=synthetic_gmm_prior(4),
                          vposer=init_vposer(), device=cuda, v2v_vjp=v2v_vjp,
                          motion_mlp=motion_mlp, net_precision=net_precision,
                          skin_io_bf16=skin_io_bf16)
    return NemoFitter(cfg, assets)


# configuration -> (fitter arguments, kernels its fit must launch)
FIT_CASES = {
    "v2_fused": ({}, {"fk_fwd", "fk_bwd", "v2v_grad", "v2v_fwd"}),
    "v2_pair": ({"v2v_vjp": "pair"},
                {"fk_fwd", "fk_bwd", "v2v_pair", "skin_bwd", "v2v_fwd"}),
    "v2_pair_vp": ({"v2v_vjp": "pair_vp"},
                   {"fk_fwd", "fk_bwd", "v2v_pair", "skin_bwd_vp",
                    "v2v_fwd"}),
    "v3_subset_full_batch": (
        dict(model_version=3, vp_v2v_n_verts=64, full_batch=True,
             weight_3d_loss=1.0, code_noise=0.01),
        {"fk_fwd", "fk_bwd", "skin_fwd", "skin_bwd"}),
    "v4": (dict(model_version=4, weight_3d_loss=1.0),
           {"fk_fwd", "fk_bwd", "v2v_grad", "v2v_fwd"}),
    "v0": (dict(model_version=0), {"fk_fwd", "fk_bwd", "v2v_grad",
                                   "v2v_fwd"}),
    "v2_fused_mlp": ({"motion_mlp": "fused"},
                     {"fk_fwd", "fk_bwd", "v2v_grad", "v2v_fwd", "mlp_fwd",
                      "mlp_bwd"}),
    # model version 0 has no MotionNet: no K6, as in JAX
    "v0_fused_mlp": (dict(model_version=0, motion_mlp="fused"),
                     {"fk_fwd", "fk_bwd", "v2v_grad", "v2v_fwd"}),
    # the JAX bench's precision: bf16 tables and "high" network products,
    # K6 at "high" only; and K6 at "bf16"
    "v2_fused_mlp_bench": (
        dict(motion_mlp="fused", net_precision="high",
             skin_dtype=torch.bfloat16),
        {"fk_fwd", "fk_bwd", "v2v_grad_bf16", "v2v_fwd_bf16", "mlp_fwd_high",
         "mlp_bwd_high"}),
    "v2_fused_mlp_bf16": (dict(motion_mlp="fused", net_precision="bf16"),
                          {"fk_fwd", "fk_bwd", "v2v_grad", "v2v_fwd",
                           "mlp_fwd_bf16", "mlp_bwd_bf16"}),
    # bf16 meshes on the subset: K3's _io_bf16 kernels, either table type
    "v3_subset_io_bf16": (
        dict(model_version=3, vp_v2v_n_verts=64, full_batch=True,
             weight_3d_loss=1.0, skin_io_bf16=True, net_precision="high"),
        {"fk_fwd", "fk_bwd", "skin_fwd_io_bf16", "skin_bwd_io_bf16"}),
    "v3_subset_bf16_io_bf16": (
        dict(model_version=3, vp_v2v_n_verts=64, full_batch=True,
             weight_3d_loss=1.0, skin_io_bf16=True,
             skin_dtype=torch.bfloat16),
        {"fk_fwd", "fk_bwd", "skin_fwd_bf16_io_bf16",
         "skin_bwd_bf16_io_bf16"}),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_steps_launch_every_kernel(cuda, case):
    """Each configuration's stages launch exactly the kernels of its path."""
    over, expected = FIT_CASES[case]
    fitter = _tiny_fitter(cuda, **over)
    reset_launches()
    fitter.warmup(2)
    fitter.opt_cam(2)
    m = fitter.fit(3, chunk=3)
    fitter.eval_loss()
    counts = launch_counts()
    assert {k for k, v in counts.items() if v > 0} == expected, counts
    assert np.isfinite(m["total_loss"]).all()


@pytest.mark.parametrize("case", ["v2_fused", "v3_subset_full_batch", "v4",
                                  "v0", "v2_fused_mlp"])
def test_stage_steps_never_synchronise(cuda, case):
    """No step of any stage waits for the device (no .item(), no host
    copies, no host-built index tensors)."""
    from nemo_tpu_torch.fit.optimizer import (make_camera_stage_optimizer,
                                              make_v0_warmup_optimizer)
    fitter = _tiny_fitter(cuda, **FIT_CASES[case][0])
    cfg = fitter.cfg
    cam_opt = None if cfg.model_version >= 4 else \
        make_camera_stage_optimizer(fitter.params, cfg)
    warm_opt = make_v0_warmup_optimizer(fitter.params, cfg) \
        if cfg.model_version == 0 else None
    steps = (lambda: fitter.warmup_step(0, warm_opt),
             lambda: fitter.camera_step(cam_opt), fitter.main_step)
    for step in steps:      # first calls build the cached index tensors
        step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step in steps:
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")


# ---------------------------------------------------------------------------
# bf16 skinning tables: the _bf16 kernels against their plain versions
# ---------------------------------------------------------------------------

BF = torch.bfloat16
# bf16 gradients: the kernel and the plain version round gm = g . [vp; 1]
# and gvp to bf16 after f32 sums taken in other orders; where the two sums
# straddle a rounding boundary one term moves by a bf16 step (2^-8 of it),
# which at these inputs (A ~ N(0, 1), so gvp reaches a few units) moves a
# gradient entry by up to ~2e-4 of the tensor's largest entry. 1e-3 holds a
# few such flips, and a wrong fragment or missing term moves entries by
# much more; but a rounding point moved (pf or A left in f32, gm or gvp not
# rounded, gvsh summing the rounded gvp) moves them by ~1e-3 as well, so
# _rounds_where_plain also holds each gradient much nearer the plain version
# than to every such variant. The CPU tests hold the plain version to the
# JAX kernels at 1e-5 and to 1/20 of the bf16-vs-f32 gap.
GRAD_BF16 = 1e-3


def _bf16_tables(args):
    """_skin_args' / _pair_args' operands with the tables in bf16."""
    out = list(args)
    out[3], out[4] = out[3].to(BF), out[4].to(BF)
    return out


def _rounds_where_plain(got, args, g, vp=None):
    """Each gradient of a _bf16 kernel lies within lbs.MISROUNDED_SHARE of
    the plain version's distance from every lbs.skin_bwd_misrounded variant
    that changes it (the JAX kernels' own bf16 gradients pass the same
    check on the CPU: tests/test_torch_port_skin_bf16.py)."""
    shares = lbs.misrounding_shares(got, *args, g, vp=vp)
    assert shares and max(shares.values()) <= lbs.MISROUNDED_SHARE, shares


def _bf16_vp_close(got, want):
    """A stored bf16 vp: the kernel and the plain version round f32 sums
    taken in another order, so an entry may differ by one bf16 step (2^-8
    relative) where the two sums straddle a rounding boundary."""
    assert got.dtype == want.dtype == BF
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2.0 ** -8 * float(want.float().abs().max()))


@pytest.mark.parametrize("V", [5, 300, 1024, 6890])
@pytest.mark.parametrize("B", [1, 37, 512, 960])
def test_bf16_kernels_match_plain(cuda, B, V):
    """Every _bf16 kernel against its plain bf16 version at the grid's
    shapes (ragged B and V; odd V copies bf16 one element at a time): K3f
    (vertices within 1e-5 of the largest entry), K3b recomputing vp and
    reading the pair mode's bf16 vp under a random cotangent (gradients
    within GRAD_BF16), K2 fused and forward-only (the total within rtol
    1e-5, gradients GRAD_BF16) and the pair mode (the total, the sign
    exact, vp to one bf16 step). Every gradient is also much nearer the
    plain version than to a variant with a rounding point moved
    (_rounds_where_plain). Each reruns bit-identical, only the _bf16
    counters move, and the f32 kernels' counters stay at 0."""
    args, full = _pair_args(B, V, cuda, seed=B + V)
    args, full = _bf16_tables(args), _bf16_tables(full)
    g = torch.randn((B, 3, V), generator=torch.Generator().manual_seed(V)
                    ).to(cuda)
    reset_launches()
    out = lbs.skin_fwd_cuda(*args)
    _close_scaled(out, lbs.skin_verts_t_plain(*args), 1e-5)
    assert torch.equal(lbs.skin_fwd_cuda(*args), out)
    pair = lbs.v2v_pair_cuda(*full, want_vp=True)
    tot_p, sign_p, vp_p = lbs.v2v_pair_plain(*full, want_vp=True)
    torch.testing.assert_close(pair[0], tot_p, rtol=1e-5, atol=0)
    assert torch.equal(pair[1], sign_p)
    _bf16_vp_close(pair[2], vp_p)
    assert all(torch.equal(a, b) for a, b in
               zip(lbs.v2v_pair_cuda(*full, want_vp=True), pair))
    for stored in (None, pair[2]):
        got = lbs.skin_bwd_cuda(*args, g, vp=stored)
        for a, b in zip(got, lbs.skin_bwd_plain(*args, g, vp=stored)):
            _close_scaled(a, b, GRAD_BF16)
        _rounds_where_plain(got, args, g, stored)
        assert all(torch.equal(a, b) for a, b in
                   zip(lbs.skin_bwd_cuda(*args, g, vp=stored), got))
    tot_k, gk = lbs.v2v_l1_cuda(*full, grad=True)
    tot_pl, gp = lbs.v2v_l1_plain(*full, grad=True)
    torch.testing.assert_close(tot_k, tot_pl, rtol=1e-5, atol=0)
    for a, b in zip(gk, gp):
        _close_scaled(a, b, GRAD_BF16)
    _rounds_where_plain(gk, full[:5], sign_p)
    tot_2, g2 = lbs.v2v_l1_cuda(*full, grad=True)
    assert torch.equal(tot_2, tot_k)
    assert all(torch.equal(a, b) for a, b in zip(g2, gk))
    assert torch.equal(lbs.v2v_l1_cuda(*full, grad=False)[0], tot_k)
    counts = launch_counts()
    assert {k for k, v in counts.items() if v} == {
        k + lbs.BF16 for k in lbs._KERNELS}, counts


def test_bf16_kernel_resources(cuda):
    """Every _bf16 instantiation fits one block an SM without spilling;
    the fused K2 one, which holds 255 registers in f32, included."""
    res = {"v2v_fused": lbs.v2v_fused_attributes(bf16=True)}
    for pair in (False, True):
        res[f"skin_fwd pair={pair}"] = lbs.skin_fwd_attributes(pair, True)
    for stored in (False, True):
        res[f"skin_bwd stored={stored}"] = lbs.skin_bwd_attributes(stored,
                                                                   True)
    for name, r in res.items():
        assert r["local_bytes"] == 0, (name, r)
        assert 0 < r["registers"] <= 255, (name, r)
        assert r["static_smem_bytes"] + r["dynamic_smem_bytes"] <= 232448, \
            (name, r)


@pytest.mark.parametrize("name", ["posedirs_t", "W_t"])
@pytest.mark.parametrize("V", [300, 301])
def test_bf16_launchers_take_tables_on_their_boundary(cuda, name, V):
    """The bf16 tables are read two elements (4 bytes) at a time where V is
    even and one (2 bytes) where it is odd: a table 2 bytes off a 4-byte
    boundary is refused at V = 300 and taken, matching the plain version,
    at V = 301."""
    args, full = _pair_args(37, V, cuda, seed=V)
    args, full = _bf16_tables(args), _bf16_tables(full)
    i = 3 if name == "posedirs_t" else 4
    t = args[i]
    shifted = torch.empty(t.numel() + 1, device=cuda, dtype=BF)[1:].view(
        t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 4 == 2
    moved = args[:i] + [shifted] + args[i + 1:]
    moved_full = moved + full[5:]
    if V % 2 == 0:
        with pytest.raises(ValueError, match="boundary"):
            lbs.skin_fwd_cuda(*moved)
        with pytest.raises(ValueError, match="boundary"):
            lbs.v2v_l1_cuda(*moved_full, grad=True)
    else:
        _close_scaled(lbs.skin_fwd_cuda(*moved),
                      lbs.skin_verts_t_plain(*args), 1e-5)
        g = torch.sign(torch.randn(
            (37, 3, V), generator=torch.Generator().manual_seed(V))).to(cuda)
        for a, b in zip(lbs.skin_bwd_cuda(*moved, g),
                        lbs.skin_bwd_plain(*args, g)):
            _close_scaled(a, b, GRAD_BF16)
        _, gk = lbs.v2v_l1_cuda(*moved_full, grad=True)
        for a, b in zip(gk, lbs.v2v_l1_plain(*full, grad=True)[1]):
            _close_scaled(a, b, GRAD_BF16)


@pytest.mark.parametrize("kind", ["transposed", "offset"])
def test_skin_verts_t_bf16_takes_strided_views(cuda, kind):
    """skin_verts_t with bf16 tables (K3f, then K3b, both _bf16) on
    transposed or offset views of every operand (a bf16 table 2 bytes off
    its boundary) matches the plain bf16 version, forward and gradients."""
    args, g = _skin_args(37, 300, cuda, seed=15)
    args = _bf16_tables([a.cpu() for a in args])
    leaves = [_strided(a, kind, cuda) for a in args]
    reset_launches()
    out = lbs.skin_verts_t(300, *(v for _, v in leaves))
    out.backward(g)
    assert launch_counts()["skin_fwd_bf16"] == 1
    assert launch_counts()["skin_bwd_bf16"] == 1
    _close_scaled(out.detach().cpu(), lbs.skin_verts_t_plain(*args), 1e-5)
    for (leaf, _), a, w in zip(leaves, args,
                               lbs.skin_bwd_plain(*args, g.cpu())):
        _close_scaled(_grad_of(leaf, kind, a.shape).cpu(), w, GRAD_BF16)


@pytest.mark.parametrize("vjp", lbs.VJP_MODES)
@pytest.mark.parametrize("kind", ["transposed", "offset"])
def test_skin_v2v_l1_bf16_takes_strided_views(cuda, kind, vjp):
    """skin_v2v_l1 with bf16 tables in every vjp mode on transposed or
    offset views of every operand matches the plain bf16 version: the total
    and its gradients."""
    _, full = _pair_args(37, 300, cuda, seed=16)
    full = _bf16_tables([a.cpu() for a in full])
    leaves = [_strided(a, kind, cuda) for a in full]
    total = lbs.skin_v2v_l1(300, *(v for _, v in leaves), vjp=vjp)
    total.backward()
    want, grads = lbs.v2v_l1_plain(*full, grad=True)
    torch.testing.assert_close(total.detach().cpu(), want, rtol=1e-5,
                               atol=0)
    for (leaf, _), a, w in zip(leaves[:3], full[:3], grads):
        _close_scaled(_grad_of(leaf, kind, a.shape).cpu(), -w, GRAD_BF16)


BF16_FIT_CASES = {c: (FIT_CASES[c][0], {
    k + lbs.BF16 if k in lbs._KERNELS else k for k in FIT_CASES[c][1]})
    for c in ("v2_fused", "v2_pair", "v2_pair_vp", "v3_subset_full_batch")}


@pytest.mark.parametrize("case", sorted(BF16_FIT_CASES))
def test_fit_steps_launch_bf16_kernels(cuda, case):
    """With bf16 tables each configuration's stages launch the _bf16
    skinning kernels and no f32 one; no step synchronises."""
    over, expected = BF16_FIT_CASES[case]
    fitter = _tiny_fitter(cuda, skin_dtype=BF, **over)
    reset_launches()
    fitter.warmup(2)
    fitter.opt_cam(2)
    m = fitter.fit(3, chunk=3)
    fitter.eval_loss()
    counts = launch_counts()
    assert {k for k, v in counts.items() if v > 0} == expected, counts
    assert np.isfinite(m["total_loss"]).all()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fitter.main_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _raster_case(name, gen):
    """(verts (N, V, 3), faces, focals, centers, img_hw, th, tw)."""
    def blobs(N, F, spread, size):
        c = torch.stack([torch.empty(N, F).uniform_(-spread, spread,
                                                    generator=gen),
                         torch.empty(N, F).uniform_(-spread, spread,
                                                    generator=gen),
                         torch.empty(N, F).uniform_(3, 5, generator=gen)], -1)
        off = torch.empty(N, F, 3, 3).uniform_(-size, size, generator=gen)
        return (c[:, :, None] + off).reshape(N, 3 * F, 3), \
            np.arange(3 * F).reshape(F, 3)
    if name == "ragged":
        v, f = blobs(1, 2000, 1.0, 0.15)
        return v, f, [300.0], [(95.0, 50.0)], (100, 190), 32, 128
    if name == "empty_tiles_behind":
        v, f = blobs(1, 300, 0.05, 0.05)
        v[0, :30, 2] = -1.0                  # ten faces behind the camera
        return v, f, [200.0], [(40.0, 200.0)], (257, 300), 32, 128
    if name == "batch_intrinsics":
        v, f = blobs(3, 1500, 0.8, 0.2)
        return v, f, [250.0, 180.0, 320.0], \
            [(150.0, 100.0), (120.0, 90.0), (170.0, 110.0)], (200, 301), \
            32, 128
    if name == "small_tiles":
        v, f = blobs(2, 500, 0.5, 0.1)
        return v, f, [200.0, 150.0], [(64.0, 48.0), (70.0, 40.0)], \
            (96, 130), 16, 32
    # the split fold's cases (tests/torch_raster_cases.py): one tile of 11
    # work items, equal depths in two work items of a tile, slivers far
    # from the origin, a panel with every face behind the near plane
    v, f, foc, ctr, hw, th, tw = raster_cases.CASES[name]()
    return torch.tensor(v), f, foc, ctr, hw, th, tw


@pytest.mark.parametrize("case", ["ragged", "empty_tiles_behind",
                                  "batch_intrinsics", "small_tiles",
                                  "many_chunks", "cross_chunk_tie", "sliver",
                                  "all_behind"])
@pytest.mark.parametrize("stream", [True, False])
def test_raster_kernels_match_plain(cuda, case, stream):
    """K5s / K5g against the plain fold on the same binned entries, twice:
    coverage, face ids, z and bary identical (the kernels round every
    operation as the plain version does, and their merge does not depend
    on the order the work items run in), and one launch of the mode's
    kernel through the public op."""
    from nemo_tpu_torch.ops import raster
    gen = torch.Generator().manual_seed(len(case))
    v, f, foc, ctr, hw, th, tw = _raster_case(case, gen)
    ent = raster.prepare(v.to(cuda), f, foc, ctr, hw, th, tw)
    plain = raster.rasterize_plain(ent, hw, th, tw, stream=stream)
    for _ in range(2):
        kernel = raster.raster_stream_cuda(
            ent, raster.stream_inputs(ent), hw, th, tw) if stream else \
            raster.raster_gather_cuda(ent, raster.gather_inputs(ent), hw, th,
                                      tw)
        for a, b in zip(kernel, plain):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b)
    z = kernel[0]
    assert torch.isfinite(z).any() and not torch.isfinite(z).all()
    reset_launches()
    got = raster.rasterize_triangles_batched(v.to(cuda), f, foc, ctr, hw,
                                             th=th, tw=tw, stream=stream)
    counts = launch_counts()
    assert counts["raster_stream"] == int(stream)
    assert counts["raster_gather"] == int(not stream)
    for a, b in zip(got, kernel):
        assert torch.equal(a, b)


def test_raster_batched_never_synchronises(cuda):
    """rasterize_triangles_batched on CUDA tensors, both modes, runs with
    no host synchronisation (the work list is built and read on the
    device), and gives the plain fold's outputs."""
    from nemo_tpu_torch.ops import raster
    gen = torch.Generator().manual_seed(9)
    v, f, foc, ctr, hw, th, tw = _raster_case("batch_intrinsics", gen)
    v, f = v.to(cuda), torch.as_tensor(f).to(cuda)
    for stream in (True, False):     # the first calls build and load
        raster.rasterize_triangles_batched(v, f, foc, ctr, hw, stream=stream)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [raster.rasterize_triangles_batched(v, f, foc, ctr, hw,
                                                  stream=stream)
               for stream in (True, False)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ent = raster.prepare(v, f, foc, ctr, hw)
    for stream, out in zip((True, False), got):
        for a, b in zip(out, raster.rasterize_plain(ent, hw, stream=stream)):
            assert torch.equal(a, b)


def test_raster_gather_overflow(cuda):
    """Gather mode on a tile over faces_per_tile drops what the plain
    gather drops, and differs from the stream mode there."""
    from nemo_tpu_torch.ops import raster
    gen = torch.Generator().manual_seed(5)
    v, f, foc, ctr, hw, th, tw = _raster_case("empty_tiles_behind", gen)
    assert raster.gather_mode_overflow(v[0].numpy(), f, foc[0], ctr[0], hw,
                                       faces_per_tile=64) > 0
    ent = raster.prepare(v.to(cuda), f, foc, ctr, hw)
    got = raster.raster_gather_cuda(ent, raster.gather_inputs(ent, 64), hw)
    want = raster.rasterize_plain(ent, hw, faces_per_tile=64, stream=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    stream = raster.raster_stream_cuda(ent, raster.stream_inputs(ent), hw)
    assert not torch.equal(got[1], stream[1])


# K4 cases: (T, N, M, kind). N and M straddle the parent kernel's 128-query
# block and 1024-candidate tile; "dup" repeats every candidate (ties, the
# lowest index must win) and puts some queries exactly on candidates; "far"
# puts the sets 100 m apart; "path_e" is the fit's scan -> mesh shape (the
# test runs both directions). The kinds of tests/torch_chamfer_cases.py:
# ties across group and range boundaries ("straddle"), a set of 5
# candidates ("few"), +inf and NaN distances ("nonfinite"). Each case runs
# at the split nn_split picks for the card; over both directions the cases
# reach every instantiation (q = 1, 2, 4) and 1 to 16 ranges
# (test_chamfer_cases_reach_every_split).
CHAMFER_CASES = {"one_point": (1, 1, 1, "normal"),
                 "ragged": (3, 129, 1025, "normal"),
                 "t1_two_tiles": (1, 300, 2100, "normal"),
                 "t60": (60, 200, 700, "normal"),
                 "dup": (4, 150, 600, "dup"),
                 "far": (5, 97, 1500, "far"),
                 "path_e": (60, 512, 6890, "normal"),
                 "straddle": (2, 48, 600, "straddle"),
                 "few": (2, 9, 5, "few"),
                 "nonfinite": (3, 20, 90, "nonfinite")}


def _chamfer_inputs(case, cuda):
    T, N, M, kind = CHAMFER_CASES[case]
    if kind in ("straddle", "few", "nonfinite"):
        a, b = chamfer_cases.chamfer_case(kind)
        assert a.shape == (T, N, 3) and b.shape == (T, M, 3)
        return torch.tensor(a).to(cuda), torch.tensor(b).to(cuda)
    gen = torch.Generator().manual_seed(N + M)
    b = torch.randn((T, M, 3), generator=gen)
    a = torch.randn((T, N, 3), generator=gen)
    if kind == "dup":
        b[:, M // 2:] = b[:, :M - M // 2]
        a[:, :N // 3] = b[:, M // 2:M // 2 + N // 3]
    elif kind == "far":
        a += 100.0
    return a.to(cuda).contiguous(), b.to(cuda).contiguous()


@pytest.mark.parametrize("case", sorted(CHAMFER_CASES))
def test_chamfer_kernel_matches_plain(cuda, case):
    """K4 against its plain version on the card: distances and indices
    bit-equal (the kernel rounds every operation in the plain version's
    order), in both directions, and bit-equal on a rerun; one launch per
    call through nn_one_way."""
    from nemo_tpu_torch.ops import chamfer
    a, b = _chamfer_inputs(case, cuda)
    for x, y in ((a, b), (b, a)):
        dp, ip = chamfer.nn_one_way_plain(x, y)
        dk, ik = chamfer.nn_one_way_cuda(x, y)
        assert dk.dtype == dp.dtype and ik.dtype == ip.dtype == torch.int64
        assert torch.equal(dk, dp) and torch.equal(ik, ip)
        again = chamfer.nn_one_way_cuda(x, y)
        assert torch.equal(again[0], dk) and torch.equal(again[1], ik)
        if CHAMFER_CASES[case][3] == "dup" and y is b:
            M = b.shape[1]
            assert bool((ik < M - M // 2).all())
    reset_launches()
    chamfer.nn_one_way(a, b)
    assert launch_counts()["chamfer_nn"] == 1


def test_chamfer_cases_reach_every_split(cuda):
    """The splits nn_split gives CHAMFER_CASES on this card, both ways:
    every instantiation (q = 1, 2, 4), one range, two and sixteen; path
    E's (4, 16) and (4, 2) on a 132-SM card; and "straddle"'s scan ->
    mesh ranges end on one of its ties, so the lower index must win across
    a range boundary."""
    from nemo_tpu_torch.ops import chamfer
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = {}
    for case, (T, N, M, _) in CHAMFER_CASES.items():
        splits[case] = (chamfer.nn_split(T, N, M, sms),
                        chamfer.nn_split(T, M, N, sms))
    every = [s for pair in splits.values() for s in pair]
    assert {s.q for s in every} == {1, 2, 4}
    assert {1, 2, 16} <= {s.ranges for s in every}
    if sms == 132:
        assert [(s.q, s.ranges) for s in splits["path_e"]] == [(4, 16),
                                                              (4, 2)]
    s = splits["straddle"][0]
    ends = {s.range * w for w in range(1, s.ranges)}
    assert ends & {p + 1 for p in chamfer_cases._TIES}, s


def test_chamfer_kernel_resources(cuda):
    """Each instantiation fits two blocks of 16 warps an SM (64 registers
    a thread at most) without spilling, in 32 KB of shared memory."""
    from nemo_tpu_torch.ops import chamfer
    for q in (1, 2, 4):
        att = chamfer.nn_attributes(q)
        assert att["registers"] <= 64 and att["local_bytes"] == 0, att
        assert att["dynamic_smem_bytes"] == 32768, att


def test_chamfer_one_way_launches_once(cuda):
    """chamfer_one_way launches K4 once a call (its backward none) and
    matches chamfer_distance's first direction on the card."""
    from nemo_tpu_torch.ops import chamfer
    a, b = _chamfer_inputs("t60", cuda)
    x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
    reset_launches()
    d = chamfer.chamfer_one_way(x, y)
    d.sum().backward()
    assert launch_counts()["chamfer_nn"] == 1
    d1, _ = chamfer.chamfer_distance(a, b)
    assert torch.equal(d.detach(), d1)


@pytest.mark.parametrize("kind", ["transposed", "offset"])
def test_nn_one_way_takes_strided_views(cuda, kind):
    """nn_one_way on transposed or offset CUDA views copies what the kernel
    refuses, once, and matches the plain version bit for bit in one launch;
    nn_one_way_cuda itself refuses a non-contiguous operand."""
    from nemo_tpu_torch.ops import chamfer
    a, b = (t.cpu() for t in _chamfer_inputs("ragged", cuda))
    va, vb = (_strided(t, kind, cuda)[1].detach() for t in (a, b))
    reset_launches()
    d, i = chamfer.nn_one_way(va, vb)
    assert launch_counts()["chamfer_nn"] == 1
    dp, ip = chamfer.nn_one_way_plain(a, b)
    assert torch.equal(d.cpu(), dp) and torch.equal(i.cpu(), ip)
    if kind == "transposed":
        with pytest.raises(ValueError, match="contiguous"):
            chamfer.nn_one_way_cuda(va, vb)


@pytest.mark.parametrize("case", ["ragged", "dup"])
def test_chamfer_distance_grads_card_vs_cpu(cuda, case):
    """chamfer_distance's value and gradients on the card against the CPU
    path from the same inputs (the kernel on the card, the plain version on
    the CPU): values and gradients within 1e-5 of the largest entry, as
    index_add_ on CUDA sums onto a point with atomics, in an order that
    changes from run to run."""
    from nemo_tpu_torch.ops.chamfer import chamfer_distance
    a, b = _chamfer_inputs(case, cuda)
    g = torch.Generator().manual_seed(9)
    w1 = torch.rand(a.shape[:2], generator=g)
    w2 = torch.rand(b.shape[:2], generator=g)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        x = a.detach().to(dev).requires_grad_()
        y = b.detach().to(dev).requires_grad_()
        d1, d2 = chamfer_distance(x, y)
        ((d1 * w1.to(dev)).sum() + (d2 * w2.to(dev)).sum()).backward()
        outs.append([t.detach().cpu() for t in (d1, d2, x.grad, y.grad)])
    for k, c in zip(*outs):
        torch.testing.assert_close(k, c, rtol=0,
                                   atol=1e-5 * max(1.0, float(c.abs().max())))


# K6 cases (B, D, H, O): ragged everywhere (none a multiple of the 64 x 64
# tile or the 16-deep slice), the phase-0 anchor's batch of one at the
# reference widths, and the reference batch
MLP_CASES = {"ragged": (13, 19, 72, 147), "b1": (1, 105, 1000, 147),
             "reference": (512, 105, 1000, 147)}


def _mlp_inputs(case, device):
    B, D, H, O = MLP_CASES[case]
    gen = torch.Generator().manual_seed(B + H)
    u = lambda *s, fan_in: ((torch.rand(s, generator=gen) * 2 - 1)
                            / fan_in ** 0.5)
    args = (torch.rand((B, D), generator=gen), u(D, H, fan_in=D),
            u(H, fan_in=D), u(H, H, fan_in=H), u(H, fan_in=H),
            u(H, H, fan_in=H), u(H, fan_in=H), u(H, O, fan_in=H),
            u(O, fan_in=H))
    return [a.to(device) for a in args], torch.randn((B, O),
                                                     generator=gen).to(device)


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_kernels_match_plain(cuda, case):
    """K6f and K6b against their plain versions (f32, TF32 off): values
    within 1e-5 and gradients within 1e-4 of each tensor's largest entry;
    a second run bit-identical (fixed-order sums); one launch of each
    through the public op."""
    from nemo_tpu_torch.ops import mlp
    args, gout = _mlp_inputs(case, cuda)
    got = mlp.mlp_fwd_cuda(*args)
    for a, b in zip(got, mlp.motion_net_mlp_plain(*args)):
        _close_scaled(a, b, 1e-5)
    saved = (args[0], *got[1:], args[1], args[3], args[5], args[7])
    gk = mlp.mlp_bwd_cuda(gout, *saved)
    for a, b in zip(gk, mlp.motion_net_mlp_bwd_plain(gout, *saved)):
        assert a.shape == b.shape
        _close_scaled(a, b, 1e-4)
    again = mlp.mlp_fwd_cuda(*args) + mlp.mlp_bwd_cuda(gout, *saved)
    assert all(torch.equal(a, b) for a, b in zip(again, got + gk))
    leaves = [a.detach().requires_grad_() for a in args]
    reset_launches()
    out = mlp.MotionNetMLP.apply("highest", *leaves)
    (out * gout).sum().backward()
    counts = launch_counts()
    assert (counts["mlp_fwd"], counts["mlp_bwd"]) == (1, 1)
    assert torch.equal(out.detach(), got[0])
    for leaf, g in zip(leaves, gk):
        assert torch.equal(leaf.grad, g)


@pytest.mark.parametrize("case", ["ragged", "b1"])
def test_motion_net_fused_card_vs_cpu(cuda, case):
    """MotionNet(mlp="fused") on the card (K6) against the CPU (the plain
    versions) from the same weights: outputs and every gradient within
    1e-5 / 1e-4 of the largest entry."""
    from nemo_tpu_torch.modules.networks import MotionNet
    B, D, H, O = MLP_CASES[case]
    net = MotionNet(D, H, 24, init_last_layer_zero=False,
                    generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    x = torch.rand((B, D), generator=gen)
    w = torch.randn((B, 24 * 6), generator=gen)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        m = MotionNet(D, H, 24).to(dev)
        m.load_state_dict(net.state_dict())
        xd = x.to(dev).requires_grad_()
        pose, orient, trans = m(xd, mlp="fused")
        rot6d = torch.cat([orient["rot6d"], pose["rot6d"]], 1)
        ((rot6d * w.to(dev)).sum() + trans.sum()).backward()
        outs.append([t.detach().cpu() for t in
                     (rot6d, trans, xd.grad,
                      *(p.grad for p in m.parameters()))])
    for i, (k, c) in enumerate(zip(*outs)):
        _close_scaled(k, c, 1e-5 if i < 2 else 1e-4)


# ---------------------------------------------------------------------------
# K6 at "high" (bf16x3) and "bf16", K3 with bf16 meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["high", "bf16"])
@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_kernels_match_plain_at_precision(cuda, case, precision):
    """K6f and K6b at "high" and "bf16" against their plain versions at the
    same precision. "high": the same split and products as the plain
    version, f32 sums in another order: 1e-5 (values) and 1e-4 (gradients)
    of each tensor's largest entry, as in f32, and each output that takes
    one product of the kernel's own operands within mlp.MISROUNDED_SHARE
    of the plain version's distance from each variant that moves one point
    of the split (mlp.split_shares). "bf16": a sum straddling a rounding
    point moves the next layer's operand by one bf16 step, so one bf16
    rounding (2^-8) of the largest entry (chip_smoke.py's K6_BF16), and
    every output within mlp.MISROUNDED_SHARE of the plain version's
    distance from each variant with one kind of operand unrounded. A
    second run is bit-identical; the
    public op launches each kernel once, under the precision's counters
    only."""
    from nemo_tpu_torch.ops import mlp
    args, gout = _mlp_inputs(case, cuda)
    got = mlp.mlp_fwd_cuda(*args, precision=precision)
    want = mlp.motion_net_mlp_plain(*args, precision=precision)
    saved = (args[0], *got[1:], args[1], args[3], args[5], args[7])
    gk = mlp.mlp_bwd_cuda(gout, *saved, precision=precision)
    gp = mlp.motion_net_mlp_bwd_plain(gout, *saved, precision=precision)
    tol_f, tol_b = (1e-5, 1e-4) if precision == "high" else (2.0 ** -8,) * 2
    for a, b in zip(got, want):
        _close_scaled(a, b, tol_f)
    for a, b in zip(gk, gp):
        assert a.shape == b.shape
        _close_scaled(a, b, tol_b)
    shares = mlp.misrounding_shares(got, gk, args, (gout, *saved),
                                    precision)
    assert max(shares.values()) <= mlp.MISROUNDED_SHARE, shares
    again = (mlp.mlp_fwd_cuda(*args, precision=precision)
             + mlp.mlp_bwd_cuda(gout, *saved, precision=precision))
    assert all(torch.equal(a, b) for a, b in zip(again, got + gk))
    leaves = [a.detach().requires_grad_() for a in args]
    reset_launches()
    out = mlp.MotionNetMLP.apply(precision, *leaves)
    (out * gout).sum().backward()
    counts = launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        f"mlp_fwd_{precision}": 1, f"mlp_bwd_{precision}": 1}, counts
    assert torch.equal(out.detach(), got[0])
    for leaf, g in zip(leaves, gk):
        assert torch.equal(leaf.grad, g)


def test_mlp_kernel_resources_every_precision(cuda):
    """Every instantiation of K6's GEMM kernel (forward and backward pair,
    3xTF32, bf16x3 and bf16) fits two blocks an SM without spilling."""
    from nemo_tpu_torch.ops import mlp
    for precision in mlp.NET_PRECISIONS:
        for pair in (False, True):
            r = mlp.gemm_attributes(pair, precision)
            assert r["local_bytes"] == 0, (precision, pair, r)
            assert 0 < r["registers"] <= 128, (precision, pair, r)
            assert 2 * (r["static_smem_bytes"] + r["dynamic_smem_bytes"]) \
                <= 228 * 1024, (precision, pair, r)


def _bf16_step(want):
    """One bf16 step of each entry (2^-7 of it), plus the f32 kernels'
    1e-5 of the largest entry for entries near 0: where the kernel's and
    the plain version's f32 vertices straddle a rounding point, their bf16
    values are one step apart."""
    return 2.0 ** -7 * want.abs() + 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("tables", ["f32", "bf16"])
@pytest.mark.parametrize("B,V", [(1, 5), (37, 300), (37, 301), (960, 1024),
                                 (512, 6890)])
def test_skin_io_bf16_kernels(cuda, B, V, tables):
    """K3f writing bf16 vertices gives the f32 kernel's vertices rounded to
    nearest even, bit for bit, so at most one bf16 step from the plain
    version's; K3b under a bf16 cotangent gives the f32-cotangent kernel's
    gradients on the widened cotangent, bit for bit (the widening is
    exact), each rerun bit-identical; only the _io_bf16 counters move."""
    args, _ = _skin_args(B, V, cuda, seed=B + V)
    if tables == "bf16":
        args = _bf16_tables(args)
    sfx = lbs.BF16 if tables == "bf16" else ""
    g = torch.randn((B, 3, V), generator=torch.Generator().manual_seed(V)
                    ).to(cuda).to(BF)
    f32 = lbs.skin_fwd_cuda(*args)
    reset_launches()
    out = lbs.skin_fwd_cuda(*args, out_dtype=BF)
    assert out.dtype == BF and torch.equal(out, f32.to(BF))
    want = lbs.skin_verts_t_plain(*args)
    assert bool(((out.float() - want).abs() <= _bf16_step(want)).all())
    assert torch.equal(lbs.skin_fwd_cuda(*args, out_dtype=BF), out)
    got = lbs.skin_bwd_cuda(*args, g)
    assert all(torch.equal(a, b) for a, b in
               zip(lbs.skin_bwd_cuda(*args, g), got))
    counts = launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "skin_fwd" + sfx + lbs.IO_BF16: 2,
        "skin_bwd" + sfx + lbs.IO_BF16: 2}, counts
    ref = lbs.skin_bwd_cuda(*args, g.float())
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError):
        lbs.skin_bwd_cuda(*args, g, vp=f32.to(args[3].dtype))
    for io in (lbs.skin_fwd_attributes(False, tables == "bf16", True),
               lbs.skin_bwd_attributes(False, tables == "bf16", True)):
        assert io["local_bytes"] == 0, io
        assert io["static_smem_bytes"] + io["dynamic_smem_bytes"] <= 232448


@pytest.mark.parametrize("tables", ["f32", "bf16"])
def test_skin_verts_t_io_bf16_card_vs_cpu(cuda, tables):
    """skin_verts_t(out_dtype=bf16) and its gradients on the card against
    the CPU (the plain versions): the bf16 mesh within one bf16 step, the
    gradients under the same bf16 cotangent within 1e-4 (f32 tables) or
    GRAD_BF16 (bf16 tables) of each tensor's largest entry."""
    B, V = 37, 300
    args = [a.cpu() for a in _skin_args(B, V, cuda, seed=5)[0]]
    if tables == "bf16":
        args = _bf16_tables(args)
    w = torch.randn((B, 3, V), generator=torch.Generator().manual_seed(6))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [a.to(dev).requires_grad_() for a in args[:3]]
        out = lbs.skin_verts_t(V, *leaves, args[3].to(dev), args[4].to(dev),
                               out_dtype=BF)
        assert out.dtype == BF
        (out.float() * w.to(dev)).sum().backward()
        outs.append([out.detach().float().cpu()]
                    + [x.grad.cpu() for x in leaves])
    (ok, *gk), (oc, *gc) = outs
    assert bool(((ok - oc).abs() <= _bf16_step(oc)).all())
    tol = GRAD_BF16 if tables == "bf16" else 1e-4
    for a, b in zip(gk, gc):
        _close_scaled(a, b, tol)


# K7: GroupNorm + ReLU (ops/groupnorm.py); R odd, HuMoR's widths in 16
# groups at the reference fit's batch and cvh_47x600's full batch, the
# 128-wide test HuMoR, and groups across whole float4s of a lane
GN_SHAPES = [(1, 1024, 16), (37, 1024, 16), (960, 1024, 16),
             (28200, 1024, 16), (61, 512, 16), (33, 128, 16), (9, 1024, 4),
             (5, 1024, 1)]


def _gn_inputs(R, C, groups, dev):
    gen = torch.Generator().manual_seed(R + C)
    x = 2.0 * torch.randn((R, C), generator=gen) + 0.5
    if R > 2:
        x[1, :C // groups] = 3.25            # a constant group
    gamma = 0.5 + torch.rand((C,), generator=gen)
    beta = 0.4 * torch.randn((C,), generator=gen)
    gy = torch.randn((R, C), generator=gen)
    return [t.to(dev) for t in (x, gamma, beta, gy)]


@pytest.mark.parametrize("R,C,groups", GN_SHAPES)
def test_gn_relu_kernels_match_eager(cuda, R, C, groups):
    """K7's forward and backward against the eager composition on the card
    and its autograd (the output 1e-5, dx, dgamma and dbeta 1e-4 of the
    largest entry: the kernels sum a group in another order and multiply by
    1 / sqrt(var + eps)), and against their CPU emulation (1e-6: the same
    operations in the same order, the emulation's fmaf through float64 but
    for its rare double rounding). dx with and without dgamma is the same,
    and a rerun gives the same bits."""
    from nemo_tpu_torch.models.humor import _group_norm
    from nemo_tpu_torch.ops import _emulation, groupnorm
    x, gamma, beta, gy = _gn_inputs(R, C, groups, cuda)
    xs, gs, bs = (t.clone().requires_grad_() for t in (x, gamma, beta))
    want = torch.relu(_group_norm(xs, gs, bs, groups))
    want.backward(gy)
    y, mean, rstd = groupnorm.gn_relu_fwd_cuda(x, gamma, beta, groups)
    dx, dg, db = groupnorm.gn_relu_bwd_cuda(x, gamma, beta, mean, rstd, gy,
                                            groups, wgrad=True)
    dx_alone, none_g, none_b = groupnorm.gn_relu_bwd_cuda(
        x, gamma, beta, mean, rstd, gy, groups)
    torch.cuda.synchronize()
    assert none_g is None and none_b is None
    assert torch.equal(dx_alone, dx)
    _close_scaled(y, want.detach(), 1e-5)
    for got, ref in ((dx, xs.grad), (dg, gs.grad), (db, bs.grad)):
        _close_scaled(got, ref, 1e-4)
    cpu = [t.cpu() for t in (x, gamma, beta, gy)]
    ye, me, re = _emulation.gn_relu_fwd_emulation(*cpu[:3], groups)
    dxe, dge, dbe = _emulation.gn_relu_bwd_emulation(
        *cpu[:3], mean.cpu(), rstd.cpu(), cpu[3], groups, wgrad=True)
    for got, ref in ((y, ye), (mean, me), (rstd, re), (dx, dxe), (dg, dge),
                     (db, dbe)):
        _close_scaled(got.cpu(), ref, 1e-6)
    again = groupnorm.gn_relu_fwd_cuda(x, gamma, beta, groups)
    again_b = groupnorm.gn_relu_bwd_cuda(x, gamma, beta, mean, rstd, gy,
                                         groups, wgrad=True)
    assert all(torch.equal(a, b) for a, b in zip(again + again_b,
                                                 (y, mean, rstd, dx, dg, db)))


def test_gn_relu_through_humor(cuda, monkeypatch):
    """HuMoR's posterior and prior on the card through K7 (apply_mlp's
    route) against the eager composition on the card: the outputs 1e-5 and
    the gradients of the inputs 1e-4 of their largest entries, four forward
    and four backward launches an MLP, none with frozen weights' dgamma."""
    from nemo_tpu_torch.models import humor
    gen = torch.Generator().manual_seed(3)
    cfg = humor.HumorConfig()
    p = humor.init_humor(gen, cfg)
    for mod in ("encoder", "prior"):
        for i in range(1, 5):
            p[mod][f"gn{i}_g"] = 0.5 + torch.rand(1024, generator=gen)
            p[mod][f"gn{i}_b"] = 0.3 * torch.randn(1024, generator=gen)
    p = humor.humor_to(p, cuda)
    states = torch.randn((301, 2, humor.STATE_DIM), generator=gen).to(cuda)

    def run():
        s = states.clone().requires_grad_()
        out = humor.humor_infer_seq(p, cfg, s)
        out["kl"].sum().backward()
        return out["kl"].detach(), out["z_mean"].detach(), s.grad

    reset_launches()
    got = run()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["humor_gn_fwd"] == 8 and counts["humor_gn_bwd"] == 8
    monkeypatch.setattr(humor, "_gn_relu", lambda x, g, b, n: torch.relu(
        humor._group_norm(x, g, b, n)))
    want = run()
    _close_scaled(got[0], want[0], 1e-5)
    _close_scaled(got[1], want[1], 1e-5)
    _close_scaled(got[2], want[2], 1e-4)


def test_gn_relu_kernel_resources(cuda):
    """K7's kernels at C = 1024 spill nothing."""
    from nemo_tpu_torch.ops import groupnorm
    for backward, wgrad in ((False, False), (True, False), (True, True)):
        a = groupnorm.gn_relu_attributes(backward, wgrad, 1024)
        assert a["local_bytes"] == 0, (backward, wgrad, a)
