#!/usr/bin/env python
"""Smoke test of the PyTorch port on one NVIDIA GPU: kernels, then the fit.

Run from the repository root with no arguments:

    python3 chip_smoke.py

1. Device: needs CUDA (exits nonzero without it) and prints the card's
   name and power limit as nvidia-smi reports them.
2. Build: compiles nemo_tpu_torch/csrc/*.cu for sm_90a (ops/_build.py, one
   nvcc per source, in parallel).
3. Kernels against their plain PyTorch versions on the card, at the shapes
   of the fit's paths: K1 forward and backward (random rotations at
   B=512, 960 and 60 on SMPL's tree, and at 512 and 60 on a 23-deep chain,
   a star and a random 64-joint tree, each rerun bit-identical, with the
   kernels' registers, shared memory and spills and, at 512 and 960, each
   direction's device time a launch from torch.profiler beside the one-call
   time and an empty kernel's launch floor); K2 in fused, forward-only and
   pair modes (B=512, the 6890-vertex synthetic SMPL's tables), the fused
   and forward-only modes (the one-pass kernel) also at B=960, with the
   kernel's registers, shared memory and spills; K3f and the pair mode
   (the one-pass forward kernel, with its registers, shared memory and
   spills) at (512, 6890), (960, 1024), (37, 300) and (1, 5), each run
   twice for bit-stability;
   K3b (the one-pass backward) recomputing the posed vertices and
   reading stored ones, under a random cotangent and a sign, at (512,
   6890) (the stored vertices and the sign from K2's pair mode), at path
   A's (960, 1024), at (1, 5) and at (37, 300), each run twice for
   bit-stability, with the kernel's registers, shared memory and spills;
   K5s and K5g (the tile rasterizer's stream and gather
   modes) on the synthetic problem's posed mesh at 1000 x 1900, one panel
   and a batch of four; K4 (the one-way nearest-neighbour chamfer) at
   (60, 512, 6890) and (60, 6890, 512), each rerun bit-identical, with its
   split, registers, shared memory and spills and each direction's device
   time a launch beside the launch floor and its instruction figure; K6f
   and K6b (the fused MotionNet MLP, forward and backward) at (B, D, H,
   O) = (512, 105, 1000, 147), (960, ...) and (1, ...), each run twice
   for bit-stability, with the GEMM kernel's registers, shared memory and
   spills, its distance from its CPU emulation at B=512 and the same
   products as a chain of cuBLAS calls timed beside it. Each check
   prints its max error beside its tolerance; each kernel's median CUDA-event time beside its plain
   version's, one PyTorch call's (where one computes the whole function or
   its largest contraction) and its bound (the least time the card could
   take: the larger of bytes over 3.35 TB/s and f32 FLOPs over 67 TFLOP/s;
   for the one-pass kernels (K2's fused, forward-only and pair modes, K3f,
   K3b) the operations bound counts their posedirs contractions as three
   TF32 products at 495 TFLOP/s on the tensor cores and the rest as f32, for
   K6 every product so, and the f32 bound is printed beside it).
4. The fit, one path after another, each with the launch counters zeroed
   just before and read just after, and each asserting that its own
   kernels ran:
   - slice 1: the reference configuration (bench.py's NemoConfig: NemoV2,
     batch 512, h_dim 1000, RBF 100 quadratic, 200-node phase nets, 8 views
     x 120 frames, VPoser v2v 10 + KL 1 + GMM 1), warmup, camera and main
     stages, eval_loss and the eval CSVs, the K2 fused mode;
   - path A: the custom-video configuration (run_examples/
     custom-video-example.sh: NemoV3, full_batch so B=960, weight_3d_loss
     1000, lr_phase 0, lr_factor 1) with the opt-in v2v prior on 1024
     vertices (the recipe itself keeps the full mesh) through K3f/K3b;
   - path B: slice 1's workload with the K2 pair mode, then pair_vp;
   - path C: a few steps of each stage for model versions 0, 1 and 4;
   - path D: the fit's render outputs on K5s (a mesh video of 4 views x
     30 frames, the 8 x 8 rollout figure, the comparison strip), a
     checkpoint saved and loaded into a fresh fitter, and K5g equal to K5s
     on the video's panels;
   - path E: HuMoR 3D fitting through humor_tool, process-amass on a
     synthetic raw AMASS walk, then fit-amass --obs joints verts points at
     the CLI's defaults (60 frames, 512 scan points, 30/70/70 steps, the
     reference HuMoR widths) through K4 and K1, and the eval CSVs; the SMPL
     model and the HuMoR weights come from files written as in path G;
   - path F: slice 1's reference configuration with the MotionNet through
     K6 (motion_mlp="fused"), two K6f launches a predict (the batch and the
     B = 1 phase-0 anchor), and fit_loss with its gradients against the
     plain MotionNet on the card from the same parameters and batch;
   - path G: the recipes from asset files in the real layouts, written
     into a temporary directory from the smoke's body and priors (the SMPL
     chumpy pickle and npz, J_regressor_extra.npy, a V02_05 VPoser
     snapshot, gmm_08.pkl, a HuMoR checkpoint): every loader's tensors
     bit-identical on the card, the init fit_loss from files equal to the
     in-memory one, run_examples/nemomocap-example.sh's fit through the
     CLI on a bundle with vs, pare and GLAMR baselines (5/5/10 steps,
     every 4th video frame; the eval CSVs' baseline and GLAMR columns
     finite), then the custom-video configuration without and with the
     HuMoR dynamics term (card vs CPU on the full grid, no sync, steps/s).
   Losses must be finite, main-stage kp_loss must fall on slice 1 and paths
   A and F (stage 2's loss on path E), fit_loss on the card must agree with the
   port's CPU path from the same parameters (points3d_loss and the stage-3
   loss on path E; with the HuMoR term on path G), and one step of each
   stage must run without a device synchronisation.

Prints a JSON line of per-kernel results, the nvidia-smi line as the tool
prints it, and as the last line {"ok": true, "device": {...}}. Any failure
raises (exit code 1).
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time

BATCH = 512
BATCH_A = 8 * 120       # path A's full batch: every view and frame
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores, 700 W
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores, 700 W
PEAK_HBM_BYTES = 3.35e12

# counter key -> (source, TPU kernel it replaces)
KERNELS = {
    "fk_fwd": ("nemo_tpu_torch/csrc/fk.cu",
               "nemo_tpu/ops/fk_pallas.py:197"),
    "fk_bwd": ("nemo_tpu_torch/csrc/fk.cu",
               "nemo_tpu/ops/fk_pallas.py:226"),
    "v2v_grad": ("nemo_tpu_torch/csrc/v2v.cu",
                 "nemo_tpu/ops/lbs_pallas.py:709"),
    "v2v_fwd": ("nemo_tpu_torch/csrc/v2v.cu",
                "nemo_tpu/ops/lbs_pallas.py:560"),
    "v2v_pair": ("nemo_tpu_torch/csrc/v2v.cu",
                 "nemo_tpu/ops/lbs_pallas.py:560"),
    "skin_fwd": ("nemo_tpu_torch/csrc/skin.cu",
                 "nemo_tpu/ops/lbs_pallas.py:129"),
    "skin_bwd": ("nemo_tpu_torch/csrc/skin.cu",
                 "nemo_tpu/ops/lbs_pallas.py:259"),
    "skin_bwd_vp": ("nemo_tpu_torch/csrc/skin.cu",
                    "nemo_tpu/ops/lbs_pallas.py:259"),
    "raster_stream": ("nemo_tpu_torch/csrc/raster.cu",
                      "nemo_tpu/ops/raster_pallas.py:391"),
    "raster_gather": ("nemo_tpu_torch/csrc/raster.cu",
                      "nemo_tpu/ops/raster_pallas.py:199"),
    "chamfer_nn": ("nemo_tpu_torch/csrc/chamfer.cu",
                   "nemo_tpu/ops/chamfer.py:111"),
    "mlp_fwd": ("nemo_tpu_torch/csrc/mlp.cu",
                "nemo_tpu/ops/mlp_pallas.py:153"),
    "mlp_bwd": ("nemo_tpu_torch/csrc/mlp.cu",
                "nemo_tpu/ops/mlp_pallas.py:177"),
}

# f32 operations per (batch row, vertex) of the skinning kernels (a MAC is
# 2): posing 3x207 MACs + 3 adds, blending 12x24 MACs, transforming 9 MACs;
# in a backward blending only the 3x3 rotation part, 9x24 MACs (gvp reads
# M's rotation, gA reads [vp; 1], never M's translation), gvp 9 MACs, gpf
# 3x207 MACs, gA 9 products + 12x24 MACs, gvsh 3 adds; |rec - orig| and its
# sum 9.
POSE_FLOP = 2 * 621 + 3
BLEND_FLOP = 2 * 288
BWD_BLEND_FLOP = 2 * 216
SIDE_FLOP = POSE_FLOP + BLEND_FLOP + 2 * 9
# one posedirs contraction per (batch row, vertex): a side's forward vph or
# the backward gpf. The one-pass kernels run them on the TF32 tensor cores
# as three products each (3xTF32): K2 the forward of both sides and gpf,
# K3b gpf and, recomputing the posed vertices, the forward of its one side,
# K3f and K2's pair mode the forward of each side; the rest of their work
# stays on the CUDA cores
POSE_TC_FLOP = 2 * 621
K2_TC_FWD_FLOP = 2 * POSE_TC_FLOP
K2_TC_GRAD_FLOP = POSE_TC_FLOP
GRAD_FLOP = 2 * 9 + 2 * 621 + 9 + 2 * 288 + 3
L1_FLOP = 9
# per joint: forward R = R_p R_l (27 MACs), t = R_p t_l + t_p (9 MACs + 3);
# backward twice the products (the parent's and the local cotangents)
FK_FLOP_PER_JOINT = {"fk_fwd": 2 * (27 + 9) + 3,
                     "fk_bwd": 2 * 2 * (27 + 9) + 3}
# f32 operations of one face test at one pixel in the rasterizer's fold
# (csrc/raster_common.cuh): three edge functions of 2 subtractions, 2
# products and 1 subtraction each (15), three sign products and three
# comparisons (6), three barycentric and three inverse-depth products (6),
# 2 additions, 1 depth comparison: 30. The bound counts them for each
# (entry, sub-tile) pair the kernel folds, over the sub-tile's 256 pixels:
# the span scatter's repeated entries and the pairs the exact cull rules
# out need no work. The TPU kernel's dense work (each distinct (face,
# tile) pair over the tile's 4096 pixels) is printed beside it. Bytes:
# each entry read once (9 f32 attributes and a face id), z, fid and bary
# written (20 B a pixel).
RASTER_FLOP = 30
RASTER_TILE_PIXELS = 32 * 128
RASTER_SUBTILE_PIXELS = 8 * 32   # a warp's sub-tile in csrc/raster.cu
RASTER_ENTRY_BYTES = 40
RASTER_PIXEL_BYTES = 20
IMG_HW = (1000, 1900)    # synthetic_problem's image, (D0 height, D1 width)
# f32 operations per (query, candidate) pair of the chamfer search: 3
# products and 2 sums for the dot, the product by 2, one sum, one
# difference, one comparison
CHAMFER_FLOP = 9
# f32 instructions csrc/chamfer.cu issues a pair for that arithmetic: it
# doubles each query once and takes the minimum a group at a time (fminf),
# so 3 products, 4 sums and a minimum
CHAMFER_INSTR = 8
# f32 instructions the card issues a second: 132 SMs x 128 lanes at 1.98 GHz
LANE_INSTR_PER_S = 132 * 128 * 1.98e9
# path E: fit-amass's defaults (seq_len 60, num_samp_pts 512, steps 30 70
# 70, lr 1e-2, latent 48) on the 6890-vertex synthetic SMPL
SEQ_LEN, SAMP_PTS = 60, 512
# the reference MotionNet (bench.py:101): input RBF 100 + instance code 5,
# width 1000, heads 24 x 6 rotations + 3 translations
MLP_D, MLP_H, MLP_O = 105, 1000, 147


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(flop: float, bytes_: float):
    """(least time in ms, what bounds it)."""
    t_op, t_mem = flop / PEAK_F32_FLOPS, bytes_ / PEAK_HBM_BYTES
    return 1e3 * max(t_op, t_mem), ("operations" if t_op >= t_mem else "bytes")


def tc_bound_ms(flop: float, tc_flop: float, bytes_: float):
    """A one-pass kernel's least time with its posedirs contractions
    (tc_flop of the flop) on the tensor cores in 3xTF32 and the rest in
    f32 on the CUDA cores: (ms, "tensor cores", "CUDA cores" or
    "bytes")."""
    times = {"tensor cores": 3 * tc_flop / PEAK_TF32_FLOPS,
             "CUDA cores": (flop - tc_flop) / PEAK_F32_FLOPS,
             "bytes": bytes_ / PEAK_HBM_BYTES}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def check(name: str, got, want, atol: float, results: dict) -> float:
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = math.isfinite(err) and err <= atol
    print(f"[kernel] {name}: max_abs_err {err:.3e} (tolerance {atol:.3e}), "
          f"relative to max |plain| {err / max(scale, 1e-30):.3e} "
          f"(max |plain| {scale:.3e}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    results[name] = max(results.get(name, 0.0), err)
    return err


def time_kernel(rec, key, shape, kernel, plain, flop, bytes_, library=None,
                plain_reps: int = 20, tc_flop=None):
    """Median CUDA-event times of a kernel, its plain version and one
    PyTorch call, beside the bound; given the flop its tensor cores take,
    the bound is the tensor-core one and the f32 bound is only printed.
    The first record of a key is kept."""
    f32_ms, by = bound_ms(flop, bytes_)
    b_ms = f32_ms
    if tc_flop is not None:
        b_ms, tc_by = tc_bound_ms(flop, tc_flop, bytes_)
        by = "bytes" if tc_by == "bytes" else "operations"
    r = {"ms": median_ms(kernel),
         "plain_ms": median_ms(plain, reps=plain_reps,
                               warm=min(3, plain_reps)),
         "library_ms": None if library is None else median_ms(library),
         "bound_ms": b_ms, "bound_by": by, "shape": shape,
         "gflop": flop / 1e9, "mbytes": bytes_ / 1e6}
    lib = "none" if library is None else f"{r['library_ms']:.4f} ms"
    print(f"[time] {key} {shape}: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, one PyTorch call {lib}, bound "
          f"{b_ms:.4f} ms ({by}; {flop / 1e9:.3f} GFLOP, "
          f"{bytes_ / 1e6:.3f} MB) (median of 20 CUDA-event timings, "
          f"{plain_reps} of the plain version)")
    if tc_flop is not None:
        print(f"[time] {key} {shape}: tensor-core bound {b_ms:.4f} ms "
              f"({tc_by}; {3 * tc_flop / 1e9:.3f} GFLOP in 3xTF32 at 495 "
              f"TFLOP/s, {(flop - tc_flop) / 1e9:.3f} GFLOP f32 at 67) "
              f"beside the f32 bound {f32_ms:.4f} ms; kernel at "
              f"{100 * b_ms / r['ms']:.1f}% of it ({nvidia_smi_line()})")
    rec.setdefault(key, r)
    return r


def profiled_ms(fn, kernels, reps: int = 20, launches: int = 1,
                tries: int = 5) -> dict:
    """{kernel: mean device time a launch in ms, or None} for the launches
    whose name holds ``kernel``, from torch.profiler over ``reps`` calls of
    fn, each of which launches every kernel ``launches`` times (device time
    alone: neither the host's work nor the gaps between launches). A trace
    may lose the device events of its first launches (late in a long
    process, the first few milliseconds' worth), so each trace runs fn
    ``reps`` times unmeasured, then the ``reps`` measured calls inside a
    mark. A kernel's time comes only from a trace that holds all reps x
    launches of its launches after the mark; fn is traced again while a
    kernel lacks one, up to ``tries`` traces, and a kernel that none held
    whole maps to None ("not measured")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    out = dict.fromkeys(kernels)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            with record_function("profiled_ms"):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        t0 = next(e.time_range.start for e in events
                  if e.name == "profiled_ms"
                  and e.device_type == DeviceType.CPU)
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and e.time_range.start >= t0]
        for k in kernels:
            mine = [e.time_range.elapsed_us() for e in device if k in e.name]
            if out[k] is None and len(mine) == reps * launches:
                out[k] = sum(mine) / len(mine) / 1e3
        if all(v is not None for v in out.values()):
            break
    return out


def device_ms_text(ms, reps: int = 20) -> str:
    """profiled_ms's entry as text."""
    if ms is None:
        return f"not measured (no trace held all {reps} launches)"
    return f"{ms:.4f} ms (torch.profiler, mean of {reps} launches)"


def random_rotations(B: int, J: int, gen, device, scale: float = 0.6):
    import torch
    from nemo_tpu_torch.geometry.rotations import batch_rodrigues
    aa = scale * torch.randn((B, J, 3), generator=gen)
    return batch_rodrigues(aa).to(device)


def skin_side_inputs(smpl, B, gen, device, offset=0.0):
    """(pf, A34) as smpl_v2v_l1_sum builds them from random rotations; a
    nonzero offset moves each row by +-offset metres on each axis."""
    import torch
    from nemo_tpu_torch.body.smpl import fk_rt
    Jr = torch.einsum('jv,vk->jk', smpl.J_regressor, smpl.v_template)[None]
    with torch.no_grad():
        rot = random_rotations(B, 24, gen, device)
        pf = (rot[:, 1:] - torch.eye(3, device=device)).reshape(B, 207)
        R_g, _, t_rel = fk_rt(rot, Jr, smpl.parents)
        A = torch.cat([R_g, t_rel[..., None]], -1)
    if offset:
        A[..., 3] += offset * torch.sign(torch.randn((B, 1, 3),
                                                     generator=gen)).to(device)
    return pf.contiguous(), A.reshape(B, 24, 12).contiguous()


def k3b_checks(a, g, vp, tag, errs):
    """K3b recomputing the posed vertices and reading the stored vp against
    the plain version under the cotangent g, each rerun bit-identical
    (fixed-order partials, no atomics). Tolerance: sums over V (gpf, gA) or
    B (gvsh) products, the posedirs ones in 3xTF32, in another order; atol
    1e-4 x the tensor's largest entry. Returns both modes' gradients."""
    import torch
    from nemo_tpu_torch.ops import lbs
    out = []
    for key, stored in (("skin_bwd", None), ("skin_bwd_vp", vp)):
        got = lbs.skin_bwd_cuda(*a, g, vp=stored)
        for name, gk, gp in zip(("gpf", "gA", "gvsh"), got,
                                lbs.skin_bwd_plain(*a, g, vp=stored)):
            check(f"{key} {name} {tag}", gk, gp, 1e-4 * float(gp.abs().max()),
                  errs)
        if not all(torch.equal(x, y) for x, y in
                   zip(lbs.skin_bwd_cuda(*a, g, vp=stored), got)):
            raise AssertionError(f"{key} is not bit-stable run to run ({tag})")
        out.append(got)
    return out


def kernel_phase(device, smpl):
    """Every kernel against its plain version, with times and bounds.
    Returns ({kernel: max_abs_err}, {kernel: timing record})."""
    import torch
    from nemo_tpu_torch.body.smpl import subset_skin_tables
    from nemo_tpu_torch.ops import fk, lbs

    gen = torch.Generator().manual_seed(0)
    errs, rec = {}, {}
    parents = tuple(int(p) for p in smpl.parents)
    B, B_A, J, V = BATCH, BATCH_A, 24, smpl.num_vertices

    def timed(*a, **k):
        return time_kernel(rec, *a, **k)

    # K1 at slice 1's batch, path A's full batch (8 views x 120 frames) and
    # path E's 60-frame windows on SMPL's tree, and at 512 and 60 on a
    # 23-deep chain, a star and a random 64-joint tree; each rerun must give
    # the same bits (fixed-order folds, no atomics). Tolerance: a chain of
    # up to 23 f32 3x3 products of O(1) entries; the two sides differ only
    # in summation order and FMA (~1e-7 a product). The cases beyond
    # SMPL's at 512 and 960 draw from a generator of their own, so the
    # later kernels' inputs stay as they were.
    tree_gen = torch.Generator().manual_seed(64)
    fk_trees = {"smpl": parents, "chain": (-1,) + tuple(range(23)),
                "star": (-1,) + (0,) * 23,
                "random64": (-1,) + tuple(
                    int(torch.randint(0, j, (1,), generator=tree_gen))
                    for j in range(1, 64))}
    print("[kernel] fk_fwd_kernel, fk_bwd_kernel resources at J=24 "
          "(cudaFuncGetAttributes): " + json.dumps(
              [fk.fk_attributes(False), fk.fk_attributes(True)]))
    fk_cases = [("smpl", B), ("smpl", B_A), ("smpl", SEQ_LEN)] + [
        (tree, Bk) for tree in ("chain", "star", "random64")
        for Bk in (B, SEQ_LEN)]
    for tree, Bk in fk_cases:
        par = fk_trees[tree]
        Jk, tag = len(par), f"{tree} B={Bk}"
        g = gen if tree == "smpl" and Bk in (B, B_A) else tree_gen
        R_l = random_rotations(Bk, Jk, g, device)
        t_l = (0.3 * torch.randn((Bk, Jk, 3), generator=g)).to(device)
        gR = torch.randn((Bk, Jk, 3, 3), generator=g).to(device)
        gt = torch.randn((Bk, Jk, 3), generator=g).to(device)
        Rk, tk = fk.fk_fwd_cuda(R_l, t_l, par)
        Rp, tp = fk.fk_fwd_plain(R_l, t_l, par)
        check(f"fk_fwd {tag}", torch.cat([Rk.flatten(), tk.flatten()]),
              torch.cat([Rp.flatten(), tp.flatten()]), 1e-5, errs)
        gRk, gtk = fk.fk_bwd_cuda(R_l, t_l, Rk, gR, gt, par)
        gRp, gtp = fk.fk_bwd_plain(R_l, t_l, Rp, gR, gt, par)
        # cotangents are N(0,1) summed over up to 63 descendants: O(10)
        check(f"fk_bwd {tag}", torch.cat([gRk.flatten(), gtk.flatten()]),
              torch.cat([gRp.flatten(), gtp.flatten()]), 1e-4, errs)
        again = fk.fk_fwd_cuda(R_l, t_l, par) + fk.fk_bwd_cuda(
            R_l, t_l, Rk, gR, gt, par)
        if not all(torch.equal(a, b)
                   for a, b in zip(again, (Rk, tk, gRk, gtk))):
            raise AssertionError(f"K1 is not bit-stable run to run ({tag})")
        if tree != "smpl" or Bk == SEQ_LEN:
            continue
        # no single PyTorch call composes a kinematic tree: library none
        calls = {"fk_fwd": lambda: fk.fk_fwd_cuda(R_l, t_l, par),
                 "fk_bwd": lambda: fk.fk_bwd_cuda(R_l, t_l, Rk, gR, gt, par)}
        r = {"fk_fwd": timed(
            "fk_fwd", f"B={Bk}", calls["fk_fwd"],
            lambda: fk.fk_fwd_plain(R_l, t_l, par),
            FK_FLOP_PER_JOINT["fk_fwd"] * (Jk - 1) * Bk,
            nbytes(R_l, t_l, Rk, tk))}
        r["fk_bwd"] = timed(
            "fk_bwd", f"B={Bk}", calls["fk_bwd"],
            lambda: fk.fk_bwd_plain(R_l, t_l, Rk, gR, gt, par),
            FK_FLOP_PER_JOINT["fk_bwd"] * (Jk - 1) * Bk,
            nbytes(R_l, t_l, Rk, gR, gt, gRk, gtk))
        dev = profiled_ms(lambda: (calls["fk_fwd"](), calls["fk_bwd"](),
                                   fk.fk_empty_cuda(Bk, Jk, False, device)),
                          ("fk_fwd_kernel", "fk_bwd_kernel",
                           "fk_empty_kernel"))
        ms = {k: device_ms_text(v) for k, v in dev.items()}
        for key in calls:
            print(f"[time] {key} B={Bk}: device time a launch "
                  f"{ms[key + '_kernel']}, one "
                  f"call {r[key]['ms']:.4f} ms, launch floor "
                  f"{ms['fk_empty_kernel']} (an empty kernel on K1's grid), "
                  f"bound {r[key]['bound_ms']:.4f} ms ({nvidia_smi_line()})")

    # K2 inputs as smpl_v2v_l1_sum builds them. The rec side gets a
    # per-row offset of +-10 m on each axis, so no vertex difference is
    # near 0: there sign(rec - orig) could flip between two summation
    # orders and move a gradient entry by a whole term.
    vsh = smpl.v_template.t().contiguous()
    pd, W = smpl.posedirs_t, smpl.lbs_weights_t
    print(f"[kernel] v2v_fused_kernel resources (cudaFuncGetAttributes): "
          f"{json.dumps(lbs.v2v_fused_attributes())}")

    def k2_inputs(Bk, g):
        pf_o, A_o = skin_side_inputs(smpl, Bk, g, device)
        pf_r, A_r = skin_side_inputs(smpl, Bk, g, device, offset=10.0)
        return (pf_o, A_o, vsh, pd, W, pf_r, A_r)

    fwd_res = {k: lbs.skin_fwd_attributes(k == "pair")
               for k in ("skin_fwd", "pair")}
    print(f"[kernel] skin_fwd_kernel resources (cudaFuncGetAttributes): "
          f"{json.dumps(fwd_res)}")

    def fwd_stable(args, got, tag):
        """The pair mode rerun bit-identical, and without vp the same total
        and sign."""
        again = lbs.v2v_pair_cuda(*args, want_vp=True)
        tot_n, sign_n, none = lbs.v2v_pair_cuda(*args, want_vp=False)
        if not (all(torch.equal(x, y) for x, y in zip(again, got)) and
                none is None and torch.equal(tot_n, got[0]) and
                torch.equal(sign_n, got[1])):
            raise AssertionError(f"v2v_pair is not bit-stable ({tag})")

    def pair_checks(args, tag):
        """The pair mode against its plain version: total rtol 1e-5 (sums
        of B x 3V |diff| terms in another order), sign exact (the rec side
        offset by +-10 m), vp within 1e-5 of its largest entry (sums of
        207 products, in 3xTF32, in another order); then fwd_stable."""
        got = lbs.v2v_pair_cuda(*args, want_vp=True)
        tot_p, sign_p, vp_p = lbs.v2v_pair_plain(*args, want_vp=True)
        check(f"v2v_pair total {tag}", got[0], tot_p,
              1e-5 * float(tot_p.abs()), errs)
        check(f"v2v_pair sign {tag}", got[1], sign_p, 0.0, errs)
        check(f"v2v_pair vp {tag}", got[2], vp_p,
              1e-5 * float(vp_p.abs().max()), errs)
        fwd_stable(args, got, tag)

    def k3f_check(a, tag):
        """K3f against its plain version (sums of 207 + 24 + 3 f32 products
        of metre-scale values: 1e-5 of the largest entry), rerun
        bit-identical."""
        out_k = lbs.skin_fwd_cuda(*a)
        out_p = lbs.skin_verts_t_plain(*a)
        check(f"skin_fwd {tag}", out_k, out_p,
              1e-5 * float(out_p.abs().max()), errs)
        if not torch.equal(lbs.skin_fwd_cuda(*a), out_k):
            raise AssertionError(f"skin_fwd is not bit-stable ({tag})")

    def k2_fused_checks(args, tag):
        """K2's one-pass kernel (fused and forward-only modes) against the
        plain version; returns (total, grads) of each."""
        tot_k, grads_k = lbs.v2v_l1_cuda(*args, grad=True)
        tot_p, grads_p = lbs.v2v_l1_plain(*args, grad=True)
        tot_f, _ = lbs.v2v_l1_cuda(*args, grad=False)
        # total: B x 20670 |diff| terms summed in another order, rtol 1e-5
        check(f"v2v_grad total{tag}", tot_k, tot_p,
              1e-5 * float(tot_p.abs()), errs)
        check(f"v2v_fwd total{tag}", tot_f, tot_p,
              1e-5 * float(tot_p.abs()), errs)
        if not torch.equal(tot_f, tot_k):
            raise AssertionError(f"forward-only total differs from grad "
                                 f"mode{tag}")
        # gradients: sums of up to 3V = 20670 products (the posedirs ones
        # in 3xTF32) in another order; atol 1e-4 x the tensor's largest
        # entry
        for name, gk, gp in zip(("gpf", "gA", "gvsh"), grads_k, grads_p):
            check(f"v2v_grad {name}{tag}", gk, gp,
                  1e-4 * float(gp.abs().max()), errs)
        rerun = lbs.v2v_l1_cuda(*args, grad=True)
        if not (torch.equal(rerun[0], tot_k) and all(
                torch.equal(a, b) for a, b in zip(rerun[1], grads_k))):
            raise AssertionError(f"K2 is not bit-stable run to run{tag}")
        return (tot_k, grads_k), (tot_p, grads_p)

    def k2_times(args, grads, tot, gvp):
        """Times of K2's fused and forward-only modes; gvp (B, 3V) feeds
        the one PyTorch call of the fused mode's largest contraction."""
        Bk = args[0].shape[0]
        bv = Bk * V
        VV = 3 * V
        pf2 = torch.cat([args[0], args[5]])
        pd2 = pd.reshape(207, VV)
        io = nbytes(*args[:2], *args[5:], tot) + nbytes(vsh, pd, W)
        timed("v2v_grad", f"B={Bk}, V={V}",
              lambda: lbs.v2v_l1_cuda(*args, grad=True),
              lambda: lbs.v2v_l1_plain(*args, grad=True),
              bv * (2 * SIDE_FLOP + L1_FLOP + GRAD_FLOP),
              io + nbytes(*grads),
              library=lambda: torch.matmul(gvp, pd2.t()),
              tc_flop=bv * (K2_TC_FWD_FLOP + K2_TC_GRAD_FLOP))
        timed("v2v_fwd", f"B={Bk}, V={V}",
              lambda: lbs.v2v_l1_cuda(*args, grad=False),
              lambda: lbs.v2v_l1_plain(*args, grad=False),
              bv * (2 * SIDE_FLOP + L1_FLOP), io,
              library=lambda: torch.matmul(pf2, pd2),
              tc_flop=bv * K2_TC_FWD_FLOP)

    args = k2_inputs(B, gen)
    pf_o, A_o, _, _, _, pf_r, A_r = args
    side = (pf_o, A_o, vsh, pd, W)
    (tot_k, (gpf_k, gA_k, gvsh_k)), (tot_p, (gpf_p, gA_p, gvsh_p)) = \
        k2_fused_checks(args, "")

    # K2 pair mode: sign exact (the offset keeps every difference far from
    # 0), vp to f32 ordering noise, and the gradients K3b computes from
    # them against the plain gradients.
    tot_q, sign_k, vp_k = lbs.v2v_pair_cuda(*args, want_vp=True)
    _, sign_p, vp_p = lbs.v2v_pair_plain(*args, want_vp=True)
    check("v2v_pair total", tot_q, tot_p, 1e-5 * float(tot_p.abs()), errs)
    check("v2v_pair sign", sign_k, sign_p, 0.0, errs)
    check("v2v_pair vp", vp_k, vp_p, 1e-5 * float(vp_p.abs().max()), errs)
    fwd_stable(args, (tot_q, sign_k, vp_k), f"B={B}, V={V}")
    pair = lbs.skin_bwd_cuda(*side, sign_k)
    pair_vp = lbs.skin_bwd_cuda(*side, sign_k, vp=vp_k)
    for name, gk, gp in zip(("gpf", "gA", "gvsh"), pair, (gpf_p, gA_p, gvsh_p)):
        check(f"v2v_pair grad {name}", gk, gp, 1e-4 * float(gp.abs().max()),
              errs)
    # Not bit-identical by design, so only printed: K3b recomputes vp in
    # 3xTF32 on the tensor cores, K2's pair mode stores a vp summed in f32
    # on the CUDA cores; the 1e-5 checks below hold them together.
    ident = {
        "pair_vp vs pair": all(torch.equal(a, b) for a, b in zip(pair_vp, pair)),
        "pair vs fused": all(torch.equal(a, b) for a, b in
                             zip(pair, (gpf_k, gA_k, gvsh_k)))}
    print(f"[kernel] bit-identical gradients: {json.dumps(ident)}")
    for name, a, b in zip(("gpf", "gA", "gvsh"), pair_vp, pair):
        check(f"skin_bwd_vp vs skin_bwd (pair) {name}", a, b,
              1e-5 * float(b.abs().max()), errs)

    # K3b under a random cotangent at (512, 6890), both modes, the stored
    # posed vertices the K2 pair mode's vp; then at the small shapes
    res = {m: lbs.skin_bwd_attributes(m == "stored_vp")
           for m in ("recompute", "stored_vp")}
    print(f"[kernel] skin_bwd_kernel resources (cudaFuncGetAttributes): "
          f"{json.dumps(res)}")
    g = torch.randn((B, 3, V), generator=gen).to(device)
    got, got_vp = k3b_checks(side, g, vp_k, f"B={B}, V={V}", errs)
    ident["skin_bwd_vp vs skin_bwd (random g)"] = all(
        torch.equal(a, b) for a, b in zip(got_vp, got))
    print(f"[kernel] bit-identical gradients: {json.dumps(ident)}")
    posed = lambda a: (torch.einsum('bp,pkv->bkv', a[0], a[3])
                       + a[2]).contiguous()
    gen_s = torch.Generator().manual_seed(1)
    for Bk, Vk in ((1, 5), (37, 300)):
        vidx, pd_s, W_s = subset_skin_tables(smpl, Vk)
        a = (*skin_side_inputs(smpl, Bk, gen_s, device),
             vsh[:, vidx].contiguous(), pd_s, W_s)
        gk = torch.randn((Bk, 3, Vk), generator=gen_s).to(device)
        for gname, gg in (("random g", gk), ("sign g", torch.sign(gk))):
            k3b_checks(a, gg, posed(a), f"B={Bk}, V={Vk}, {gname}", errs)

    # K3f at the slice-1 shape and at path A's (B=960, V=1024 subset); then
    # K3f and the pair mode at path A's shape and at the ragged (37, 300)
    # and (1, 5), each rerun bit-identical (fixed-order partials, no
    # atomics)
    vidx, pd_s, W_s = subset_skin_tables(smpl, 1024)
    pf_a, A_a = skin_side_inputs(smpl, B_A, gen, device)
    fwd_cases = (((pf_o, A_o, vsh, pd, W), f"B={B}, V={V}"),
                 ((pf_a, A_a, vsh[:, vidx].contiguous(), pd_s, W_s),
                  f"B={B_A}, V={len(vidx)}"))
    for a, shape in fwd_cases:
        k3f_check(a, shape)
    for Bk, Vk in ((B_A, 1024), (37, 300), (1, 5)):
        vi, pd_k, W_k = subset_skin_tables(smpl, Vk)
        a = (*skin_side_inputs(smpl, Bk, gen_s, device),
             vsh[:, vi].contiguous(), pd_k, W_k)
        shape = f"B={Bk}, V={len(vi)}"
        if Bk != B_A:
            k3f_check(a, shape)
        pair_args = (*a, *skin_side_inputs(smpl, Bk, gen_s, device,
                                           offset=10.0))
        pair_checks(pair_args, shape)

    # times at the paths' shapes
    VV = 3 * V
    pd2 = pd.reshape(207, VV)
    gvp = torch.randn((B, VV), generator=gen).to(device)
    pf2 = torch.cat([pf_o, pf_r])
    tables = nbytes(vsh, pd, W)
    bv = B * V
    k2_times(args, (gpf_k, gA_k, gvsh_k), tot_k, gvp)
    timed("v2v_pair", f"B={B}, V={V}, vp stored",
          lambda: lbs.v2v_pair_cuda(*args, want_vp=True),
          lambda: lbs.v2v_pair_plain(*args, want_vp=True),
          bv * (2 * SIDE_FLOP + L1_FLOP),
          nbytes(pf_o, A_o, pf_r, A_r, tot_k, sign_k, vp_k) + tables,
          library=lambda: torch.matmul(pf2, pd2),
          tc_flop=bv * K2_TC_FWD_FLOP)
    # K2's fused and forward-only modes at the custom-video recipe's full
    # batch (8 views x 120 frames), checked and timed as at B=512
    # (a generator of its own, so the later phases draw what they drew)
    gen_a = torch.Generator().manual_seed(B_A)
    args_a = k2_inputs(B_A, gen_a)
    (tot_a, grads_a), _ = k2_fused_checks(args_a, f" B={B_A}")
    k2_times(args_a, grads_a, tot_a,
             torch.randn((B_A, 3 * V), generator=gen_a).to(device))
    del args_a, grads_a
    timed("skin_bwd", f"B={B}, V={V}",
          lambda: lbs.skin_bwd_cuda(*side, g),
          lambda: lbs.skin_bwd_plain(*side, g),
          bv * (POSE_FLOP + BWD_BLEND_FLOP + GRAD_FLOP),
          nbytes(*side, g, *got), library=lambda: torch.matmul(gvp, pd2.t()),
          tc_flop=bv * 2 * POSE_TC_FLOP)
    timed("skin_bwd_vp", f"B={B}, V={V}",
          lambda: lbs.skin_bwd_cuda(*side, g, vp=vp_k),
          lambda: lbs.skin_bwd_plain(*side, g, vp=vp_k),
          bv * (BWD_BLEND_FLOP + GRAD_FLOP),
          nbytes(A_o, pd, W, g, vp_k, *got),
          library=lambda: torch.matmul(gvp, pd2.t()),
          tc_flop=bv * POSE_TC_FLOP)
    for a, shape in reversed(fwd_cases):     # path A's shape is the record
        Bk, Vk = a[0].shape[0], a[2].shape[1]
        pdk = a[3].reshape(207, 3 * Vk)
        timed("skin_fwd", shape, lambda: lbs.skin_fwd_cuda(*a),
              lambda: lbs.skin_verts_t_plain(*a),
              Bk * Vk * SIDE_FLOP, nbytes(*a) + 4 * Bk * 3 * Vk,
              library=lambda: torch.matmul(a[0], pdk),
              tc_flop=Bk * Vk * POSE_TC_FLOP)
    # K3b at path A's shape under a random cotangent and a sign: recomputing
    # vp, as the subset loss runs it, and reading it stored; timed in the
    # log beside the (512, 6890) one
    Bk, Vk = B_A, len(vidx)
    a = fwd_cases[1][0]
    ga = torch.randn((Bk, 3, Vk), generator=gen).to(device)
    vp_a = posed(a)
    got_a, _ = k3b_checks(a, ga, vp_a, f"B={Bk}, V={Vk}", errs)
    k3b_checks(a, torch.sign(ga), vp_a, f"B={Bk}, V={Vk}, sign g", errs)
    pdk = a[3].reshape(207, 3 * Vk)
    gvpa = torch.randn((Bk, 3 * Vk), generator=gen).to(device)
    timed("skin_bwd path A", f"B={Bk}, V={Vk}",
          lambda: lbs.skin_bwd_cuda(*a, ga),
          lambda: lbs.skin_bwd_plain(*a, ga),
          Bk * Vk * (POSE_FLOP + BWD_BLEND_FLOP + GRAD_FLOP),
          nbytes(*a, ga, *got_a), library=lambda: torch.matmul(gvpa, pdk.t()),
          tc_flop=Bk * Vk * 2 * POSE_TC_FLOP)
    timed("skin_bwd_vp path A", f"B={Bk}, V={Vk}",
          lambda: lbs.skin_bwd_cuda(*a, ga, vp=vp_a),
          lambda: lbs.skin_bwd_plain(*a, ga, vp=vp_a),
          Bk * Vk * (BWD_BLEND_FLOP + GRAD_FLOP),
          nbytes(a[1], a[3], a[4], ga, vp_a, *got_a),
          library=lambda: torch.matmul(gvpa, pdk.t()),
          tc_flop=Bk * Vk * POSE_TC_FLOP)

    kernel_err = {
        "fk_fwd": max(errs[k] for k in errs if k.startswith("fk_fwd")),
        "fk_bwd": max(errs[k] for k in errs if k.startswith("fk_bwd")),
        "v2v_grad": max(errs[k] for k in errs if k.startswith("v2v_grad")),
        "v2v_fwd": max(errs[k] for k in errs if k.startswith("v2v_fwd")),
        "v2v_pair": max(errs[k] for k in errs if k.startswith("v2v_pair")),
        "skin_fwd": max(errs[k] for k in errs if k.startswith("skin_fwd")),
        "skin_bwd": max(errs[k] for k in errs if k.startswith("skin_bwd ")),
        "skin_bwd_vp": max(errs[k] for k in errs
                           if k.startswith("skin_bwd_vp")),
    }
    return kernel_err, rec


def posed_panels(smpl, bundle, device, views):
    """The synthetic problem's ground-truth mesh at frame 0 of each view, in
    that view's camera frame: (verts_cam (N, V, 3), focals, centers)."""
    import numpy as np
    import torch
    from nemo_tpu_torch.body.smpl import smpl_forward
    from nemo_tpu_torch.geometry.camera import camera_from_params_np
    pose = torch.as_tensor(bundle.gt3d_pose[views, 0], device=device)
    trans = torch.as_tensor(bundle.gt3d_trans[views, 0], device=device)
    with torch.no_grad():
        verts, _ = smpl_forward(smpl, torch.zeros((1, 10), device=device),
                                pose[:, 3:], pose[:, :3], pose2rot=True,
                                want_vertices=True, transl=trans)
    cams = [camera_from_params_np(bundle.gt_cameras[v], *IMG_HW)
            for v in views]
    R = torch.as_tensor(np.stack([c.rotation for c in cams]), device=device)
    t = torch.as_tensor(np.stack([c.translation for c in cams]),
                        device=device)
    verts_cam = (verts @ R.transpose(-1, -2) + t[:, None]).contiguous()
    return (verts_cam, [float(c.focal_length) for c in cams],
            [(float(c.center[0]), float(c.center[1])) for c in cams])


def raster_pairs(ent):
    """Distinct (face, tile) pairs that a fold of ``ent`` reads (the span
    scatter's duplicate entries of a face in a tile counted once)."""
    import torch
    counts = ent.counts
    tile = torch.repeat_interleave(torch.arange(counts.numel(),
                                                device=counts.device), counts)
    first = torch.repeat_interleave(ent.starts, counts)
    offset = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    face = ent.face[first + torch.arange(tile.numel(), device=tile.device)
                    - offset]
    return torch.unique(tile * (ent.N * ent.F) + face).numel()


def raster_phase(device, smpl, bundle, rec):
    """K5s and K5g against the plain fold on the card at path D's shapes:
    the posed 6890-vertex mesh at 1000 x 1900, one panel and a batch of
    four views ("body"); the same mesh 30 m further away, so a few tiles
    hold all of its entries ("crowded"); and the mesh with every face twice,
    each twin 13776 faces later in its tiles, so equal depths meet in
    different work items and the first must win ("tie", which must also
    equal "body"). Every output must be bit-identical to the plain
    version's (torch.equal on z, fid and bary), and so must a second run;
    K5g equals K5s on "body" (no overflow); on the crowded and tie cases
    gather mode drops the entries past its default capacity as its plain
    version does. The image's ragged right and bottom tiles are part of
    every comparison. Returns {kernel: max_abs_err} and adds the body's
    times to rec."""
    import torch
    from nemo_tpu_torch.ops import raster
    faces = torch.as_tensor(smpl.faces, device=device).long()
    verts_cam, focals, centers = posed_panels(smpl, bundle, device,
                                              [0, 1, 2, 3])
    far = verts_cam.clone()
    far[..., 2] += 30.0
    for name, att in raster.raster_attributes().items():
        print(f"[raster] {name} kernel: {json.dumps(att)}")
    errs = {}
    outs = {}
    for n, shape in ((4, "4 panels 1000x1900"), (1, "1 panel 1000x1900")):
        for case, v, f in (("body", verts_cam, faces), ("crowded", far, faces),
                           ("tie", verts_cam, torch.cat([faces, faces]))):
            ent = raster.prepare(v[:n], f, focals[:n], centers[:n], IMG_HW)
            if case == "body":
                for i in range(n):
                    if raster.gather_mode_overflow(
                            verts_cam[i].cpu().numpy(), smpl.faces,
                            focals[i], centers[i], IMG_HW):
                        raise AssertionError(f"panel {i}: gather mode "
                                             "overflows")
            si, gi = raster.stream_inputs(ent), raster.gather_inputs(ent)
            calls = {"raster_stream":
                     lambda: raster.raster_stream_cuda(ent, si, IMG_HW),
                     "raster_gather":
                     lambda: raster.raster_gather_cuda(ent, gi, IMG_HW)}
            got = {k: fn() for k, fn in calls.items()}
            for key, stream in (("raster_stream", True),
                                ("raster_gather", False)):
                want = raster.rasterize_plain(ent, IMG_HW, stream=stream)
                again = calls[key]()
                tag = f"{key} {case} {shape}"
                for part, a, b, c in zip(("z", "fid", "bary"), got[key],
                                         want, again):
                    if not (torch.equal(a, b) and torch.equal(a, c)):
                        raise AssertionError(f"{tag}: {part} differs from "
                                             "the plain version's or the "
                                             "rerun's")
                cov = torch.isfinite(want[0])
                check(f"{tag} z", got[key][0][cov], want[0][cov], 0.0, errs)
                check(f"{tag} bary", got[key][2], want[2], 0.0, errs)
            if case == "body" and not all(torch.equal(a, b) for a, b in zip(
                    got["raster_gather"], got["raster_stream"])):
                raise AssertionError(f"K5g differs from K5s at {shape}")
            if case == "tie" and not all(torch.equal(a, b) for a, b in zip(
                    got["raster_stream"], outs[n])):
                raise AssertionError(f"tie {shape}: a later twin won")
            outs.setdefault(n, got["raster_stream"])
            work = raster.raster_work(ent)
            print(f"[raster] {case} {shape}: bit-identical to the plain "
                  f"version and on a rerun, both modes; {work['entries']} "
                  f"entries, busiest tile {work['busiest_tile']} entries, "
                  f"{work['busy_tiles']} of {ent.counts.numel()} tiles hold "
                  f"entries, {work['items']} work items of "
                  f"{raster.CHUNK} entries, {work['subtiles_folded']} of "
                  f"{work['subtile_tests']} (entry, sub-tile) pairs folded "
                  f"after the cull; coverage "
                  f"{float(torch.isfinite(got['raster_stream'][0]).float().mean()):.4f}")
            if case != "body":
                print(f"[time] raster {case} {shape}: K5s "
                      f"{median_ms(calls['raster_stream']):.4f} ms, K5g "
                      f"{median_ms(calls['raster_gather']):.4f} ms (median "
                      "of 20 CUDA-event timings, every launch of the call "
                      f"inside; {nvidia_smi_line()})")
                continue
            pix = n * IMG_HW[0] * IMG_HW[1]
            bytes_ = work["entries"] * RASTER_ENTRY_BYTES \
                + pix * RASTER_PIXEL_BYTES
            flop = work["subtiles_folded"] * RASTER_SUBTILE_PIXELS \
                * RASTER_FLOP
            dense = raster_pairs(ent) * RASTER_TILE_PIXELS * RASTER_FLOP
            # no single PyTorch call rasterizes: library none
            for key in ("raster_stream", "raster_gather"):
                r = time_kernel(rec, key, shape, calls[key],
                                lambda: raster.rasterize_plain(
                                    ent, IMG_HW, stream=key ==
                                    "raster_stream"),
                                flop, bytes_, plain_reps=3)
                print(f"[time] {key} {shape}: bound {r['bound_ms']:.4f} "
                      f"ms ({r['bound_by']}) from the (entry, sub-tile) "
                      "pairs the kernel folds (repeated entries and the "
                      f"cull's skipped; {flop / 1e9:.3f} GFLOP: "
                      f"{1e3 * flop / PEAK_F32_FLOPS:.4f} ms at 67 "
                      f"TFLOP/s, {1e3 * flop / (PEAK_F32_FLOPS / 2):.4f} "
                      "ms at one f32 instruction an operation, no FMA) "
                      f"and {bytes_ / 1e6:.3f} MB "
                      f"({1e3 * bytes_ / PEAK_HBM_BYTES:.4f} ms); the TPU "
                      "kernel's dense work (every distinct (face, tile) "
                      f"pair at all 4096 pixels): {dense / 1e9:.3f} GFLOP, "
                      f"{1e3 * dense / PEAK_F32_FLOPS:.4f} ms, "
                      f"{1e3 * dense / (PEAK_F32_FLOPS / 2):.4f} ms an "
                      f"instruction each; kernel at "
                      f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound "
                      f"({nvidia_smi_line()})")
    return {k: max(v for name, v in errs.items() if name.startswith(k + " "))
            for k in ("raster_stream", "raster_gather")}


def chamfer_phase(device, smpl, rec):
    """K4 against its plain version on the card at path E's shapes: 60
    frames of a 512-point scan near the 6890-vertex mesh, scan -> mesh (the
    direction the loss reads) and mesh -> scan. The kernel rounds every
    operation in the plain version's order, so distances and indices must
    be identical (tolerance 0), and a rerun must give the same bits. Prints
    the kernel's split, its registers, shared memory and spills, and each
    direction's device time a launch from torch.profiler beside the
    one-call time, an empty kernel's launch floor, the bound and the
    instruction figures (each of the 9 operations a pair issued alone, and
    the 8 instructions a pair the kernel issues).
    Returns {"chamfer_nn": max_abs_err} and adds the times to rec (the scan
    -> mesh record first)."""
    import torch
    from nemo_tpu_torch.ops import chamfer
    gen = torch.Generator().manual_seed(4)
    T, N = SEQ_LEN, SAMP_PTS
    V = smpl.num_vertices
    mesh = (smpl.v_template.cpu()[None] + 0.02 * torch.randn(
        (T, V, 3), generator=gen)).to(device).contiguous()
    pick = torch.randint(0, V, (T, N), generator=gen).to(device)
    scan = (torch.gather(mesh, 1, pick[..., None].expand(T, N, 3))
            + 0.01 * torch.randn((T, N, 3), generator=gen).to(device)
            ).contiguous()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print("[kernel] nn_one_way_split_kernel<4>, <2>, <1> resources "
          "(cudaFuncGetAttributes): " + json.dumps(
              [chamfer.nn_attributes(q) for q in (4, 2, 1)]))
    errs = {}
    for a, b, shape in ((scan, mesh, f"T={T}, N={N}, M={V}"),
                        (mesh, scan, f"T={T}, N={V}, M={N}")):
        Tk, Nk, Mk = a.shape[0], a.shape[1], b.shape[1]
        dk, ik = chamfer.nn_one_way_cuda(a, b)
        dp, ip = chamfer.nn_one_way_plain(a, b)
        n_idx = int((ik != ip).sum())
        print(f"[kernel] chamfer_nn {shape}: split "
              f"{chamfer.nn_split(Tk, Nk, Mk, sms)}; indices differing from "
              f"the plain version {n_idx} of {ik.numel()} (tolerance 0)")
        if n_idx:
            raise AssertionError("chamfer_nn: argmin differs from plain")
        check(f"chamfer_nn {shape}", dk, dp, 0.0, errs)
        dr, ir = chamfer.nn_one_way_cuda(a, b)
        if not (torch.equal(dr, dk) and torch.equal(ir, ik)):
            raise AssertionError(f"K4 is not bit-stable run to run ({shape})")
        bt = b.transpose(1, 2).contiguous()
        call = lambda: chamfer.nn_one_way_cuda(a, b)
        r = time_kernel(rec, "chamfer_nn", shape, call,
                        lambda: chamfer.nn_one_way_plain(a, b),
                        CHAMFER_FLOP * Tk * Nk * Mk, nbytes(a, b, dk, ik),
                        library=lambda: torch.bmm(a, bt), plain_reps=5)
        dev = profiled_ms(call, ("nn_one_way",))
        dev.update(profiled_ms(lambda: chamfer.nn_empty_cuda(
            Tk, Nk, Mk, device), ("chamfer_empty",)))
        ms = {k: device_ms_text(v) for k, v in dev.items()}
        pairs = Tk * Nk * Mk
        instr = {n: 1e3 * n * pairs / LANE_INSTR_PER_S
                 for n in (CHAMFER_FLOP, CHAMFER_INSTR)}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(20):
            call()
        end.record()
        end.synchronize()
        print(f"[time] chamfer_nn {shape}: device time a launch "
              f"{ms['nn_one_way']}, 20 launches back to back "
              f"{start.elapsed_time(end) / 20:.4f} ms each (CUDA events), "
              f"one call {r['ms']:.4f} ms, launch floor "
              f"{ms['chamfer_empty']} (an empty kernel on K4's grid), "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), instruction "
              f"figure {instr[CHAMFER_FLOP]:.4f} ms (the {CHAMFER_FLOP} "
              f"operations a pair each issued alone, 132 SMs x 128 lanes at "
              f"1.98 GHz), the kernel's own {instr[CHAMFER_INSTR]:.4f} ms "
              f"(its {CHAMFER_INSTR} instructions a pair) "
              f"({nvidia_smi_line()})")
    return {"chamfer_nn": max(errs.values())}


def mlp_phase(device, rec):
    """K6f and K6b against their plain versions on the card at the fit's
    shapes: the reference MotionNet at B = 512 (slice 1, path F), 960 (the
    custom-video full batch) and 1 (the phase-0 anchor of every predict),
    weights drawn at the init's scale (U(+-1/sqrt(fan_in))), inputs in
    [0, 1) like the RBF features, a random N(0, 1) cotangent. Both sides
    of the backward read the kernel's saved activations, so the ReLU masks
    are the same. Tolerances: sums of up to 1000 f32 products in another
    order than cuBLAS's (the plain version, TF32 off), 1e-5 (forward) and
    1e-4 (gradients) of each tensor's largest entry. A second run of each
    kernel must be bit-identical (fixed-order sums, no atomics). Every
    product runs on the tensor cores in 3xTF32, so the bound is the
    tensor-core one; beside one PyTorch call (the largest product) the
    same products as a chain of cuBLAS calls are timed, and at B = 512 the
    kernels' distance from their CPU emulation (run here on the card) is
    printed as a record, not a gate: mma.sync sums in its own order.
    Returns {kernel: max_abs_err} and adds the times to rec (B = 512
    first)."""
    import torch
    from nemo_tpu_torch.ops import mlp
    gen = torch.Generator().manual_seed(6)
    D, H, O = MLP_D, MLP_H, MLP_O

    def init(*shape, fan_in):
        u = torch.rand(shape, generator=gen) * 2.0 - 1.0
        return (u / math.sqrt(fan_in)).to(device)

    W = (init(D, H, fan_in=D), init(H, fan_in=D), init(H, H, fan_in=H),
         init(H, fan_in=H), init(H, H, fan_in=H), init(H, fan_in=H),
         init(H, O, fan_in=H), init(O, fan_in=H))
    errs = {}
    print(f"[kernel] TF32 in matmuls: {torch.backends.cuda.matmul.allow_tf32}")
    print(f"[kernel] mlp_gemm_kernel resources (cudaFuncGetAttributes): "
          f"{json.dumps({k: mlp.gemm_attributes(k == 'backward pair') for k in ('forward', 'backward pair')})}")
    for B in (BATCH, BATCH_A, 1):
        x = torch.rand((B, D), generator=gen).to(device)
        gout = torch.randn((B, O), generator=gen).to(device)
        args = (x, *W)
        got = mlp.mlp_fwd_cuda(*args)
        want = mlp.motion_net_mlp_plain(*args)
        for name, a, b in zip(("out", "h1", "h2", "z"), got, want):
            check(f"mlp_fwd {name} B={B}", a, b, 1e-5 * float(b.abs().max()),
                  errs)
        bwd_args = (gout, x, *got[1:], W[0], W[2], W[4], W[6])
        gk = mlp.mlp_bwd_cuda(*bwd_args)
        gp = mlp.motion_net_mlp_bwd_plain(*bwd_args)
        for name, a, b in zip(("gx", "gW1", "gb1", "gW2", "gb2", "gW3", "gb3",
                               "gWo", "gbo"), gk, gp):
            check(f"mlp_bwd {name} B={B}", a, b, 1e-4 * float(b.abs().max()),
                  errs)
        again = mlp.mlp_fwd_cuda(*args) + mlp.mlp_bwd_cuda(*bwd_args)
        if not all(torch.equal(a, b) for a, b in zip(again, got + gk)):
            raise AssertionError(f"K6 is not bit-stable run to run (B={B})")
        if B == BATCH:
            em = (mlp.motion_net_mlp_split_emulation(*args),
                  mlp.motion_net_mlp_bwd_split_emulation(*bwd_args))
            diff = {name: float((a - b).abs().max() / b.abs().max())
                    for name, a, b in zip(
                        ("out", "h1", "h2", "z", "gx", "gW1", "gb1", "gW2",
                         "gb2", "gW3", "gb3", "gWo", "gbo"),
                        got + gk, em[0] + em[1])}
            print(f"[kernel] K6 vs its 3xTF32 emulation on the card (B={B}; "
                  f"largest difference / the tensor's largest entry; a "
                  f"record, no gate): {json.dumps(diff)}")
        flop = 2 * B * (D * H + 2 * H * H + H * O)
        shape = f"B={B}, D={D}, H={H}, O={O}"
        x_, h1, h2, z = args[0], got[1], got[2], got[3]
        def fwd_chain():   # K6f's products, one cuBLAS call each
            for a, w, b in ((x_, W[0], W[1]), (h1, W[2], W[3]),
                            (h2, W[4], W[5]), (z, W[6], W[7])):
                torch.addmm(b, a, w)

        def bwd_chain():   # K6b's products, one cuBLAS call each (any (B, H)
            # tensor stands in for gz, gh2 and gh1)
            for act, w, g in ((z, W[6], gout), (h2, W[4], z),
                              (h1, W[2], h2), (x_, W[0], h1)):
                torch.mm(act.t(), g)
                torch.mm(g, w.t())

        chain = {"mlp_fwd": median_ms(fwd_chain),
                 "mlp_bwd": median_ms(bwd_chain)}
        # one call: the largest contraction, (B, 1000).(1000, 1000) forward
        # and (1000, B).(B, 1000) backward, f32 with TF32 off
        for key, r in (
                ("mlp_fwd", time_kernel(
                    rec, "mlp_fwd", shape, lambda: mlp.mlp_fwd_cuda(*args),
                    lambda: mlp.motion_net_mlp_plain(*args), flop,
                    nbytes(*args, *got),
                    library=lambda: torch.addmm(W[3], h1, W[2]),
                    tc_flop=flop)),
                ("mlp_bwd", time_kernel(
                    rec, "mlp_bwd", shape,
                    lambda: mlp.mlp_bwd_cuda(*bwd_args),
                    lambda: mlp.motion_net_mlp_bwd_plain(*bwd_args),
                    2 * flop, nbytes(*bwd_args, *gk),
                    library=lambda: torch.mm(h1.t(), h2),
                    tc_flop=2 * flop))):
            print(f"[time] {key} {shape}: cuBLAS chain {chain[key]:.4f} ms "
                  f"(the kernel's products, one torch.addmm/mm each, TF32 "
                  f"off; median of 20) against the kernel's {r['ms']:.4f}")
            rec[key].setdefault("chain_ms", chain[key])
    print(f"[kernel] K6f and K6b bit-identical on a second run at B = "
          f"{BATCH}, {BATCH_A} and 1")
    return {k: max(v for name, v in errs.items() if name.startswith(k + " "))
            for k in ("mlp_fwd", "mlp_bwd")}


# ---------------------------------------------------------------------------
# the fit's paths
# ---------------------------------------------------------------------------

def reference_config(**over):
    from nemo_tpu_torch.fit import NemoConfig
    base = dict(
        model_version=2, h_dim=1000, instance_code_size=5,
        phase_rbf_dim=100, rbf_kernel="quadratic",
        monotonic_network_n_nodes=200, phase_init="rand",
        batch_size=BATCH, loss="mse_robust",
        weight_vp_loss=10.0, weight_vp_z_loss=1.0, weight_gmm_loss=1.0,
        lr_factor=0.5, label_type="gt")
    return NemoConfig(**{**base, **over})


def custom_video_config(**over):
    """run_examples/custom-video-example.sh's fit (lr_human 1e-3 of its
    sweep) at the reference widths: NemoV3, full batch over every view and
    frame, the 3D loss against the initializer, the full-mesh v2v prior."""
    return reference_config(**{**dict(
        model_version=3, phase_init="linear", lr_human=1e-3,
        lr_instance=1e-3, lr_phase=0.0, lr_factor=1.0, weight_3d_loss=1000.0,
        full_batch=True), **over})


def make_fitter(device, smpl, bundle, cfg, v2v_vjp="fused",
                motion_mlp="plain"):
    import torch
    from nemo_tpu_torch.fit import NemoFitter, build_assets
    from nemo_tpu_torch.priors.gmm import synthetic_gmm_prior
    from nemo_tpu_torch.priors.vposer import init_vposer
    assets = build_assets(bundle, smpl, cfg, gmm=synthetic_gmm_prior(8),
                          vposer=init_vposer(
                              generator=torch.Generator().manual_seed(7)),
                          device=device, v2v_vjp=v2v_vjp,
                          motion_mlp=motion_mlp)
    return NemoFitter(cfg, assets, seed=0)


def run_path(name, expected, fn):
    """Zero the launch counters, run fn, read them; the path's kernels must
    have launched. Returns (counts, fn's result)."""
    import torch
    from nemo_tpu_torch.ops import launch_counts, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"[{name}] launches: {json.dumps(counts)}")
    missing = [k for k in expected if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{name}: kernels {missing} were not launched")
    return counts, out


def stages(fitter, warmup, cam, main, chunk):
    """warmup -> camera -> main; returns (metrics, steady steps/s over all
    chunks but the first, main seconds). Each chunk ends with its metrics
    on the host (a sync), so the chunk boundaries time the steps."""
    import torch
    wm = fitter.warmup(warmup)
    cm = fitter.opt_cam(cam)
    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fm = fitter.fit(main, chunk=chunk,
                    on_chunk=lambda *_: stamps.append(time.perf_counter()))
    steady = (main - chunk) / (stamps[-1] - stamps[0]) if len(stamps) > 1 \
        else float("nan")
    return (wm, cm, fm), steady, stamps[-1] - t0


def check_finite(name, metrics, *evals):
    import numpy as np
    arrays = [a for m in metrics for a in m.values()]
    if not all(np.isfinite(a).all() for a in arrays) or not all(
            math.isfinite(v) for e in evals for v in e.values()):
        raise AssertionError(f"{name}: non-finite loss")


def check_falls(name, kp, n):
    print(f"[{name}] kp_loss {kp[0]:.2f} -> {kp[-1]:.2f}")
    if not kp[-n:].mean() < kp[:n].mean():
        raise AssertionError(f"{name}: main-stage kp_loss did not fall")


def card_vs_cpu(name, fitter, bundle, smpl, batch=None):
    """fit_loss on the card against the port's CPU path (plain versions of
    the kernels, in the same v2v and MotionNet modes, with the same HuMoR
    weights) from the same parameters, on one batch of 64, or on ``batch``
    (view and frame indices on the host)."""
    import torch
    from nemo_tpu_torch.fit import NemoParams, build_assets, fit_loss
    cfg, assets = fitter.cfg, fitter.assets
    V, F = assets.num_views, assets.num_frames
    g = torch.Generator().manual_seed(3)
    vi, fi = batch if batch is not None else (
        torch.randint(0, V, (64,), generator=g),
        torch.randint(0, F, (64,), generator=g))
    with torch.no_grad():
        _, m_gpu = fit_loss(fitter.params, cfg, assets, vi.to(assets.device),
                            fi.to(assets.device))
        cpu_assets = build_assets(bundle, smpl.to("cpu"), cfg,
                                  gmm=assets.gmm.to("cpu"),
                                  vposer={k: v.cpu()
                                          for k, v in assets.vposer.items()},
                                  device="cpu", v2v_vjp=assets.v2v_vjp,
                                  motion_mlp=assets.motion_mlp,
                                  humor=assets.humor,
                                  humor_cfg=assets.humor_cfg)
        params_cpu = NemoParams(cfg, V, assets.img_d0)
        params_cpu.load_state_dict({k: v.cpu() for k, v in
                                    fitter.params.state_dict().items()})
        _, m_cpu = fit_loss(params_cpu, cfg, cpu_assets, vi, fi)
    for k in m_cpu:
        a, b = float(m_gpu[k]), float(m_cpu[k])
        print(f"[{name}] fit_loss {k}: cuda {a:.6f} cpu {b:.6f}")
        if not abs(a - b) <= 1e-4 * abs(b) + 1e-6:
            raise AssertionError(f"{name} fit_loss {k}: card and CPU disagree")


def no_sync_steps(name, fitter):
    """One step of each stage with every synchronising call an error."""
    import torch
    from nemo_tpu_torch.fit.optimizer import (make_camera_stage_optimizer,
                                              make_v0_warmup_optimizer)
    cfg = fitter.cfg
    cam_opt = None if cfg.model_version >= 4 else \
        make_camera_stage_optimizer(fitter.params, cfg)
    warm_opt = make_v0_warmup_optimizer(fitter.params, cfg) \
        if cfg.model_version == 0 else None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fitter.warmup_step(0, warm_opt)
        fitter.camera_step(cam_opt)
        fitter.main_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"[{name}] a step of each stage ran without a device "
          "synchronisation")


def slice1_path(device, smpl, bundle):
    """The reference configuration through K1 and K2's fused mode."""
    import numpy as np
    import torch
    from nemo_tpu_torch.eval.metrics import eval_2d, eval_3d, write_csv
    from nemo_tpu_torch.fit import predict, project_to_views
    main = 30
    fitter = make_fitter(device, smpl, bundle, reference_config())

    def run():
        init = fitter.eval_loss()
        ms, steady, main_s = stages(fitter, 10, 10, main, 10)
        final = fitter.eval_loss()
        V, F = fitter.assets.num_views, fitter.assets.num_frames
        vi = torch.arange(V, device=device).repeat_interleave(F)
        fi = torch.arange(F, device=device).repeat(V)
        with torch.no_grad():
            preds = predict(fitter.params, fitter.cfg, fitter.assets, vi, fi)
            pts2d = project_to_views(fitter.params, fitter.cfg, fitter.assets,
                                     preds["j"], vi)
        pts2d = pts2d.cpu().numpy().reshape(V, F, 25, 2)
        with tempfile.TemporaryDirectory() as d:
            write_csv(eval_2d(pts2d, {"op": bundle.labels["op"]},
                              bundle.labels["gt"], bundle.bbox_diag("gt")),
                      os.path.join(d, "eval_2d.csv"))
            stats3d = eval_3d(fitter.assets.smpl, preds["poses"].cpu().numpy()
                              .reshape(V, F, 69), bundle.gt3d_pose,
                              {"vibe": bundle.hmr_theta})
            write_csv(stats3d, os.path.join(d, "eval_3d.csv"))
            with open(os.path.join(d, "eval_2d.csv")) as f:
                header = f.readline().strip()
        return init, ms, steady, main_s, final, stats3d, header

    counts, (init, ms, steady, main_s, final, stats3d, header) = run_path(
        "slice 1", ("fk_fwd", "fk_bwd", "v2v_grad", "v2v_fwd"), run)
    print(f"[slice 1] main stage: {main} steps in {main_s:.3f} s; the last "
          f"{main - 10} at {steady:.3f} steps/s (batch {BATCH}, 8 views x "
          f"120 frames, V={smpl.num_vertices})")
    print(f"[slice 1] init {init}\n[slice 1] final {final}")
    check_finite("slice 1", ms, init, final)
    check_falls("slice 1", ms[2]["kp_loss"], 10)
    V = fitter.assets.num_views
    for name, v in stats3d.items():
        if not np.isfinite(v).all() or len(v) != V:
            raise AssertionError(f"eval_3d column {name} malformed")
    if header != ",recon_error_2d-ours,pck-ours,recon_error_2d-op,pck-op":
        raise AssertionError(f"eval_2d header {header!r}")
    no_sync_steps("slice 1", fitter)
    card_vs_cpu("slice 1", fitter, bundle, smpl)
    return counts, steady


def path_a(device, smpl, bundle):
    """The custom-video configuration with the opt-in 1024-vertex v2v
    subset, which runs K3 in place of K2."""
    cfg = custom_video_config(vp_v2v_n_verts=1024)
    fitter = make_fitter(device, smpl, bundle, cfg)
    print(f"[path A] {cfg}")
    main = 40

    def run():
        ms, steady, main_s = stages(fitter, 10, 10, main, 10)
        return ms, steady, main_s, fitter.eval_loss()

    counts, (ms, steady, main_s, final) = run_path(
        "path A", ("fk_fwd", "fk_bwd", "skin_fwd", "skin_bwd"), run)
    B = fitter.assets.num_views * fitter.assets.num_frames
    print(f"[path A] main stage: {main} steps in {main_s:.3f} s; the last "
          f"{main - 10} at {steady:.3f} steps/s (full batch B={B}, v2v on "
          f"{len(fitter.assets.v2v_vidx)} vertices; {nvidia_smi_line()})")
    print(f"[path A] final {final}")
    check_finite("path A", ms, final)
    check_falls("path A", ms[2]["kp_loss"], 10)
    card_vs_cpu("path A", fitter, bundle, smpl)
    no_sync_steps("path A", fitter)
    return counts, steady


def path_b(device, smpl, bundle):
    """Slice 1's workload with the K2 pair modes: 10 main steps each, from
    the same fresh parameters. The modes share K2's pair-mode forward;
    their gradients agree, by design not bit for bit: pair has K3b
    recompute the posed vertices in 3xTF32, pair_vp reads the f32 ones K2
    stored. So fit_loss and every parameter gradient of the two modes are
    held together from the same parameters and batch (the loss within
    1e-5 relative, gradients within 1e-5 of each tensor's largest entry,
    as the kernel phase holds K3b's), and not the two 10-step curves,
    which Adam parts from the first step wherever a gradient entry is
    near 0."""
    out = {}
    for vjp, bwd in (("pair", "skin_bwd"), ("pair_vp", "skin_bwd_vp")):
        fitter = make_fitter(device, smpl, bundle, reference_config(),
                             v2v_vjp=vjp)
        if vjp == "pair":
            modes_agree("path B", fitter, "v2v_vjp", ("pair", "pair_vp"),
                        1e-5, 1e-5)
        counts, fm = run_path(f"path B {vjp}", ("v2v_pair", bwd),
                              lambda: fitter.fit(10, chunk=10))
        if counts["v2v_grad"]:
            raise AssertionError(f"path B {vjp}: the fused mode ran")
        check_finite(f"path B {vjp}", [fm])
        print(f"[path B {vjp}] total_loss {fm['total_loss'][0]:.3f} -> "
              f"{fm['total_loss'][-1]:.3f}")
        out[vjp] = counts
    return out


def path_c(device, smpl, bundle):
    """Model versions 0, 1 and 4 at the reference width: 5 steps of each
    stage."""
    out = {}
    for v, over in ((0, dict(phase_rbf_dim=0)), (1, dict(phase_rbf_dim=0)),
                    (4, dict(weight_3d_loss=1.0, weight_instance_loss=0.1,
                             code_noise=0.01))):
        fitter = make_fitter(device, smpl, bundle,
                             reference_config(model_version=v, **over))

        def run():
            ms, _, _ = stages(fitter, 5, 5, 5, 5)
            return ms

        counts, ms = run_path(f"path C v{v}", ("fk_fwd", "fk_bwd",
                                                 "v2v_grad"), run)
        check_finite(f"path C v{v}", ms)
        print(f"[path C v{v}] " + "; ".join(
            f"{k} {a[0]:.3f} -> {a[-1]:.3f}" for m in ms
            for k, a in m.items() if k in ("warmup_loss", "cam_loss",
                                           "total_loss")))
        if v == 4:
            no_sync_steps("path C v4", fitter)
        out[f"v{v}"] = counts
    return out


def path_d(device, smpl, bundle):
    """The fit's render outputs and a checkpoint round trip: the reference
    configuration, a few steps of each stage; save_fit_state and
    load_fit_state into a fresh fitter (parameters bit-identical, eval_loss
    equal); the full mesh per view; the mesh video (4 views, every 4th of
    120 frames: 30 frames, 120 panels), the rollout figure (8 views x 8
    frames) and the comparison strip (6 panels) on K5s at 1000 x 1900; then
    K5g on the video's panels, which gather mode holds without overflow,
    equal to K5s."""
    import numpy as np
    import torch
    from nemo_tpu_torch.fit import predict
    from nemo_tpu_torch.geometry.camera import camera_from_params_np
    from nemo_tpu_torch.ops import raster
    from nemo_tpu_torch.render import (make_mesh_panel_fn,
                                       render_comparison_figure,
                                       render_mesh_video,
                                       render_rollout_figure)
    from nemo_tpu_torch.render.mesh import composite_panel
    from nemo_tpu_torch.utils.checkpoint import load_fit_state, save_fit_state
    cfg = reference_config()
    fitter = make_fitter(device, smpl, bundle, cfg)
    V, F = fitter.assets.num_views, fitter.assets.num_frames
    n_frames = len(range(0, F, 4))
    faces = smpl.faces
    out = {}

    def run():
        ms, _, _ = stages(fitter, 5, 5, 10, 5)
        check_finite("path D", ms)
        with tempfile.TemporaryDirectory() as d:
            save_fit_state(d, fitter, cfg)
            fresh = make_fitter(device, smpl, bundle, cfg)
            if not load_fit_state(d, fresh):
                raise AssertionError("path D: generator state not restored")
        same = all(torch.equal(a, b) for a, b in
                   zip(fitter.params.parameters(), fresh.params.parameters()))
        e0, e1 = fitter.eval_loss(), fresh.eval_loss()
        print(f"[path D] checkpoint round trip: parameters bit-identical "
              f"{same}, eval_loss equal {e0 == e1} ({e0})")
        if not same or e0 != e1 or fresh.step != fitter.step:
            raise AssertionError("path D: the checkpoint did not restore "
                                 "the fit")
        with torch.no_grad():
            verts = np.stack([predict(
                fitter.params, cfg, fitter.assets,
                torch.full((F,), v, device=device),
                torch.arange(F, device=device),
                want_vertices=True)["v"].cpu().numpy() for v in range(V)])
        cam9 = fitter.params.cameras.detach().cpu().numpy()
        cams = [camera_from_params_np(cam9[v], *IMG_HW) for v in range(V)]
        with tempfile.TemporaryDirectory() as d:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vid = render_mesh_video(os.path.join(d, "mesh_rollout.mp4"),
                                    verts, faces, cams, bundle, max_views=4,
                                    every=4, device=device)
            t_video = time.perf_counter() - t0
            frames = sorted(os.listdir(vid)) if os.path.isdir(vid) else None
            # the same frames without the PNG writes: render, one copy to
            # the host, composite
            fn = make_mesh_panel_fn(faces, cams[:4], IMG_HW, device=device)
            R = np.stack([c.rotation for c in cams[:4]])
            t = np.stack([c.translation for c in cams[:4]])
            split = {"render": 0.0, "copy": 0.0, "composite": 0.0}
            for f in range(0, F, 4):
                t0 = time.perf_counter()
                imgs, masks = fn(verts[:4, f], R, t)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                both = torch.cat([imgs, masks[..., None]], -1).cpu().numpy()
                t2 = time.perf_counter()
                np.concatenate([composite_panel(b[..., :3], b[..., 3], None,
                                                IMG_HW) for b in both], 1)
                t3 = time.perf_counter()
                for k, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
                    split[k] += dt / n_frames
            t_nopng = n_frames * sum(split.values())
            t0 = time.perf_counter()
            grid = render_rollout_figure(
                os.path.join(d, "rollout_figure.png"), verts, faces, cams,
                bundle, num_frames=8, device=device)
            t_fig = time.perf_counter() - t0
            comp = render_comparison_figure(
                os.path.join(d, "comparison_view0.png"), 0, verts[0], faces,
                cams[0], bundle, num_frames=6, device=device)
            sizes = {n: os.path.getsize(os.path.join(d, n)) for n in
                     ("rollout_figure.png", "comparison_view0.png")}
        print(f"[path D] {vid}: {len(frames) if frames else 'mp4'} frames "
              f"of {4 * IMG_HW[1]}x{IMG_HW[0]}; {t_video / n_frames:.4f} s a "
              f"frame with the PNG writes, {t_nopng / n_frames:.4f} s "
              f"without; rollout "
              f"figure {grid.shape} in {t_fig:.2f} s, comparison "
              f"{comp.shape}; PNG bytes {json.dumps(sizes)}; s a frame "
              f"without the PNG writes: {json.dumps(split)}")
        if frames is not None and len(frames) != n_frames:
            raise AssertionError(f"path D: {len(frames)} video frames")
        if grid.shape != (1052, 2000, 3) or comp.shape[0] != 2 * IMG_HW[0] \
                * 2000 // (6 * IMG_HW[1]):
            raise AssertionError("path D: figure grids malformed")
        covered = float((grid < 0.99).any(-1).mean())
        if not np.isfinite(grid).all() or covered < 0.001:
            raise AssertionError(f"path D: rollout figure covers "
                                 f"{covered:.5f} of its pixels")
        # K5g on the video's panels, equal to K5s
        Rt = torch.as_tensor(R, device=device)
        tt = torch.as_tensor(t, device=device)
        foc = [float(c.focal_length) for c in cams[:4]]
        ctr = [(float(c.center[0]), float(c.center[1])) for c in cams[:4]]
        # JAX's default capacity, doubled for a frame whose busiest tile
        # holds more entries, so that no panel overflows
        grown = {}
        for f in range(0, F, 4):
            vc = (torch.as_tensor(verts[:4, f], device=device)
                  @ Rt.transpose(-1, -2) + tt[:, None]).contiguous()
            fpt = 4096
            while any(raster.gather_mode_overflow(
                    vc[v].cpu().numpy(), faces, foc[v], ctr[v], IMG_HW,
                    faces_per_tile=fpt) for v in range(4)):
                fpt *= 2
            if fpt > 4096:
                grown[f] = fpt
            a = raster.rasterize_triangles_batched(vc, faces, foc, ctr,
                                                   IMG_HW, stream=True)
            b = raster.rasterize_triangles_batched(
                vc, faces, foc, ctr, IMG_HW, faces_per_tile=fpt,
                stream=False)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"path D frame {f}: K5g differs from "
                                     "K5s")
        print(f"[path D] K5g equals K5s on the video's {4 * n_frames} "
              "panels, each with a gather-mode overflow of 0 at "
              f"faces_per_tile 4096 except frames {json.dumps(grown)} "
              "(frame: the capacity that holds its busiest tile)")
        out.update(video_s=t_video / n_frames, nopng_s=t_nopng / n_frames)

    counts, _ = run_path("path D", ("fk_fwd", "fk_bwd", "v2v_grad",
                                    "raster_stream", "raster_gather"), run)
    return counts, out


def raw_amass_walk(path, T=360):
    """A synthetic raw AMASS sequence (the JAX CLI test's swaying walk,
    tests/test_humor_tool_cli.py) over T frames at 120 fps: process-amass
    keeps the middle 80%, drops the two edge frames and downsamples to 30
    fps, so 360 frames leave 71 (300 would leave 59, short of seq_len 60)."""
    import numpy as np
    rng = np.random.default_rng(0)
    t = np.linspace(0, 4 * np.pi, T)[:, None]
    poses = np.zeros((T, 156))
    poses[:, :3] = 0.2 * np.stack(
        [np.sin(t[:, 0]), np.cos(t[:, 0]), 0 * t[:, 0]], 1)
    poses[:, 3:66] = 0.15 * np.sin(t + rng.uniform(0, np.pi, (1, 63)))
    trans = np.stack([0.3 * t[:, 0], 0.1 * np.sin(t[:, 0]), np.zeros(T)], 1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, poses=poses, trans=trans,
             betas=rng.standard_normal(16) * 0.3, gender="neutral",
             mocap_framerate=120.0)


def path_e(device, files):
    """HuMoR 3D fitting through the port's humor_tool: process-amass on a
    synthetic raw sequence, then fit-amass --obs joints verts points at the
    CLI's defaults (60 frames, 512 scan points, 30/70/70 steps), on the
    card (the CLI's default device), and the eval CSVs. The SMPL model
    comes from the written .npz of the 6890-vertex synthetic body and the
    HuMoR weights (the reference widths, latent 48) from the written
    checkpoint of init_humor at --seed 0: the model and weights the CLI
    builds without the two flags. K4 runs in
    every step (scan -> mesh alone, the direction the points3d loss reads),
    K1 in every SMPL forward and backward.
    Then points3d_loss and the stage-3 loss on the card against the port's
    CPU path from the same parameters (the fit's result)."""
    import numpy as np
    import torch
    from nemo_tpu_torch.cli import humor_tool
    from nemo_tpu_torch.models import humor_fit
    from nemo_tpu_torch.models.humor import HumorConfig, humor_to
    fits, stage_s = [], []
    real_fit, real_adam = humor_fit.humor_motion_fit, humor_fit._run_adam

    def recording_fit(*a, **k):         # the CLI's fit, with its outputs kept
        out = real_fit(*a, **k)
        fits.append((a, k, out))
        return out

    def timed_stage(*a, **k):           # each stage's Adam loop, timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_adam(*a, **k)
        torch.cuda.synchronize()
        stage_s.append(time.perf_counter() - t0)
        return out

    with tempfile.TemporaryDirectory() as d:
        raw_amass_walk(os.path.join(d, "raw", "HumanEva", "S1",
                                    "walk_poses.npz"))
        proc, out = os.path.join(d, "proc"), os.path.join(d, "fit")

        def run():
            humor_fit.humor_motion_fit = recording_fit
            humor_fit._run_adam = timed_stage
            try:
                t0 = time.perf_counter()
                if humor_tool.main(["process-amass", "--amass_root",
                                    os.path.join(d, "raw"), "--out", proc,
                                    "--datasets", "HumanEva", "--smpl_path",
                                    files["smpl_npz"]]) != 0:
                    raise AssertionError("path E: process-amass failed")
                t1 = time.perf_counter()
                if humor_tool.main(["fit-amass", "--amass", proc, "--out",
                                    out, "--obs", "joints", "verts",
                                    "points", "--smpl_path",
                                    files["smpl_npz"], "--humor_ckpt",
                                    files["humor"]]) != 0:
                    raise AssertionError("path E: fit-amass failed")
                return t1 - t0, time.perf_counter() - t1
            finally:
                humor_fit.humor_motion_fit = real_fit
                humor_fit._run_adam = real_adam

        counts, (t_proc, t_fit) = run_path(
            "path E", ("chamfer_nn", "fk_fwd", "fk_bwd"), run)
        (args, kw, fit), = fits
        losses = {s: fit[f"stage{s}_loss"].cpu().numpy() for s in (1, 2, 3)}
        print(f"[path E] process-amass {t_proc:.2f} s, fit-amass "
              f"{t_fit:.2f} s; " + "; ".join(
                  f"stage {s}: {len(v)} steps in {t:.2f} s "
                  f"({len(v) / t:.2f} steps/s), loss {v[0]:.4f} -> "
                  f"{v[-1]:.4f}" for (s, v), t in zip(losses.items(),
                                                     stage_s)))
        if not all(np.isfinite(v).all() for v in losses.values()):
            raise AssertionError("path E: non-finite stage loss")
        if not losses[2][-1] < losses[2][0]:
            raise AssertionError("path E: stage-2 loss did not fall")
        res = os.path.join(out, "results_out")
        seq_dir = os.path.join(res, os.listdir(res)[0])
        with np.load(os.path.join(seq_dir, "observations.npz")) as f:
            if f["points3d"].shape != (SEQ_LEN, SAMP_PTS, 3):
                raise AssertionError("path E: scan shape")
        csvs = sorted(os.listdir(os.path.join(out, "eval_out")))
        print(f"[path E] {seq_dir}: {sorted(os.listdir(seq_dir))}; eval "
              f"CSVs {csvs}")
        for name in ("stage3_results_per_seq_mean.csv",
                     "stage3_results_agg_mean.csv", "compare_mean.csv"):
            if name not in csvs:
                raise AssertionError(f"path E: {name} missing")
        with open(os.path.join(out, "eval_out",
                               "stage3_results_agg_mean.csv")) as f:
            head, vals = f.read().splitlines()[:2]
        agg = dict(zip(head.split(","), map(float, vals.split(","))))
        print(f"[path E] eval (mean): " + ", ".join(
            f"{k} {agg[k]:.4f}" for k in ("joints3d_all", "verts3d_all",
                                           "mesh3d_all", "contact_acc")))

    # card vs CPU from the same parameters: the fit's motion and latents
    smpl_c, hp = args[0], args[1]
    cfg, obs = kw["cfg"], kw["obs3d"]
    hcfg = HumorConfig(latent_size=48)
    pose, trans, betas = fit["pose"], fit["trans"], fit["betas"]
    p = {"x0": humor_fit.state_from(smpl_c, betas, pose[1], trans[1],
                                    pose[0], trans[0])[None],
         "z": fit["z"][None], "floor": fit["floor"]}
    vals = []
    for dev in (device, torch.device("cpu")):
        mv = lambda t: t.to(dev) if torch.is_tensor(t) else t
        sm = smpl_c.to(dev)
        o = {k: mv(v) for k, v in obs.items()}
        with torch.no_grad():
            verts = humor_fit.body_verts(sm, mv(pose), mv(trans), mv(betas))
            vals.append((
                float(humor_fit.points3d_loss(o["points3d"], verts)),
                float(humor_fit.stage3_loss(
                    sm, humor_to(hp, dev), hcfg, cfg,
                    {k: mv(v) for k, v in p.items()}, mv(betas),
                    mv(fit["floor"]), o))))
    for k, (a, b) in zip(("points3d_loss", "stage-3 loss"), zip(*vals)):
        print(f"[path E] {k}: cuda {a:.6f} cpu {b:.6f}")
        # the card's SMPL forward and rollout sum their matmuls in another
        # order than the CPU's (~1e-6 relative); K4 and the plain version
        # agree bit for bit given the same vertices
        if not abs(a - b) <= 1e-4 * abs(b) + 1e-6:
            raise AssertionError(f"path E {k}: card and CPU disagree")
    return counts


def modes_agree(name, fitter, field, modes, loss_rtol, grad_rel):
    """fit_loss and its parameter gradients with the assets' ``field`` set
    to each of two ``modes``, on the card, from the same parameters and
    batch: the loss within loss_rtol relative, each gradient
    within grad_rel of its tensor's largest entry. b_lin's gradient is 0
    (trans - trans0 cancels it): what each mode computes there is the
    difference of two equal column sums taken in different orders, held to
    the scale of W_lin's gradient."""
    import dataclasses
    import torch
    from nemo_tpu_torch.fit import fit_loss
    cfg, params = fitter.cfg, fitter.params
    V, F = fitter.assets.num_views, fitter.assets.num_frames
    g = torch.Generator().manual_seed(5)
    vi = torch.randint(0, V, (cfg.batch_size,), generator=g).to(fitter.device)
    fi = torch.randint(0, F, (cfg.batch_size,), generator=g).to(fitter.device)
    res = {}
    for mode in modes:
        assets = dataclasses.replace(fitter.assets, **{field: mode})
        params.zero_grad(set_to_none=True)
        loss, _ = fit_loss(params, cfg, assets, vi, fi)
        loss.backward()
        res[mode] = (float(loss.detach()), {n: p.grad.detach().clone()
                                   for n, p in params.named_parameters()
                                   if p.grad is not None})
    params.zero_grad(set_to_none=True)
    (la, ga), (lb, gb) = (res[m] for m in modes)
    a, b = modes
    print(f"[{name}] fit_loss {b} {lb:.6f} {a} {la:.6f} (relative "
          f"{abs(lb - la) / abs(la):.3e}, tolerance {loss_rtol:g})")
    if not abs(lb - la) <= loss_rtol * abs(la):
        raise AssertionError(f"{name}: {b} and {a} fit_loss disagree")
    if sorted(ga) != sorted(gb):
        raise AssertionError(f"{name}: the modes reach different parameters")
    worst = 0.0
    for k, want in ga.items():
        scale = ga["motion.W_lin"] if k == "motion.b_lin" else want
        err = float((gb[k] - want).abs().max())
        tol = grad_rel * float(scale.abs().max())
        worst = max(worst, err / max(tol, 1e-30))
        if not err <= tol:
            raise AssertionError(f"{name}: gradient {k} differs by {err:.3e} "
                                 f"(tolerance {tol:.3e})")
    print(f"[{name}] gradients of {len(ga)} tensors, {b} vs {a}: the "
          f"largest error is {worst:.3f} of its tolerance ({grad_rel:g} of "
          "the tensor's largest entry)")


def path_f(device, smpl, bundle):
    """Slice 1's reference configuration with the MotionNet through K6
    (motion_mlp="fused", the JAX package's NEMO_TPU_NET_FUSED=1): 10 warmup,
    10 camera and 30 main steps at B=512, h_dim 1000. Then the K6 launches
    of one predict (two K6f: the batch and the B = 1 phase-0 anchor) and of
    one fit_loss with its backward, a step of each stage without a device
    synchronisation, card vs CPU, and fused vs plain on the card."""
    import torch
    from nemo_tpu_torch.fit import fit_loss, predict
    from nemo_tpu_torch.ops import launch_counts, reset_launches
    fitter = make_fitter(device, smpl, bundle, reference_config(),
                         motion_mlp="fused")
    main = 30

    def run():
        ms, steady, main_s = stages(fitter, 10, 10, main, 10)
        return ms, steady, main_s, fitter.eval_loss()

    counts, (ms, steady, main_s, final) = run_path(
        "path F", ("fk_fwd", "fk_bwd", "v2v_grad", "mlp_fwd", "mlp_bwd"), run)
    print(f"[path F] main stage: {main} steps in {main_s:.3f} s; the last "
          f"{main - 10} at {steady:.3f} steps/s (batch {BATCH}, the "
          "MotionNet through K6)")
    print(f"[path F] final {final}")
    check_finite("path F", ms, final)
    check_falls("path F", ms[2]["kp_loss"], 10)
    cfg, assets = fitter.cfg, fitter.assets
    vi = torch.arange(BATCH, device=device) % assets.num_views
    fi = torch.arange(BATCH, device=device) % assets.num_frames
    reset_launches()
    with torch.no_grad():
        predict(fitter.params, cfg, assets, vi, fi)
    one_predict = launch_counts()
    reset_launches()
    fit_loss(fitter.params, cfg, assets, vi, fi)[0].backward()
    one_loss = launch_counts()
    fitter.params.zero_grad(set_to_none=True)
    got = {"predict": [one_predict[k] for k in ("mlp_fwd", "mlp_bwd")],
           "fit_loss and backward": [one_loss[k]
                                     for k in ("mlp_fwd", "mlp_bwd")]}
    print(f"[path F] (mlp_fwd, mlp_bwd) launches: {json.dumps(got)}")
    if got != {"predict": [2, 0], "fit_loss and backward": [2, 2]}:
        raise AssertionError("path F: expected two K6f launches a predict "
                             "(the batch and the phase-0 anchor)")
    no_sync_steps("path F", fitter)
    card_vs_cpu("path F", fitter, bundle, smpl)
    modes_agree("path F", fitter, "motion_mlp", ("plain", "fused"), 1e-5,
                1e-4)
    return counts, steady


def write_asset_files(d, smpl):
    """The recipe's assets in the real files' layouts under d, written from
    the smoke's own objects: the 6890-vertex synthetic body as
    smpl/SMPL_NEUTRAL.pkl (chumpy arrays, a sparse J_regressor, uint32
    parents and faces) and as SMPL_NEUTRAL.npz, J_regressor_extra.npy, the
    VPoser of make_fitter as V02_05/snapshots/*.ckpt ('vp_model.' keys),
    the synthetic GMM as gmm_08.pkl (a dict), and init_humor's weights at
    generator seed 0 (humor_tool's default) as a {'model': ...} torch
    file. Returns the paths and the in-memory sources."""
    import numpy as np
    import torch
    from nemo_tpu_torch.models.humor import HumorConfig, init_humor
    from nemo_tpu_torch.priors.gmm import synthetic_gmm_arrays
    from nemo_tpu_torch.priors.vposer import init_vposer
    from nemo_tpu_torch.utils import asset_files as af
    host = smpl.to("cpu")
    arrays = af.smpl_file_arrays(host)
    os.makedirs(os.path.join(d, "smpl"))
    files = {
        "smpl_dir": os.path.join(d, "smpl"),
        "smpl_pkl": af.write_smpl_pkl(os.path.join(d, "smpl",
                                                   "SMPL_NEUTRAL.pkl"),
                                      arrays),
        "smpl_npz": af.write_smpl_npz(os.path.join(d, "SMPL_NEUTRAL.npz"),
                                      arrays),
        "jre": os.path.join(d, "J_regressor_extra.npy"),
        "gmm": af.write_gmm_pkl(os.path.join(d, "gmm_08.pkl"),
                                *synthetic_gmm_arrays(8)),
    }
    np.save(files["jre"], host.J_regressor_extra.numpy())
    vposer = init_vposer(generator=torch.Generator().manual_seed(7))
    files["vposer"] = af.write_vposer_snapshot(os.path.join(d, "V02_05"),
                                               vposer)
    humor = init_humor(torch.Generator().manual_seed(0), HumorConfig())
    files["humor"] = af.write_humor_ckpt(os.path.join(d, "humor.pth"),
                                         humor)
    return files, {"vposer": vposer, "humor": humor}


def loaders_bit_identical(device, smpl, files, sources):
    """Each loader's tensors on the card against their in-memory sources,
    bit for bit: both SMPL files (every SMPLModel field), the VPoser
    snapshot, the GMM and the HuMoR checkpoint. Returns the loaded SMPL,
    GMM, VPoser and HuMoR."""
    import numpy as np
    import torch
    from nemo_tpu_torch.body.assets import load_smpl, load_smpl_npz
    from nemo_tpu_torch.body.smpl import _TENSOR_FIELDS
    from nemo_tpu_torch.models.humor import HumorConfig, load_humor
    from nemo_tpu_torch.priors.gmm import load_gmm_prior, synthetic_gmm_prior
    from nemo_tpu_torch.priors.vposer import load_vposer

    def same(tag, a, b):
        if not (a.device == b.device and a.dtype == b.dtype
                and torch.equal(a, b)):
            raise AssertionError(f"path G: {tag} differs from its source")

    loaded = {"smpl (pkl)": load_smpl(files["smpl_dir"], files["jre"],
                                      device=device),
              "smpl (npz)": load_smpl_npz(files["smpl_npz"], files["jre"],
                                          device=device)}
    n = 0
    for tag, m in loaded.items():
        for f in _TENSOR_FIELDS:
            same(f"{tag} {f}", getattr(m, f), getattr(smpl, f))
            n += 1
        for f in ("parents", "vertex_joint_ids", "joint_map", "faces"):
            if not np.array_equal(getattr(m, f), getattr(smpl, f)):
                raise AssertionError(f"path G: {tag} {f} differs")
            n += 1
    gmm = load_gmm_prior(files["gmm"], device=device)
    want = synthetic_gmm_prior(8).to(device)
    for f in ("means", "precisions", "nll_weights"):
        same(f"gmm {f}", getattr(gmm, f), getattr(want, f))
        n += 1
    vposer = load_vposer(files["vposer"], device=device)
    if sorted(vposer) != sorted(sources["vposer"]):
        raise AssertionError("path G: VPoser keys differ")
    for k, v in sources["vposer"].items():
        same(f"vposer {k}", vposer[k], v.to(device))
        n += 1
    humor = load_humor(files["humor"], HumorConfig(), device=device)
    for m, sub in sources["humor"].items():
        for k, v in sub.items():
            same(f"humor {m}.{k}", humor[m][k], v.to(device))
            n += 1
    print(f"[path G] {n} loaded tensors and index arrays (SMPL from the "
          "pickle and the npz, GMM, VPoser, HuMoR) bit-identical on the card "
          "to their in-memory sources")
    return loaded["smpl (pkl)"], gmm, vposer, humor


def recipe_bundle(bundle, path):
    """The smoke's bundle with vs, pare and GLAMR baseline poses and GLAMR
    world data (global orient and root translation) near the ground truth,
    from a seeded numpy RNG, saved to path."""
    import dataclasses
    import numpy as np
    rng = np.random.default_rng(11)
    V, F = bundle.num_views, bundle.num_frames
    pose = lambda: np.concatenate(
        [bundle.gt3d_pose[..., 3:] + 0.1 * rng.standard_normal((V, F, 69)),
         np.ones((V, F, 1))], -1).astype(np.float32)
    b = dataclasses.replace(
        bundle, baseline_poses={"vs": pose(), "pare": pose(),
                                "glamr": pose()},
        glamr_orient=(bundle.gt3d_pose[..., :3] + 0.1 * rng.standard_normal(
            (V, F, 3))).astype(np.float32),
        glamr_trans=(bundle.gt3d_trans + 0.1 * rng.standard_normal(
            (V, F, 3))).astype(np.float32))
    b.save(path)
    return path


def path_g(device, smpl, bundle, files, sources):
    """The NeMo-MoCap recipe from files in the real layouts, at full width.

    1. Every loader's tensors on the card bit-identical to their sources.
    2. fit_loss at initialisation (reference configuration, 8 views x 120
       frames, B=512, the same seed and batch) equal between a fitter on
       the loaded assets and one on the in-memory assets.
    3. nemo_tpu_torch.cli.fit with run_examples/nemomocap-example.sh's
       flags (--default_config configs/default-v2.yml, the four asset
       paths, the mesh video) on the bundle with vs, pare and GLAMR
       baselines and GLAMR world data. Cut: 5 warmup, 5 camera and 10 main
       steps (--warmup_step, --opt_cam_step, --n_steps), and the video to
       every 4th frame (--render_video 30 in place of 1, as path D). The
       eval CSVs must hold the baseline and GLAMR columns, all finite.
    4. The custom-video configuration (NemoV3, full batch B=960) on the
       loaded assets, without and then with the HuMoR dynamics term
       (weight 1, the written checkpoint): 3 warmup, 3 camera and 20 main
       steps each, the main stage's steps/s. With the term: humor_loss
       finite, the first main step's loss (the full grid) on the card
       against the CPU, a step of each stage without a
       synchronisation.
    """
    import numpy as np
    import torch
    from nemo_tpu_torch.cli import fit as fit_cli
    from nemo_tpu_torch.fit import NemoFitter, build_assets, fit_loss
    out = {}
    t_start = time.perf_counter()

    def run():
        smpl_f, gmm_f, vposer_f, humor_f = loaders_bit_identical(
            device, smpl, files, sources)
        # 2. init fit_loss, loaded vs in-memory assets
        cfg = reference_config()
        mem = make_fitter(device, smpl, bundle, cfg)
        fil = NemoFitter(cfg, build_assets(bundle, smpl_f, cfg, gmm=gmm_f,
                                           vposer=vposer_f, device=device),
                         seed=0)
        g = torch.Generator().manual_seed(9)
        V, F = bundle.num_views, bundle.num_frames
        vi = torch.randint(0, V, (BATCH,), generator=g).to(device)
        fi = torch.randint(0, F, (BATCH,), generator=g).to(device)
        with torch.no_grad():
            _, m_mem = fit_loss(mem.params, cfg, mem.assets, vi, fi)
            _, m_fil = fit_loss(fil.params, cfg, fil.assets, vi, fi)
        got = {k: (float(m_mem[k]), float(m_fil[k])) for k in m_mem}
        print(f"[path G] init fit_loss at B={BATCH}, in memory vs from "
              f"files: {json.dumps(got)}")
        if sorted(m_mem) != sorted(m_fil) or any(a != b for a, b in
                                                 got.values()):
            raise AssertionError("path G: fit_loss from the files differs")
        del mem, fil
        # 3. the recipe through the CLI
        with tempfile.TemporaryDirectory() as d:
            argv = ["--bundle", recipe_bundle(bundle, os.path.join(
                        d, "bundle.npz")),
                    "--default_config", "configs/default-v2.yml",
                    "--smpl_path", files["smpl_dir"],
                    "--j_regressor_extra", files["jre"],
                    "--vposer_path", files["vposer"],
                    "--gmm_path", files["gmm"],
                    "--render_video", "30", "--warmup_step", "5",
                    "--opt_cam_step", "5", "--n_steps", "10",
                    "--out_dir", os.path.join(d, "out"),
                    "--device", str(device)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if fit_cli.main(argv) != 0:
                raise AssertionError("path G: the fit CLI failed")
            out["cli_s"] = time.perf_counter() - t0
            run_dir = os.path.join(d, "out", "000000")
            print(f"[path G] the recipe's fit CLI: {out['cli_s']:.2f} s; "
                  f"outputs {sorted(os.listdir(run_dir))}")
            want = {"eval_3d.csv": ("mpjpe-vibe", "mpjpe-vs", "mpjpe-pare",
                                    "mpjpe-glamr", "pa_mpjpe-glamr"),
                    "eval_3d_dynamic.csv": ("mpjpe-vibe", "mpjpe-glamr"),
                    "eval_3d_global.csv": ("mpjpe-ours", "mpvpe-ours",
                                           "mpjpe-glamr", "mpvpe-glamr")}
            for name, cols in want.items():
                with open(os.path.join(run_dir, name)) as f:
                    rows = [line.strip().split(",") for line in f]
                head, vals = rows[0], [list(map(float, r[1:]))
                                       for r in rows[1:]]
                missing = [c for c in cols if c not in head]
                if missing or len(vals) != V or not np.isfinite(vals).all():
                    raise AssertionError(f"path G: {name} malformed "
                                         f"(missing {missing})")
                print(f"[path G] {name}: {head[1:]}; view 0 "
                      f"{dict(zip(head[1:], vals[0]))}")
        # 4. the custom-video configuration without, then with, the
        # HuMoR term
        for weight in (0.0, 1.0):
            tag = "path G humor" if weight else "path G no humor"
            cfg = custom_video_config(weight_humor_loss=weight)
            fitter = NemoFitter(cfg, build_assets(
                bundle, smpl_f, cfg, gmm=gmm_f, vposer=vposer_f,
                device=device, humor=humor_f if weight else None), seed=0)
            wm, cm = fitter.warmup(3), fitter.opt_cam(3)
            if weight:
                grid = (torch.arange(V).repeat_interleave(F),
                        torch.arange(F).repeat(V))
                card_vs_cpu(tag, fitter, bundle, smpl_f, batch=grid)
            main, chunk = 20, 5
            stamps = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fm = fitter.fit(main, chunk=chunk, on_chunk=lambda *_:
                            stamps.append(time.perf_counter()))
            rate = (main - chunk) / (stamps[-1] - stamps[0])
            out["humor_steps_s" if weight else "custom_steps_s"] = rate
            check_finite(tag, [wm, cm, fm])
            rows, term = "off", ""
            if weight:
                rows = f"on {3 * V * F} rows"
                term = (f"humor_loss {fm['humor_loss'][0]:.4f} -> "
                        f"{fm['humor_loss'][-1]:.4f}, ")
            print(f"[{tag}] main stage: {main} steps in "
                  f"{stamps[-1] - t0:.3f} s; the last {main - chunk} at "
                  f"{rate:.3f} steps/s (full batch B={V * F}, the HuMoR "
                  f"term {rows}; {nvidia_smi_line()}); {term}total_loss "
                  f"{fm['total_loss'][0]:.3f} -> {fm['total_loss'][-1]:.3f}")
        no_sync_steps("path G humor", fitter)

    counts, _ = run_path("path G", ("fk_fwd", "fk_bwd", "v2v_grad",
                                    "v2v_fwd", "raster_stream"), run)
    out["seconds"] = time.perf_counter() - t_start
    print(f"[path G] {out['seconds']:.1f} s in all")
    return counts, out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    print("[device] " + ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("matplotlib", "PIL")))
    device = torch.device("cuda", 0)

    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    from nemo_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {_build.library_path()} ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds if _build.build_seconds is not None else 0:.2f} s)")

    smpl = synthetic_smpl_model(6890, seed=0, device=device)
    kernel_err, rec = kernel_phase(device, smpl)
    bundle, _ = synthetic_problem(smpl, num_views=8, num_frames=120,
                                  img_hw=IMG_HW, seed=0)
    kernel_err.update(raster_phase(device, smpl, bundle, rec))
    kernel_err.update(chamfer_phase(device, smpl, rec))
    kernel_err.update(mlp_phase(device, rec))
    paths = {}
    paths["slice 1"], steady1 = slice1_path(device, smpl, bundle)
    paths["path A"], steady_a = path_a(device, smpl, bundle)
    for k, c in path_b(device, smpl, bundle).items():
        paths[f"path B {k}"] = c
    for k, c in path_c(device, smpl, bundle).items():
        paths[f"path C {k}"] = c
    paths["path D"], render = path_d(device, smpl, bundle)
    with tempfile.TemporaryDirectory() as d:
        files, sources = write_asset_files(d, smpl)
        paths["path E"] = path_e(device, files)
        paths["path F"], steady_f = path_f(device, smpl, bundle)
        paths["path G"], g = path_g(device, smpl, bundle, files, sources)
    launches = {k: sum(c[k] for c in paths.values()) for k in KERNELS}
    print(f"[paths] render: {render['video_s']:.4f} s a video frame with the "
          f"PNG writes, {render['nopng_s']:.4f} s without")
    print(f"[paths] steps/s: slice 1 {steady1:.3f}, path A {steady_a:.3f}, "
          f"path F {steady_f:.3f}, path G's custom-video configuration "
          f"{g['custom_steps_s']:.3f} without the HuMoR term and "
          f"{g['humor_steps_s']:.3f} with it; path G {g['seconds']:.1f} s; "
          f"launches summed over the paths {json.dumps(launches)}; "
          f"{time.perf_counter() - t_start:.1f} s in all")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": kernel_err[k],
         "ms": rec[k]["ms"], "plain_ms": rec[k]["plain_ms"],
         "bound_ms": rec[k]["bound_ms"], "bound_by": rec[k]["bound_by"],
         "library_ms": rec[k]["library_ms"], "shape": rec[k]["shape"]}
        for k, (src, rep) in KERNELS.items()]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
