#!/usr/bin/env python
"""Smoke test of the PyTorch port on one NVIDIA GPU: kernels, then the fit.

Run from the repository root with no arguments:

    python3 chip_smoke.py

1. Device: needs CUDA (exits nonzero without it) and prints the card's
   name and power limit as nvidia-smi reports them.
2. Build: compiles nemo_tpu_torch/csrc/*.cu for sm_90a (ops/_build.py).
3. Kernels against their plain PyTorch versions on the card, at the shapes
   of the fit's main path: K1 forward and backward (B=512, random
   rotations) and K2 in grad and forward-only mode (B=512, the 6890-vertex
   synthetic SMPL's tables), with max errors beside stated tolerances and
   median CUDA-event times of kernel and plain.
4. The fit at the reference width (bench.py's NemoConfig: NemoV2, batch
   512, h_dim 1000, RBF 100 quadratic, 200-node phase nets, 8 views x 120
   frames, VPoser v2v weight 10 + KL 1 + GMM 1): warmup, camera and main
   stages, eval_loss and the eval CSVs. Launch counters are zeroed just
   before and read just after; every kernel must have run. Losses must be
   finite, the main-stage kp_loss must fall, and fit_loss on the card must
   agree with the port's CPU path from the same parameters.

Prints a JSON line of per-kernel results, the nvidia-smi line as the tool
prints it, and as the last line {"ok": true, "device": {...}}. Any failure
raises (exit code 1).
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

WARMUP_STEPS, CAM_STEPS, MAIN_STEPS = 10, 10, 50
BATCH = 512

# (counter key, source, TPU kernel it replaces)
KERNELS = {
    "fk_fwd": ("nemo_tpu_torch/csrc/fk.cu",
               "nemo_tpu/ops/fk_pallas.py:197"),
    "fk_bwd": ("nemo_tpu_torch/csrc/fk.cu",
               "nemo_tpu/ops/fk_pallas.py:226"),
    "v2v_grad": ("nemo_tpu_torch/csrc/v2v.cu",
                 "nemo_tpu/ops/lbs_pallas.py:709"),
    "v2v_fwd": ("nemo_tpu_torch/csrc/v2v.cu",
                "nemo_tpu/ops/lbs_pallas.py:560"),
}


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


def random_rotations(B: int, J: int, gen, device, scale: float = 0.6):
    import torch
    from nemo_tpu_torch.geometry.rotations import batch_rodrigues
    aa = scale * torch.randn((B, J, 3), generator=gen)
    return batch_rodrigues(aa).to(device)


def kernel_phase(device, smpl):
    """K1/K2 against their plain versions at the main path's shapes."""
    import torch
    from nemo_tpu_torch.body.smpl import fk_rt
    from nemo_tpu_torch.ops import fk, lbs

    gen = torch.Generator().manual_seed(0)
    errs, times = {}, {}
    parents = tuple(int(p) for p in smpl.parents)
    B, J, V = BATCH, 24, smpl.num_vertices

    # K1. Tolerance: an 8-level chain of f32 3x3 products of O(1) entries;
    # the two sides differ only in summation order (~1e-7 per product).
    R_l = random_rotations(B, J, gen, device)
    t_l = (0.3 * torch.randn((B, J, 3), generator=gen)).to(device)
    gR = torch.randn((B, J, 3, 3), generator=gen).to(device)
    gt = torch.randn((B, J, 3), generator=gen).to(device)
    Rk, tk = fk.fk_fwd_cuda(R_l, t_l, parents)
    Rp, tp = fk.fk_fwd_plain(R_l, t_l, parents)
    check("fk_fwd", torch.cat([Rk.flatten(), tk.flatten()]),
          torch.cat([Rp.flatten(), tp.flatten()]), 1e-5, errs)
    gRk, gtk = fk.fk_bwd_cuda(R_l, t_l, Rk, gR, gt, parents)
    gRp, gtp = fk.fk_bwd_plain(R_l, t_l, Rp, gR, gt, parents)
    # cotangents are N(0,1) summed over up to 23 descendants: entries O(10)
    check("fk_bwd", torch.cat([gRk.flatten(), gtk.flatten()]),
          torch.cat([gRp.flatten(), gtp.flatten()]), 1e-4, errs)
    times["fk_fwd"] = (median_ms(lambda: fk.fk_fwd_cuda(R_l, t_l, parents)),
                       median_ms(lambda: fk.fk_fwd_plain(R_l, t_l, parents)))
    times["fk_bwd"] = (
        median_ms(lambda: fk.fk_bwd_cuda(R_l, t_l, Rk, gR, gt, parents)),
        median_ms(lambda: fk.fk_bwd_plain(R_l, t_l, Rk, gR, gt, parents)))

    # K2 inputs as smpl_v2v_l1_sum builds them. The rec side gets a
    # per-row offset of +-10 m on each axis, so no vertex difference is
    # near 0: there sign(rec - orig) could flip between two summation
    # orders and move a gradient entry by a whole term.
    vsh = smpl.v_template.t().contiguous()
    Jr = torch.einsum('jv,vk->jk', smpl.J_regressor, smpl.v_template)[None]

    def side(rot):
        pf = (rot[:, 1:] - torch.eye(3, device=device)).reshape(B, 207)
        R_g, _, t_rel = fk_rt(rot, Jr, smpl.parents)
        return pf.contiguous(), torch.cat([R_g, t_rel[..., None]], -1).reshape(
            B, 24, 12).contiguous()

    with torch.no_grad():
        pf_o, A_o = side(random_rotations(B, J, gen, device))
        pf_r, A_r = side(random_rotations(B, J, gen, device))
    offset = 10.0 * torch.sign(torch.randn((B, 1, 3), generator=gen)).to(device)
    A_r = A_r.reshape(B, 24, 3, 4).clone()
    A_r[..., 3] += offset
    A_r = A_r.reshape(B, 24, 12).contiguous()
    args = (pf_o, A_o, vsh, smpl.posedirs_t, smpl.lbs_weights_t, pf_r, A_r)
    tot_k, (gpf_k, gA_k, gvsh_k) = lbs.v2v_l1_cuda(*args, grad=True)
    tot_p, (gpf_p, gA_p, gvsh_p) = lbs.v2v_l1_plain(*args, grad=True)
    tot_f, _ = lbs.v2v_l1_cuda(*args, grad=False)
    # total: 10.6M |diff| terms summed in another order, rtol 1e-5
    check("v2v_grad total", tot_k, tot_p, 1e-5 * float(tot_p.abs()), errs)
    check("v2v_fwd total", tot_f, tot_p, 1e-5 * float(tot_p.abs()), errs)
    if not torch.equal(tot_f, tot_k):
        raise AssertionError("forward-only total differs from grad mode")
    # gradients: sums of up to 3V = 20670 f32 products in another order;
    # atol 1e-4 x the tensor's largest entry
    for name, gk, gp in (("v2v_grad gpf", gpf_k, gpf_p),
                         ("v2v_grad gA", gA_k, gA_p),
                         ("v2v_grad gvsh", gvsh_k, gvsh_p)):
        check(name, gk, gp, 1e-4 * float(gp.abs().max()), errs)
    rerun = lbs.v2v_l1_cuda(*args, grad=True)
    if not (torch.equal(rerun[0], tot_k) and all(
            torch.equal(a, b) for a, b in zip(rerun[1], (gpf_k, gA_k, gvsh_k)))):
        raise AssertionError("K2 is not bit-stable run to run")
    times["v2v_grad"] = (median_ms(lambda: lbs.v2v_l1_cuda(*args, grad=True)),
                         median_ms(lambda: lbs.v2v_l1_plain(*args, grad=True)))
    times["v2v_fwd"] = (median_ms(lambda: lbs.v2v_l1_cuda(*args, grad=False)),
                        median_ms(lambda: lbs.v2v_l1_plain(*args, grad=False)))
    for k, (tk_, tp_) in times.items():
        print(f"[time] {k}: kernel {tk_:.4f} ms, plain {tp_:.4f} ms "
              f"(median of 20 CUDA-event timings, B={B}, V={V})")
    kernel_err = {
        "fk_fwd": errs["fk_fwd"], "fk_bwd": errs["fk_bwd"],
        "v2v_grad": max(errs["v2v_grad total"], errs["v2v_grad gpf"],
                        errs["v2v_grad gA"], errs["v2v_grad gvsh"]),
        "v2v_fwd": errs["v2v_fwd total"],
    }
    return kernel_err, times


def slice_phase(device, smpl):
    """The fit's main path at the reference width, through the kernels."""
    import numpy as np
    import torch
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    from nemo_tpu_torch.eval.metrics import eval_2d, eval_3d, write_csv
    from nemo_tpu_torch.fit import (NemoConfig, NemoFitter, NemoParams,
                                    build_assets, fit_loss, predict,
                                    project_to_views)
    from nemo_tpu_torch.fit.optimizer import make_camera_stage_optimizer
    from nemo_tpu_torch.ops import launch_counts, reset_launches
    from nemo_tpu_torch.priors.gmm import synthetic_gmm_prior
    from nemo_tpu_torch.priors.vposer import init_vposer

    cfg = NemoConfig(
        model_version=2, h_dim=1000, instance_code_size=5,
        phase_rbf_dim=100, rbf_kernel="quadratic",
        monotonic_network_n_nodes=200, phase_init="rand",
        batch_size=BATCH, loss="mse_robust",
        weight_vp_loss=10.0, weight_vp_z_loss=1.0, weight_gmm_loss=1.0,
        lr_factor=0.5, n_steps=MAIN_STEPS, warmup_step=WARMUP_STEPS,
        opt_cam_step=CAM_STEPS, label_type="gt")
    bundle, _ = synthetic_problem(smpl, num_views=8, num_frames=120, seed=0)
    assets = build_assets(bundle, smpl, cfg, gmm=synthetic_gmm_prior(8),
                          vposer=init_vposer(
                              generator=torch.Generator().manual_seed(7)),
                          device=device)
    fitter = NemoFitter(cfg, assets, seed=0)

    torch.cuda.synchronize()
    reset_launches()
    init = fitter.eval_loss()
    wm = fitter.warmup()
    cm = fitter.opt_cam()
    # chunks of 10 steps; each chunk ends with its metrics on the host (a
    # sync), so the chunk boundaries time the steps. The first chunk takes
    # the one-off costs of the stage (first launches at new shapes, caching
    # allocator growth); steps/s is read over the other four.
    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fm = fitter.fit(chunk=10, on_chunk=lambda *_: stamps.append(
        time.perf_counter()))
    main_s = stamps[-1] - t0
    steady_s = stamps[-1] - stamps[0]
    final = fitter.eval_loss()
    V, F = assets.num_views, assets.num_frames
    vi = torch.arange(V, device=device).repeat_interleave(F)
    fi = torch.arange(F, device=device).repeat(V)
    with torch.no_grad():
        preds = predict(fitter.params, cfg, assets, vi, fi)
        pts2d = project_to_views(fitter.params, cfg, assets, preds["j"], vi)
    pts2d = pts2d.cpu().numpy().reshape(V, F, 25, 2)
    with tempfile.TemporaryDirectory() as d:
        write_csv(eval_2d(pts2d, {"op": bundle.labels["op"]},
                          bundle.labels["gt"], bundle.bbox_diag("gt")),
                  os.path.join(d, "eval_2d.csv"))
        stats3d = eval_3d(assets.smpl, preds["poses"].cpu().numpy().reshape(
            V, F, 69), bundle.gt3d_pose, {"vibe": bundle.hmr_theta})
        write_csv(stats3d, os.path.join(d, "eval_3d.csv"))
        with open(os.path.join(d, "eval_2d.csv")) as f:
            header = f.readline().strip()
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"[slice] launches during the fit: {json.dumps(counts)}")
    for k in KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the fit")

    steps_per_s = (MAIN_STEPS - 10) / steady_s
    print(f"[slice] main stage: {MAIN_STEPS} steps in {main_s:.3f} s; the "
          f"last {MAIN_STEPS - 10} in {steady_s:.3f} s = {steps_per_s:.3f} "
          f"steps/s (batch {BATCH}, 8 views x 120 frames, "
          f"V={smpl.num_vertices})")
    kp = fm["kp_loss"]
    print(f"[slice] init {init}\n[slice] final {final}")
    print(f"[slice] warmup_loss {wm['warmup_loss'][0]:.4f} -> "
          f"{wm['warmup_loss'][-1]:.4f}; cam_loss {cm['cam_loss'][0]:.2f} -> "
          f"{cm['cam_loss'][-1]:.2f}; kp_loss {kp[0]:.2f} -> {kp[-1]:.2f}")
    arrays = [wm["warmup_loss"], cm["cam_loss"], *fm.values()]
    if not all(np.isfinite(a).all() for a in arrays) or not all(
            math.isfinite(v) for v in (*init.values(), *final.values())):
        raise AssertionError("non-finite loss in the fit")
    if not kp[-10:].mean() < kp[:10].mean():
        raise AssertionError("main-stage kp_loss did not fall")
    for name, v in stats3d.items():
        if not np.isfinite(v).all() or len(v) != V:
            raise AssertionError(f"eval_3d column {name} malformed")
    if header != ",recon_error_2d-ours,pck-ours,recon_error_2d-op,pck-op":
        raise AssertionError(f"eval_2d header {header!r}")

    # One more step of each stage with every synchronising call turned into
    # an error: nothing inside a stage may wait for the device.
    cam_opt = make_camera_stage_optimizer(fitter.params, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fitter.warmup_step(0)
        fitter.camera_step(cam_opt)
        fitter.main_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("[slice] a step of each stage ran without a device synchronisation")

    # The card against the port's CPU path (plain PyTorch versions of the
    # kernels) from the same parameters, on one batch of 64.
    g = torch.Generator().manual_seed(3)
    vi = torch.randint(0, V, (64,), generator=g)
    fi = torch.randint(0, F, (64,), generator=g)
    with torch.no_grad():
        _, m_gpu = fit_loss(fitter.params, cfg, assets, vi.to(device),
                            fi.to(device))
        cpu_assets = build_assets(bundle, smpl.to("cpu"), cfg,
                                  gmm=assets.gmm.to("cpu"),
                                  vposer={k: v.cpu()
                                          for k, v in assets.vposer.items()},
                                  device="cpu")
        params_cpu = NemoParams(cfg, V, assets.img_d0)
        params_cpu.load_state_dict({k: v.cpu() for k, v in
                                    fitter.params.state_dict().items()})
        _, m_cpu = fit_loss(params_cpu, cfg, cpu_assets, vi, fi)
    for k in m_cpu:
        a, b = float(m_gpu[k]), float(m_cpu[k])
        print(f"[slice] fit_loss {k}: cuda {a:.6f} cpu {b:.6f}")
        if not abs(a - b) <= 1e-4 * abs(b) + 1e-6:
            raise AssertionError(f"fit_loss {k}: card and CPU disagree")
    return counts, steps_per_s


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    device = torch.device("cuda", 0)

    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {_build.library_path()} ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds if _build.build_seconds is not None else 0:.2f} s)")

    smpl = synthetic_smpl_model(6890, seed=0, device=device)
    kernel_err, times = kernel_phase(device, smpl)
    counts, steps_per_s = slice_phase(device, smpl)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[k], "max_abs_err": kernel_err[k],
         "ms": times[k][0], "plain_ms": times[k][1]}
        for k, (src, rep) in KERNELS.items()]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
