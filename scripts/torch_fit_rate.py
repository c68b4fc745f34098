#!/usr/bin/env python
"""Main-stage rate and device profile of the PyTorch port on one GPU.

    python scripts/torch_fit_rate.py [--config NAME ...] [--steps 50]
        [--reps 5] [--profile_steps 10]

Builds a fitter for each named configuration on the synthetic 6890-vertex
SMPL and 8 views x 120 frames with chip_smoke.py's configurations and
fitter set-up, runs 10 warmup and 10 camera steps and one untimed main run
of ``--steps`` each, then ``--reps`` rounds of timed main runs of
``--steps``, one run a configuration in turn within each round (host
clock; each run ends with its metrics on the host). With
``--profile_steps`` it then traces that many main steps of each under
torch.profiler and reports the kernels a step, the launch calls a step,
the device's kernel time and busy time (the union of kernel intervals) a
step, the kernels with the most device time, and the port's spans
(portbench/harness/spans.py): device ms a step by owner span, the host's
own ms a step outside CUDA calls, and the spans' table on standard error.
To compare two commits, unpack each (git archive) and run each copy's own
script in one call.

Configurations (chip_smoke.py):
  reference            reference_config: NemoV2, batch 512, h_dim 1000, RBF
                       100 quadratic, 200-node phase nets, VPoser v2v 10 +
                       KL 1 + GMM 1 (bench.py:99-113)
  reference_fused      the same with the MotionNet through the fused MLP
                       kernels K6 (motion_mlp="fused"; chip_smoke.py's path F)
  custom_video         custom_video_config: NemoV3 as
                       run_examples/custom-video-example.sh:52-85 (full
                       batch B=960, weight_3d_loss 1000, lr_phase 0,
                       lr_factor 1), full-mesh v2v prior through K2
  custom_video_subset  the same with the opt-in v2v prior on 1024 vertices
                       through K3 (chip_smoke.py's path A)
  reference_bf16       reference with bf16 skinning tables (--skin_bf16:
                       K2's bf16 kernels; chip_smoke.py's path H)
  custom_video_subset_bf16  custom_video_subset with bf16 tables (K3f/K3b
                       bf16)
  reference_bench      reference at the JAX bench's precision: bf16 tables
                       and "high" (bf16x3) network products
                       (--net_precision high; chip_smoke.py's path I)
  reference_bench_fused  the same with the MotionNet through K6 at "high"

Prints one JSON line per timed run and per profile, then the nvidia-smi
line (name, power limit).
"""

import argparse
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (stdlib imports only at module level)

def _subset():
    return chip_smoke.custom_video_config(vp_v2v_n_verts=1024)


# name -> (configuration, MotionNet mode, bf16 skinning tables, network
# precision)
CONFIGS = {
    "reference": (chip_smoke.reference_config, "plain", False, "highest"),
    "reference_fused": (chip_smoke.reference_config, "fused", False,
                        "highest"),
    "custom_video": (chip_smoke.custom_video_config, "plain", False,
                     "highest"),
    "custom_video_subset": (_subset, "plain", False, "highest"),
    "reference_bf16": (chip_smoke.reference_config, "plain", True, "highest"),
    "custom_video_subset_bf16": (_subset, "plain", True, "highest"),
    "reference_bench": (chip_smoke.reference_config, "plain", True, "high"),
    "reference_bench_fused": (chip_smoke.reference_config, "fused", True,
                              "high"),
}


def make_fitters(configs):
    import torch
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    device = torch.device("cuda", 0)
    smpl = {bf16: synthetic_smpl_model(
        6890, seed=0, device=device,
        skin_dtype=torch.bfloat16 if bf16 else torch.float32)
        for bf16 in sorted({CONFIGS[name][2] for name in configs})}
    bundle, _ = synthetic_problem(next(iter(smpl.values())), num_views=8,
                                  num_frames=120, seed=0)
    return {name: chip_smoke.make_fitter(device, smpl[CONFIGS[name][2]],
                                         bundle, CONFIGS[name][0](),
                                         motion_mlp=CONFIGS[name][1],
                                         net_precision=CONFIGS[name][3])
            for name in configs}


def timed_run(fitter, steps: int) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitter.fit(steps, chunk=steps)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile(fitter, steps: int) -> dict:
    """Trace ``steps`` main steps: per-step kernel count, launch calls,
    kernel and busy time, top kernels, device time by owner span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from portbench.harness.spans import reduce_spans, table
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fitter.fit(steps, chunk=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, launches = [], 0
    for e in prof.events():
        # a record_function's range on the device's timeline is no kernel
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            kernels.append((e.name, e.time_range.start, e.time_range.end))
        elif "LaunchKernel" in e.name:
            launches += 1
    busy, end = 0.0, float("-inf")
    for _, s, t in sorted(kernels, key=lambda k: k[1]):
        if t > end:
            busy += t - max(s, end)
            end = t
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for name, s, t in kernels:
        per_name[name][0] += t - s
        per_name[name][1] += 1
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:15]
    total_us = sum(t - s for _, s, t in kernels)
    sp = reduce_spans(prof.events(), steps, mark=None)
    print(table(sp), file=sys.stderr)
    return {
        "steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
        "kernels_per_step": len(kernels) / steps,
        "launch_calls_per_step": launches / steps,
        "kernel_ms_per_step": 1e-3 * total_us / steps,
        "busy_ms_per_step": 1e-3 * busy / steps,
        "device_ms_per_step_by_span": {
            k: 1e-3 * us / steps for k, us in sp["owned_us"].items()},
        "host_ms_per_step": 1e-3 * sp["step_host_us"] / steps,
        "top_kernels": [{"name": n[:90], "ms_per_step": 1e-3 * us / steps,
                         "per_step": c / steps} for n, (us, c) in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), nargs="+",
                    default=["reference"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile_steps", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_fit_rate: needs a CUDA device", file=sys.stderr)
        return 1
    from nemo_tpu_torch.ops import launch_counts, reset_launches
    fitters = make_fitters(args.config)
    for fitter in fitters.values():
        fitter.warmup(10)
        fitter.opt_cam(10)
        timed_run(fitter, args.steps)
    for rep in range(args.reps):
        for name, fitter in fitters.items():
            reset_launches()
            s = timed_run(fitter, args.steps)
            print(json.dumps({"config": name, "steps": args.steps, "rep": rep,
                              "seconds": s, "steps_per_s": args.steps / s,
                              "launches_per_step": {
                                  k: v / args.steps
                                  for k, v in launch_counts().items() if v}}),
                  flush=True)
    if args.profile_steps:
        for name, fitter in fitters.items():
            print(json.dumps({"config": name, "steps": args.steps,
                              "profile": profile(fitter,
                                                 args.profile_steps)}),
                  flush=True)
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
