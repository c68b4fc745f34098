#!/usr/bin/env python
"""K6 (the fused MotionNet MLP, forward and backward) of one checkout, timed
on one GPU, with digests of its outputs.

    python scripts/torch_mlp_times.py [--root DIR] [--batches 512 960 1]
        [--reps 20] [--label NAME] [--profile]
        [--precision highest|high|bf16]

Imports ``nemo_tpu_torch`` and ``chip_smoke`` from DIR (default: the
checkout this script lies in) and builds its kernels there.

For each batch B, at the reference MotionNet's widths (chip_smoke.py's
MLP_D, MLP_H, MLP_O: D=105, H=1000, O=147), draws weights U(+-1/sqrt(fan_in))
and x in [0, 1) as chip_smoke.py's K6 phase does (seed B) and an N(0, 1)
cotangent; holds ``mlp.mlp_fwd_cuda`` against ``mlp.motion_net_mlp_plain``
(1e-5 of each output's largest entry) and ``mlp.mlp_bwd_cuda`` against
``mlp.motion_net_mlp_bwd_plain`` (1e-4 of each gradient's largest entry),
both sides of the backward reading the kernel's saved activations; then
times the kernel and the plain version (the same products as a chain of
cuBLAS calls with TF32 off). Each line carries the largest error relative
to a tensor's largest entry, of the kernel against the plain version and of
the kernel and the plain version against the plain version in f64, the
host time of one call (the wrapper's work before it returns, the median of
10 rounds of 20 calls) and the sha256 of the kernel's outputs on these
seeded inputs. With --profile, torch.profiler traces 20 more calls of each
kernel and the line adds the device time a call and each launch's device
time in launch order.

--precision runs both sides at one of the port's network precisions
(ops/mlp.py NET_PRECISIONS; a checkout from before them has "highest"
only, which is passed as no argument at all, so equal digests across
checkouts there mean the same bits). At "high" the tolerances are those of
f32; at "bf16" both are chip_smoke.py's K6_BF16 (one bf16 rounding,
2^-8), and the f64 errors are not computed (the function rounds its
operands to bf16).

A time is the median of ``--reps`` CUDA-event timings of one call each
after 3 warm-up calls. To compare two commits on one card, unpack the other
with ``git archive`` into a directory that .gitignore lists and run, in one
call, this script with --root set to each in turn: parent, change, change,
parent.

Prints one JSON line per (kernel, B), then the nvidia-smi line (name, power
limit). Needs a CUDA device.
"""

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chip_smoke.py's K6_BF16 (kept here: an older checkout's smoke lacks it)
K6_BF16 = 2.0 ** -8


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=REPO)
    p.add_argument("--batches", type=int, nargs="+", default=[512, 960, 1])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--label", default="")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--precision", default="highest",
                   choices=("highest", "high", "bf16"))
    args = p.parse_args(argv)
    prec = {} if args.precision == "highest" else {
        "precision": args.precision}
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("torch_mlp_times: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import MLP_D, MLP_H, MLP_O, median_ms
    from nemo_tpu_torch.ops import mlp
    import nemo_tpu_torch
    if not os.path.abspath(nemo_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"nemo_tpu_torch came from {nemo_tpu_torch.__file__}"
                           f", not from {root}")
    device = torch.device("cuda", 0)
    D, H, O = MLP_D, MLP_H, MLP_O
    label = args.label or root

    def rel_err(got, want):
        return max(float((a.double() - b).abs().max() / b.abs().max())
                   for a, b in zip(got, want))

    def host_ms(fn):
        rounds = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            rounds.append((time.perf_counter() - t0) / 20 * 1e3)
        torch.cuda.synchronize()
        return sorted(rounds)[len(rounds) // 2]

    def device_profile(fn, calls=20):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.events()
                       if e.device_type.name == "CUDA"),
                      key=lambda e: e.time_range.start)
        per = len(kern) // calls
        if per == 0 or len(kern) != per * calls:
            return None, None  # the trace lost launches
        launches = [[kern[i].name.split("(")[0].split("::")[-1][:40],
                     round(sum(kern[c * per + i].time_range.elapsed_us()
                               for c in range(calls)) / calls, 2)]
                    for i in range(per)]
        return round(sum(t for _, t in launches) / 1e3, 4), launches

    for B in args.batches:
        gen = torch.Generator().manual_seed(B)

        def init(*shape, fan_in):
            u = torch.rand(shape, generator=gen) * 2.0 - 1.0
            return (u / math.sqrt(fan_in)).to(device)

        W = (init(D, H, fan_in=D), init(H, fan_in=D), init(H, H, fan_in=H),
             init(H, fan_in=H), init(H, H, fan_in=H), init(H, fan_in=H),
             init(H, O, fan_in=H), init(O, fan_in=H))
        x = torch.rand((B, D), generator=gen).to(device)
        gout = torch.randn((B, O), generator=gen).to(device)
        fwd_args = (x, *W)
        got = mlp.mlp_fwd_cuda(*fwd_args, **prec)
        bwd_args = (gout, x, *got[1:], W[0], W[2], W[4], W[6])
        grads = mlp.mlp_bwd_cuda(*bwd_args, **prec)
        tols = (K6_BF16,) * 2 if args.precision == "bf16" else (1e-5, 1e-4)
        for kernel, k_fn, p_fn, out, tol in (
                ("K6f", mlp.mlp_fwd_cuda, mlp.motion_net_mlp_plain, got,
                 tols[0]),
                ("K6b", mlp.mlp_bwd_cuda, mlp.motion_net_mlp_bwd_plain,
                 grads, tols[1])):
            a = fwd_args if kernel == "K6f" else bwd_args
            fn = lambda *t, k_fn=k_fn: k_fn(*t, **prec)
            plain = lambda *t, p_fn=p_fn: p_fn(*t, **prec)
            want = plain(*a)
            rel = rel_err(out, want)
            if not rel <= tol:
                raise AssertionError(f"{kernel} at B={B}: off by {rel:.3e} of "
                                     f"a tensor's largest entry ({tol:g})")
            exact = p_fn(*(t.double() for t in a)) \
                if args.precision == "highest" else None
            rec = {"label": label, "kernel": kernel,
                   "precision": args.precision, "B": B, "D": D, "H": H,
                   "O": O, "ms": median_ms(lambda: fn(*a), reps=args.reps),
                   "plain_ms": median_ms(lambda: plain(*a), reps=args.reps),
                   "host_ms": host_ms(lambda: fn(*a)),
                   "max_rel_err": rel,
                   "f64_rel_err": exact and rel_err(out, exact),
                   "plain_f64_rel_err": exact and rel_err(want, exact),
                   "sha256": digest(*out), "reps": args.reps}
            if args.profile:
                rec["device_ms"], rec["launches_us"] = device_profile(
                    lambda: fn(*a))
            print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
