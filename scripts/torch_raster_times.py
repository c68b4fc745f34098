#!/usr/bin/env python
"""K5s and K5g (the tile rasterizer) of one checkout, timed on one GPU, with
digests of their outputs.

    python scripts/torch_raster_times.py [--root DIR] [--label NAME]
        [--reps 20] [--profile]

Imports ``nemo_tpu_torch`` and ``chip_smoke`` from DIR (default: the
checkout this script lies in) and builds its kernels there. The inputs are
chip_smoke.py's path D panels (the synthetic problem's posed 6890-vertex
mesh in views 0-3 at 1000 x 1900, seed 0), at 4 panels and 1: "body"; the
same mesh 30 m further away, "crowded"; every face twice, "tie". For each
case and mode (``raster_stream_cuda``, ``raster_gather_cuda`` at the
default capacity) a line gives ``ms``, the median of ``--reps`` CUDA-event
timings of one call (the wrapper's host work and every launch of the call
inside), ``device_ms``, one call's share of ``--reps`` calls run back to
back (scripts/torch_v2v_times.py's loop_ms), and the sha256 of (z, fid,
bary), so two checkouts that compute the same bits print the same
digests. ``--profile`` adds each launch's device time (torch.profiler, 10
calls). To compare two commits on one card, unpack the other with ``git
archive`` into a directory that .gitignore lists and run, in one call,
this script with --root set to each in turn: parent, change, change,
parent.

Prints one JSON line per (case, panels, mode), then the nvidia-smi
line (name, power limit). Needs a CUDA device.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=REPO)
    p.add_argument("--label", default="")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--profile", action="store_true")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("torch_raster_times: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import nemo_tpu_torch
    from torch_v2v_times import digest, loop_ms
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.data.synthetic import synthetic_problem
    from nemo_tpu_torch.ops import raster
    if not os.path.abspath(nemo_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"nemo_tpu_torch came from {nemo_tpu_torch.__file__}"
                           f", not from {root}")
    device = torch.device("cuda", 0)
    smpl = synthetic_smpl_model(6890, seed=0, device=device)
    bundle, _ = synthetic_problem(smpl, num_views=8, num_frames=120,
                                  img_hw=cs.IMG_HW, seed=0)
    verts, focals, centers = cs.posed_panels(smpl, bundle, device,
                                             [0, 1, 2, 3])
    faces = torch.as_tensor(smpl.faces, device=device).long()
    far = verts.clone()
    far[..., 2] += 30.0
    label = args.label or root

    def by_launch(fn):
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            dt = getattr(e, "device_time_total", 0) or getattr(
                e, "cuda_time_total", 0)
            # kernels only: not the port's nemo.ops.raster_* launch spans
            if dt > 0 and "raster" in e.key and \
                    not e.key.startswith("nemo."):
                name = e.key.split("raster_")[1].split("(")[0].split("<")[0]
                out[name] = dt / 10 / 1e3
        return out

    for n in (4, 1):
        for case, v, f in (("body", verts, faces), ("crowded", far, faces),
                           ("tie", verts, torch.cat([faces, faces]))):
            ent = raster.prepare(v[:n], f, focals[:n], centers[:n],
                                 cs.IMG_HW)
            si, gi = raster.stream_inputs(ent), raster.gather_inputs(ent)
            calls = {"K5s": lambda: raster.raster_stream_cuda(ent, si,
                                                              cs.IMG_HW),
                     "K5g": lambda: raster.raster_gather_cuda(ent, gi,
                                                              cs.IMG_HW)}
            for kernel, fn in calls.items():
                rec = {"label": label, "kernel": kernel, "case": case,
                       "panels": n, "sha256": digest(*fn()),
                       "ms": cs.median_ms(fn, reps=args.reps),
                       "device_ms": loop_ms(fn, args.reps),
                       "reps": args.reps}
                if args.profile:
                    rec["by_launch_ms"] = by_launch(fn)
                print(json.dumps(rec), flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
