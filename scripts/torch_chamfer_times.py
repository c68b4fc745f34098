#!/usr/bin/env python
"""K4 (the one-way nearest-neighbour chamfer) of one checkout on one GPU:
times a call, digests of the outputs, and launches a path-E step.

    python scripts/torch_chamfer_times.py [--root DIR] [--label NAME]
        [--shapes 1x512x6890 ...] [--reps 20] [--profile]

Imports ``nemo_tpu_torch`` from DIR (default: the checkout this script
lies in) and builds its kernels there; chip_smoke.py, whose helpers do
the measuring, comes from this script's checkout, so two checkouts are
measured by the same rules.

- Both directions at path E's shapes (``humor_tool fit-amass``'s defaults:
  60 frames, a 512-point scan, the 6890-vertex synthetic SMPL), scan ->
  mesh (T=60, N=512, M=6890) and mesh -> scan (60, 6890, 512), from
  chip_smoke.py's chamfer inputs (generator seed 4: the mesh 0.02 N(0, 1)
  about the template, the scan 0.01 N(0, 1) about vertices it picks).
  ``--shapes`` adds (T, N, M) cases, written TxNxM, of N(0, 1) queries and
  candidates (generator seed T + N + M). Each case is held against
  ``chamfer.nn_one_way_plain`` (distances and indices identical) and
  prints ``ms``, the median of ``--reps`` CUDA-event timings of one call
  (the wrapper's host work inside), ``loop_ms``, one call's share of
  ``--reps`` calls run back to back (scripts/torch_v2v_times.py's
  loop_ms), ``bound_ms`` (chip_smoke.py's: 9 f32 operations a (query,
  candidate) pair at 67 TFLOP/s, or the bytes at 3.35 TB/s if longer),
  ``instr_ms`` (the same 9 operations a pair, each issued as one
  instruction: 132 SMs x 128 lanes at 1.98 GHz), ``kernel_instr_ms`` (the
  8 instructions a pair csrc/chamfer.cu issues, at that rate), the split
  the checkout's kernel takes (``chamfer.nn_split``; null where it has
  none) and the sha256 of ``dist`` and ``idx``, so two checkouts that
  compute the same bits print the same digests.
- ``--profile`` adds ``device_ms``, the kernel's device time a launch
  (chip_smoke.py's ``profiled_ms``: torch.profiler, the mean over --reps
  launches from a trace that holds every one of them; null where none
  did), and ``floor_ms``, the same for an empty kernel on the kernel's grid
  (``chamfer.nn_empty_cuda``; null where the checkout has none), and the
  K4 launches and device time of one path-E stage-1 step (the data terms
  of ``models/humor_fit.obs3d_terms`` with the scan observed, at path E's
  shapes, forward and backward; the launch counters reset just before,
  read just after; the device time over 5 traced steps), nvidia-smi's
  SM clock, power draw and temperature sampled while K4 (scan -> mesh)
  runs back to back for 2 s, and the instructions that a pass of K4's
  group loop issues at path E's scan -> mesh split, read from the
  library's SASS (cuobjdump), by opcode and a pair, with the time they
  take at one instruction a cycle on each lane.

To compare two commits on one card, unpack the other with ``git archive``
into a directory that .gitignore lists and run, in one call, this script
with --root set to each in turn: parent, change, change, parent.

Prints one JSON line per measurement, then the nvidia-smi line (name,
power limit). Needs a CUDA device.
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def inner_loop(lib: str, kernel: str):
    """{opcode: count} of the group loop of the function whose name holds
    ``kernel`` in lib's SASS (cuobjdump from the CUDA toolkit): the
    innermost loop with the most FMNMX (the group minima), the
    instructions each of its passes issues. None where cuobjdump is
    missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if kernel in f.split()[0])
    rows = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]*)"
        r"([^;]*);", body)]
    loops = []      # (first, last) address of each backward branch's loop
    for a, op, rest in rows:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and m and int(m.group(1), 16) < a:
            loops.append((int(m.group(1), 16), a))
    inner = [(lo, hi) for lo, hi in loops if not any(
        lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi) for l2, h2 in loops)]
    counts = [collections.Counter(op.split(".")[0] for a, op, _ in rows
                                  if lo <= a <= hi) for lo, hi in inner]
    return dict(max(counts, key=lambda c: c["FMNMX"]))


def path_e_inputs(smpl, device, T, N):
    """chip_smoke.py's chamfer inputs: (scan (T, N, 3), mesh (T, V, 3))."""
    import torch
    gen = torch.Generator().manual_seed(4)
    V = smpl.num_vertices
    mesh = (smpl.v_template.cpu()[None] + 0.02 * torch.randn(
        (T, V, 3), generator=gen)).to(device).contiguous()
    pick = torch.randint(0, V, (T, N), generator=gen).to(device)
    scan = (torch.gather(mesh, 1, pick[..., None].expand(T, N, 3))
            + 0.01 * torch.randn((T, N, 3), generator=gen).to(device)
            ).contiguous()
    return scan, mesh


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=REPO)
    p.add_argument("--label", default="")
    p.add_argument("--shapes", nargs="*", default=[],
                   help="extra (T, N, M) cases, each TxNxM")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--profile", action="store_true")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    sys.path.insert(0, REPO)
    import chip_smoke as cs     # this checkout's measuring rules
    sys.path.insert(0, root)    # --root's package and kernels
    import torch
    if not torch.cuda.is_available():
        print("torch_chamfer_times: needs a CUDA device", file=sys.stderr)
        return 1
    import nemo_tpu_torch
    from torch_v2v_times import digest, loop_ms
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.models import humor_fit
    from nemo_tpu_torch.ops import (_build, chamfer, launch_counts,
                                    reset_launches)
    if not os.path.abspath(nemo_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"nemo_tpu_torch came from {nemo_tpu_torch.__file__}"
                           f", not from {root}")
    device = torch.device("cuda", 0)
    label = args.label or root
    empty = getattr(chamfer, "nn_empty_cuda", None)
    split = getattr(chamfer, "nn_split", None)
    attributes = getattr(chamfer, "nn_attributes", None)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    T, N = cs.SEQ_LEN, cs.SAMP_PTS
    smpl = synthetic_smpl_model(6890, seed=0, device=device)
    scan, mesh = path_e_inputs(smpl, device, T, N)
    cases = [("scan -> mesh", scan, mesh), ("mesh -> scan", mesh, scan)]
    for shape in args.shapes:
        Tk, Nk, Mk = (int(x) for x in shape.split("x"))
        gen = torch.Generator().manual_seed(Tk + Nk + Mk)
        cases.append((shape, torch.randn((Tk, Nk, 3), generator=gen)
                      .to(device), torch.randn((Tk, Mk, 3), generator=gen)
                      .to(device)))
    if attributes is not None:
        print(json.dumps({"label": label, "attributes": attributes()}),
              flush=True)

    for name, a, b in cases:
        Tk, Nk, Mk = a.shape[0], a.shape[1], b.shape[1]
        d, i = chamfer.nn_one_way_cuda(a, b)
        dp, ip = chamfer.nn_one_way_plain(a, b)
        if not (torch.equal(d, dp) and torch.equal(i, ip)):
            raise AssertionError(f"K4 {name}: differs from the plain version")
        d2, i2 = chamfer.nn_one_way_cuda(a, b)
        if not (torch.equal(d, d2) and torch.equal(i, i2)):
            raise AssertionError(f"K4 {name}: not bit-stable run to run")
        fn = lambda: chamfer.nn_one_way_cuda(a, b)
        pairs = Tk * Nk * Mk
        rec = {"label": label, "kernel": "K4", "case": name,
               "T": Tk, "N": Nk, "M": Mk,
               "split": None if split is None else split(
                   Tk, Nk, Mk, sms)._asdict(),
               "sha256_dist": digest(d), "sha256_idx": digest(i),
               "ms": cs.median_ms(fn, reps=args.reps),
               "loop_ms": loop_ms(fn, args.reps),
               "bound_ms": cs.bound_ms(cs.CHAMFER_FLOP * pairs,
                                       cs.nbytes(a, b, d, i))[0],
               "instr_ms": 1e3 * cs.CHAMFER_FLOP * pairs
               / cs.LANE_INSTR_PER_S,
               "kernel_instr_ms": 1e3 * cs.CHAMFER_INSTR * pairs
               / cs.LANE_INSTR_PER_S,
               "reps": args.reps}
        if args.profile:
            rec["device_ms"] = cs.profiled_ms(
                fn, ("nn_one_way",), args.reps)["nn_one_way"]
            rec["floor_ms"] = None if empty is None else cs.profiled_ms(
                lambda: empty(Tk, Nk, Mk, device), ("chamfer_empty",),
                args.reps)["chamfer_empty"]
        print(json.dumps(rec), flush=True)

    if args.profile and split is not None:
        # the instructions K4 issues a pair at path E (q queries a thread,
        # chamfer.GROUP candidates a pass of its group loop)
        q = split(T, N, mesh.shape[1], sms).q
        ops = inner_loop(_build.library_path(),
                         f"nn_one_way_split_kernelILi{q}E")
        if ops is not None:
            n = sum(ops.values()) / (q * chamfer.GROUP)
            print(json.dumps({"label": label, "K4 group loop": {
                "q": q, "pairs": q * chamfer.GROUP, "opcodes": ops,
                "instructions_a_pair": n, "ms_at_issue_rate": 1e3 * n * T
                * N * mesh.shape[1] / cs.LANE_INSTR_PER_S}}), flush=True)

    if args.profile:
        # the SM clock, power and temperature while K4 runs back to back
        fn = lambda: chamfer.nn_one_way_cuda(scan, mesh)
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
             "temperature.gpu", "--format=csv,noheader", "-lms", "250"],
            stdout=subprocess.PIPE, text=True)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 2.0:
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
        smi.terminate()
        print(json.dumps({"label": label, "under load": smi.communicate()[0]
                          .strip().splitlines()}), flush=True)
        cfg = humor_fit.MotionOptConfig(points3d_weight=1.0)
        obs = {"points3d": scan}
        gen = torch.Generator().manual_seed(5)
        pose = (0.1 * torch.randn((T, 72), generator=gen)).to(device)
        params = {"orient": pose[:, :3].clone().requires_grad_(),
                  "trans": scan.mean(dim=1).clone().requires_grad_()}

        def step():
            for v in params.values():
                v.grad = None
            full = torch.cat([params["orient"], pose[:, 3:]], dim=1)
            humor_fit.obs3d_terms(smpl, cfg, obs, full, params["trans"],
                                  None).backward()

        step()
        torch.cuda.synchronize()
        reset_launches()
        step()
        torch.cuda.synchronize()
        launches = launch_counts()["chamfer_nn"]
        ms = cs.profiled_ms(step, ("nn_one_way",), 5,
                            launches)["nn_one_way"]
        dev = None if ms is None else ms * launches
        print(json.dumps({"label": label, "path E stage-1 step": {
            "chamfer_nn_launches": launches, "K4_device_ms": dev}}),
            flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
