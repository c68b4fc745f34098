#!/usr/bin/env python
"""Where a skinning kernel's time goes, from copies with parts removed.

    python scripts/torch_fwd_phases.py [--kernel fwd|fused] [--out DIR]
        [--reps 20] [--batches 28200] [--variants full ...]

The script copies ``nemo_tpu_torch`` and ``chip_smoke.py`` of the checkout
it lies in into DIR/<variant> (default DIR: out/fwd_phases, which .gitignore
lists), edits the copy's kernel source to remove one part of the kernel,
builds each copy in its own process and times it.

--kernel fwd: skin_fwd_kernel (csrc/skin_fwd.cuh), which runs K3f and K2's
pair mode, at K3f's (512, 6890) and (960, 1024) and the pair mode's B=512,
V=6890 with vp stored:

- full: the kernel as it is;
- no_mma: the tensor-core group skips the vph products (vph is stale);
- no_pd_copy: the copy group stages no posedirs slices;
- no_blend: the CUDA-core group skips the blend M = A . W;
- no_store: no output is written (the stores' condition is never true);
- copies_only: no_mma and no_blend together;
- mma_only: no_blend and no_pd_copy;
- blend_only: no_mma and no_pd_copy.

--kernel fused: K2's fused kernel with f32 tables (csrc/v2v.cu,
v2v_fused_kernel_ws, mode 1) at V=6890 and each of --batches (default the
benchmark cell's 28200 rows):

- full: the kernel as it is;
- no_pd_copy: no posedirs slice is copied (W and v_shaped still are);
- no_vph: the forward posedirs contraction (vph of both sides) is skipped;
- no_gpf: the backward posedirs contraction (gpf) is skipped;
- no_blend: the blend M = A . W is skipped;
- no_ga: the gA accumulation is skipped;
- no_partials: no per-block partial is stored (the stores' condition is
  never true, so the sums that feed them stay);
- no_work: no_pd_copy, no_vph, no_gpf, no_blend and no_ga together: what is
  left is the loop, its barriers, the W copies, the vertices and signs and
  the partial stores.

The outputs of a variant other than ``full`` are wrong by construction; only
their times mean something. Each time is one launch's device share
(scripts/torch_v2v_times.py's loop_ms: CUDA events around ``--reps``
back-to-back calls, divided by the count, the median of 5 windows), on the
inputs of chip_smoke.py's skin_side_inputs on the synthetic SMPL. Prints one
JSON line a (variant, kernel, shape), then the nvidia-smi line. Needs a CUDA
device.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = "nemo_tpu_torch/csrc/"

# (file under csrc/, text found once, its replacement)
_NO_MMA = ("skin_fwd.cuh",
           "        vph_mma_split(s_pfb, s_pfs, s_pd(buf), vph(buf, kh), fn0, "
           "kh * kXPH,\n                      (kh + 1) * kXPH, lane >> 2, "
           "lane & 3);\n", "        ;\n")
_NO_PD_COPY = ("skin_fwd.cuh", "      load(buf, t_begin + i);\n", "")
_NO_BLEND = ("skin_fwd.cuh", "    for (int j0 = 0; j0 < kJ; j0 += 4) {",
             "    for (int j0 = 0; j0 < 0; j0 += 4) {")
FWD = {
    "full": [],
    "no_mma": [_NO_MMA],
    "no_pd_copy": [_NO_PD_COPY],
    "no_blend": [_NO_BLEND],
    "no_store": [("skin_fwd.cuh", "    const int nv = b < B ? V - v : 0;",
                  "    const int nv = b < B && ow > 8 ? V - v : 0;")],
    "copies_only": [_NO_MMA, _NO_BLEND],
    "mma_only": [_NO_BLEND, _NO_PD_COPY],
    "blend_only": [_NO_MMA, _NO_PD_COPY],
}

# the warp-specialised v2v_fused_kernel_ws (v2v.cu)
_WS = {
    "no_pd_copy": [("v2v.cu", "      ws_copy_pd(",
                    "      if (V < 0) ws_copy_pd(")],
    "no_vph": [("v2v.cu", "      ws_vph(", "      if (V < 0) ws_vph(")],
    "no_gpf": [("v2v.cu", "        ws_gpf(", "        if (V < 0) ws_gpf(")],
    "no_blend": [("v2v.cu", "    for (int j0 = 0; j0 < kJ; j0 += 4) {",
                  "    for (int j0 = 0; j0 < 0; j0 += 4) {")],
    "no_ga": [("v2v.cu", "      ws_ga(", "      if (V < 0) ws_ga(")],
    "no_partials": [
        ("v2v.cu", "          if (b < B && p < kP) gpf_r[",
         "          if (b < -B && p < kP) gpf_r["),
        ("v2v.cu", "  if (gt == 0)\n    tot_part[",
         "  if (gt == 0 && B < 0)\n    tot_part["),
        ("v2v.cu", "  if (grad && bg < B) {", "  if (grad && bg < -B) {"),
        ("v2v.cu", "        if (v < V) gvsh_part[",
         "        if (v < -V) gvsh_part[")],
}


FUSED = {"full": [], **_WS,
         "no_work": [e for k in ("no_pd_copy", "no_vph", "no_gpf", "no_blend",
                                 "no_ga") for e in _WS[k]]}


def make_copy(out_dir: str, name: str, edits) -> str:
    root = os.path.join(out_dir, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "nemo_tpu_torch"),
                    os.path.join(root, "nemo_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
    for src, old, new in edits:
        path = os.path.join(root, CSRC, src)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the edit's source text is not in "
                               f"{src} exactly once: {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def measure(root: str, name: str, kernel: str, batches, reps: int) -> None:
    """Runs in the copy's own process: build, time, print."""
    sys.path.insert(0, root)
    import torch
    from chip_smoke import skin_side_inputs
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.body.smpl import subset_skin_tables
    from nemo_tpu_torch.ops import lbs
    from torch_v2v_times import loop_ms
    device = torch.device("cuda", 0)
    smpl = synthetic_smpl_model(6890, seed=0, device=device)
    vsh = smpl.v_template.t().contiguous()

    gen = torch.Generator().manual_seed(0)
    if kernel == "fused":
        for B in batches:
            a = (*skin_side_inputs(smpl, B, gen, device), vsh,
                 smpl.posedirs_t, smpl.lbs_weights_t,
                 *skin_side_inputs(smpl, B, gen, device, offset=10.0))
            print(json.dumps({
                "variant": name, "kernel": "K2 fused", "B": B, "V": 6890,
                "ms": loop_ms(lambda: lbs.v2v_l1_cuda(
                    *a, grad=True, posedirs_pad=smpl.posedirs_pad), reps)}),
                flush=True)
        return
    for B, V in ((512, 6890), (960, 1024)):
        pf, A = skin_side_inputs(smpl, B, gen, device)
        if V == smpl.num_vertices:
            s = (pf, A, vsh, smpl.posedirs_t, smpl.lbs_weights_t)
        else:
            vidx, pd_s, W_s = subset_skin_tables(smpl, V)
            s = (pf, A, vsh[:, vidx].contiguous(), pd_s, W_s)
        print(json.dumps({"variant": name, "kernel": "K3f", "B": B, "V": V,
                          "ms": loop_ms(lambda: lbs.skin_fwd_cuda(*s), reps)}),
              flush=True)
        if V == smpl.num_vertices:
            pair = (*s, *skin_side_inputs(smpl, B, gen, device, offset=10.0))
            print(json.dumps({
                "variant": name, "kernel": "pair", "B": B, "V": V,
                "ms": loop_ms(lambda: lbs.v2v_pair_cuda(*pair, want_vp=True),
                              reps)}),
                flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--kernel", choices=("fwd", "fused"), default="fwd")
    p.add_argument("--out", default=os.path.join(REPO, "out", "fwd_phases"))
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--batches", type=int, nargs="+", default=[28200])
    p.add_argument("--variants", nargs="+")
    p.add_argument("--measure", nargs=2, metavar=("ROOT", "NAME"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.measure:
        measure(*args.measure, args.kernel, args.batches, args.reps)
        return 0
    edits = FWD if args.kernel == "fwd" else FUSED
    names = args.variants or list(edits)
    roots = {name: make_copy(args.out, name, edits[name]) for name in names}
    # build every copy first, in parallel (one nvcc per source each)
    builds = [subprocess.Popen([sys.executable, "-c",
                                "import sys; sys.path.insert(0, sys.argv[1]);"
                                "from nemo_tpu_torch.ops import _build;"
                                "_build.build()", root])
              for root in roots.values()]
    if any(b.wait() for b in builds):
        raise RuntimeError("a build failed")
    for name, root in roots.items():
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--kernel", args.kernel, "--reps", str(args.reps),
                        "--batches", *map(str, args.batches),
                        "--measure", root, name], check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
