#!/usr/bin/env python
"""K2, K3b and K3f of one checkout, timed on one GPU, with digests of outputs.

    python scripts/torch_v2v_times.py [--root DIR] [--batches 512 960 28200]
        [--reps 20] [--label NAME] [--tables f32|bf16]

Imports ``nemo_tpu_torch`` and ``chip_smoke`` from DIR (default: the
checkout this script lies in) and builds its kernels there.

- K2: for each batch B, draws both sides' pose features and transforms with
  chip_smoke.py's skin_side_inputs on the synthetic 6890-vertex SMPL (seed
  B; the rec side offset by +-10 m), holds the fused mode's total against
  the plain version's (rtol 1e-5), and times ``lbs.v2v_l1_cuda`` with
  grad=True and grad=False. Each line carries the sha256 of the mode's
  outputs on these seeded inputs (fused: the total, gpf, gA and gvsh;
  forward-only: the total), so two checkouts whose K2 computes the same
  bits print the same digests. B=28200 is the benchmark cell's full batch
  (cv_47x600: 47 x 600 rows a step). A ``resources`` line gives the fused
  kernel's registers, shared memory and spill bytes
  (``lbs.v2v_fused_attributes``, the tables' instantiation).
- K2's pair mode on the same inputs: holds ``lbs.v2v_pair_cuda`` against
  ``lbs.v2v_pair_plain`` (total rtol 1e-5, sign exact, vp within 1e-5 of
  its largest entry) and times it with vp stored and without; digests of
  (total, sign, vp) and of (total, sign).
- K3b: at (512, 6890) and at path A's (960, 1024) (chip_smoke.py's 1024
  vertex subset), pf and A as above (seed B + V), a N(0,1) cotangent and
  the posed vertices computed by the plain einsum; holds
  ``lbs.skin_bwd_cuda`` against ``lbs.skin_bwd_plain`` (1e-4 of each
  gradient's largest entry) and times it recomputing vp and reading it,
  with a digest of its gradients.
- K3f at the same two shapes and inputs: holds ``lbs.skin_fwd_cuda``
  against ``lbs.skin_verts_t_plain`` (1e-5 of the largest entry), with a
  digest of the vertices.

--tables bf16 builds the skinning tables in bf16 (a checkout with
``skin_dtype``), so every call runs the kernels' bf16 instantiations; the
vp K3b reads is then stored in bf16, the pair mode's vp is held to one
bf16 step and K3b's gradients to 1e-3 of their largest entry.

Each line has two times: ``ms``, the median of ``--reps`` CUDA-event
timings of one call each after 3 warm-up calls (the wrapper's host work
inside), and ``device_ms``, one call's share of ``--reps`` calls run back
to back (the host enqueues faster than the kernels run), the median of 5
such windows. To compare two commits on one card, unpack the other
with ``git archive`` into a directory that .gitignore lists and run, in one
call, this script with --root set to each in turn: parent, change, change,
parent.

Prints one JSON line per (kernel, mode, shape), then the nvidia-smi line
(name, power limit). Needs a CUDA device.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K3B_SHAPES = ((512, 6890), (960, 1024))


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes (a bf16 tensor's as int16: numpy has no
    bf16)."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def loop_ms(fn, reps: int) -> float:
    """One call's device share: CUDA events around reps back-to-back
    calls, divided by reps, the median of 5 windows after 3 warm-ups."""
    import torch
    for _ in range(3):
        fn()
    windows = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        windows.append(start.elapsed_time(end) / reps)
    return sorted(windows)[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=REPO)
    p.add_argument("--batches", type=int, nargs="+",
                   default=[512, 960, 28200])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--label", default="")
    p.add_argument("--tables", choices=("f32", "bf16"), default="f32")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("torch_v2v_times: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import median_ms, skin_side_inputs
    from nemo_tpu_torch.body.assets import synthetic_smpl_model
    from nemo_tpu_torch.body.smpl import subset_skin_tables
    from nemo_tpu_torch.ops import lbs
    import nemo_tpu_torch
    if not os.path.abspath(nemo_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"nemo_tpu_torch came from {nemo_tpu_torch.__file__}"
                           f", not from {root}")
    device = torch.device("cuda", 0)
    bf16 = args.tables == "bf16"
    smpl = synthetic_smpl_model(6890, seed=0, device=device, **(
        {"skin_dtype": torch.bfloat16} if bf16 else {}))
    vsh = smpl.v_template.t().contiguous()
    label = args.label or root
    # K2 reads the model's padded posedirs copy where the checkout's model
    # holds one (f32 tables), as the fit does
    pad = getattr(smpl, "posedirs_pad", None)
    k2_kw = {} if pad is None else {"posedirs_pad": pad}
    vp_tol, grad_tol = (2.0 ** -8, 1e-3) if bf16 else (1e-5, 1e-4)

    def emit(fn, **rec):
        rec["ms"] = median_ms(fn, reps=args.reps)
        rec["device_ms"] = loop_ms(fn, args.reps)
        print(json.dumps({"label": label, "tables": args.tables, **rec,
                          "reps": args.reps}), flush=True)

    print(json.dumps({"label": label, "tables": args.tables,
                      "kernel": "K2", "resources":
                      lbs.v2v_fused_attributes(bf16=bf16)}), flush=True)
    for B in args.batches:
        gen = torch.Generator().manual_seed(B)
        pf_o, A_o = skin_side_inputs(smpl, B, gen, device)
        pf_r, A_r = skin_side_inputs(smpl, B, gen, device, offset=10.0)
        a = (pf_o, A_o, vsh, smpl.posedirs_t, smpl.lbs_weights_t, pf_r, A_r)
        tot_k, grads = lbs.v2v_l1_cuda(*a, grad=True, **k2_kw)
        tot_f, _ = lbs.v2v_l1_cuda(*a, grad=False, **k2_kw)
        tot_p, _ = lbs.v2v_l1_plain(*a, grad=False)
        rel = float((tot_k - tot_p).abs() / tot_p.abs())
        if not rel <= 1e-5:
            raise AssertionError(f"B={B}: total off by {rel:.3e} (rtol 1e-5)")
        sha = {"fused": digest(tot_k, *grads), "forward_only": digest(tot_f)}
        for mode, grad in (("fused", True), ("forward_only", False)):
            emit(lambda: lbs.v2v_l1_cuda(*a, grad=grad, **k2_kw),
                 kernel="K2", mode=mode, B=B, V=6890, total_rel_err=rel,
                 sha256=sha[mode])
        tot_p, sign_p, vp_p = lbs.v2v_pair_plain(*a, want_vp=True)
        for want_vp in (True, False):
            got = lbs.v2v_pair_cuda(*a, want_vp=want_vp)
            err = {"total_rel_err": float((got[0] - tot_p).abs()
                                          / tot_p.abs()),
                   "sign_equal": bool(torch.equal(got[1], sign_p))}
            if want_vp:
                err["vp_rel_err"] = float(
                    (got[2].float() - vp_p.float()).abs().max()
                    / vp_p.float().abs().max())
            if not (err["total_rel_err"] <= 1e-5 and err["sign_equal"] and
                    err.get("vp_rel_err", 0.0) <= vp_tol):
                raise AssertionError(f"K2 pair at B={B}: {err}")
            emit(lambda: lbs.v2v_pair_cuda(*a, want_vp=want_vp), kernel="K2",
                 mode="pair_vp" if want_vp else "pair", B=B, V=6890, **err,
                 sha256=digest(*(t for t in got if t is not None)))

    for B, V in K3B_SHAPES:
        gen = torch.Generator().manual_seed(B + V)
        pf, A = skin_side_inputs(smpl, B, gen, device)
        if V == smpl.num_vertices:
            s = (pf, A, vsh, smpl.posedirs_t, smpl.lbs_weights_t)
        else:
            vidx, pd_s, W_s = subset_skin_tables(smpl, V)
            s = (pf, A, vsh[:, vidx].contiguous(), pd_s, W_s)
        g = torch.randn((B, 3, V), generator=gen).to(device)
        vp = (torch.einsum('bp,pkv->bkv', pf, s[3].float()) + s[2]).to(
            s[3].dtype).contiguous()
        for mode, stored in (("recompute", None), ("stored_vp", vp)):
            got = lbs.skin_bwd_cuda(*s, g, vp=stored)
            want = lbs.skin_bwd_plain(*s, g, vp=stored)
            rel = max(float((x - y).abs().max() / y.abs().max())
                      for x, y in zip(got, want))
            if not rel <= grad_tol:
                raise AssertionError(f"K3b {mode} at ({B}, {V}): off by "
                                     f"{rel:.3e} of a gradient's largest "
                                     f"entry ({grad_tol})")
            emit(lambda: lbs.skin_bwd_cuda(*s, g, vp=stored), kernel="K3b",
                 mode=mode, B=B, V=V, max_rel_err=rel, sha256=digest(*got))
        out = lbs.skin_fwd_cuda(*s)
        want = lbs.skin_verts_t_plain(*s)
        rel = float((out - want).abs().max() / want.abs().max())
        if not rel <= 1e-5:
            raise AssertionError(f"K3f at ({B}, {V}): off by {rel:.3e} of "
                                 f"the largest entry (1e-5)")
        emit(lambda: lbs.skin_fwd_cuda(*s), kernel="K3f", mode="forward",
             B=B, V=V, max_rel_err=rel, sha256=digest(out))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
