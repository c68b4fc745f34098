"""Asset / data-layout checker: validate everything a real run needs
BEFORE spending an hour on it (port of nemo_tpu/cli/doctor.py).

The reference assumes `software/{smpl,V02_05,spin_data}` and a per-action
exp_dir of frames/OpenPose/VIBE/GT artifacts (config.py,
multi_view_sequence.py:250-483) and fails deep inside the run when any
piece is missing or malformed. This command loads every provided piece
through the same loaders the packer/fit use and prints one PASS/WARN/FAIL
line each, plus a final verdict.

  python -m nemo_tpu_torch.cli.doctor --nemo_cfg_path action.yml \
      --smpl_path software/smpl/SMPL_NEUTRAL.pkl \
      --vposer_path software/V02_05 \
      --gmm_path software/spin_data/gmm_08.pkl [--device cuda]

The assets load through the port's loaders onto --device ('cuda' by
default, as the fit CLI; 'cpu' must be asked for).

Exit code 0 when every REQUIRED piece passes (OpenPose dirs per view +
whatever assets were explicitly passed); optional pieces (GT, VIBE,
frames, cameras) only WARN when absent; 2 when nothing was asked for.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
from typing import List, Tuple

_ROWS: List[Tuple[str, str, str]] = []     # (status, what, detail)


def _row(status: str, what: str, detail: str = "") -> None:
    _ROWS.append((status, what, detail))
    print(f"[{status:4s}] {what}" + (f" — {detail}" if detail else ""))


def _check(what: str, fn, required: bool = True):
    """Run fn() -> detail string; record PASS / FAIL (or WARN if not
    required)."""
    try:
        detail = fn()
        _row("PASS", what, detail or "")
        return True
    except FileNotFoundError as e:
        _row("FAIL" if required else "WARN", what, str(e))
    except Exception as e:  # malformed content
        _row("FAIL", what, f"{type(e).__name__}: {e}")
    return False


def check_assets(args, device) -> None:
    if args.smpl_path:
        def smpl():
            from ..body.assets import load_smpl
            m = load_smpl(args.smpl_path,
                          args.j_regressor_extra or None, device=device)
            extra = ("49-joint map active" if args.j_regressor_extra
                     else "no J_regressor_extra (25-joint OP set only)")
            return (f"{m.num_vertices} verts, {len(m.parents)} joints, "
                    f"{m.shapedirs.shape[-1]} betas; {extra}")
        _check(f"SMPL model {args.smpl_path}", smpl)
    if args.vposer_path:
        def vposer():
            from ..priors.vposer import load_vposer
            p = load_vposer(args.vposer_path, device=device)
            n = sum(v.numel() for v in p.values())
            return f"{n:,} params converted"
        _check(f"VPoser ckpt {args.vposer_path}", vposer)
    if args.gmm_path:
        def gmm():
            from ..priors.gmm import load_gmm_prior
            g = load_gmm_prior(args.gmm_path, device=device)
            return (f"{g.means.shape[0]} components over "
                    f"{g.means.shape[1]}-d pose")
        _check(f"GMM prior {args.gmm_path}", gmm)


def check_action(args) -> None:
    from ..utils import load_action_config

    box = {}

    def loadcfg():
        if not osp.exists(args.nemo_cfg_path):
            raise FileNotFoundError(args.nemo_cfg_path)
        box["cfg"] = load_action_config(args.nemo_cfg_path)
        return ""

    if not _check(f"action config {args.nemo_cfg_path}", loadcfg):
        return
    cfg = box["cfg"]
    if "seq_names" in cfg and "videos" not in cfg:
        _row("PASS", "config type", f"Penn Action, "
             f"{len(cfg['seq_names'])} sequences (use --penn_mats/"
             f"--penn_root with cli.preprocess)")
        return
    exp_dir = cfg["exp_dir"]
    names = cfg["videos"]["names"]
    _row("PASS" if osp.isdir(exp_dir) else "FAIL", f"exp_dir {exp_dir}",
         f"{len(names)} views: {', '.join(names[:4])}"
         + ("..." if len(names) > 4 else ""))

    for name in names:
        base = osp.join(exp_dir, name)

        def op():
            # same candidates as cli/preprocess.py (reference layouts:
            # demo.sh `.op`, run_openpose `_openpose`)
            from ..data import load_openpose_dir
            for cand in (base + ".frames.op", base + ".op",
                         base + "_openpose"):
                if osp.isdir(cand):
                    pts = load_openpose_dir(cand)
                    return (f"{osp.basename(cand)}: {pts.shape[0]} frames, "
                            f"{(pts[..., 2] > 0.5).mean():.0%} confident")
            raise FileNotFoundError(
                f"none of {name}.frames.op / {name}.op / {name}_openpose")
        _check(f"view {name}: OpenPose", op)

        fdir = base + ".frames"
        if osp.isdir(fdir):
            n = len([f for f in os.listdir(fdir)
                     if f.lower().endswith((".png", ".jpg", ".jpeg"))])
            _row("PASS", f"view {name}: frames", f"{n} images")
        else:
            _row("WARN", f"view {name}: frames",
                 f"{name}.frames missing (no real-frame overlays)")

        def gt():
            from ..data import load_gt2d_pkl_dir
            if osp.exists(base + "_gt_2d.npy"):
                import numpy as np
                return f"packed npy, {np.load(base + '_gt_2d.npy').shape}"
            if osp.isdir(base + "_gt_new"):
                g = load_gt2d_pkl_dir(base + "_gt_new")
                return f"_gt_new pkl dir, {g.shape[0]} frames"
            raise FileNotFoundError(f"{name}_gt_2d.npy / {name}_gt_new")
        _check(f"view {name}: GT 2D", gt, required=False)

        def vibe():
            from ..data import load_vibe_pickle
            for cand in (osp.join(exp_dir, name + "_vibe",
                                  "vibe_output.pkl"),
                         osp.join(exp_dir, "vibe", name,
                                  "vibe_output.pkl")):
                if osp.exists(cand):
                    person = load_vibe_pickle(cand, 5000)
                    if person is None:
                        raise ValueError(f"{cand}: no usable person track")
                    mask = person.get("mask")
                    cov = (f", {float(mask.mean()):.0%} frame coverage"
                           if mask is not None else "")
                    return osp.relpath(cand, exp_dir) + cov
            raise FileNotFoundError(
                f"{name}_vibe/vibe_output.pkl / vibe/{name}/vibe_output.pkl")
        _check(f"view {name}: VIBE init", vibe, required=False)

    if args.gt_cam_paths:
        # the formats cli/preprocess.py packs: a .npy (9,) vector, or a
        # joblib / torch file through load_gt_camera_pt (the JAX doctor
        # sends a .npy through load_gt_camera_pt too, and fails it)
        def cam(p):
            if p.endswith(".npy"):
                import numpy as np
                return f"{np.load(p).reshape(-1)[:9].shape}"
            from ..data import load_gt_camera_pt
            return f"{load_gt_camera_pt(p)[0].shape}"
        for pth in args.gt_cam_paths.split(","):
            _check(f"GT camera {pth}", lambda p=pth: cam(p), required=False)
    if args.mocap_pkl:
        def mocap():
            from ..utils import pickles
            d = pickles.load(args.mocap_pkl)
            keys = sorted(d.keys()) if hasattr(d, "keys") else type(d)
            return f"keys: {keys}"
        _check(f"mocap pkl {args.mocap_pkl}", mocap, required=False)


def build_parser():
    p = argparse.ArgumentParser(
        "nemo_tpu_torch.cli.doctor", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nemo_cfg_path", default="",
                   help="per-action YAML (exp_dir + videos.names)")
    p.add_argument("--smpl_path", default="")
    p.add_argument("--j_regressor_extra", default="")
    p.add_argument("--vposer_path", default="")
    p.add_argument("--gmm_path", default="")
    p.add_argument("--gt_cam_paths", default="",
                   help="comma-separated GT camera files (.npy, joblib "
                        "or torch opt_cam_IMG_*.pt)")
    p.add_argument("--mocap_pkl", default="")
    p.add_argument("--device", default="cuda",
                   help="where the assets load: 'cuda' or 'cpu'")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    del _ROWS[:]
    if not (args.nemo_cfg_path or args.smpl_path or args.vposer_path
            or args.gmm_path):
        build_parser().print_help()
        return 2
    from .. import resolve_device
    check_assets(args, resolve_device(args.device))
    if args.nemo_cfg_path:
        check_action(args)
    fails = [w for s, w, _ in _ROWS if s == "FAIL"]
    warns = sum(1 for s, _, _ in _ROWS if s == "WARN")
    if fails:
        print(f"\nNOT READY: {len(fails)} failing check(s): "
              + "; ".join(fails))
        return 1
    print(f"\nREADY: {len(_ROWS) - warns} checks passed"
          + (f", {warns} optional piece(s) missing" if warns else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
