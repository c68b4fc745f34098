"""Video preprocessing CLI: frames / openpose / assemble subcommands (port
of nemo_tpu/cli/video_tool.py).

Entry-surface parity with the reference's out-of-process video tools:
- ``frames``  — scripts/video_to_frames.py:8-35 +
  custom_video/video_to_frames_custom.py:35-39 (per-view ffmpeg frame dump
  into ``<exp_dir>/<name>.frames``) and nemo/process_input_videos.py:23-29
  (YAML-driven view iteration).
- ``openpose`` — nemo/run_openpose.py + custom_video/demo.sh:55 (the
  containerized BODY_25 invocation per frame dir, JSON keypoints out).
- ``assemble`` — nemo/utils/render_utils.py:90-145 (PNG sequence -> mp4).

ffmpeg / the OpenPose container are external dependencies exactly as in the
reference; ``--print_only`` emits the commands without executing so the
surface is testable (and usable as a script generator) on boxes without
them.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

from ..data.video import frames_to_video, openpose_command, video_to_frames
from ..utils.exp import load_action_config


def _view_names(cfg: dict) -> list:
    return list(cfg["videos"]["names"])


def _video_path(cfg: dict, name: str, data_dir: str) -> str:
    root = cfg["videos"].get("root_dir") or osp.join(data_dir, "videos")
    path = name if osp.isabs(name) else osp.join(root, name)
    # reference configs list extensionless view names ("tennis_swing.0",
    # custom_video/nemo-config.yml); the video file on disk is <name>.mp4
    # (video_to_frames_custom.py:37) while frame/openpose dirs keep the
    # bare name (<name>.frames)
    if not path.lower().endswith((".mp4", ".avi", ".mov", ".mkv")):
        path += ".mp4"
    return path


def _frames_dir(cfg: dict, name: str, data_dir: str, suffix: str) -> str:
    """``<exp_dir>/<name><suffix>`` with the FULL video name kept —
    cli/preprocess.py probes ``<name>.frames`` / ``<name>.op`` /
    ``<name>_openpose`` with the extension included."""
    exp = cfg.get("exp_dir") or osp.join(data_dir, "exps")
    return osp.join(exp, name + suffix)


def cmd_frames(args: argparse.Namespace) -> int:
    """Dump every configured view's video to numbered PNG frames."""
    cfg = load_action_config(args.nemo_cfg_path)
    for name in _view_names(cfg):
        vid = _video_path(cfg, name, args.data_dir)
        out = _frames_dir(cfg, name, args.data_dir, args.suffix)
        cmd = video_to_frames(vid, out, run=not args.print_only)
        print(" ".join(cmd))
    return 0


def cmd_openpose(args: argparse.Namespace) -> int:
    """Print/run the OpenPose container command for every view's frames."""
    cfg = load_action_config(args.nemo_cfg_path)
    rc = 0
    for name in _view_names(cfg):
        frames = _frames_dir(cfg, name, args.data_dir, args.suffix)
        out_json = _frames_dir(cfg, name, args.data_dir, ".op")
        cmd = openpose_command(frames, out_json, runtime=args.runtime)
        print(" ".join(cmd))
        if not args.print_only:
            os.makedirs(out_json, exist_ok=True)
            import subprocess
            rc |= subprocess.run(cmd).returncode
    return rc


def cmd_assemble(args: argparse.Namespace) -> int:
    """PNG frame dir -> mp4."""
    cmd = frames_to_video(args.frame_dir, args.out, fps=args.fps,
                          run=not args.print_only)
    print(" ".join(cmd))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nemo_tpu_torch.cli.video_tool")
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("frames", help="videos -> per-view frame dirs")
    f.add_argument("--nemo_cfg_path", required=True)
    f.add_argument("--data_dir", default="data",
                   help="fallback root when the YAML omits root_dir/exp_dir")
    f.add_argument("--suffix", default=".frames",
                   help="frame-dir suffix (custom entry uses '.frames', "
                        "mocap uses '' — process_input_videos.py:27)")
    f.add_argument("--print_only", action="store_true")
    f.set_defaults(fn=cmd_frames)

    o = sub.add_parser("openpose", help="frame dirs -> OpenPose JSON dirs")
    o.add_argument("--nemo_cfg_path", required=True)
    o.add_argument("--data_dir", default="data")
    o.add_argument("--suffix", default=".frames")
    o.add_argument("--runtime", default="docker",
                   choices=["docker", "singularity"])
    o.add_argument("--print_only", action="store_true")
    o.set_defaults(fn=cmd_openpose)

    a = sub.add_parser("assemble", help="frame dir -> mp4")
    a.add_argument("--frame_dir", required=True)
    a.add_argument("--out", required=True)
    a.add_argument("--fps", type=float, default=30)
    a.add_argument("--print_only", action="store_true")
    a.set_defaults(fn=cmd_assemble)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
