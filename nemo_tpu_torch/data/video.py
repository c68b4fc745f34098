"""Video preprocessing: frames extraction, OpenPose runner, video assembly
(port of nemo_tpu/data/video.py; host tools only).

Behavioral reference: scripts/video_to_frames.py:8-35, hmr/video.py:21-97
(ffmpeg frame dump + containerized OpenPose invocation), and
nemo/utils/render_utils.py:90-145 (PNG sequence -> mp4). These are
out-of-process tools in the reference too; here the commands are built
centrally, run via subprocess, and every step is importable + testable.
"""

from __future__ import annotations

import os
import os.path as osp
import subprocess
from typing import List, Optional


def video_to_frames(video_path: str, out_dir: str, fps: Optional[float] = None,
                    pattern: str = "%06d.png", run: bool = True
                    ) -> List[str]:
    """ffmpeg video -> numbered frames (video_to_frames.py:8-35).

    Returns the command argv; executes it when run=True.
    """
    os.makedirs(out_dir, exist_ok=True)
    cmd = ["ffmpeg", "-y", "-i", video_path]
    if fps:
        cmd += ["-vf", f"fps={fps}"]
    cmd += ["-qscale:v", "2", osp.join(out_dir, pattern)]
    if run:
        subprocess.run(cmd, check=True, capture_output=True)
    return cmd


def frames_to_video(frame_dir: str, out_path: str, fps: float = 30,
                    pattern: str = "%06d.png", run: bool = True) -> List[str]:
    """PNG sequence -> mp4 (render_utils.py:90-145)."""
    cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-i",
           osp.join(frame_dir, pattern), "-c:v", "libx264", "-pix_fmt",
           "yuv420p", out_path]
    if run:
        subprocess.run(cmd, check=True, capture_output=True)
    return cmd


def openpose_command(img_dir: str, out_json_dir: str,
                     runtime: str = "docker",
                     image: str = "cwaffles/openpose",
                     number_people_max: int = 1) -> List[str]:
    """Build the containerized OpenPose BODY_25 invocation.

    Mirrors hmr/video.py:76-92 (singularity) and custom_video/demo.sh:63-66
    (docker): JSON keypoints out, no display. The container itself is an
    external dependency exactly as in the reference.
    """
    op_args = ["--image_dir", "/data/imgs", "--write_json", "/data/out",
               "--display", "0", "--render_pose", "0",
               "--number_people_max", str(number_people_max)]
    if runtime == "docker":
        return ["docker", "run", "--rm", "-v", f"{img_dir}:/data/imgs",
                "-v", f"{out_json_dir}:/data/out", image,
                "./build/examples/openpose/openpose.bin"] + op_args
    if runtime == "singularity":
        return ["singularity", "exec", "--nv", image,
                "openpose.bin"] + op_args
    raise ValueError(f"unknown runtime {runtime!r}")


def run_openpose(img_dir: str, out_json_dir: str, **kwargs) -> None:
    os.makedirs(out_json_dir, exist_ok=True)
    cmd = openpose_command(img_dir, out_json_dir, **kwargs)
    subprocess.run(cmd, check=True)
