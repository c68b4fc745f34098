"""PNG sequence -> mp4 through ffmpeg (port of frames_to_video in
nemo_tpu/data/video.py; the reference's render_utils.py:90-145)."""

from __future__ import annotations

import os.path as osp
import subprocess
from typing import List


def frames_to_video(frame_dir: str, out_path: str, fps: float = 30,
                    pattern: str = "%06d.png", run: bool = True) -> List[str]:
    """PNG sequence -> mp4 (render_utils.py:90-145)."""
    cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-i",
           osp.join(frame_dir, pattern), "-c:v", "libx264", "-pix_fmt",
           "yuv420p", out_path]
    if run:
        subprocess.run(cmd, check=True, capture_output=True)
    return cmd
