"""Data layer: packed bundles, synthetic problems and the ingestion
adapters the preprocessing CLI packs from (port of nemo_tpu.data)."""

from .bundle import (MultiViewBundle, resample_indices,
                     resample_to_common_frames)
from .camera_fit import DEFAULT_FIT_JOINTS, fit_gt_camera
from .openpose import (PARSER_CALLS, flip_horizontal, load_gt2d_pkl_dir,
                       load_gt_camera_pt, load_openpose_dir,
                       parse_openpose_json, read_posetrack_keypoints,
                       reset_parser_calls)
from .penn_action import load_penn_sequence, penn_gt_to_op
from .synthetic import synthetic_problem
from .vibe import (densify_person, load_baseline_arrays,
                   load_baseline_pickle, load_vibe_pickle, person_joints2d,
                   select_person_near_gt, vibe_render_arrays, vibe_to_theta)
from .video import (frames_to_video, openpose_command, run_openpose,
                    video_to_frames)

__all__ = [
    "MultiViewBundle", "resample_indices", "resample_to_common_frames",
    "DEFAULT_FIT_JOINTS", "fit_gt_camera",
    "PARSER_CALLS", "flip_horizontal", "load_gt2d_pkl_dir",
    "load_gt_camera_pt", "load_openpose_dir", "parse_openpose_json",
    "read_posetrack_keypoints", "reset_parser_calls",
    "load_penn_sequence", "penn_gt_to_op", "synthetic_problem",
    "densify_person", "load_baseline_arrays", "load_baseline_pickle",
    "load_vibe_pickle", "person_joints2d", "select_person_near_gt",
    "vibe_render_arrays", "vibe_to_theta",
    "frames_to_video", "openpose_command", "run_openpose", "video_to_frames",
]
