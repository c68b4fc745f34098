"""Data layer: packed bundles, synthetic problems, the ingestion adapters
the preprocessing CLI packs from, AMASS processing with the HuMoR training
windows, and VIBE's training data (port of nemo_tpu.data)."""

from .amass_process import (amass_state_windows, amass_world_states,
                            canonicalize_windows, cleanup_amass_data,
                            determine_floor_height_and_contacts,
                            estimate_angular_velocity, estimate_velocity,
                            load_amass_windows, process_amass_dir,
                            process_amass_seq)
from .bundle import (MultiViewBundle, resample_indices,
                     resample_to_common_frames)
from .camera_fit import DEFAULT_FIT_JOINTS, fit_gt_camera
from .openpose import (PARSER_CALLS, flip_horizontal, load_gt2d_pkl_dir,
                       load_gt_camera_pt, load_openpose_dir,
                       parse_openpose_json, read_posetrack_keypoints,
                       reset_parser_calls)
from .keypoints import (VOCAB, conversion_index, convert_kps, get_perm_idxs,
                        keypoint_hflip)
from .penn_action import load_penn_sequence, penn_gt_to_op
from .sharded import (ShardedDataset, as_sharded_arrays, batch_iterator,
                      write_shards)
from .synthetic import synthetic_problem
from .vibe import (densify_person, load_baseline_arrays,
                   load_baseline_pickle, load_vibe_pickle, person_joints2d,
                   select_person_near_gt, vibe_render_arrays, vibe_to_theta)
from .vibe_db import (VIBE_DB_SCHEMA, VibeDbBuilder, db_to_shards,
                      extract_features, load_db, make_windows,
                      merge_2d3d_batch, mixed_2d3d_iterator, read_3dpw,
                      read_penn_action, split_2d3d_batch_sizes)
from .vibe_readers import (bbox_from_kp2d, iter_tfrecord, parse_tf_example,
                           read_amass, read_h36m, read_insta,
                           read_insta_record, read_mpii3d, read_nemomocap,
                           read_posetrack)
from .video import (frames_to_video, openpose_command, run_openpose,
                    video_to_frames)

__all__ = [
    "amass_state_windows", "amass_world_states", "canonicalize_windows",
    "cleanup_amass_data", "determine_floor_height_and_contacts",
    "estimate_angular_velocity", "estimate_velocity", "load_amass_windows",
    "process_amass_dir", "process_amass_seq",
    "MultiViewBundle", "resample_indices", "resample_to_common_frames",
    "DEFAULT_FIT_JOINTS", "fit_gt_camera",
    "PARSER_CALLS", "flip_horizontal", "load_gt2d_pkl_dir",
    "load_gt_camera_pt", "load_openpose_dir", "parse_openpose_json",
    "read_posetrack_keypoints", "reset_parser_calls",
    "VOCAB", "conversion_index", "convert_kps", "get_perm_idxs",
    "keypoint_hflip", "ShardedDataset", "as_sharded_arrays", "batch_iterator",
    "write_shards",
    "load_penn_sequence", "penn_gt_to_op", "synthetic_problem",
    "densify_person", "load_baseline_arrays", "load_baseline_pickle",
    "load_vibe_pickle", "person_joints2d", "select_person_near_gt",
    "vibe_render_arrays", "vibe_to_theta",
    "VIBE_DB_SCHEMA", "VibeDbBuilder", "db_to_shards", "extract_features",
    "load_db", "make_windows", "merge_2d3d_batch", "mixed_2d3d_iterator",
    "read_3dpw", "read_penn_action", "split_2d3d_batch_sizes",
    "bbox_from_kp2d", "iter_tfrecord", "parse_tf_example", "read_amass",
    "read_h36m", "read_insta", "read_insta_record", "read_mpii3d",
    "read_nemomocap", "read_posetrack",
    "frames_to_video", "openpose_command", "run_openpose", "video_to_frames",
]
