"""Evaluation metrics (port of nemo_tpu.eval)."""

from .metrics import (dynamic_frame_mask, eval_2d, eval_3d, eval_3d_global,
                      eval_3d_pa, eval_view_indices, pck_2d, rmse_2d,
                      smpl_grid_forward, write_csv)

__all__ = [
    "dynamic_frame_mask", "eval_2d", "eval_3d", "eval_3d_global",
    "eval_3d_pa", "eval_view_indices", "pck_2d", "rmse_2d",
    "smpl_grid_forward", "write_csv",
]
