"""Rendering and visualisation (port of nemo_tpu.render): mesh overlays and
the pretty renderer on the tile rasterizer, the mesh rollout video, the
composed mesh figures, and the matplotlib keypoint figures."""

from .keypoints import (OP25_EDGES, draw_skeleton,
                        render_dynamic_velocity_plots, render_eval_grid,
                        render_keypoint_rollout, render_loss_curves,
                        render_per_joint_keypoint_frames, render_phase_plot,
                        render_vibe_debug_panel)
from .mesh import (blue_spectrum, checkerboard_plane, combine_meshes,
                   composite_panel, face_window_params, make_mesh_panel_fn,
                   raster_render, rasterize_triangles, render_mesh_overlay,
                   render_pretty, shade_vertices, splat_render,
                   upsample_faces, vertex_normals)
from .figures import (baseline_persons_from_bundle, gt_cameras_for_render,
                      render_3d_rollout_figure, render_baseline_rollout,
                      render_comparison_figure, render_glamr_rollout,
                      render_global_overlay,
                      render_global_root_trajectories, render_gt_rollout,
                      render_input_figure, render_pred_in_gt_rollout,
                      render_pretty_individual_figure,
                      render_pretty_rollout_figure, render_rollout_figure,
                      render_rollout_mv_figure)
from .video import render_mesh_video, render_overlay_video

__all__ = ["OP25_EDGES", "draw_skeleton", "render_eval_grid",
           "render_keypoint_rollout",
           "render_dynamic_velocity_plots",
           "render_loss_curves", "render_per_joint_keypoint_frames",
           "render_phase_plot", "render_vibe_debug_panel",
           "blue_spectrum", "checkerboard_plane", "combine_meshes",
           "composite_panel", "face_window_params", "make_mesh_panel_fn",
           "raster_render", "rasterize_triangles", "render_mesh_overlay",
           "render_pretty", "shade_vertices", "splat_render",
           "upsample_faces", "vertex_normals",
           "render_mesh_video", "render_overlay_video",
           "baseline_persons_from_bundle", "render_3d_rollout_figure",
           "render_baseline_rollout",
           "render_comparison_figure", "render_global_overlay",
           "render_global_root_trajectories",
           "render_input_figure", "render_pretty_individual_figure",
           "render_pretty_rollout_figure",
           "render_rollout_mv_figure",
           "render_rollout_figure", "render_gt_rollout",
           "render_pred_in_gt_rollout", "render_glamr_rollout",
           "gt_cameras_for_render"]
