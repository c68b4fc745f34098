"""Rendering and visualisation (port of nemo_tpu.render, the part the fit's
outputs use): mesh overlays on the tile rasterizer, the mesh rollout video,
the composed mesh figures, and the matplotlib keypoint figures."""

from .figures import (baseline_persons_from_bundle, render_baseline_rollout,
                      render_comparison_figure, render_global_overlay,
                      render_rollout_figure)
from .keypoints import (OP25_EDGES, draw_skeleton,
                        render_dynamic_velocity_plots, render_eval_grid,
                        render_keypoint_rollout, render_loss_curves,
                        render_phase_plot, render_vibe_debug_panel)
from .mesh import (combine_meshes, composite_panel, face_window_params,
                   make_mesh_panel_fn, raster_render, render_mesh_overlay,
                   shade_vertices, splat_render, upsample_faces,
                   vertex_normals)
from .video import render_mesh_video, render_overlay_video

__all__ = ["baseline_persons_from_bundle", "render_baseline_rollout",
           "render_comparison_figure", "render_global_overlay",
           "render_rollout_figure", "OP25_EDGES", "draw_skeleton",
           "render_dynamic_velocity_plots", "render_eval_grid",
           "render_keypoint_rollout", "render_loss_curves",
           "render_phase_plot", "render_vibe_debug_panel",
           "combine_meshes", "composite_panel", "face_window_params",
           "make_mesh_panel_fn", "raster_render",
           "render_mesh_overlay", "shade_vertices", "splat_render",
           "upsample_faces", "vertex_normals", "render_mesh_video",
           "render_overlay_video"]
