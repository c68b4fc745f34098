"""Hand-written Hopper kernels with their plain PyTorch versions.

K1 ``fk.fk_compose`` (forward and backward kernels), K2
``lbs.skin_v2v_l1`` (fused, pair and forward-only modes), K3
``lbs.skin_verts_t`` (forward and backward kernels), K4
``chamfer.nn_one_way`` (under ``chamfer.chamfer_distance`` and
``chamfer.chamfer_one_way``), K5
``raster.rasterize_triangles`` (stream and gather modes), K6
``mlp.motion_net_mlp`` (forward and backward kernels) and K7
``groupnorm.group_norm_relu`` (forward and backward kernels). Each wrapper
counts its kernel launches; :func:`launch_counts` reads the counts and
:func:`reset_launches` sets them to zero.
"""

from __future__ import annotations

from typing import Dict

from . import chamfer, fk, groupnorm, lbs, mlp, raster
from .chamfer import chamfer_distance, chamfer_one_way, nn_one_way
from .fk import fk_compose
from .groupnorm import group_norm_relu
from .lbs import skin_v2v_l1, skin_verts_t
from .mlp import motion_net_mlp
from .raster import rasterize_triangles, rasterize_triangles_batched

_COUNTERS = (fk.LAUNCHES, lbs.LAUNCHES, chamfer.LAUNCHES, raster.LAUNCHES,
             mlp.LAUNCHES, groupnorm.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel and mode."""
    return {k: v for counts in _COUNTERS for k, v in counts.items()}


def reset_launches() -> None:
    for counts in _COUNTERS:
        for k in counts:
            counts[k] = 0


__all__ = ["fk_compose", "skin_v2v_l1", "skin_verts_t", "nn_one_way",
           "chamfer_distance", "chamfer_one_way", "motion_net_mlp",
           "group_norm_relu",
           "rasterize_triangles", "rasterize_triangles_batched",
           "launch_counts", "reset_launches"]
