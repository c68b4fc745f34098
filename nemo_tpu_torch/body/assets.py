"""Synthetic SMPL body model, and conversion from the JAX package's model.

``synthetic_smpl_model`` is the same numpy/scipy recipe as
nemo_tpu/body/assets.py, so one seed gives identical tables in both
packages. Loaders for the real (MPI-licensed) SMPL files are still to port
(ROADMAP Queue 1, Slice 2).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import constants
from .smpl import SMPLModel, build_fused_tables


def assemble(v_template, shapedirs, posedirs, J_regressor, weights, parents,
             faces, J_regressor_extra: Optional[np.ndarray],
             num_betas: int = 10, device=None) -> SMPLModel:
    """SMPLModel from raw SMPL arrays (posedirs as (207, V*3) or
    (V, 3, 207)), with the fused joint tables and vertex-major twins."""
    v_template = np.asarray(v_template, np.float32)
    V = v_template.shape[0]
    shapedirs = np.asarray(shapedirs, np.float32)[..., :num_betas]
    posedirs = np.asarray(posedirs, np.float32)
    if posedirs.shape[0] == V:
        posedirs = posedirs.reshape(V * 3, -1).T
    posedirs = np.ascontiguousarray(posedirs, np.float32)
    weights = np.asarray(weights, np.float32)
    if J_regressor_extra is None:
        J_regressor_extra = np.zeros((9, V), np.float32)
    J_regressor_extra = np.asarray(J_regressor_extra, np.float32)
    vids = constants.VERTEX_JOINT_IDS
    if V != 6890:  # synthetic / downscaled models remap vertex keypoints
        vids = (vids * V) // 6890
    ES, EP, EW = build_fused_tables(weights, J_regressor_extra, vids, posedirs)
    return SMPLModel.from_numpy(
        device=device, v_template=v_template, shapedirs=shapedirs,
        posedirs=posedirs, J_regressor=np.asarray(J_regressor, np.float32),
        lbs_weights=weights, J_regressor_extra=J_regressor_extra,
        fused_ES=ES, fused_EP=EP, fused_EW=EW,
        posedirs_t=posedirs.reshape(-1, V, 3).transpose(0, 2, 1),
        lbs_weights_t=weights.T, parents=parents, vertex_joint_ids=vids,
        joint_map=constants.JOINT_MAP, faces=faces)


def synthetic_smpl_model(num_vertices: int = 6890, seed: int = 0,
                         num_betas: int = 10, device=None) -> SMPLModel:
    """A deterministic, kinematically valid synthetic body model (the same
    recipe and numbers as nemo_tpu.body.synthetic_smpl_model)."""
    rng = np.random.RandomState(seed)
    parents = constants.SMPL_PARENTS
    J = len(parents)

    rest = np.zeros((J, 3), np.float32)
    offsets = 0.25 * rng.randn(J, 3).astype(np.float32)
    offsets[:, 1] -= 0.1
    for i in range(1, J):
        rest[i] = rest[parents[i]] + offsets[i]

    owner = rng.randint(0, J, size=num_vertices)
    v_template = rest[owner] + 0.08 * rng.randn(num_vertices, 3).astype(
        np.float32)

    d = np.linalg.norm(v_template[:, None] - rest[None], axis=-1)
    logits = -d / 0.05
    logits -= logits.max(axis=1, keepdims=True)
    w = np.exp(logits)
    order = np.argsort(-w, axis=1)
    mask = np.zeros_like(w)
    np.put_along_axis(mask, order[:, :4], 1.0, axis=1)
    w = w * mask
    weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    Jreg = np.zeros((J, num_vertices), np.float32)
    for j in range(J):
        idx = np.argsort(d[:, j])[:16]
        Jreg[j, idx] = 1.0 / 16

    shapedirs = 0.01 * rng.randn(num_vertices, 3, num_betas).astype(np.float32)
    posedirs_raw = 0.001 * rng.randn(207, num_vertices * 3).astype(np.float32)
    jre = np.abs(rng.randn(9, num_vertices)).astype(np.float32)
    jre /= jre.sum(axis=1, keepdims=True)

    from scipy.spatial import cKDTree
    _, nn = cKDTree(v_template).query(v_template, k=3)
    faces = nn.astype(np.int64)

    return assemble(v_template, shapedirs, posedirs_raw, Jreg, weights,
                    parents, faces, jre, num_betas, device=device)


def smpl_from_numpy(model, device=None) -> SMPLModel:
    """Port model from the arrays of a nemo_tpu ``SMPLModel`` (any object
    with its field names; values are read with ``np.asarray``). The JAX
    model's logical ``posedirs_t``/``lbs_weights_t`` are taken as they are;
    its kernel-tiled ``pd_tiles``/``w_tiles`` are layout only."""
    fields = ("v_template", "shapedirs", "posedirs", "J_regressor",
              "lbs_weights", "J_regressor_extra", "fused_ES", "fused_EP",
              "fused_EW", "posedirs_t", "lbs_weights_t", "parents",
              "vertex_joint_ids", "joint_map")
    arrays = {f: np.asarray(getattr(model, f)) for f in fields}
    arrays["faces"] = getattr(model, "faces", None)
    return SMPLModel.from_numpy(device=device, **arrays)
