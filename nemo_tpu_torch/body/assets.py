"""SMPL model files, the synthetic body model, and conversion from the JAX
package's model.

The real SMPL files are distributed by MPI and cannot ship with the code:
  * ``load_smpl_npz`` reads the .npz layout of smplx's conversion tools;
  * ``load_smpl_pkl`` reads the original chumpy-era pickle without chumpy,
    through a tolerant unpickler that stands in for chumpy's array class
    (``J_regressor`` is a scipy sparse matrix there, parents and faces are
    uint32);
  * ``load_smpl`` dispatches on the extension, and in a directory picks the
    neutral model.
``synthetic_smpl_model`` is the same numpy/scipy recipe as
nemo_tpu/body/assets.py, so one seed gives identical tables in both
packages.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from . import constants
from .smpl import SMPLModel, build_fused_tables

# a directory's candidates, in the order load_smpl tries them
SMPL_CANDIDATES = ("SMPL_NEUTRAL.pkl", "SMPL_NEUTRAL.npz",
                   "basicmodel_neutral_lbs_10_207_0_v1.1.0.pkl",
                   "basicModel_neutral_lbs_10_207_0_v1.0.0.pkl")


class _ChumpyStub:
    """Takes a pickled chumpy.Ch's state; the wrapped array is ``.r`` and
    ``np.asarray`` of the stub."""

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})

    @property
    def r(self):
        for key in ("x", "a", "v"):
            if key in self.__dict__:
                return np.asarray(self.__dict__[key])
        raise AttributeError("chumpy stub holds no array payload")

    def __array__(self, dtype=None, copy=None):
        arr = self.r
        return arr.astype(dtype) if dtype is not None else arr


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        return super().find_class(module, name)


def _to_dense(x) -> np.ndarray:
    if hasattr(x, "todense"):  # scipy sparse
        return np.asarray(x.todense())
    return np.asarray(x)


def _parents(kintree_table) -> np.ndarray:
    """Row 0 of the kinematic tree as int64, the root's parent -1 (the
    files store it as uint32 4294967295)."""
    parents = np.asarray(_to_dense(kintree_table), np.int64)[0].copy()
    parents[0] = -1
    return parents


def assemble(v_template, shapedirs, posedirs, J_regressor, weights, parents,
             faces, J_regressor_extra: Optional[np.ndarray],
             num_betas: int = 10, device=None) -> SMPLModel:
    """SMPLModel from raw SMPL arrays (posedirs as (207, V*3) or
    (V, 3, 207); J_regressor dense or scipy sparse; any array may be a
    chumpy stand-in), with the fused joint tables and vertex-major twins.
    shapedirs is cut to its first num_betas columns."""
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
        posedirs=posedirs, J_regressor=_to_dense(J_regressor).astype(
            np.float32),
        lbs_weights=weights, J_regressor_extra=J_regressor_extra,
        fused_ES=ES, fused_EP=EP, fused_EW=EW,
        posedirs_t=posedirs.reshape(-1, V, 3).transpose(0, 2, 1),
        lbs_weights_t=weights.T, parents=parents, vertex_joint_ids=vids,
        joint_map=constants.JOINT_MAP, faces=faces)


def load_smpl_pkl(path: str, j_regressor_extra_path: Optional[str] = None,
                  num_betas: int = 10, device=None) -> SMPLModel:
    """An original SMPL .pkl (a chumpy pickle), read without chumpy."""
    with open(path, "rb") as f:
        data = _TolerantUnpickler(f, encoding="latin1").load()
    jre = np.load(j_regressor_extra_path) if j_regressor_extra_path else None
    v_template = _to_dense(data["v_template"])
    return assemble(
        v_template, _to_dense(data["shapedirs"]),
        _to_dense(data["posedirs"]).reshape(len(v_template), 3, -1),
        data["J_regressor"], _to_dense(data["weights"]),
        _parents(data["kintree_table"]),
        None if data.get("f") is None else _to_dense(data["f"]), jre,
        num_betas, device=device)


def load_smpl_npz(path: str, j_regressor_extra_path: Optional[str] = None,
                  num_betas: int = 10, device=None) -> SMPLModel:
    """A converted SMPL .npz (the smplx tools' layout)."""
    data = np.load(path, allow_pickle=True)
    jre = np.load(j_regressor_extra_path) if j_regressor_extra_path else None
    return assemble(np.asarray(data["v_template"]), data["shapedirs"],
                    np.asarray(data["posedirs"]), data["J_regressor"],
                    data["weights"], _parents(data["kintree_table"]),
                    data.get("f"), jre, num_betas, device=device)


def load_smpl(path: str, j_regressor_extra_path: Optional[str] = None,
              num_betas: int = 10, device=None) -> SMPLModel:
    """Dispatch on the file's extension; a directory gives its first
    SMPL_CANDIDATES file (the neutral model)."""
    if os.path.isdir(path):
        for cand in SMPL_CANDIDATES:
            full = os.path.join(path, cand)
            if os.path.exists(full):
                path = full
                break
        else:
            raise FileNotFoundError(f"no SMPL model file under {path}")
    load = load_smpl_npz if path.endswith(".npz") else load_smpl_pkl
    return load(path, j_regressor_extra_path, num_betas, device=device)


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
