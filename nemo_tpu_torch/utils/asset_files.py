"""Write SMPL, VPoser, GMM and HuMoR files in the layouts of the real ones.

The real asset files are licensed and cannot ship with the code. These
writers put the synthetic objects (``synthetic_smpl_model``,
``init_vposer``, ``synthetic_gmm_arrays``, ``init_humor``) into the files'
own layouts, so that the loaders, and a fit from files, run end to end
without them:

  * ``write_smpl_pkl``: the chumpy-era pickle. The arrays are objects of a
    class ``chumpy.ch.Ch`` (a stand-in registered in ``sys.modules`` only
    while pickling, so the file unpickles only through the loaders'
    tolerant unpickler), ``J_regressor`` is a ``scipy.sparse.csc_matrix``,
    and ``kintree_table`` and ``f`` are uint32, the root's parent
    4294967295;
  * ``write_smpl_npz``: the smplx tools' .npz;
  * ``write_vposer_snapshot``: a V02_05 directory, ``snapshots/*.ckpt``
    holding ``{"state_dict": {"vp_model.<torch key>": tensor}}``;
  * ``write_gmm_pkl``: a gmm_08.pkl dict (means, covars, weights);
  * ``write_humor_ckpt``: ``{"model": state_dict}`` in the reference
    module layout, and ``write_humor_npz``: humor_tool's flat 'module.key'
    arrays.
"""

from __future__ import annotations

import os
import pickle
import sys
import types
from typing import Dict

import numpy as np
import torch

from ..body.smpl import SMPLModel
from ..priors.vposer import _TORCH_KEY_MAP

_BN_FIELDS = ("weight", "bias", "running_mean", "running_var")
# (torch module, number of Linear layers) of each HuMoR parameter group
_HUMOR_MODULES = {"encoder": ("encoder", 5), "decoder": ("decoder", 4),
                  "prior": ("prior_net", 5)}


def smpl_file_arrays(model: SMPLModel) -> Dict[str, np.ndarray]:
    """The raw arrays of an SMPL file for ``model``: v_template, shapedirs
    (V, 3, betas), posedirs (V, 3, 207), a dense J_regressor (24, V),
    weights (V, 24), kintree_table and f as uint32."""
    t = lambda x: x.detach().cpu().numpy()
    V = model.num_vertices
    parents = np.asarray(model.parents, np.int64)
    kintree = np.stack([parents, np.arange(len(parents))]).astype(np.uint32)
    return {
        "v_template": t(model.v_template),
        "shapedirs": t(model.shapedirs),
        "posedirs": np.ascontiguousarray(t(model.posedirs).T.reshape(
            V, 3, -1)),
        "J_regressor": t(model.J_regressor),
        "weights": t(model.lbs_weights),
        "kintree_table": kintree,
        "f": np.asarray(model.faces).astype(np.uint32),
    }


def write_smpl_npz(path: str, arrays: Dict[str, np.ndarray]) -> str:
    np.savez(path, **arrays)
    return path


class Ch:
    """Pickles as chumpy.ch.Ch with the array in its state's 'x'."""

    def __init__(self, x):
        self.x = np.asarray(x)


def write_smpl_pkl(path: str, arrays: Dict[str, np.ndarray]) -> str:
    """The chumpy-era pickle of ``arrays`` (smpl_file_arrays' layout)."""
    import scipy.sparse
    data = {k: Ch(arrays[k]) for k in ("v_template", "shapedirs", "posedirs",
                                       "weights")}
    data.update(J_regressor=scipy.sparse.csc_matrix(arrays["J_regressor"]),
                kintree_table=arrays["kintree_table"], f=arrays["f"],
                bs_style="lbs", bs_type="lrotmin")
    saved = {m: sys.modules.get(m) for m in ("chumpy", "chumpy.ch")}
    ch = types.ModuleType("chumpy.ch")
    ch.Ch = Ch
    Ch.__module__ = "chumpy.ch"
    sys.modules.update({"chumpy": types.ModuleType("chumpy"),
                        "chumpy.ch": ch})
    try:
        with open(path, "wb") as f:
            pickle.dump(data, f, protocol=2)
    finally:
        Ch.__module__ = __name__
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    return path


def vposer_state_dict(params: Dict[str, torch.Tensor],
                      prefix: str = "vp_model.") -> Dict[str, torch.Tensor]:
    """VPoser weights in the torch module layout: Linear weights (out, in),
    BatchNorm statistics as weight, bias, running_mean, running_var."""
    sd = {}
    for tkey, names in _TORCH_KEY_MAP.items():
        fields = _BN_FIELDS if len(names) == 4 else ("weight", "bias")
        for name, field in zip(names, fields):
            v = params[name].detach().cpu()
            sd[f"{prefix}{tkey}.{field}"] = \
                v.t().contiguous() if field == "weight" and v.dim() == 2 \
                else v.clone()
    return sd


def write_vposer_snapshot(directory: str, params: Dict[str, torch.Tensor],
                          name: str = "V02_05_epoch=13_val_loss=0.03.ckpt",
                          prefix: str = "vp_model.") -> str:
    """A V02_05-style directory: snapshots/<name> holds the state dict."""
    snap = os.path.join(directory, "snapshots")
    os.makedirs(snap, exist_ok=True)
    torch.save({"state_dict": vposer_state_dict(params, prefix)},
               os.path.join(snap, name))
    return directory


def write_gmm_pkl(path: str, means, covars, weights) -> str:
    with open(path, "wb") as f:
        pickle.dump({"means": np.asarray(means), "covars": np.asarray(covars),
                     "weights": np.asarray(weights)}, f, protocol=2)
    return path


def humor_state_dict(params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """HuMoR weights in the reference MLP layout: the k-th Linear at
    net.3k, (out, in), the GroupNorm before it at net.3k-2."""
    sd = {}
    for group, sub in params.items():
        module, n_linear = _HUMOR_MODULES[group]
        for k in range(n_linear):
            base = f"{prefix}{module}.net"
            sd[f"{base}.{3 * k}.weight"] = sub[f"w{k}"].detach().cpu().t() \
                .contiguous()
            sd[f"{base}.{3 * k}.bias"] = sub[f"b{k}"].detach().cpu().clone()
            if k:
                sd[f"{base}.{3 * k - 2}.weight"] = \
                    sub[f"gn{k}_g"].detach().cpu().clone()
                sd[f"{base}.{3 * k - 2}.bias"] = \
                    sub[f"gn{k}_b"].detach().cpu().clone()
    return sd


def write_humor_ckpt(path: str, params, prefix: str = "") -> str:
    """{'model': state_dict} (prefix 'module.' as DataParallel saves it)."""
    torch.save({"model": humor_state_dict(params, prefix)}, path)
    return path


def write_humor_npz(path: str, params) -> str:
    """humor_tool's ``train`` layout: one 'group.key' array each."""
    np.savez(path, **{f"{g}.{k}": v.detach().cpu().numpy()
                      for g, sub in params.items() for k, v in sub.items()})
    return path
