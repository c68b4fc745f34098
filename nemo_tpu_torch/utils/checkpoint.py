"""Weights carried across from the JAX package, and fit checkpoints.

nemo_tpu saves parameters flattened to numpy with '/'-joined pytree paths
(nemo_tpu/utils/checkpoint.py:25-30): ``cameras``, ``phase/shifts``,
``phase/scales``, ``motion/trunk/W1`` ... ``motion/b_lin``,
``rbf/log_sigmas``, ``instance``, ``betas``. The port's ``NemoParams``
names the same tensors with '.' (``motion.trunk.W1``) in the same ``(in,
out)`` layout, so conversion is a rename. Parameter init draws from
jax.random on one side and torch on the other, so every parity test starts
the port from converted JAX parameters.

A fit checkpoint is a directory in the JAX package's layout, so each
package reads the other's parameters, Adam moments and plateau states:

- ``params.npz``: the parameters under the flat '/' keys;
- ``opt_state.npz``: each group's Adam state under optax's flat paths,
  ``<group>/<i>/.count``, ``<group>/<i>/.mu[/<param>]`` and ``.nu``, where
  ``i`` is scale_by_adam's place in the group's optax chain (1 after
  torch-Adam weight decay, else 0);
- ``plateau.npz``: ``<group>/.best``, ``.num_bad``, ``.scale``;
- ``meta.json``: the main-stage step and the config.

The port's batch generator state goes in ``generator.npy`` (with its
device type in ``meta.json``). JAX's ``key.npy`` cannot be carried across
RNGs: resuming a JAX checkpoint, or a port checkpoint on another device
type, restarts the batch stream from the fitter's seed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from ..fit.model import NemoParams
from ..priors.gmm import gmm_from_numpy
from ..priors.vposer import vposer_from_numpy

__all__ = ["params_from_numpy", "params_to_numpy", "vposer_from_numpy",
           "gmm_from_numpy", "save_fit_state", "load_fit_state",
           "load_saved_config"]


@torch.no_grad()
def params_from_numpy(params: NemoParams, flat: Mapping[str, np.ndarray]
                      ) -> NemoParams:
    """Copy JAX-flattened parameters into ``params`` (in place; returned).
    Every port parameter must be present with the same shape."""
    own = dict(params.named_parameters())
    missing = [k for k in own if k.replace(".", "/") not in flat]
    if missing:
        raise KeyError(f"parameters missing from the checkpoint: {missing}")
    for name, p in own.items():
        src = np.asarray(flat[name.replace(".", "/")], np.float32)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: checkpoint shape {src.shape}, "
                             f"expected {tuple(p.shape)}")
        p.copy_(torch.from_numpy(src.copy()))
    return params


def params_to_numpy(params: NemoParams) -> Dict[str, np.ndarray]:
    """The inverse: numpy arrays under the JAX package's flat keys."""
    return {name.replace(".", "/"): p.detach().cpu().numpy()
            for name, p in params.named_parameters()}


def _adam_keys(params: NemoParams, group: str, opt) -> tuple:
    """(count key, [moment key stem per tensor]) of one group's Adam under
    optax's flat paths; a stem takes '.mu' or '.nu' after it."""
    i = 1 if opt.wd and not opt.decoupled else 0
    mod = getattr(params, group)
    subs: List[str] = [""] if isinstance(mod, torch.nn.Parameter) else \
        ["/" + n.replace(".", "/") for n, _ in mod.named_parameters()]
    return f"{group}/{i}/.count", [(f"{group}/{i}/", s) for s in subs]


def save_fit_state(path: str, fitter, cfg=None) -> None:
    """Save the fitter's parameters, Adam moments, plateau states, step,
    batch generator state (and config)."""
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(osp.join(path, "params.npz"),
                        **params_to_numpy(fitter.params))
    opt = {}
    for g, adam in fitter.optimizer.groups.items():
        count_key, stems = _adam_keys(fitter.params, g, adam)
        opt[count_key] = np.asarray(adam.count, np.int32)
        for (stem, sub), m, v in zip(stems, adam.m, adam.v):
            opt[f"{stem}.mu{sub}"] = m.detach().cpu().numpy()
            opt[f"{stem}.nu{sub}"] = v.detach().cpu().numpy()
    np.savez_compressed(osp.join(path, "opt_state.npz"), **opt)
    plateau = {}
    for g, s in fitter.plateau.items():
        for field in s._fields:
            plateau[f"{g}/.{field}"] = getattr(s, field).cpu().numpy()
    np.savez_compressed(osp.join(path, "plateau.npz"), **plateau)
    np.save(osp.join(path, "generator.npy"),
            fitter.generator.get_state().numpy())
    meta: Dict[str, Any] = {"step": int(fitter.step),
                            "generator_device": fitter.device.type}
    if cfg is not None:
        meta["config"] = dataclasses.asdict(cfg)
    with open(osp.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


@torch.no_grad()
def load_fit_state(path: str, fitter) -> bool:
    """Restore a checkpoint of either package into ``fitter`` (in place).
    Every parameter must be present; Adam and plateau states the
    checkpoint lacks stay as they are, and its extra entries are ignored.
    Returns whether the batch generator state was restored (False: the
    batch stream restarts from the fitter's seed)."""
    params_from_numpy(fitter.params,
                      dict(np.load(osp.join(path, "params.npz"))))
    opt = dict(np.load(osp.join(path, "opt_state.npz")))
    for g, adam in fitter.optimizer.groups.items():
        count_key, stems = _adam_keys(fitter.params, g, adam)
        if count_key not in opt:
            continue
        adam.count = int(opt[count_key])
        for (stem, sub), m, v in zip(stems, adam.m, adam.v):
            m.copy_(torch.from_numpy(np.asarray(opt[f"{stem}.mu{sub}"])))
            v.copy_(torch.from_numpy(np.asarray(opt[f"{stem}.nu{sub}"])))
    plateau = dict(np.load(osp.join(path, "plateau.npz")))
    for g, s in list(fitter.plateau.items()):
        if f"{g}/.best" in plateau:
            fitter.plateau[g] = type(s)(*(
                torch.as_tensor(plateau[f"{g}/.{field}"],
                                dtype=getattr(s, field).dtype,
                                device=fitter.device)
                for field in s._fields))
    with open(osp.join(path, "meta.json")) as f:
        meta = json.load(f)
    fitter.step = int(meta["step"])
    gen = osp.join(path, "generator.npy")
    if osp.exists(gen) and meta.get("generator_device") == fitter.device.type:
        fitter.generator.set_state(torch.from_numpy(np.load(gen)))
        return True
    return False


def load_saved_config(path: str) -> Dict[str, Any]:
    """The config a checkpoint was saved with ({} when it has none)."""
    with open(osp.join(path, "meta.json")) as f:
        return json.load(f).get("config", {})
