"""Weights carried across from the JAX package.

nemo_tpu saves parameters flattened to numpy with '/'-joined pytree paths
(nemo_tpu/utils/checkpoint.py:25-30): ``cameras``, ``phase/shifts``,
``phase/scales``, ``motion/trunk/W1`` ... ``motion/b_lin``,
``rbf/log_sigmas``, ``instance``, ``betas``. The port's ``NemoParams``
names the same tensors with '.' (``motion.trunk.W1``) in the same ``(in,
out)`` layout, so conversion is a rename. Parameter init draws from
jax.random on one side and torch on the other, so every parity test starts
the port from converted JAX parameters.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..fit.model import NemoParams
from ..priors.gmm import gmm_from_numpy
from ..priors.vposer import vposer_from_numpy

__all__ = ["params_from_numpy", "params_to_numpy", "vposer_from_numpy",
           "gmm_from_numpy"]


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
