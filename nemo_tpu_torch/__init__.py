"""nemo_tpu_torch — the NeMo fit in PyTorch, with hand-written Hopper kernels.

A port of ``nemo_tpu`` (JAX/Pallas on a TPU) to PyTorch and CUDA on an NVIDIA
H100. The module layout mirrors ``nemo_tpu`` name for name, so
``nemo_tpu_torch/body/smpl.py`` is the counterpart of ``nemo_tpu/body/smpl.py``.
The JAX package stays the reference: the tests hold each ported function
against it on identical numpy inputs.

This package never imports jax, optax or nemo_tpu.

Numerics: NeMo is a millimetre-accuracy geometric optimizer, and the JAX
package pins every matmul to HIGHEST (f32) precision. The port does the same
at import: TF32 is off for matmuls and convolutions.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(name: str = "cuda") -> torch.device:
    """The device the port runs on. ``"cuda"`` raises when no card is
    visible; the CPU (plain PyTorch versions of every kernel) must be asked
    for explicitly with ``"cpu"``."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass --device cpu to run the plain PyTorch path")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")


@functools.lru_cache(maxsize=None)
def _device_index(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.long, device=device)


def device_index(values: Sequence[int], device) -> torch.Tensor:
    """A static index array (joint maps, parents) as a long tensor on
    ``device``, made once per (values, device). Indexing a CUDA tensor with
    a host array copies the array to the card and waits for the stream, so
    the fit's steps index with these instead and never synchronise."""
    return _device_index(tuple(int(v) for v in values), torch.device(device))
