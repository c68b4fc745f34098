"""Hand-written Hopper kernels with their plain PyTorch versions.

K1 ``fk.fk_compose`` (forward and backward kernels) and K2
``lbs.skin_v2v_l1`` (grad and forward-only modes). Each wrapper counts its
kernel launches; :func:`launch_counts` reads the counts and
:func:`reset_launches` sets them to zero.
"""

from __future__ import annotations

from typing import Dict

from . import fk, lbs
from .fk import fk_compose
from .lbs import skin_v2v_l1


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel and mode."""
    return {**fk.LAUNCHES, **lbs.LAUNCHES}


def reset_launches() -> None:
    for counts in (fk.LAUNCHES, lbs.LAUNCHES):
        for k in counts:
            counts[k] = 0


__all__ = ["fk_compose", "skin_v2v_l1", "launch_counts", "reset_launches"]
