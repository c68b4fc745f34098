"""Bundles and synthetic problems (port of nemo_tpu.data)."""

from .bundle import MultiViewBundle
from .synthetic import synthetic_problem
