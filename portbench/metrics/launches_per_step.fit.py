"""Kernel launches a main-stage step: the CUDA runtime's launch calls on
the host over the traced steps (stage loop, fit/loop.py)."""


def read(rec):
    return rec["launches"] / rec["steps"] if rec["launches"] else None
