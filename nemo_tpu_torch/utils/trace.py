"""Profiler spans and kernel-launch counters of the port.

``span(name)`` marks a region in a torch.profiler trace, on the host's
timeline, and nowhere else: it opens a record while a profiler records and
is a shared no-op otherwise, so that the program pays one check a span
when nobody traces it. The spans are function-scope records, so the
profiler draws no annotation of them on the device's timeline: a trace's
device operations stay the kernels themselves. ``launch(counts, key)``
counts one launch of a hand-written kernel under ``counts[key]`` (the ops
modules' ``LAUNCHES``) and marks it as the span ``nemo.ops.<key>``.

The main stage's step (fit/loop.py, parallel/mesh.py, fit/model.py) is
parted into ``nemo.fit.*`` spans (step, forward, backward, optimizer,
metrics_copy) and layer spans (``nemo.net.*``, ``nemo.body.smpl``,
``nemo.loss.*``, ``nemo.prior.*``); portbench/harness/spans.py reads them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

_recording = torch.autograd._profiler_enabled
# a record of the FUNCTION scope, as an operator's, under the given name
_RECORD = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


def span(name: str, args: Optional[Dict[str, object]] = None):
    """A context that marks its block as ``name`` in a torch.profiler trace
    (``args``: keyword values kept with the record where the profiler
    records inputs, record_shapes=True); the shared no-op when no profiler
    records."""
    if not _recording():
        return _OFF
    return _RECORD(name, [], args) if args else _RECORD(name)


@contextlib.contextmanager
def launch(counts: Dict[str, int], key: str) -> Iterator[None]:
    """Around one launch of a hand-written kernel: the span
    ``nemo.ops.<key>``, and ``counts[key] += 1`` once the block returns
    (a launch that raises is not counted)."""
    with span("nemo.ops." + key):
        yield
    counts[key] += 1
