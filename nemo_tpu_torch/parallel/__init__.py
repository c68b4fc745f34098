"""Data parallelism over torch.distributed and the seed fan-out (port of
nemo_tpu.parallel).

  * data parallel (``--dp N``): one process a rank, each on its own device
    (NCCL on CUDA, gloo on the CPU). Every rank draws the same global batch
    and keeps its rows; the losses are global functions of the batch (each
    rank's rows summed over the global count), and one all-reduce a step
    sums the gradients and metrics, so the ranks step in lockstep and
    compute the single-device fit (``fit.loop.NemoFitter(mesh=...)``).
  * seed fan-out: S independent main-stage fits stepped in lockstep on one
    device, or split over the ranks (``fit_many_seeds``).

Attribute imports are lazy (PEP 562), as in the JAX package: importing
``distributed`` stays light, and ``fanout`` pulls in the fit stack only
when it is used.
"""

from . import distributed

_LAZY = {
    "fit_many_seeds": "fanout", "make_fanout": "fanout",
    "batch_sharding": "mesh", "data_parallel_step": "mesh",
    "make_mesh": "mesh", "replicated": "mesh", "replicate_tree": "mesh",
    "shard_batch": "mesh",
}

__all__ = ["distributed", *sorted(_LAZY)]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        val = getattr(mod, name)
        globals()[name] = val
        return val
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
