"""Process-group set-up for data-parallel runs, and host-side helpers that
keep side effects (checkpoints, CSVs, renders) on rank 0.

The port's counterpart of nemo_tpu/parallel/distributed.py: one process a
rank over torch.distributed. Usage, near the top of a rank's program:

    from nemo_tpu_torch.parallel import distributed
    distributed.initialize()        # torchrun's environment, or arguments
    if distributed.is_primary():
        ...                         # write checkpoints / metrics

Without torchrun's environment and without arguments, ``initialize()`` is
a no-op that returns False, and every helper answers for one process.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: str = "cuda",
               backend: Optional[str] = None) -> bool:
    """Join the data-parallel process group; True when one is active.

    * With ``coordinator_address`` ("host:port"), ``num_processes`` and
      ``process_id`` given, they are used (a tcp:// rendezvous).
    * Else torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
      RANK; LOCAL_RANK picks the card) is read.
    * With neither it is a no-op returning False (one process).

    The backend is NCCL for ``device`` "cuda" (each rank on the card
    LOCAL_RANK, else its rank) and gloo for "cpu"; ``backend`` overrides
    it. Safe to call again once the group is up.
    """
    if dist.is_available() and dist.is_initialized():
        return True
    explicit = coordinator_address is not None
    if not explicit and not (os.environ.get("MASTER_ADDR")
                             and os.environ.get("WORLD_SIZE")):
        return False
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("initialize: coordinator_address needs "
                             "num_processes and process_id")
        rank, world = int(process_id), int(num_processes)
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=world, rank=rank)
    else:
        rank, world = _env_int("RANK") or 0, _env_int("WORLD_SIZE")
        kw = dict(init_method="env://", world_size=world, rank=rank)
    if dev.type == "cuda" and backend == "nccl":
        local = _env_int("LOCAL_RANK")
        card = rank if local is None or explicit else local
        if card >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} needs card {card}: "
                             f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(card)
    dist.init_process_group(backend=backend, **kw)
    return True


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def is_primary() -> bool:
    """True on the process that does host-side IO (checkpoints, CSVs)."""
    return process_index() == 0


def local_batch_slice(global_batch: int) -> slice:
    """This process's [start, stop) rows of a global batch."""
    from .mesh import batch_rows
    return batch_rows(global_batch, process_index(), process_count())


def barrier(name: str = "nemo_tpu_barrier") -> None:
    """Block until every process reaches this point (no-op alone)."""
    if process_count() > 1:
        dist.barrier()
