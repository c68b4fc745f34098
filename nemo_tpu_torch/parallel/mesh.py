"""Data-parallel meshes over torch.distributed (port of
nemo_tpu/parallel/mesh.py).

A ``Mesh`` names the dp process group, this rank's place in it and the
device its tensors live on. Parameters are replicated (broadcast from rank
0 once, then kept equal by identical updates); each batch is split over
the ranks by rows. The JAX package lets XLA insert the gradient
all-reduce; here ``reduce_gradients`` does it, one all-reduce a step over
every gradient and metric, and the losses take the mesh so that each rank
computes its share of the global function (fit.model.fit_loss).

Collectives used on the program's path are all_reduce and broadcast, the
two that gloo also offers on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.trace import span


def batch_rows(n: int, rank: int, size: int) -> slice:
    """Rank ``rank``'s rows of a leading axis of length n split over
    ``size`` ranks (n must tile)."""
    if n % size:
        raise ValueError(f"batch of {n} not divisible by the {size}-rank "
                         f"dp mesh")
    per = n // size
    return slice(rank * per, (rank + 1) * per)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: ``size`` ranks of ``group`` (None: the
    default group, or no group when size is 1), this process at ``rank``,
    its tensors on ``device``."""
    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None
    axis_name: str = "dp"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the ranks (a new tensor; t is left as is)."""
        if self.size == 1:
            return t
        out = t.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank src's t on every rank, in place."""
        if self.size > 1:
            dist.broadcast(t, src, group=self.group)
        return t

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading axis of length n (n must tile)."""
        return batch_rows(n, self.rank, self.size)

    def tiles(self, n: int) -> bool:
        return n % self.size == 0


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "dp",
              device=None) -> Mesh:
    """The dp mesh over the process group torch.distributed has set up
    (distributed.initialize), or a one-rank mesh without one. n_devices,
    when given, must equal the group's size. device: this rank's device;
    by default the current card under NCCL, else the CPU."""
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        nccl = dist.get_backend() == "nccl"
    else:
        size, rank, nccl = 1, 0, False
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"make_mesh({n_devices}): the process group has {size} "
            f"rank(s); start {n_devices} ranks (torchrun, or the fit CLI's "
            f"--dp) and call distributed.initialize() first")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if nccl
                  else torch.device("cpu"))
    return Mesh(rank=rank, size=size, device=torch.device(device),
                axis_name=axis_name)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The leading (batch) axis split over the mesh's ranks."""
    mesh: Mesh

    def place(self, a) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                            else a)
        return t[self.mesh.rows(t.shape[0])].to(self.mesh.device)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Rank 0's value on every rank."""
    mesh: Mesh

    def place(self, a) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                            else a).to(self.mesh.device).contiguous()
        return self.mesh.broadcast(t)


def batch_sharding(mesh: Mesh, axis_name: str = "dp") -> BatchSharding:
    """Shard the leading (batch) axis over the mesh."""
    return BatchSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_batch(mesh: Mesh, *arrays, axis_name: str = "dp"):
    """This rank's rows of each array, on the mesh's device."""
    sh = batch_sharding(mesh, axis_name)
    return tuple(sh.place(a) for a in arrays)


def replicate_tree(mesh: Mesh, tree):
    """Rank 0's values of a tree of tensors on every rank: an nn.Module's
    parameters and buffers and tensors in dicts, lists and tuples are
    overwritten in place; numpy arrays become tensors on the mesh's
    device. Returns the tree."""
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in [*tree.parameters(), *tree.buffers()]:
                mesh.broadcast(t.data)
        return tree
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            return mesh.broadcast(tree.data if tree.is_contiguous()
                                  else tree.contiguous())
    if isinstance(tree, np.ndarray):
        return replicated(mesh).place(tree)
    if isinstance(tree, dict):
        return type(tree)((k, replicate_tree(mesh, v))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate_tree(mesh, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate_tree(mesh, v) for v in tree)
    return tree


def reduce_gradients(mesh: Mesh, params: Sequence[torch.Tensor],
                     metrics: Dict[str, torch.Tensor],
                     sharded: bool = True) -> Dict[str, torch.Tensor]:
    """Sum the parameters' gradients and the metrics over the ranks in one
    all-reduce; the summed gradients replace each ``.grad`` (None counts
    as zeros) and the summed metrics are returned. With ``sharded`` false
    (a batch that did not tile the ranks and so ran whole on each) only
    rank 0's values enter the sum, so every rank takes rank 0's bits."""
    if mesh.size == 1:
        return metrics
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    keys = list(metrics)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [metrics[k].reshape(1).to(grads[0].dtype)
                        for k in keys])
    if not sharded and mesh.rank != 0:
        flat = torch.zeros_like(flat)
    dist.all_reduce(flat, group=mesh.group)
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p)
        off += n
    return {k: flat[off + i] for i, k in enumerate(keys)}


def data_parallel_step(loss_fn, mesh: Optional[Mesh],
                       axis_name: str = "dp"):
    """Wrap a loss for data-parallel gradient steps (XLA inserts this
    all-reduce into the JAX package's jitted step; here it is explicit).

    wrapped(params, cfg, assets, view_idx, frame_idx, noise=None) takes the
    global batch and its code noise, keeps this rank's rows, and calls
    loss_fn(params, cfg, assets, view_idx, frame_idx[, noise=noise],
    mesh=mesh), so that the loss is this rank's share of the global one
    (fit.model.fit_loss). It runs the backward into the parameters' .grad
    (set to None first), sums the gradients and metrics over the ranks
    (reduce_gradients), and returns the global metrics, detached; the
    caller steps its optimizer. A batch that does not tile the ranks runs
    whole on every rank with no mesh, and rank 0's gradient is taken.
    Without a mesh, or on one rank, it is a plain gradient step. The loss
    and its backward are the spans ``nemo.fit.forward`` and
    ``nemo.fit.backward`` (utils.trace)."""

    def wrapped(params: torch.nn.Module, cfg, assets, view_idx, frame_idx,
                noise: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        n = int(view_idx.shape[0])
        many = mesh is not None and mesh.size > 1
        sharded = many and mesh.tiles(n)
        kw = {}
        if sharded:
            rows = mesh.rows(n)
            view_idx, frame_idx = view_idx[rows], frame_idx[rows]
            noise = None if noise is None else noise[rows]
            kw["mesh"] = mesh
        if noise is not None:
            kw["noise"] = noise
        params.zero_grad(set_to_none=True)
        with span("nemo.fit.forward"):
            loss, metrics = loss_fn(params, cfg, assets, view_idx, frame_idx,
                                    **kw)
        with span("nemo.fit.backward"):
            loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if many:
            metrics = reduce_gradients(mesh, list(params.parameters()),
                                       metrics, sharded=sharded)
        return metrics

    return wrapped
