"""Seed fan-out: many independent main-stage fits on one device, or split
over the ranks of a mesh (port of nemo_tpu/parallel/fanout.py).

The reference sweeps seeds with SLURM job arrays, one GPU a job; the JAX
package vmaps the whole main stage over a seed axis. Here each seed is a
``fit.loop.NemoFitter`` of its own (init_params from seed base + s, its own
Adam, plateau schedulers and batch generator), and one Python loop steps
them in lockstep: step i of every seed before step i + 1, with no host
synchronisation inside a step. So seed s follows, bit for bit, the main
stage of a lone ``NemoFitter(cfg, assets, seed=base + s)``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import torch

from ..fit.loop import BatchSource, NemoFitter
from ..fit.model import NemoAssets, NemoConfig


def _seed_range(num_seeds: int, mesh) -> range:
    if mesh is None or mesh.size == 1:
        return range(num_seeds)
    if num_seeds % mesh.size:
        raise ValueError(f"{num_seeds} seeds not divisible by the "
                         f"{mesh.size}-rank dp mesh")
    per = num_seeds // mesh.size
    return range(mesh.rank * per, (mesh.rank + 1) * per)


def make_fanout(cfg: NemoConfig, assets: NemoAssets, num_seeds: int,
                steps: Optional[int] = None, base_seed: int = 0, mesh=None,
                batch_sources: Optional[Sequence[BatchSource]] = None):
    """(fan, inputs): fan(*inputs) runs the sweep and returns (params,
    losses) as fit_many_seeds describes them. inputs = (seeds, params0):
    this rank's seed indices and, for each, None (the fitter's own
    init_params(base_seed + s)) or a state dict of NemoParams to start
    from; a caller may put such state dicts in (e.g. parameters converted
    from another package) before calling fan. fan builds fresh fitters on
    every call, so the same inputs run the same sweep again.
    batch_sources: optional per-seed replacements of the batch sampler."""
    steps = cfg.n_steps if steps is None else steps
    seeds = list(_seed_range(num_seeds, mesh))
    params0: List[Optional[Mapping]] = [None] * len(seeds)

    def fan(seeds: Sequence[int], params0: Sequence[Optional[Mapping]]):
        fitters: List[NemoFitter] = []
        for s, p0 in zip(seeds, params0):
            f = NemoFitter(cfg, assets, seed=base_seed + s,
                           batch_source=None if batch_sources is None
                           else batch_sources[s])
            if p0 is not None:
                f.params.load_state_dict(p0)
            fitters.append(f)
        curves: List[List[torch.Tensor]] = [[] for _ in fitters]
        for _ in range(steps):
            for f, curve in zip(fitters, curves):
                curve.append(f.main_step()["total_loss"])
        names = [n for n, _ in fitters[0].params.named_parameters()] \
            if fitters else []
        params = {n: torch.stack([dict(f.params.named_parameters())[n]
                                  .detach() for f in fitters])
                  for n in names}
        losses = (torch.stack([torch.stack(c) for c in curves])
                  if steps and fitters else
                  torch.zeros((len(fitters), steps), device=assets.device))
        if mesh is not None and mesh.size > 1:
            params, losses = _gather_seeds(mesh, num_seeds, seeds, params,
                                           losses)
        return ({n.replace(".", "/"): v for n, v in params.items()},
                losses)

    return fan, (seeds, params0)


def _gather_seeds(mesh, num_seeds: int, seeds: Sequence[int],
                  params: Dict[str, torch.Tensor], losses: torch.Tensor):
    """Every rank's seeds on every rank: each fills its rows of a zeroed
    (S, ...) buffer and one all-reduce sums them (a sum with zeros is
    exact, and all_reduce is offered by gloo on CUDA tensors too)."""
    parts = [*params.values(), losses]
    flat = torch.cat([p.reshape(len(seeds), -1) for p in parts], dim=1)
    full = flat.new_zeros((num_seeds, flat.shape[1]))
    full[seeds[0]:seeds[-1] + 1] = flat
    full = mesh.all_reduce(full)
    out, off = [], 0
    for p in parts:
        n = p[0].numel()
        out.append(full[:, off:off + n].reshape((num_seeds,) + p.shape[1:]))
        off += n
    return dict(zip(params, out[:-1])), out[-1]


def fit_many_seeds(cfg: NemoConfig, assets: NemoAssets, num_seeds: int,
                   steps: Optional[int] = None, base_seed: int = 0,
                   mesh=None,
                   batch_sources: Optional[Sequence[BatchSource]] = None
                   ) -> Dict[str, object]:
    """Run num_seeds independent main-stage fits of ``steps`` (default
    cfg.n_steps) steps, seed s from init_params(base_seed + s).

    Returns {"params": {'/'-key: (S, ...) tensor}, "losses": (S, steps)
    numpy}: params_from_numpy(p, {k: v[s] for k, v in params.items()})
    loads seed s. With a mesh the seeds split over the ranks (num_seeds
    must divide by its size) and every rank returns the whole result. For
    repeated sweeps, or other starting parameters, build once with
    make_fanout."""
    fan, inputs = make_fanout(cfg, assets, num_seeds, steps, base_seed,
                              mesh, batch_sources)
    params, losses = fan(*inputs)
    return {"params": params, "losses": losses.cpu().numpy()}
