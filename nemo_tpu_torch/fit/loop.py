"""The three-stage NeMo fit: warmup -> camera stage -> main optimization.

Port of nemo_tpu/fit/loop.py. Each stage is a plain Python loop of
PyTorch steps. Nothing inside a stage waits for the device: batches are drawn
on the device from a ``torch.Generator``, the plateau schedulers are device
tensors, and per-step metrics stay on the device until the end of the stage
(or of a main-stage chunk), where they are stacked and copied to the host
once.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .model import (NemoAssets, NemoConfig, camera_stage_loss, fit_loss,
                    init_params, warmup_loss)
from .optimizer import (GroupOptimizer, make_camera_stage_optimizer,
                        plateau_init_all, plateau_update_all)

# batch_source(stage, step) -> (view_idx, frame_idx) for stage "warmup"
# (step counted within the stage) or "main" (step counted over all chunks)
BatchSource = Callable[[str, int], Tuple[object, object]]


def _stack(records: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """Per-step device scalars -> host arrays, one copy per key."""
    if not records:
        return {}
    return {k: torch.stack([r[k] for r in records]).cpu().numpy()
            for k in records[0]}


class NemoFitter:
    """Drives the three-stage optimization for one action.

    batch_source: optional replacement for the on-device batch sampler (the
    tests replay the JAX fitter's batch stream through it).
    """

    def __init__(self, cfg: NemoConfig, assets: NemoAssets, seed: int = 0,
                 batch_source: Optional[BatchSource] = None):
        self.cfg = cfg
        self.assets = assets
        self.device = assets.device
        self.params = init_params(cfg, assets.num_views, assets.img_d0,
                                  torch.Generator().manual_seed(seed),
                                  self.device)
        self.optimizer = GroupOptimizer(self.params, cfg)
        self.plateau = plateau_init_all(cfg, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.batch_source = batch_source
        self.step = 0

    def _batch(self, stage: str, step: int, batch_size: int):
        V, F = self.assets.num_views, self.assets.num_frames
        if self.batch_source is not None and stage != "eval":
            vi, fi = self.batch_source(stage, step)
            return (torch.as_tensor(np.array(vi), dtype=torch.long,
                                    device=self.device),
                    torch.as_tensor(np.array(fi), dtype=torch.long,
                                    device=self.device))
        kw = dict(generator=self.generator, device=self.device)
        return (torch.randint(0, V, (batch_size,), **kw),
                torch.randint(0, F, (batch_size,), **kw))

    def _grad_step(self, loss_fn, vi, fi):
        self.params.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(self.params, self.cfg, self.assets, vi, fi)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    # One step of each stage. Each returns its metrics as device scalars
    # and never waits for the device.

    def warmup_step(self, i: int) -> Dict[str, torch.Tensor]:
        vi, fi = self._batch("warmup", i, self.cfg.batch_size)
        _, metrics = self._grad_step(warmup_loss, vi, fi)
        self.optimizer.step(active=("motion", "rbf", "phase"))
        return metrics

    def camera_step(self, cam_opt) -> Dict[str, torch.Tensor]:
        V = self.assets.num_views
        vi = torch.arange(V, device=self.device)
        fi = torch.zeros(V, dtype=torch.long, device=self.device)
        _, metrics = self._grad_step(camera_stage_loss, vi, fi)
        cam_opt.step()
        return metrics

    def main_step(self) -> Dict[str, torch.Tensor]:
        vi, fi = self._batch("main", self.step, self.cfg.batch_size)
        loss, metrics = self._grad_step(fit_loss, vi, fi)
        self.optimizer.step(plateau=self.plateau)
        self.plateau = plateau_update_all(self.plateau, loss, self.cfg)
        self.step += 1
        return metrics

    def warmup(self, steps: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Fit the predicted pose to the initializer theta; steps the
        persistent motion/rbf/phase Adams (reference :3493-3503)."""
        steps = self.cfg.warmup_step if steps is None else steps
        return _stack([self.warmup_step(i) for i in range(steps)])

    def opt_cam(self, steps: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Frame 0 of every view, a fresh cameras-only Adam that is dropped
        after the stage (reference :2869-2906)."""
        steps = self.cfg.opt_cam_step if steps is None else steps
        cam_opt = make_camera_stage_optimizer(self.params, self.cfg)
        return _stack([self.camera_step(cam_opt) for _ in range(steps)])

    def fit(self, steps: Optional[int] = None, chunk: int = 500,
            on_chunk: Optional[Callable[["NemoFitter", int, dict], None]] = None
            ) -> Dict[str, np.ndarray]:
        """Main optimization, in chunks; on_chunk(fitter, step, metrics)
        runs on the host between chunks."""
        steps = self.cfg.n_steps if steps is None else steps
        out: Dict[str, list] = {}
        done = 0
        while done < steps:
            n = min(chunk, steps - done)
            metrics = _stack([self.main_step() for _ in range(n)])
            for k, v in metrics.items():
                out.setdefault(k, []).append(v)
            done += n
            if on_chunk is not None:
                on_chunk(self, self.step, metrics)
        return {k: np.concatenate(v) for k, v in out.items()}

    @torch.no_grad()
    def eval_loss(self, batch_size: Optional[int] = None,
                  full: bool = True) -> Dict[str, float]:
        """Loss without an update: the full (view, frame) grid, or one
        random batch with full=False."""
        V, F = self.assets.num_views, self.assets.num_frames
        if full:
            vi = torch.arange(V, device=self.device).repeat_interleave(F)
            fi = torch.arange(F, device=self.device).repeat(V)
        else:
            vi, fi = self._batch("eval", -1, batch_size or self.cfg.batch_size)
        _, metrics = fit_loss(self.params, self.cfg, self.assets, vi, fi)
        return {k: float(v) for k, v in metrics.items()}
