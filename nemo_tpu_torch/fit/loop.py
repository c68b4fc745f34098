"""The three-stage NeMo fit: warmup -> camera stage -> main optimization.

Port of nemo_tpu/fit/loop.py. Each stage is a plain Python loop of
PyTorch steps. Nothing inside a stage waits for the device: batches and
code noise are drawn on the device from a ``torch.Generator``, the
full-batch grid is built once, the plateau schedulers are device tensors,
and per-step metrics stay on the device until the end of the stage (or of a
main-stage chunk), where they are stacked and copied to the host once.

Per model version: V0 warms up through a fresh Adam over its pose network,
V1+ through the persistent motion/rbf/phase Adams; the camera stage of
V0-V3 steps a fresh cameras-only Adam at frame 0 of every view, that of V4
steps every group but the betas on random batches. ``full_batch`` main
steps run the fixed (view x frame) grid instead of a random batch.

With a data-parallel ``mesh`` (parallel.make_mesh) every rank seeds the same
generator, draws the global batch and code noise and keeps its rows; the
losses are the global functions (fit.model.fit_loss(mesh=...)), and one
all-reduce a step sums the gradients and metrics, so every rank's Adam and
plateau schedulers step on the same values and the parameters stay equal
bit for bit. A batch that does not tile the ranks (the full grid on an odd
count) runs whole on every rank, and rank 0's gradient is taken.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .model import (NemoAssets, NemoConfig, camera_stage_loss, fit_loss,
                    init_params, warmup_loss)
from .optimizer import (GroupOptimizer, make_camera_stage_optimizer,
                        make_v0_warmup_optimizer, plateau_init_all,
                        plateau_update_all)
from ..parallel.mesh import data_parallel_step, replicate_tree
from ..utils.trace import span

# batch_source(stage, step) -> (view_idx, frame_idx) for stage "warmup",
# "camera" (V4; both counted within the stage) or "main" (counted over all
# chunks)
BatchSource = Callable[[str, int], Tuple[object, object]]


def _stack(records: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """Per-step device scalars -> host arrays, one copy per key."""
    if not records:
        return {}
    with span("nemo.fit.metrics_copy"):
        return {k: torch.stack([r[k] for r in records]).cpu().numpy()
                for k in records[0]}


class NemoFitter:
    """Drives the three-stage optimization for one action.

    batch_source: optional replacement for the on-device batch sampler (the
    tests replay the JAX fitter's batch stream through it); it gives the
    global batch, of which a data-parallel rank keeps its rows.
    mesh: a data-parallel mesh (parallel.make_mesh); the batch size must
    tile its ranks unless the fit is full-batch.
    """

    def __init__(self, cfg: NemoConfig, assets: NemoAssets, seed: int = 0,
                 batch_source: Optional[BatchSource] = None, mesh=None):
        self.cfg = cfg
        self.assets = assets
        self.device = assets.device
        self.mesh = mesh
        if mesh is not None and not cfg.full_batch and \
                cfg.batch_size % mesh.size != 0:
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by the "
                f"{mesh.size}-rank dp mesh")
        self.params = init_params(cfg, assets.num_views, assets.img_d0,
                                  torch.Generator().manual_seed(seed),
                                  self.device)
        if mesh is not None:
            replicate_tree(mesh, self.params)
        self.optimizer = GroupOptimizer(self.params, cfg)
        self.plateau = plateau_init_all(cfg, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.batch_source = batch_source
        self.step = 0
        V, F = assets.num_views, assets.num_frames
        self._grid = (torch.arange(V, device=self.device).repeat_interleave(F),
                      torch.arange(F, device=self.device).repeat(V))

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

    def _noise(self, batch: int) -> Optional[torch.Tensor]:
        """The code noise draw of a training step (None when off)."""
        cfg = self.cfg
        if cfg.code_noise <= 0 or not cfg.uses_instance_code:
            return None
        return torch.randn((batch, cfg.instance_code_size),
                           generator=self.generator, device=self.device)

    def _grad_step(self, loss_fn, vi, fi, noise=None
                   ) -> Dict[str, torch.Tensor]:
        """Gradients into .grad and the step's metrics, summed over the
        ranks under a mesh. vi, fi and noise are the global batch."""
        return data_parallel_step(loss_fn, self.mesh)(
            self.params, self.cfg, self.assets, vi, fi, noise)

    # One step of each stage. Each returns its metrics as device scalars
    # and never waits for the device.

    def warmup_step(self, i: int, opt=None) -> Dict[str, torch.Tensor]:
        """opt: V0's warmup Adam (make_v0_warmup_optimizer); V1+ steps the
        persistent motion/rbf/phase Adams."""
        vi, fi = self._batch("warmup", i, self.cfg.batch_size)
        metrics = self._grad_step(warmup_loss, vi, fi)
        if opt is not None:
            opt.step()
        else:
            self.optimizer.step(active=("motion", "rbf", "phase"))
        return metrics

    def camera_step(self, cam_opt=None, i: int = 0
                    ) -> Dict[str, torch.Tensor]:
        """cam_opt: the V0-V3 cameras-only Adam; V4 (cam_opt None) steps
        every group but the betas on batch i of the stage."""
        if self.cfg.model_version >= 4:
            vi, fi = self._batch("camera", i, self.cfg.batch_size)
            metrics = self._grad_step(camera_stage_loss, vi, fi,
                                      noise=self._noise(vi.shape[0]))
            self.optimizer.step(active=("cameras", "motion", "rbf", "phase",
                                        "instance"))
            return metrics
        V = self.assets.num_views
        vi = torch.arange(V, device=self.device)
        fi = torch.zeros(V, dtype=torch.long, device=self.device)
        metrics = self._grad_step(camera_stage_loss, vi, fi)
        cam_opt.step()
        return metrics

    def main_step(self) -> Dict[str, torch.Tensor]:
        """One main-stage step, traced as the span ``nemo.fit.step`` (its
        index kept with it) around ``nemo.fit.forward``,
        ``nemo.fit.backward`` and ``nemo.fit.optimizer``."""
        with span("nemo.fit.step", {"step": self.step}):
            if self.cfg.full_batch:
                vi, fi = self._grid
            else:
                vi, fi = self._batch("main", self.step, self.cfg.batch_size)
            metrics = self._grad_step(fit_loss, vi, fi,
                                      noise=self._noise(vi.shape[0]))
            with span("nemo.fit.optimizer"):
                self.optimizer.step(plateau=self.plateau)
                self.plateau = plateau_update_all(
                    self.plateau, metrics["total_loss"], self.cfg)
            self.step += 1
        return metrics

    def warmup(self, steps: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Fit the predicted pose to the initializer theta: V1+ steps the
        persistent motion/rbf/phase Adams (reference :3493-3503), V0 a
        fresh Adam over its pose network that is dropped after the stage
        (:3211-3214)."""
        steps = self.cfg.warmup_step if steps is None else steps
        opt = make_v0_warmup_optimizer(self.params, self.cfg) \
            if self.cfg.model_version == 0 else None
        return _stack([self.warmup_step(i, opt) for i in range(steps)])

    def opt_cam(self, steps: Optional[int] = None) -> Dict[str, np.ndarray]:
        """V0-V3: frame 0 of every view, a fresh cameras-only Adam that is
        dropped after the stage (reference :2869-2906). V4: random batches,
        the persistent Adams of every group but the betas (:4060-4149)."""
        steps = self.cfg.opt_cam_step if steps is None else steps
        cam_opt = None if self.cfg.model_version >= 4 else \
            make_camera_stage_optimizer(self.params, self.cfg)
        return _stack([self.camera_step(cam_opt, i) for i in range(steps)])

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
        random batch with full=False. Under a mesh every rank evaluates
        the whole batch (the parameters are equal on every rank)."""
        if full:
            vi, fi = self._grid
        else:
            vi, fi = self._batch("eval", -1, batch_size or self.cfg.batch_size)
        _, metrics = fit_loss(self.params, self.cfg, self.assets, vi, fi)
        return {k: float(v) for k, v in metrics.items()}
