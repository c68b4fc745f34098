"""HuMoR evaluation: full-test stats, sampling and reconstruction, in
PyTorch.

Port of nemo_tpu/models/humor_eval.py (behavioral reference:
humor/humor/test/test_humor.py) as plain functions over (N, T, 207) packed
state sequences on the parameters' device:

  * ``humor_eval_full_test`` (:118-147): the one-step training loss over
    the test set with ground-truth inputs, mean and std per stat;
  * ``humor_eval_sampling`` (:170-239): prior rollouts from each
    sequence's first state, per-window sample statistics;
  * ``humor_eval_recon`` (:242-339): the posterior-mean latents of the
    whole sequence drive a rollout from the first state, per-field errors
    against GT;
  * ``humor_eval_metrics``: the compact one-step / rollout-drift / KL
    summary.

The draws (the posterior draw of each full-test batch, each sampled
rollout step's prior draw) come from ``draw(shape)`` when given, so both
packages can be fed the same numbers, else from a ``torch.Generator`` on
the parameters' device seeded by ``seed``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .humor import (STATE_FIELDS, HumorConfig, Params, gaussian_kl,
                    humor_decode, humor_infer_seq, humor_posterior,
                    humor_prior, humor_roll_out, humor_train_loss,
                    split_state)

Draw = Callable[[Tuple[int, ...]], torch.Tensor]


def _device(params: Params):
    return next(iter(params["decoder"].values())).device


def _draw_fn(params: Params, draw: Optional[Draw], seed: int) -> Draw:
    """draw(shape) on the parameters' device: the given one, else a
    generator's standard normals."""
    dev = _device(params)
    if draw is not None:
        return lambda shape: torch.as_tensor(draw(shape),
                                             dtype=torch.float32,
                                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return lambda shape: torch.randn(shape, generator=gen, device=dev)


def _seqs(params: Params, sequences) -> torch.Tensor:
    return torch.as_tensor(np.asarray(sequences, np.float32),
                           device=_device(params))


@torch.no_grad()
def humor_eval_metrics(params: Params, cfg: HumorConfig, sequences,
                       rollout_steps: int = 10) -> Dict[str, float]:
    """Evaluate a trained HuMoR model on (N, T, D) state sequences:
      one_step_rec    mean L2 of posterior-mean one-step reconstruction
      rollout_drift   mean L2 between a `rollout_steps` prior-mean rollout
                      and GT
      prior_kl        mean KL(posterior || prior) over transitions
    """
    seqs = _seqs(params, sequences)
    N, T, D = seqs.shape
    past = seqs[:, :-1].reshape(N * (T - 1), D)
    nxt = seqs[:, 1:].reshape(N * (T - 1), D)
    qm, qv = humor_posterior(params, cfg, past, nxt)
    pm, pv = humor_prior(params, cfg, past)
    pred, _ = humor_decode(params, cfg, qm, past)  # posterior-mean decode
    one_step = torch.sqrt(((pred - nxt) ** 2).sum(-1)).mean()
    kl = gaussian_kl(qm, qv, pm, pv)
    steps = min(rollout_steps, T - 1)
    roll = humor_roll_out(params, cfg, seqs[:, 0], steps, use_mean=True)
    drift = torch.sqrt(((roll["states"] - seqs[:, 1:steps + 1]) ** 2
                        ).sum(-1)).mean()
    vals = torch.stack([one_step, drift, kl]).cpu().tolist()
    return dict(zip(("one_step_rec", "rollout_drift", "prior_kl"), vals))


@torch.no_grad()
def humor_eval_full_test(params: Params, cfg: HumorConfig, sequences,
                         batch_size: int = 8, kl_weight: float = 4e-4,
                         draw: Optional[Draw] = None, seed: int = 0
                         ) -> Dict[str, float]:
    """Full-test-set evaluation with training-time stats (test_humor.py:
    118-147): batches the (N, T, D) windows, runs the one-step training
    loss on each with ground-truth inputs (draw((B (T-1), L)) its
    posterior draw, one a batch) and returns mean/std per stat plus
    per-field one-step reconstruction MSEs."""
    seqs = np.asarray(sequences, np.float32)
    N, T, D = seqs.shape
    draw = _draw_fn(params, draw, seed)
    per_batch: Dict[str, list] = {}
    for i in range(0, N, batch_size):
        b = _seqs(params, seqs[i:i + batch_size])
        past = b[:, :-1].reshape(-1, D)
        nxt = b[:, 1:].reshape(-1, D)
        eps = draw((past.shape[0], cfg.latent_size))
        _, metrics = humor_train_loss(params, cfg, past, nxt, eps,
                                      kl_weight=kl_weight)
        qm, _ = humor_posterior(params, cfg, past, nxt)
        pred, _c = humor_decode(params, cfg, qm, past)
        err = split_state(pred - nxt)
        for name, _d, _r in STATE_FIELDS:
            metrics[f"rec_{name}"] = (err[name] ** 2).mean()
        vals = torch.stack(list(metrics.values())).cpu().tolist()
        for k2, v in zip(metrics, vals):
            per_batch.setdefault(k2, []).append(v)
    out: Dict[str, float] = {}
    for k2, vals in per_batch.items():
        out[k2] = float(np.mean(vals))
        out[f"{k2}_std"] = float(np.std(vals))
    return out


@torch.no_grad()
def humor_eval_sampling(params: Params, cfg: HumorConfig, sequences,
                        num_samples: int = 3,
                        samp_len: Optional[int] = None,
                        draw: Optional[Draw] = None, seed: int = 0
                        ) -> Dict[str, float]:
    """Per-window sampling statistics (test_humor.py:170-239): the prior
    rolled out `num_samples` times from each sequence's first state (each
    step's draw from draw((N, L)), sample after sample) and
      sample_diversity   mean pairwise L2 between samples of one window
      sample_drift       mean L2 of samples vs GT over the overlap
      prior_std          mean predicted prior std along rollouts
      trans_travel       mean root-translation distance travelled
    samp_len defaults to T-1 (the reference uses samp_len*30 frames)."""
    seqs = _seqs(params, sequences)
    N, T, D = seqs.shape
    steps = int(samp_len) if samp_len else T - 1
    draw = _draw_fn(params, draw, seed)
    rolls, prior_std = [], []
    for _ in range(num_samples):
        r = humor_roll_out(params, cfg, seqs[:, 0], steps, draw=draw)
        rolls.append(r["states"])                           # (N, steps, D)
        prior_std.append(torch.sqrt(r["prior_var"]).mean())
    rolls_np = torch.stack(rolls).cpu().numpy()             # (S, N, steps, D)
    prior_std = torch.stack(prior_std).cpu().numpy().astype(np.float64)
    div = []
    for a in range(num_samples):
        for b in range(a + 1, num_samples):
            div.append(np.sqrt(((rolls_np[a] - rolls_np[b]) ** 2
                                ).sum(-1)).mean())
    overlap = min(steps, T - 1)
    gt = seqs[:, 1:overlap + 1].cpu().numpy()
    drift = np.sqrt(((rolls_np[:, :, :overlap] - gt[None]) ** 2
                     ).sum(-1)).mean()
    trans = rolls_np[..., :3]                               # trans field
    travel = np.sqrt(((trans[:, :, -1] - trans[:, :, 0]) ** 2).sum(-1)).mean()
    return {
        "sample_diversity": float(np.mean(div)) if div else 0.0,
        "sample_drift": float(drift),
        "prior_std": float(np.mean(prior_std)),
        "trans_travel": float(travel),
        "num_samples": float(num_samples),
        "samp_len": float(steps),
    }


@torch.no_grad()
def humor_eval_recon(params: Params, cfg: HumorConfig, sequences
                     ) -> Dict[str, float]:
    """Reconstruction evaluation (test_humor.py:242-339): encode the full
    sequence with the posterior (infer_global_seq, :295), decode a rollout
    driven by the posterior-mean z sequence from the first state
    (roll_out(z_seq=latent_z_seq), :306-313) and report per-field errors
    between the reconstruction and GT."""
    seqs = _seqs(params, sequences)
    N, T, D = seqs.shape
    enc = humor_infer_seq(params, cfg, seqs)                # (N, T-1, L)
    recon = humor_roll_out(params, cfg, seqs[:, 0], T - 1,
                           z_seq=enc["z_mean"])
    pred = recon["states"]                                  # (N, T-1, D)
    gt = seqs[:, 1:]
    names = ["recon_l2", "posterior_kl"]
    vals = [torch.sqrt(((pred - gt) ** 2).sum(-1)).mean(), enc["kl"].mean()]
    perr = split_state(pred - gt)
    for name, _d, _r in STATE_FIELDS:
        names.append(f"recon_{name}")
        vals.append(torch.sqrt((perr[name] ** 2).sum(-1)).mean())
    return dict(zip(names, torch.stack(vals).cpu().tolist()))
