"""VPoser training on AMASS-style pose data, in PyTorch.

Port of nemo_tpu/priors/vposer_train.py (behavioral reference:
human_body_prior/train/vposer_trainer.py:61-337): the VAE trained with a
v2v L1 through the body model (the original mesh a constant), the KL to
N(0, 1), and the geodesic matrot and joint L1 terms kept until a warm-epoch
cutoff; batch norm in batch-statistics mode with its running statistics
carried in the parameter dict.

A train step is one forward and backward on the device and one Adam
update with optax's arithmetic (``fit.optimizer.GroupAdam``) over every
tensor but the running statistics, which the batch's new statistics then
overwrite, as the JAX step does after zeroing their gradients. With a body
model the step runs SMPL's vertex path twice, the original under
``torch.no_grad()``: two K1f launches and, under the gradient, one K1b.

The rsample draw is an argument of the loss, so the same draw can be given
to both packages; ``train_vposer`` draws it from a ``torch.Generator``
seeded by ``seed`` unless the caller passes ``draw``.
``vposer_train_state_{from,to}_jax`` carry the parameters and optax's Adam
state (count, mu, nu) across.

``train_vposer(mesh=...)`` trains data-parallel (parallel.make_mesh): every
rank takes the same permutation and draw and keeps its rows of each batch;
batch norm normalises by the global batch's statistics (summed over the
ranks through a differentiable all-reduce, as SyncBatchNorm does), the
losses are global means, and one all-reduce a step sums the gradients and
metrics, so that every rank applies the same update.
"""

from __future__ import annotations

import dataclasses
import glob
import os.path as osp
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..body.smpl import SMPLModel, smpl_forward
from ..fit.losses import batch_mean
from ..fit.optimizer import GroupAdam
from ..geometry.rotations import batch_rodrigues
from .vposer import Params, vposer_decode


def load_amass_pose_data(paths: Sequence[str],
                         max_per_file: Optional[int] = None) -> np.ndarray:
    """AMASS-style npz motion files ('poses' (T, 156) SMPL-H axis-angle)
    as one (N, 63) bank of body poses, columns 3:66."""
    banks = []
    for path in paths:
        body = np.asarray(np.load(path)["poses"], np.float32)[:, 3:66]
        if max_per_file is not None:
            body = body[:max_per_file]
        banks.append(body)
    return np.concatenate(banks, axis=0)


def prepare_vposer_dataset(out_dir: str, amass_splits: dict, amass_dir: str,
                           keep_rate: float = 0.3, seed: int = 0,
                           shard_size: int = 4096) -> dict:
    """AMASS -> per-split sharded banks of 'pose_body' (63) and
    'root_orient' (3) (data/sharded.write_shards), the reference's
    prepare_vposer_datasets: per sequence in sorted order, keep_rate * 0.8
    of its frames drawn without replacement from the middle 10-90% window.
    amass_splits: {'train': ['CMU', ...], ...}. Returns {split: frames}."""
    from ..data.sharded import write_shards

    rng = np.random.RandomState(seed)
    counts = {}
    for split_name, ds_names in amass_splits.items():
        pb, ro = [], []
        for ds_name in ds_names:
            for fn in sorted(glob.glob(
                    osp.join(amass_dir, ds_name, "*", "*_poses.npz"))):
                poses = np.asarray(np.load(fn)["poses"], np.float32)
                N = len(poses)
                lo, hi = int(0.1 * N), int(0.9 * N)
                if hi - lo < 1:
                    continue
                k = int(keep_rate * 0.8 * N)
                if k < 1:
                    continue
                ids = rng.choice(np.arange(lo, hi), min(k, hi - lo),
                                 replace=False)
                pb.append(poses[ids, 3:66])
                ro.append(poses[ids, :3])
        if not pb:
            counts[split_name] = 0
            continue
        arrays = {"pose_body": np.concatenate(pb),
                  "root_orient": np.concatenate(ro)}
        write_shards(arrays, osp.join(out_dir, split_name),
                     shard_size=shard_size)
        counts[split_name] = int(arrays["pose_body"].shape[0])
    return counts


@dataclasses.dataclass(frozen=True)
class VPoserTrainConfig:
    lr: float = 1e-3
    loss_kl_wt: float = 5e-3
    loss_rec_wt: float = 4.0
    loss_matrot_wt: float = 2.0
    loss_jtr_wt: float = 2.0
    keep_extra_loss_terms_until_epoch: int = 15
    batch_size: int = 128
    bn_momentum: float = 0.1


class _GlobalSum(torch.autograd.Function):
    """x summed over the mesh's ranks, differentiably: the gradient of each
    rank's input is the sum of the ranks' output gradients (every rank's
    output reads every rank's input), as SyncBatchNorm's reduction has it."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous()), None


def _bn_train(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              gamma: torch.Tensor, beta: torch.Tensor, momentum: float,
              eps: float = 1e-5, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch-statistics batch norm: (out, new running mean, new running
    var). It normalises with the biased variance and updates the running
    variance with the unbiased one, as torch's BatchNorm1d does. Under a
    data-parallel mesh x is this rank's rows and the statistics are the
    global batch's: the sum, then the sum of squared deviations from the
    global mean, each summed over the ranks."""
    if mesh is None or mesh.size == 1:
        m = x.mean(dim=0)
        v = x.var(dim=0, correction=0)
        n = x.shape[0]
    else:
        n = x.shape[0] * mesh.size
        m = _GlobalSum.apply(x.sum(dim=0), mesh) / n
        v = _GlobalSum.apply(((x - m) ** 2).sum(dim=0), mesh) / n
    out = (x - m) / torch.sqrt(v + eps) * gamma + beta
    unbiased = v * n / max(n - 1, 1)
    new_mean = (1 - momentum) * mean + momentum * m
    new_var = (1 - momentum) * var + momentum * unbiased
    return out, new_mean, new_var


def vposer_encode_train(p: Params, pose_body: torch.Tensor, momentum: float,
                        mesh=None) -> Tuple[torch.Tensor, torch.Tensor,
                                            Dict[str, torch.Tensor]]:
    """The training-mode encoder: (mu, scale, the new running statistics).
    Dropout(0.1) is left out, as in the JAX package."""
    x = pose_body.reshape(pose_body.shape[0], -1)
    x, m0, v0 = _bn_train(x, p["bn0_mean"], p["bn0_var"], p["bn0_gamma"],
                          p["bn0_beta"], momentum, mesh=mesh)
    x = F.leaky_relu(x @ p["enc_w1"] + p["enc_b1"], negative_slope=0.01)
    x, m1, v1 = _bn_train(x, p["bn1_mean"], p["bn1_var"], p["bn1_gamma"],
                          p["bn1_beta"], momentum, mesh=mesh)
    x = x @ p["enc_w2"] + p["enc_b2"]
    x = x @ p["enc_w3"] + p["enc_b3"]
    mu = x @ p["mu_w"] + p["mu_b"]
    scale = F.softplus(x @ p["logvar_w"] + p["logvar_b"])
    return mu, scale, {"bn0_mean": m0, "bn0_var": v0, "bn1_mean": m1,
                       "bn1_var": v1}


def _geodesic_angles(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    m = torch.matmul(R1, R2.transpose(-1, -2))
    tr = m.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp((tr - 1.0) / 2.0, -1 + 1e-6, 1 - 1e-6)
    return torch.arccos(cos)


def geodesic_distance(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Mean geodesic angle between two batches of rotation matrices."""
    return _geodesic_angles(R1, R2).mean()


def vposer_train_loss(params: Params, pose_body: torch.Tensor,
                      noise: torch.Tensor, cfg: VPoserTrainConfig,
                      smpl: Optional[SMPLModel], include_extra_terms: bool,
                      mesh=None
                      ) -> Tuple[torch.Tensor,
                                 Tuple[Dict[str, torch.Tensor],
                                       Dict[str, torch.Tensor]]]:
    """One batch's weighted loss and (metrics, new running statistics).
    noise is the rsample's standard-normal draw, shaped like mu (B, latent).
    Under a data-parallel mesh pose_body and noise are this rank's rows and
    the loss is this rank's share of the global batch's (its rows' sums
    over the global counts)."""
    B = pose_body.shape[0]
    mu, scale, new_stats = vposer_encode_train(params, pose_body,
                                               cfg.bn_momentum, mesh)
    z = mu + scale * noise
    dec = vposer_decode(params, z)
    rec_aa = dec["pose_body"].reshape(B, 63)

    if smpl is not None:
        orient = torch.eye(3, dtype=rec_aa.dtype,
                           device=rec_aa.device).expand(B, 1, 3, 3)
        betas = rec_aa.new_zeros((1, 10))

        def verts(aa63):
            full = torch.cat([aa63, aa63.new_zeros((B, 6))], dim=1)
            return smpl_forward(smpl, betas,
                                batch_rodrigues(full.reshape(B, 23, 3)),
                                orient)

        with torch.no_grad():  # the original mesh is a constant
            v_orig, j_orig = verts(pose_body)
        v_rec, j_rec = verts(rec_aa)
        v2v = batch_mean(torch.abs(v_rec - v_orig), mesh)
        jtr = batch_mean(torch.abs(j_rec - j_orig), mesh)
    else:
        v2v = batch_mean(torch.abs(rec_aa - pose_body), mesh)
        jtr = rec_aa.new_zeros(())

    kl = batch_mean(torch.sum(
        -torch.log(scale) + (scale ** 2 + mu ** 2) / 2.0 - 0.5, dim=1), mesh)

    loss = cfg.loss_rec_wt * v2v + cfg.loss_kl_wt * kl
    metrics = {"v2v": v2v, "kl": kl}
    if include_extra_terms:
        R_rec = dec["pose_body_matrot"].reshape(-1, 3, 3)
        R_orig = batch_rodrigues(pose_body.reshape(-1, 3))
        matrot = batch_mean(_geodesic_angles(R_rec, R_orig), mesh)
        loss = loss + cfg.loss_matrot_wt * matrot + cfg.loss_jtr_wt * jtr
        metrics["matrot"] = matrot
        metrics["jtr"] = jtr
    metrics["loss_total"] = loss
    return loss, (metrics, new_stats)


_BN_STAT_KEYS = ("bn0_mean", "bn0_var", "bn1_mean", "bn1_var")


def _trainable(params: Params):
    """The optimised tensors, in sorted key order: all but the running
    statistics."""
    return [k for k in sorted(params) if k not in _BN_STAT_KEYS]


def make_vposer_train_step(cfg: VPoserTrainConfig,
                           smpl: Optional[SMPLModel] = None,
                           include_extra_terms: bool = True, mesh=None):
    """(init_opt, step): init_opt(params) makes the Adam state (a
    GroupAdam at cfg.lr over every tensor but the running statistics,
    which it marks as requiring gradients); step(params, opt, pose_body,
    noise) updates params and opt in place and returns (params, opt, the
    batch's metrics, on the device). With a data-parallel mesh the step
    takes this rank's rows and applies the gradient summed over the ranks;
    the metrics are the global batch's."""

    def init_opt(params: Params) -> GroupAdam:
        ts = [params[k] for k in _trainable(params)]
        for t in ts:
            t.requires_grad_(True)
        return GroupAdam(ts, cfg.lr)

    def step(params: Params, opt: GroupAdam, pose_body: torch.Tensor,
             noise: torch.Tensor):
        for t in opt.params:
            t.grad = None
        with torch.enable_grad():
            loss, (metrics, new_stats) = vposer_train_loss(
                params, pose_body, noise, cfg, smpl, include_extra_terms,
                mesh)
            loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None and mesh.size > 1:
            from ..parallel.mesh import reduce_gradients
            metrics = reduce_gradients(mesh, opt.params, metrics)
        opt.step()
        with torch.no_grad():
            for k, v in new_stats.items():
                params[k].copy_(v)
        return params, opt, metrics

    return init_opt, step


def train_vposer(params: Params, pose_data: np.ndarray,
                 cfg: VPoserTrainConfig = VPoserTrainConfig(),
                 num_epochs: int = 1, seed: int = 0,
                 smpl: Optional[SMPLModel] = None, mesh=None,
                 draw: Optional[Callable[[Tuple[int, ...]], torch.Tensor]]
                 = None) -> Tuple[Params, Dict[str, np.ndarray]]:
    """Train on (N, 63) pose data on the parameters' device; returns the
    trained parameters (a new dict) and, per metric, its value on each
    epoch's last batch.

    An epoch is a pass over np.random.RandomState(seed)'s permutation in
    batches of cfg.batch_size, the remainder dropped; from epoch
    cfg.keep_extra_loss_terms_until_epoch on the step leaves out the
    matrot and joint terms. draw(shape) gives each step's standard-normal
    rsample draw, in order; by default torch.randn from a CPU
    torch.Generator seeded by seed.

    mesh: a data-parallel mesh (parallel.make_mesh). Every rank takes the
    same permutation and draw and keeps its rows of each batch
    (cfg.batch_size must divide by the mesh's size); the parameters start
    from rank 0's and stay equal on every rank."""
    B = cfg.batch_size
    rows = slice(None)
    if mesh is not None and mesh.size > 1:
        rows = mesh.rows(B)
    N = pose_data.shape[0]
    if num_epochs > 0 and N < B:
        raise ValueError(f"train_vposer: {N} poses make no batch of "
                         f"batch_size {B}")
    dev = next(iter(params.values())).device
    params = {k: v.detach().clone() for k, v in params.items()}
    if mesh is not None:
        from ..parallel.mesh import replicate_tree
        replicate_tree(mesh, params)
    if draw is None:
        gen = torch.Generator().manual_seed(seed)
        draw = lambda shape: torch.randn(shape, generator=gen)
    latent = params["mu_b"].shape[0]
    init_opt, step = make_vposer_train_step(cfg, smpl, True, mesh)
    opt = init_opt(params)
    history: Dict[str, list] = {}
    rng = np.random.RandomState(seed)
    for epoch in range(num_epochs):
        perm = rng.permutation(N)
        if epoch >= cfg.keep_extra_loss_terms_until_epoch:
            _, step = make_vposer_train_step(cfg, smpl, False, mesh)
        for i in range(0, N - B + 1, B):
            batch = torch.as_tensor(pose_data[perm[i:i + B][rows]],
                                    dtype=torch.float32, device=dev)
            noise = torch.as_tensor(draw((B, latent)), dtype=torch.float32,
                                    device=dev)[rows]
            params, opt, metrics = step(params, opt, batch, noise)
        for k, v in metrics.items():
            history.setdefault(k, []).append(float(v))
    return ({k: v.detach() for k, v in params.items()},
            {k: np.asarray(v) for k, v in history.items()})


# ---------------------------------------------------------------------------
# the JAX package's train state, both ways
# ---------------------------------------------------------------------------

def vposer_train_state_from_jax(params: Mapping[str, np.ndarray],
                                opt_state: Optional[Mapping[str, np.ndarray]]
                                = None, lr: float = 1e-3, device=None
                                ) -> Tuple[Params, GroupAdam]:
    """A JAX VPoser train state as the port's (params, opt): params as
    numpy arrays by key, opt_state optax.adam's state flattened as a
    checkpoint holds it ('0/.count', '0/.mu/<key>', '0/.nu/<key>'), or None
    for a fresh Adam."""
    p = {k: torch.tensor(np.asarray(v, np.float32), device=device)
         for k, v in params.items()}
    opt = make_vposer_train_step(VPoserTrainConfig(lr=lr))[0](p)
    if opt_state is not None:
        opt.count = int(opt_state["0/.count"])
        with torch.no_grad():
            for k, m, v in zip(_trainable(p), opt.m, opt.v):
                m.copy_(torch.from_numpy(np.asarray(
                    opt_state["0/.mu/" + k], np.float32)))
                v.copy_(torch.from_numpy(np.asarray(
                    opt_state["0/.nu/" + k], np.float32)))
    return p, opt


def vposer_train_state_to_jax(params: Params, opt: GroupAdam
                              ) -> Tuple[Dict[str, np.ndarray],
                                         Dict[str, np.ndarray]]:
    """The inverse: (params, optax.adam's flattened state) as numpy. The
    running statistics' moments, never updated, are zeros."""
    out = {k: v.detach().cpu().numpy().copy() for k, v in params.items()}
    o = {"0/.count": np.asarray(opt.count, np.int32)}
    moments = dict(zip(_trainable(params), zip(opt.m, opt.v)))
    for k in sorted(params):
        m, v = moments.get(k, (None, None))
        for stem, t in (("0/.mu/", m), ("0/.nu/", v)):
            o[stem + k] = (np.zeros_like(out[k]) if t is None
                           else t.detach().cpu().numpy().copy())
    return out, o
