"""VIBE training: the motion discriminator, VIBE's losses, the train step,
evaluation, checkpoints and the epoch loop (port of
nemo_tpu/models/vibe_train.py).

Behavioral reference: VIBE/lib/core/loss.py (VIBELoss: 2D/3D keypoint MSE,
SMPL pose/shape losses, adversarial term), VIBE/lib/models/motion_
discriminator.py:24-79 (GRU + avg/max-pool 'concat' or SelfAttention head
judging AMASS-real vs generated pose sequences), VIBE/lib/core/trainer.py
(alternating generator/discriminator updates).

The generator is the demo's ``TemporalEncoder`` (the 2048 GRU) and
``HMRHead`` (the SPIN regressor, whose mean-parameter rows ``init_pose``,
``init_shape``, ``init_cam`` train too, as in the JAX package); its SMPL
pass is ``smpl_forward``, so a train step launches kernel K1 forward and,
under the generator's gradient, K1 backward. The discriminator's stacked
GRU is one ``nn.GRU`` (cuDNN on the card; the JAX package's per-layer
``lax.scan`` of ``gru_cell``, not a Pallas kernel). cuDNN's GRU has no
backward in eval mode, so a train step puts both networks in train mode;
neither has dropout in its GRU.

Both updates are optax's Adam (``fit/optimizer.GroupAdam``: its f32 bias
correction, eps outside the square root, the ReduceLROnPlateau scale
multiplying the update). A train state is a dict of four entries, as the
JAX package's: ``gen`` (``VibeGenerator``), ``disc``
(``MotionDiscriminator``), ``gen_opt`` and ``disc_opt`` (``GroupAdam``s
over the networks' tensors in the JAX package's flat-key order).
Checkpoints are the JAX package's: ``gen.npz``, ``disc.npz``,
``gen_opt.npz``, ``disc_opt.npz`` under its '/'-joined pytree keys
(``gru/w_ih`` as (in, 3H), ``head/fc1_w`` as (in, out), optax's
``0/.count``, ``0/.mu/<key>``, ``0/.nu/<key>``), so each package loads the
other's.

Dropout (the attention pool's, off on the CLI path) draws from an explicit
``torch.Generator``; JAX's draws cannot be reproduced across RNGs.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import inspect
import os
import os.path as osp
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .. import device_index
from ..body.smpl import SMPLModel
from ..fit.optimizer import GroupAdam
from .hmr import HMRHead, hmr_head_from_jax, init_hmr_head
from .vibe import (TemporalEncoder, gru_from_jax, hmr_forward_from_features,
                   init_gru)

TrainState = Dict[str, object]

# JAX GRU key -> (torch GRU attribute, stored transposed)
_GRU_KEYS = (("w_ih", "weight_ih_l{}", True), ("w_hh", "weight_hh_l{}", True),
             ("b_ih", "bias_ih_l{}", False), ("b_hh", "bias_hh_l{}", False))


# ---------------------------------------------------------------------------
# motion discriminator
# ---------------------------------------------------------------------------

def _dropout(x: torch.Tensor, rate: float,
             generator: torch.Generator) -> torch.Tensor:
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class SelfAttention(nn.Module):
    """Learned per-frame softmax pooling (VIBE/lib/models/attention.py:
    25-78): ``layers - 1`` (Linear size->size, tanh, dropout) blocks, then
    (Linear size->1, tanh, dropout)."""

    def __init__(self, attention_size: int = 1024, layers: int = 1):
        super().__init__()
        self.mlp = nn.ModuleList(
            nn.Linear(attention_size, attention_size if i < layers - 1 else 1)
            for i in range(layers))

    def forward(self, inputs: torch.Tensor, dropout: float = 0.0,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, H) -> ((B, H) weighted sum, (B, T) attention weights).
        Dropout follows each tanh at train time: pass a generator and
        rate > 0."""
        x = inputs
        for layer in self.mlp:
            x = torch.tanh(layer(x))
            if dropout > 0.0 and generator is not None:
                x = _dropout(x, dropout, generator)
        scores = torch.softmax(x[..., 0], dim=-1)
        return torch.einsum('bth,bt->bh', inputs, scores), scores


class MotionDiscriminator(nn.Module):
    """(B, T, 69) pose sequences -> (B, 2) real/fake logits
    (motion_discriminator.py:25-79).

    feature_pool 'concat': relu(GRU outputs), then avg ++ max over time;
    'attention' (both shipped training configs): the SelfAttention pool of
    the raw GRU outputs (no relu on this path). num_layers stacks GRU
    layers (the shipped configs use 2)."""

    def __init__(self, input_size: int = 69, rnn_size: int = 1024,
                 output_size: int = 2, feature_pool: str = "concat",
                 num_layers: int = 1, attention_size: int = 1024,
                 attention_layers: int = 1):
        super().__init__()
        if feature_pool == "attention":
            if attention_size != rnn_size:
                raise ValueError(
                    "the attention MLP consumes GRU outputs directly, so "
                    f"attention_size ({attention_size}) must equal rnn_size "
                    f"({rnn_size}) — same constraint as the reference")
        elif feature_pool != "concat":
            raise ValueError(f"unknown feature_pool {feature_pool!r}")
        self.gru = nn.GRU(input_size, rnn_size, num_layers, batch_first=True)
        linear_size = 2 * rnn_size if feature_pool == "concat" else rnn_size
        self.fc = nn.Linear(linear_size, output_size)
        self.attention = (SelfAttention(attention_size, attention_layers)
                          if feature_pool == "attention" else None)

    def forward(self, seq: torch.Tensor, dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ys, _ = self.gru(seq)                                  # (B, T, H)
        if self.attention is not None:
            y, _scores = self.attention(ys, dropout, generator)
            return self.fc(y)
        ys = torch.relu(ys)
        return self.fc(torch.cat([ys.mean(dim=1), ys.amax(dim=1)], dim=1))


def init_motion_discriminator(generator: torch.Generator,
                              input_size: int = 69, rnn_size: int = 1024,
                              output_size: int = 2,
                              feature_pool: str = "concat",
                              num_layers: int = 1,
                              attention_size: int = 1024,
                              attention_layers: int = 1
                              ) -> MotionDiscriminator:
    """The JAX init's distributions drawn from a torch generator, on the
    CPU: every GRU tensor uniform(+-1/sqrt(rnn_size)), the output linear
    uniform(+-1/sqrt(its width)), attention weights uniform(-0.1, 0.1) with
    biases 0.01 (attention.py:20-23)."""
    disc = MotionDiscriminator(input_size, rnn_size, output_size,
                               feature_pool, num_layers, attention_size,
                               attention_layers)
    s = 1.0 / np.sqrt(rnn_size)
    f = 1.0 / np.sqrt(disc.fc.in_features)
    with torch.no_grad():
        for layer in range(num_layers):
            for _, name, _ in _GRU_KEYS:
                getattr(disc.gru, name.format(layer)).uniform_(
                    -s, s, generator=generator)
        disc.fc.weight.uniform_(-f, f, generator=generator)
        disc.fc.bias.uniform_(-f, f, generator=generator)
        if disc.attention is not None:
            for lin in disc.attention.mlp:
                lin.weight.uniform_(-0.1, 0.1, generator=generator)
                lin.bias.fill_(0.01)
    return disc


def motion_discriminator_from_jax(params: Mapping[str, np.ndarray]
                                  ) -> MotionDiscriminator:
    """The JAX package's discriminator (its flat '/' keys: ``gru/*``,
    ``gru_extra/<i>/*``, ``fc_w``, ``fc_b``, ``att/mlp/<i>/{w,b}``) as the
    module, its sizes read from the arrays. An ``fc_w`` of another width
    than the pool gives (a checkpoint of another pool restored into this
    layout, which the JAX package's template restore allows) is kept as
    it is; that discriminator fails when run, as JAX's does."""
    p = {k: np.asarray(v, np.float32) for k, v in params.items()}
    n_att = sum(1 for k in p if k.startswith("att/mlp/") and k.endswith("/w"))
    n_extra = sum(1 for k in p
                  if k.startswith("gru_extra/") and k.endswith("/w_ih"))
    H = p["gru/w_hh"].shape[0]
    disc = MotionDiscriminator(
        p["gru/w_ih"].shape[0], H, p["fc_w"].shape[1],
        "attention" if n_att else "concat", 1 + n_extra, H, max(n_att, 1))
    if disc.fc.in_features != p["fc_w"].shape[0]:
        disc.fc = nn.Linear(*p["fc_w"].shape)
    _load_flat(_disc_tensors(disc), p)
    return disc


# ---------------------------------------------------------------------------
# generator and the JAX package's flat keys
# ---------------------------------------------------------------------------

class VibeGenerator(nn.Module):
    """VIBE's generator: the temporal encoder and the SPIN regressor."""

    def __init__(self, gru: TemporalEncoder, head: HMRHead):
        super().__init__()
        self.gru = gru
        self.head = head


def _gru_tensors(gru: nn.GRU, layer: int, prefix: str) -> dict:
    return {f"{prefix}/{k}": (getattr(gru, name.format(layer)), tr)
            for k, name, tr in _GRU_KEYS}


def _gen_tensors(gen: VibeGenerator) -> Dict[str, Tuple[torch.Tensor, bool]]:
    """JAX flat key -> (tensor, stored transposed) for the generator."""
    out = _gru_tensors(gen.gru.gru, 0, "gru")
    for name in ("fc1", "fc2", "decpose", "decshape", "deccam"):
        lin = getattr(gen.head, name)
        out[f"head/{name}_w"] = (lin.weight, True)
        out[f"head/{name}_b"] = (lin.bias, False)
    for name in ("init_pose", "init_shape", "init_cam"):
        out[f"head/{name}"] = (getattr(gen.head, name), False)
    return dict(sorted(out.items()))


def _disc_tensors(disc: MotionDiscriminator
                  ) -> Dict[str, Tuple[torch.Tensor, bool]]:
    """JAX flat key -> (tensor, stored transposed) for the discriminator."""
    out = {}
    for layer in range(disc.gru.num_layers):
        out.update(_gru_tensors(disc.gru, layer, "gru" if layer == 0
                                else f"gru_extra/{layer - 1}"))
    out["fc_w"] = (disc.fc.weight, True)
    out["fc_b"] = (disc.fc.bias, False)
    if disc.attention is not None:
        for i, lin in enumerate(disc.attention.mlp):
            out[f"att/mlp/{i}/w"] = (lin.weight, True)
            out[f"att/mlp/{i}/b"] = (lin.bias, False)
    return dict(sorted(out.items()))


def _net_tensors(state: TrainState, net: str):
    return (_gen_tensors if net == "gen" else _disc_tensors)(state[net])


def _to_numpy(t: torch.Tensor, transposed: bool) -> np.ndarray:
    """A copy (a CPU tensor's .numpy() shares its memory)."""
    a = t.detach().cpu().numpy()
    return np.array(a.T if transposed else a, order="C")


@torch.no_grad()
def _load_flat(tensors: Mapping[str, Tuple[torch.Tensor, bool]],
               flat: Mapping[str, np.ndarray], stem: str = "") -> None:
    for k, (t, tr) in tensors.items():
        a = np.array(flat[stem + k], np.float32)
        t.copy_(torch.from_numpy(np.ascontiguousarray(a.T if tr else a)))


def _make_state(gen: VibeGenerator, disc: MotionDiscriminator,
                gen_lr: float, disc_lr: float, device) -> TrainState:
    """Both networks on ``device``, every JAX-keyed tensor trainable (the
    regressor's mean-parameter buffers too), and an Adam over each."""
    gen, disc = gen.to(device), disc.to(device)
    state: TrainState = {"gen": gen, "disc": disc}
    for net, lr in (("gen", gen_lr), ("disc", disc_lr)):
        ts = [t for t, _ in _net_tensors(state, net).values()]
        for t in ts:
            t.requires_grad_(True)
        state[f"{net}_opt"] = GroupAdam(ts, lr)
    return state


def init_vibe_train_state(generator: torch.Generator, smpl: SMPLModel,
                          gen_lr: float = 5e-5, disc_lr: float = 1e-4,
                          feat_size: int = 2048,
                          feature_pool: str = "concat",
                          disc_num_layers: int = 1,
                          attention_size: int = 1024,
                          attention_layers: int = 1,
                          device=None) -> TrainState:
    """Generator (GRU + SPIN head) and motion discriminator with an Adam
    each (Trainer.__init__'s get_optimizer pair), drawn from ``generator``
    and placed on ``device`` (the SMPL model's by default).

    feature_pool/disc_num_layers/attention_*: discriminator architecture
    knobs; the shipped reference training configs use
    feature_pool='attention', num_layers=2, attention 1024x3
    (VIBE/configs/config.yaml:37-47)."""
    gen = VibeGenerator(init_gru(generator, feat_size, feat_size),
                        init_hmr_head(generator, feat_dim=feat_size))
    disc = init_motion_discriminator(
        generator, feature_pool=feature_pool, num_layers=disc_num_layers,
        attention_size=attention_size, attention_layers=attention_layers)
    return _make_state(gen, disc, gen_lr, disc_lr,
                       smpl.device if device is None else device)


def vibe_train_state_from_jax(flat: Mapping[str, Mapping[str, np.ndarray]],
                              device=None, gen_lr: float = 5e-5,
                              disc_lr: float = 1e-4) -> TrainState:
    """A JAX train state as the port's, from its four flat dicts (``gen``,
    ``disc``, ``gen_opt``, ``disc_opt``: the '/'-keyed numpy arrays of its
    checkpoint files). An optimizer state without ``0/.count`` starts
    from zero moments."""
    g = flat["gen"]
    gen = VibeGenerator(
        gru_from_jax({k[4:]: v for k, v in g.items()
                      if k.startswith("gru/")}),
        hmr_head_from_jax({k[5:]: v for k, v in g.items()
                           if k.startswith("head/")}))
    disc = motion_discriminator_from_jax(flat["disc"])
    state = _make_state(gen, disc, gen_lr, disc_lr,
                        torch.device("cpu") if device is None else device)
    for net in ("gen", "disc"):
        opt, o = state[f"{net}_opt"], flat.get(f"{net}_opt", {})
        if "0/.count" not in o:
            continue
        opt.count = int(o["0/.count"])
        tensors = _net_tensors(state, net)
        for moment, stem in ((opt.m, "0/.mu/"), (opt.v, "0/.nu/")):
            _load_flat({k: (m, tr) for (k, (_, tr)), m
                        in zip(tensors.items(), moment)}, o, stem)
    return state


def vibe_train_state_to_jax(state: TrainState
                            ) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse: the four flat dicts of the JAX package's layout."""
    out = {}
    for net in ("gen", "disc"):
        tensors = _net_tensors(state, net)
        out[net] = {k: _to_numpy(t, tr) for k, (t, tr) in tensors.items()}
        opt = state[f"{net}_opt"]
        o = {"0/.count": np.asarray(opt.count, np.int32)}
        for moment, stem in ((opt.m, "0/.mu/"), (opt.v, "0/.nu/")):
            o.update({stem + k: _to_numpy(m, tr) for (k, (_, tr)), m
                      in zip(tensors.items(), moment)})
        out[f"{net}_opt"] = o
    return out


# ---------------------------------------------------------------------------
# VIBE loss (lib/core/loss.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VibeLossWeights:
    kp_2d: float = 300.0
    kp_3d: float = 300.0
    pose: float = 60.0
    shape: float = 0.06
    adv: float = 2.0
    disc_motion_lr: float = 1e-4


def vibe_generator_loss(pred: Dict[str, torch.Tensor],
                        target: Dict[str, torch.Tensor],
                        disc: Optional[MotionDiscriminator],
                        w: VibeLossWeights = VibeLossWeights(),
                        disc_dropout: float = 0.0,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Supervised keypoint/SMPL losses + adversarial generator term.

    pred/target dicts use (B, T, ...) tensors:
      'kp_2d' (B,T,49,3 target w/conf; pred (B,T,49,2)), 'kp_3d' (B,T,14,3),
      'pose' (B,T,72), 'betas' (B,T,10), masks 'has_3d' (B,T).
    """
    metrics = {}
    loss = pred["kp_2d"].new_zeros(())

    conf = target["kp_2d"][..., 2:]
    l2d = (conf * (pred["kp_2d"] - target["kp_2d"][..., :2]) ** 2).mean()
    metrics["loss_kp_2d"] = l2d
    loss = loss + w.kp_2d * l2d

    if "kp_3d" in target:
        kp3 = target["kp_3d"]
        has3d = target.get("has_3d", kp3.new_ones(kp3.shape[:2]))

        def center(j):  # pelvis = mean of hips, VIBE convention
            return j - (j[..., 2:3, :] + j[..., 3:4, :]) / 2

        l3d = (has3d[..., None, None] *
               (center(pred["kp_3d"]) - center(kp3)) ** 2).mean()
        metrics["loss_kp_3d"] = l3d
        loss = loss + w.kp_3d * l3d

    if "pose" in target:
        pose = target["pose"]
        has_smpl = target.get("has_smpl", pose.new_ones(pose.shape[:2]))
        lpose = (has_smpl[..., None] * (pred["pose"] - pose) ** 2).mean()
        lshape = (has_smpl[..., None] *
                  (pred["betas"] - target["betas"]) ** 2).mean()
        metrics["loss_pose"] = lpose
        metrics["loss_shape"] = lshape
        loss = loss + (w.pose * lpose + w.shape * lshape)

    if disc is not None:
        logits = disc(pred["pose_body_seq"], disc_dropout, generator)
        # generator wants the discriminator to label it real (index 1)
        ladv = (logits[:, 0] ** 2 + (logits[:, 1] - 1.0) ** 2).mean()
        metrics["loss_adv"] = ladv
        loss = loss + w.adv * ladv

    metrics["loss_total"] = loss
    return loss, metrics


def vibe_discriminator_loss(disc: MotionDiscriminator,
                            real_seq: torch.Tensor, fake_seq: torch.Tensor,
                            dropout: float = 0.0,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """LSGAN discriminator objective over pose sequences; no gradient
    reaches the fake sequence's generator."""
    real_logits = disc(real_seq, dropout, generator)
    fake_logits = disc(fake_seq.detach(), dropout, generator)
    l_real = ((real_logits[:, 1] - 1.0) ** 2 + real_logits[:, 0] ** 2).mean()
    l_fake = ((fake_logits[:, 0] - 1.0) ** 2 + fake_logits[:, 1] ** 2).mean()
    return l_real + l_fake


def _adam_step(state: TrainState, net: str, loss: torch.Tensor, lr: float,
               lr_scale) -> None:
    """One optax-Adam update of ``state[net]`` from loss's gradient."""
    opt: GroupAdam = state[f"{net}_opt"]
    grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
    for p, g in zip(opt.params, grads):
        p.grad = g
    opt.step(lr_scale, lr=lr)
    for p in opt.params:
        p.grad = None


def make_discriminator_train_step(lr: float = 1e-4, dropout: float = 0.0):
    """(init, step): ``init(disc)`` makes the discriminator's Adam,
    ``step(disc, opt, real_seq, fake_seq, generator=None)`` updates both in
    place and returns (disc, opt, loss). dropout: the attention pool's rate
    at train time (the shipped configs use 0.5, config.yaml:47
    ATT.DROPOUT default); pass a generator per call to activate it."""

    def init(disc: MotionDiscriminator) -> GroupAdam:
        return GroupAdam([t for t, _ in _disc_tensors(disc).values()], lr)

    def step(disc, opt, real_seq, fake_seq, generator=None):
        disc.train()
        loss = vibe_discriminator_loss(disc, real_seq, fake_seq, dropout,
                                       generator)
        _adam_step({"disc": disc, "disc_opt": opt}, "disc", loss, lr, None)
        return disc, opt, loss.detach()

    return init, step


# ---------------------------------------------------------------------------
# full trainer (lib/core/trainer.py Trainer.fit/train/validate/evaluate)
# ---------------------------------------------------------------------------

# SPIN-49 -> common-14 gather for the 3D loss / eval joint set: the
# reference stores kp_3d in 'common' order (dataset_3d convert_kps) whose
# hips sit at indices 2/3 — the pelvis convention both the loss and the
# eval root-centering rely on.
_SPIN_TO_COMMON = (25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38)


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _tensor(x, device) -> torch.Tensor:
    """A numpy array (or tensor) as a float32 tensor on device."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                           dtype=torch.float32, device=device)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def vibe_predict(gen: VibeGenerator, smpl: SMPLModel, feats: torch.Tensor,
                 n_iter: int = 3) -> Dict[str, torch.Tensor]:
    """(B, T, F) features -> (B, T, ...) predictions: theta (85), kp_2d
    (49, 2), kp_3d common-14, verts, pose/betas splits. Per-frame betas,
    so SMPL takes its vertex path at (B T, V)."""
    B, T = feats.shape[:2]
    y = gen.gru(feats)
    out = hmr_forward_from_features(gen.head, smpl, y.reshape(B * T, -1),
                                    n_iter)
    out = {k: v.reshape((B, T) + v.shape[1:]) for k, v in out.items()}
    theta = out["theta"]
    return {
        "theta": theta,
        "kp_2d": out["kp_2d"],
        "kp_3d": out["kp_3d"][..., device_index(_SPIN_TO_COMMON,
                                                theta.device), :],
        "verts": out["verts"],
        "pose": theta[..., 3:75],
        "betas": theta[..., 75:],
        "pose_body_seq": theta[..., 6:75],
    }


def make_vibe_train_step(smpl: SMPLModel,
                         w: VibeLossWeights = VibeLossWeights(),
                         gen_lr: float = 5e-5, n_iter: int = 3,
                         disc_dropout: float = 0.0) -> Callable:
    """One update per batch, in place: the generator's (supervised +
    adversarial, through K1b), then the discriminator's on AMASS-real vs
    the fake motion the generator predicted before its update
    (Trainer.train's two backprops, trainer.py:117-247). Adam at gen_lr and
    w.disc_motion_lr, each update times ``lr_scale`` (the twin
    ReduceLROnPlateau schedulers, train.py:119-133, trainer.py:322-326).

    batch keys ((B, T, ...), numpy or tensors): 'features', 'kp_2d' (49, 3
    w/conf), optional 'kp_3d' (common-14), 'pose' (72), 'betas' (10),
    'has_3d'/'has_smpl' (B, T) masks. real_motion: (B', T, 69) AMASS
    body-pose sequences for the discriminator. Returns (state, metrics:
    0-d tensors on the device)."""

    def step(state: TrainState, batch, real_motion,
             generator: Optional[torch.Generator] = None, lr_scale=1.0):
        gen, disc = state["gen"], state["disc"]
        gen.train()
        disc.train()
        dev = _device(gen)
        b = {k: _tensor(v, dev) for k, v in batch.items()}
        real = _tensor(real_motion, dev)
        pred = vibe_predict(gen, smpl, b["features"], n_iter)
        target = {k: b[k] for k in
                  ("kp_2d", "kp_3d", "pose", "betas", "has_3d", "has_smpl")
                  if k in b}
        loss, metrics = vibe_generator_loss(pred, target, disc, w,
                                            disc_dropout, generator)
        _adam_step(state, "gen", loss, gen_lr, lr_scale)
        d_loss = vibe_discriminator_loss(disc, real, pred["pose_body_seq"],
                                         disc_dropout, generator)
        _adam_step(state, "disc", d_loss, w.disc_motion_lr, lr_scale)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["d_m_disc_loss"] = d_loss.detach()
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# evaluation metrics (lib/utils/eval_utils.py + Trainer.evaluate)
# ---------------------------------------------------------------------------

def compute_accel(joints: np.ndarray) -> np.ndarray:
    """Mean joint acceleration magnitude per frame (eval_utils.py:11-22);
    joints (N, J, 3) along a time axis."""
    vel = joints[1:] - joints[:-1]
    acc = vel[1:] - vel[:-1]
    return np.linalg.norm(acc, axis=2).mean(axis=1)


def compute_error_accel(joints_gt: np.ndarray, joints_pred: np.ndarray
                        ) -> np.ndarray:
    """Acceleration error |a_pred - a_gt| (eval_utils.py:69-97)."""
    accel_gt = joints_gt[:-2] - 2 * joints_gt[1:-1] + joints_gt[2:]
    accel_pred = joints_pred[:-2] - 2 * joints_pred[1:-1] + joints_pred[2:]
    return np.linalg.norm(accel_pred - accel_gt, axis=2).mean(axis=1)


def evaluate_vibe(pred_j3d: np.ndarray, target_j3d: np.ndarray,
                  pred_verts: Optional[np.ndarray] = None,
                  target_verts: Optional[np.ndarray] = None
                  ) -> Dict[str, float]:
    """MPJPE / PA-MPJPE / accel / accel_err (+PVE) in mm over common-14
    joints, pelvis = mean of hips at indices 2/3 (Trainer.evaluate,
    trainer.py:389-437)."""
    from ..geometry.procrustes import similarity_transform_np

    pred = np.asarray(pred_j3d, np.float64)
    gt = np.asarray(target_j3d, np.float64)
    pred = pred - (pred[:, 2:3] + pred[:, 3:4]) / 2
    gt = gt - (gt[:, 2:3] + gt[:, 3:4]) / 2

    mpjpe = np.linalg.norm(pred - gt, axis=-1).mean(axis=-1)
    pa = np.stack([similarity_transform_np(p, g)[0]
                   for p, g in zip(pred, gt)])
    pa_mpjpe = np.linalg.norm(pa - gt, axis=-1).mean(axis=-1)

    m2mm = 1000.0
    out = {
        "mpjpe": float(mpjpe.mean() * m2mm),
        "pa-mpjpe": float(pa_mpjpe.mean() * m2mm),
        "accel": float(compute_accel(pred).mean() * m2mm),
        "accel_err": float(
            compute_error_accel(gt, pred).mean() * m2mm),
    }
    if pred_verts is not None and target_verts is not None:
        out["pve"] = float(np.linalg.norm(
            np.asarray(pred_verts) - np.asarray(target_verts),
            axis=-1).mean() * m2mm)
    return out


def save_vibe_state(path: str, state: TrainState) -> None:
    """Save the train state (gen/disc params + optimizer states) in the
    JAX package's layout — the reference's checkpoint payload
    (Trainer.save_model, trainer.py:450-470). The npz files are stored
    uncompressed (the JAX package deflates them; np.load reads either):
    float weights and moments barely deflate, and zlib takes tens of
    seconds over the shipped width's half a gigabyte."""
    os.makedirs(path, exist_ok=True)
    for k, flat in vibe_train_state_to_jax(state).items():
        np.savez(osp.join(path, f"{k}.npz"), **flat)


def load_vibe_state(path: str, state: TrainState) -> TrainState:
    """Restore a checkpoint of either package into a template train state,
    as the JAX package's ``_restore_tree``: each of the template's keys
    the files hold is read from them, the rest keep the template's values,
    extra entries are ignored. Returns a new state on the template's
    device with its learning rates."""
    flat = vibe_train_state_to_jax(state)
    for k in flat:
        with np.load(osp.join(path, f"{k}.npz")) as z:
            flat[k].update({n: z[n] for n in z.files if n in flat[k]})
    return vibe_train_state_from_jax(
        flat, _device(state["gen"]), state["gen_opt"].lr,
        state["disc_opt"].lr)


def vibe_trainer_fit(state: TrainState, step_fn, smpl: SMPLModel,
                     train_batches, valid_batches=None,
                     real_motion_batches=None,
                     epochs: int = 1,
                     lr_patience: int = 5,
                     log_fn=print,
                     debug_viz_every: int = 0,
                     debug_viz_dir: str = "",
                     mpjpe_abort: float = 0.0
                     ) -> Tuple[TrainState, Dict[str, float]]:
    """Epoch loop: train over batches, validate, evaluate (Trainer.fit,
    trainer.py:314-344). Iterables are callables returning fresh iterators
    (the reference's re-created DataLoader iterators). Returns the final
    state and the best eval dict; performance = PA-MPJPE like the
    reference's scheduler/checkpoint metric.

    debug_viz_every=N draws a pred-vs-GT keypoint panel of the first
    train batch every N epochs into debug_viz_dir (trainer.py:233,294;
    render/keypoints.render_vibe_debug_panel); where matplotlib is not
    installed it prints the path it skipped and trains on.

    lr_patience drives the twin ReduceLROnPlateau schedulers (factor 0.1,
    stepped on the eval metric each epoch) as a shared update scale passed
    into step_fn. mpjpe_abort>0 reproduces the `performance > 80` abort
    (trainer.py:342) at the given threshold (off by default)."""
    takes_lr = "lr_scale" in inspect.signature(step_fn).parameters
    lr_scale, n_bad, plateau_best = 1.0, 0, float("inf")
    best = {"pa-mpjpe": float("inf")}
    dev = smpl.device
    for epoch in range(epochs):
        real_iter = iter(real_motion_batches()) \
            if real_motion_batches else None
        first_batch = None
        for batch in train_batches():
            if first_batch is None:
                first_batch = batch
            if real_iter is None:
                real = batch["pose"][..., 3:] if "pose" in batch else \
                    np.zeros(batch["features"].shape[:2] + (69,), np.float32)
            else:
                try:
                    real = next(real_iter)
                except StopIteration:
                    real_iter = iter(real_motion_batches())
                    real = next(real_iter)
            if takes_lr:   # the f32 scale JAX's step is handed
                state, metrics = step_fn(state, batch, real,
                                         lr_scale=float(np.float32(lr_scale)))
            else:
                state, metrics = step_fn(state, batch, real)
        if (debug_viz_every > 0 and debug_viz_dir
                and epoch % debug_viz_every == 0 and first_batch is not None):
            png = osp.join(debug_viz_dir, f"debug_epoch{epoch:04d}.png")
            if importlib.util.find_spec("matplotlib") is None:
                print(f"[vibe_train] matplotlib is not installed: skipped "
                      f"{png}")
            else:
                from ..render.keypoints import render_vibe_debug_panel
                with torch.no_grad():
                    pred = vibe_predict(state["gen"], smpl,
                                        _tensor(first_batch["features"], dev))
                render_vibe_debug_panel(png, _numpy(pred["kp_2d"][0]),
                                        _numpy(first_batch["kp_2d"][0]))
        if valid_batches is None:
            continue
        preds, gts = [], []
        with torch.no_grad():
            for vb in valid_batches():
                p = vibe_predict(state["gen"], smpl,
                                 _tensor(vb["features"], dev))
                preds.append(_numpy(p["kp_3d"]).reshape(-1, 14, 3))
                gts.append(_numpy(vb["kp_3d"]).reshape(-1, 14, 3))
        perf = evaluate_vibe(np.concatenate(preds), np.concatenate(gts))
        log_fn(f"[vibe] epoch {epoch}: " + " ".join(
            f"{k}={v:.2f}" for k, v in perf.items())
            + f" lr_scale={lr_scale:g}")
        if perf["pa-mpjpe"] < best["pa-mpjpe"]:
            best = perf
        # ReduceLROnPlateau(mode=min, factor=0.1, threshold=1e-4)
        p = perf["pa-mpjpe"]
        if p < plateau_best * (1.0 - 1e-4):
            plateau_best, n_bad = p, 0
        else:
            n_bad += 1
            if n_bad > lr_patience:
                lr_scale *= 0.1
                n_bad = 0
                log_fn(f"[vibe] plateau: lr_scale -> {lr_scale:g}")
        if mpjpe_abort > 0 and perf["mpjpe"] > mpjpe_abort:
            log_fn(f"[vibe] MPJPE {perf['mpjpe']:.1f} > {mpjpe_abort}; "
                   "aborting (trainer.py:342)")
            break
    return state, best
