"""HuMoR: the CVAE latent-dynamics motion prior, in PyTorch.

Port of nemo_tpu/models/humor.py (behavioral reference:
humor/humor/models/humor_model.py): the posterior/prior/decoder MLPs with
GroupNorm and latent skip connections, residual ("delta") decoding with
rotation composition, the world <-> aligned-local frame helpers and the
autoregressive rollout, here a Python loop over steps (the reference's own
form of the JAX package's ``lax.scan``).

Parameters are the JAX package's nested dict ({"encoder", "decoder",
"prior"} -> {"w0", "b0", "gn1_g", ...}) with tensors for arrays; weights
are (in, out) as in JAX. ``humor_from_numpy`` carries a JAX parameter tree
across. No kernel runs here: the rollout is 1024-wide matmuls.

State layout ('smpl+joints' config, axis-angle rotations):
  trans(3) trans_vel(3) root_orient(3) root_orient_vel(3)
  pose_body(63) joints(66) joints_vel(66)                      -> D = 207
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..geometry.rotations import batch_rodrigues, rotmat_to_aa

Params = Dict[str, Dict[str, torch.Tensor]]

# (name, dim, is_rotation) — the 'smpl+joints' data config
STATE_FIELDS = (
    ("trans", 3, False),
    ("trans_vel", 3, False),
    ("root_orient", 3, True),
    ("root_orient_vel", 3, False),
    ("pose_body", 63, True),
    ("joints", 66, False),
    ("joints_vel", 66, False),
)
STATE_DIM = sum(d for _, d, _ in STATE_FIELDS)  # 207
NUM_CONTACTS = 9


@dataclasses.dataclass(frozen=True)
class HumorConfig:
    latent_size: int = 48
    steps_in: int = 1
    conditional_prior: bool = True
    output_delta: bool = True
    pred_contacts: bool = True
    num_groups: int = 16  # GroupNorm groups

    @property
    def input_dim(self) -> int:
        return self.steps_in * STATE_DIM

    @property
    def output_dim(self) -> int:
        return STATE_DIM + (NUM_CONTACTS if self.pred_contacts else 0)


def split_state(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    out, s = {}, 0
    for name, d, _ in STATE_FIELDS:
        out[name] = x[..., s:s + d]
        s += d
    return out


def pack_state(d: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([d[name] for name, _, _ in STATE_FIELDS], dim=-1)


# ---------------------------------------------------------------------------
# MLP with GroupNorm + latent skip (humor_model.py MLP :1209-1244)
# ---------------------------------------------------------------------------

def _group_norm(x: torch.Tensor, gamma, beta, groups: int,
                eps: float = 1e-5) -> torch.Tensor:
    B, D = x.shape
    xg = x.reshape(B, groups, D // groups)
    m = xg.mean(dim=2, keepdim=True)
    v = ((xg - m) ** 2).mean(dim=2, keepdim=True)
    xg = (xg - m) / torch.sqrt(v + eps)
    return xg.reshape(B, D) * gamma + beta


def _lin_init(gen: torch.Generator, i: int, o: int):
    s = 1.0 / np.sqrt(i)
    w = (torch.rand((i, o), generator=gen) * 2.0 - 1.0) * s
    b = (torch.rand((o,), generator=gen) * 2.0 - 1.0) * s
    return w, b


def init_mlp(gen: torch.Generator, layers, skip_size: int = 0
             ) -> Dict[str, torch.Tensor]:
    """layers[0] = in (incl. skip), rest = widths; GroupNorm between. The
    same shapes and uniform(-1/sqrt(in), 1/sqrt(in)) law as nemo_tpu's
    init_mlp, drawn from a torch.Generator (so not the same numbers)."""
    p: Dict[str, torch.Tensor] = {}
    p["w0"], p["b0"] = _lin_init(gen, layers[0], layers[1])
    prev = layers[1]
    for i in range(2, len(layers)):
        p[f"gn{i - 1}_g"] = torch.ones(prev)
        p[f"gn{i - 1}_b"] = torch.zeros(prev)
        p[f"w{i - 1}"], p[f"b{i - 1}"] = _lin_init(gen, prev + skip_size,
                                                   layers[i])
        prev = layers[i]
    return p


def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, n_layers: int,
              num_groups: int, skip_in: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """n_layers = number of Linear layers."""
    x = x @ p["w0"] + p["b0"]
    for i in range(1, n_layers):
        x = _group_norm(x, p[f"gn{i}_g"], p[f"gn{i}_b"], num_groups)
        x = torch.relu(x)
        if skip_in is not None:
            x = torch.cat([x, skip_in], dim=1)
        x = x @ p[f"w{i}"] + p[f"b{i}"]
    return x


# ---------------------------------------------------------------------------
# HuMoR model
# ---------------------------------------------------------------------------

def init_humor(gen: torch.Generator, cfg: HumorConfig = HumorConfig(),
               device=None) -> Params:
    """Random HuMoR parameters at the reference widths: encoder and prior
    4 x 1024, decoder 1024-1024-512, GroupNorm in 16 groups."""
    D, L = cfg.input_dim, cfg.latent_size
    params = {
        "encoder": init_mlp(gen, [2 * D, 1024, 1024, 1024, 1024, 2 * L]),
        "decoder": init_mlp(gen, [D + L, 1024, 1024, 512, cfg.output_dim],
                            skip_size=L),
    }
    if cfg.conditional_prior:
        params["prior"] = init_mlp(gen, [D, 1024, 1024, 1024, 1024, 2 * L])
    return humor_to(params, device)


def humor_to(params: Params, device) -> Params:
    """The parameter tree on ``device``."""
    return {m: {k: v.to(device) for k, v in sub.items()}
            for m, sub in params.items()}


def humor_from_numpy(params, device=None) -> Params:
    """Port parameters from a nemo_tpu HuMoR tree (``init_humor``'s nested
    dict, any array type ``np.asarray`` reads), f32 on ``device``."""
    return {m: {k: torch.tensor(np.asarray(v, np.float32), device=device)
                for k, v in sub.items()} for m, sub in params.items()}


def humor_posterior(p: Params, cfg: HumorConfig, past: torch.Tensor,
                    t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    out = apply_mlp(p["encoder"], torch.cat([past, t], dim=1), 5,
                    cfg.num_groups)
    mu, logvar = out[:, :cfg.latent_size], out[:, cfg.latent_size:]
    return mu, torch.exp(logvar)


def humor_prior(p: Params, cfg: HumorConfig, past: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    if not cfg.conditional_prior:
        B = past.shape[0]
        return (past.new_zeros((B, cfg.latent_size)),
                past.new_ones((B, cfg.latent_size)))
    out = apply_mlp(p["prior"], past, 5, cfg.num_groups)
    mu, logvar = out[:, :cfg.latent_size], out[:, cfg.latent_size:]
    return mu, torch.exp(logvar)


def _compose_rotation_delta(delta_aa: torch.Tensor, base_aa: torch.Tensor
                            ) -> torch.Tensor:
    """Residual rotation composition (decode :467-480): R_out = dR @ R_in."""
    J = delta_aa.shape[-1] // 3
    dR = batch_rodrigues(delta_aa.reshape(-1, J, 3))
    R = batch_rodrigues(base_aa.reshape(-1, J, 3))
    return rotmat_to_aa(torch.matmul(dR, R)).reshape(delta_aa.shape)


def humor_decode(p: Params, cfg: HumorConfig, z: torch.Tensor,
                 past: torch.Tensor
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Latent + past -> next state (+contact logits). With output_delta,
    non-rotation fields add the residual and rotation fields compose
    (decode :445-498)."""
    out = apply_mlp(p["decoder"], torch.cat([past, z], dim=1), 4,
                    cfg.num_groups, skip_in=z)
    contacts = out[:, STATE_DIM:] if cfg.pred_contacts else None
    delta = out[:, :STATE_DIM]
    if not cfg.output_delta:
        return delta, contacts
    prev = past[:, -STATE_DIM:]  # most recent step
    d, pv = split_state(delta), split_state(prev)
    nxt = {}
    for name, _, is_rot in STATE_FIELDS:
        if is_rot:
            nxt[name] = _compose_rotation_delta(d[name], pv[name])
        else:
            nxt[name] = d[name] + pv[name]
    return pack_state(nxt), contacts


# ---------------------------------------------------------------------------
# World <-> aligned-local frame (humor/utils/transforms.py:17-58 +
# humor_model.py:696-775 apply_world2local_trans)
# ---------------------------------------------------------------------------

def _xy_zero(v: torch.Tensor) -> torch.Tensor:
    """(B, 3) -> (-v_x, -v_y, 0)."""
    return torch.cat([-v[:, :2], torch.zeros_like(v[:, :1])], dim=1)


def compute_aligned_from_right(body_right: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotation (about world z) aligning body_right (B, 3) to world +x:
    project to the xy plane, acos the x component, axis from the cross
    product with +x (transforms.py:17-31); returns (mat, axis-angle)."""
    eps = 1e-6
    x_proj = body_right[:, 0:1] / (
        torch.linalg.norm(body_right[:, :2], dim=1, keepdim=True) + eps)
    angle = torch.arccos(torch.clamp(x_proj, -1.0, 1.0))
    flat = body_right * body_right.new_tensor([1.0, 1.0, 0.0])
    x_axis = body_right.new_tensor([1.0, 0.0, 0.0]).expand_as(flat)
    axis = torch.linalg.cross(flat, x_axis, dim=1)
    aa = axis / (torch.linalg.norm(axis, dim=1, keepdim=True) + eps) * angle
    return batch_rodrigues(aa), aa


def compute_world2aligned_mat(rot: torch.Tensor) -> torch.Tensor:
    """Heading-removal rotation for root orientation matrices (B, 3, 3)
    (transforms.py:33-42: body right = -R[:, :, 0])."""
    mat, _ = compute_aligned_from_right(-rot[:, :, 0])
    return mat


def compute_world2aligned_joints_mat(joints: torch.Tensor) -> torch.Tensor:
    """Same from joints (B, J, 3): right = rightUpLeg - leftUpLeg
    (transforms.py:45-58; SMPL_JOINTS left/rightUpLeg = 1/2)."""
    right = joints[:, 2] - joints[:, 1]
    right = right / torch.linalg.norm(right, dim=1, keepdim=True)
    mat, _ = compute_aligned_from_right(right)
    return mat


def apply_world2local_state(state: torch.Tensor, rot: torch.Tensor,
                            trans: torch.Tensor, trans2joint: torch.Tensor,
                            invert: bool = False) -> torch.Tensor:
    """A world->local transform of a packed (B, D) state
    (humor_model.py:696-775): root_orient composes (W @ R), trans
    translates then rotates, joints shift by trans + trans2joint then rotate
    back off the trans2joint offset, velocity fields only rotate, pose_body
    is untouched. rot: (B, 3, 3); trans, trans2joint: (B, 3)."""
    B = state.shape[0]
    W = rot.transpose(1, 2) if invert else rot
    d = split_state(state)
    out = dict(d)
    R = batch_rodrigues(d["root_orient"])
    out["root_orient"] = rotmat_to_aa(torch.matmul(W, R))
    if invert:
        out["trans"] = torch.einsum("bij,bj->bi", W, d["trans"]) - trans
    else:
        out["trans"] = torch.einsum("bij,bj->bi", W, d["trans"] + trans)
    J = d["joints"].shape[1] // 3
    pts = d["joints"].reshape(B, J, 3)
    if invert:
        pts = pts + trans2joint[:, None, :]
        pts = torch.einsum("bij,bkj->bki", W, pts)
        pts = pts - trans2joint[:, None, :] - trans[:, None, :]
    else:
        pts = pts + trans[:, None, :] + trans2joint[:, None, :]
        pts = torch.einsum("bij,bkj->bki", W, pts)
        pts = pts - trans2joint[:, None, :]
    out["joints"] = pts.reshape(B, J * 3)
    vel = d["joints_vel"].reshape(B, J, 3)
    out["joints_vel"] = torch.einsum("bij,bkj->bki", W, vel).reshape(B, J * 3)
    out["trans_vel"] = torch.einsum("bij,bj->bi", W, d["trans_vel"])
    out["root_orient_vel"] = torch.einsum("bij,bj->bi", W,
                                          d["root_orient_vel"])
    return pack_state(out)


def canonicalize_state(state: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World state -> aligned local frame; returns (local_state, rot, trans)
    with the world2local transform (roll_out's canonicalize_input,
    humor_model.py:813-837)."""
    d = split_state(state)
    rot = compute_world2aligned_mat(batch_rodrigues(d["root_orient"]))
    trans = _xy_zero(d["trans"])
    # world-frame trans2joint (:831-834): -(root joint xy + trans offset)
    t2j = _xy_zero(d["joints"][:, :3] + trans)
    return apply_world2local_state(state, rot, trans, t2j), rot, trans


def _trans2joint(state: torch.Tensor) -> torch.Tensor:
    """-root-joint xy offset, constant over a rollout (:867-869)."""
    return _xy_zero(split_state(state)["joints"][:, :3])


def humor_roll_out(p: Params, cfg: HumorConfig, x0: torch.Tensor,
                   num_steps: int, generator: Optional[torch.Generator] = None,
                   use_mean: bool = False,
                   z_seq: Optional[torch.Tensor] = None,
                   canonicalize: bool = False) -> Dict[str, torch.Tensor]:
    """Autoregressive rollout sampling the (conditional) prior each step.

    x0: (B, D) initial state. Returns {'states': (B, T, D), 'z': (B, T, L),
    'contacts': (B, T, 9), 'prior_mean', 'prior_var'}: the reference's
    roll_out (:785-1020), one loop iteration a step. z comes from z_seq
    (B, T, L) when given, else the prior mean (use_mean) or a prior sample
    drawn with ``generator``. canonicalize=True re-expresses x0 in its
    aligned local frame, feeds the model aligned-local inputs and maps the
    emitted states back to the world frame through the accumulated
    world2local transform (:965-1010).
    """
    B = x0.shape[0]

    def sample(past, i):
        pm, pv = humor_prior(p, cfg, past)
        if z_seq is not None:
            z = z_seq[:, i]
        elif use_mean:
            z = pm
        else:
            eps = torch.randn(pm.shape, generator=generator).to(pm.device)
            z = pm + eps * torch.sqrt(pv)
        pred, contacts = humor_decode(p, cfg, z, past)
        if contacts is None:
            contacts = pred.new_zeros((B, 0))
        return pred, z, contacts, pm, pv

    outs = []
    if not canonicalize:
        past = x0
        for i in range(num_steps):
            pred, z, contacts, pm, pv = sample(past, i)
            outs.append((pred, z, contacts, pm, pv))
            past = pred
    else:
        past, g_rot, g_trans = canonicalize_state(x0)
        t2j = _trans2joint(past)
        for i in range(num_steps):
            pred, z, contacts, pm, pv = sample(past, i)
            # world-frame output through the accumulated transform (:995)
            world = apply_world2local_state(pred, g_rot, g_trans, t2j,
                                            invert=True)
            # heading/xy removal for the next input (:965-975)
            g_trans = _xy_zero(split_state(world)["trans"])
            dp = split_state(pred)
            w2a_rot = compute_world2aligned_mat(
                batch_rodrigues(dp["root_orient"]))
            past = apply_world2local_state(pred, w2a_rot,
                                           _xy_zero(dp["trans"]), t2j)
            g_rot = torch.matmul(g_rot, w2a_rot)
            outs.append((world, z, contacts, pm, pv))
    names = ("states", "z", "contacts", "prior_mean", "prior_var")
    return {n: torch.stack([o[k] for o in outs], dim=1)
            for k, n in enumerate(names)}


def humor_infer_seq(p: Params, cfg: HumorConfig, states: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """Posterior latents for every transition of (B, T, D) state sequences
    (the core of the reference's infer / infer_global_seq): each
    (state_t, state_t+1) pair is encoded; the conditional prior and the
    per-transition KL, the sequence's likelihood under the motion prior,
    come with them."""
    B, T, D = states.shape
    past = states[:, :-1].reshape(B * (T - 1), D)
    nxt = states[:, 1:].reshape(B * (T - 1), D)
    qm, qv = humor_posterior(p, cfg, past, nxt)
    pm, pv = humor_prior(p, cfg, past)
    kl_per = 0.5 * (torch.log(pv) - torch.log(qv)
                    + (qv + (qm - pm) ** 2) / pv - 1.0).sum(-1)
    shape = (B, T - 1)
    return {"z_mean": qm.reshape(shape + (-1,)),
            "z_var": qv.reshape(shape + (-1,)),
            "prior_mean": pm.reshape(shape + (-1,)),
            "prior_var": pv.reshape(shape + (-1,)),
            "kl": kl_per.reshape(shape)}


def humor_transition_prior_loss(p: Params, cfg: HumorConfig,
                                states: torch.Tensor) -> torch.Tensor:
    """Mean KL(posterior || conditional prior) over the transitions of
    (B, T, D) state sequences: the dynamics-prior regularizer of the
    custom entry's weight_humor_loss term."""
    return humor_infer_seq(p, cfg, states)["kl"].mean()


def convert_humor_state_dict(sd: dict, cfg: HumorConfig = HumorConfig(),
                             device=None) -> Params:
    """A torch HuMoR state dict (numpy- or tensor-valued, possibly
    DataParallel-prefixed) in this module's layout. The reference MLP
    (humor_model.py:1209-1244) is a ModuleList [Linear, (GroupNorm, ReLU,
    Linear)*]: the k-th Linear sits at index 3k and the GroupNorm before it
    at 3k-2; modules encoder / decoder / prior_net. Linear weights
    transpose from torch's (out, in)."""
    def get(k):
        for prefix in ("", "module."):
            if prefix + k in sd:
                v = sd[prefix + k]
                v = v.detach().cpu() if hasattr(v, "detach") else v
                return torch.tensor(np.asarray(v, np.float32), device=device)
        raise KeyError(k)

    def mlp(name, n_linear):
        p: Dict[str, torch.Tensor] = {}
        for k in range(n_linear):
            p[f"w{k}"] = get(f"{name}.net.{3 * k}.weight").t().contiguous()
            p[f"b{k}"] = get(f"{name}.net.{3 * k}.bias")
            if k >= 1:
                p[f"gn{k}_g"] = get(f"{name}.net.{3 * k - 2}.weight")
                p[f"gn{k}_b"] = get(f"{name}.net.{3 * k - 2}.bias")
        return p

    out = {"encoder": mlp("encoder", 5), "decoder": mlp("decoder", 4)}
    if cfg.conditional_prior:
        out["prior"] = mlp("prior_net", 5)
    return out


def load_humor(path: str, cfg: HumorConfig = HumorConfig(), device=None
               ) -> Params:
    """A HuMoR checkpoint file ({'model': state_dict, ...}, the state dict
    possibly DataParallel-prefixed) on ``device``."""
    # the checkpoints pickle more than tensors; torch >= 2.6 defaults to
    # weights_only=True, which refuses them
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return convert_humor_state_dict(ckpt.get("model", ckpt), cfg, device)
