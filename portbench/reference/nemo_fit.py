"""The NeMo main stage in plain float32 PyTorch: the reference that the
fit's timed path is held to.

One step is the reference's NemoV3 step (NeMo, Wang et al. 2022): each
sample (view v, frame f) takes its raw phase f / (F - 1) through view v's
monotonic warp and the RBF embedding, appends view v's instance code, and
the MotionNet (a 3-layer ReLU trunk and linear 6D-rotation and translation
heads) gives SMPL's rotations and a translation, less the translation at
phase 0. SMPL's 49 joints, projected through view v's learned camera, meet
the 2D labels under the Geman-McClure loss, averaged per view. The priors
are VPoser's mean-latent reconstruction compared mesh to mesh (L1, the
reconstruction detached), VPoser's KL, the GMM's max-mixture NLL, and the
3D loss against the initializer's theta. The groups step under Adam with
L2 weight decay in the gradient (torch.optim.Adam).

Inputs are the benchmark's, as both sides get them: raw SMPL, VPoser and
GMM arrays, the 2D labels, the initializer's theta and the starting
parameters by name. Everything the program derives from them (fused joint
tables, precisions, collated labels) is worked out here again.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .body import Body, rodrigues, rot6d_to_rotmat, rotmat_to_aa

# NemoV0-V3 project SPIN joint 38 (top of head) in place of the OpenPose
# nose, then OpenPose joints 1..24
PROJ_JOINTS = (38,) + tuple(range(1, 25))
FOCAL = 5000.0
RHO = 100.0


def gmof(r: torch.Tensor) -> torch.Tensor:
    return RHO ** 2 * r ** 2 / (r ** 2 + RHO ** 2)


class Priors:
    """VPoser (eval mode) and the GMM, from the raw arrays."""

    def __init__(self, vposer: Dict[str, torch.Tensor], gmm_means, gmm_covs,
                 gmm_weights):
        self.vp = vposer
        covs = gmm_covs.double()
        self.means = gmm_means.float()
        self.precisions = torch.linalg.inv(covs).float()
        # SMPLify's normalisation: weights over (2 pi)^(D/2) sqrt(det),
        # the determinants relative to the smallest
        sqrdet = torch.sqrt(torch.linalg.det(covs))
        const = (2 * math.pi) ** (gmm_means.shape[1] / 2.0)
        self.nll_weights = (gmm_weights.double() / (
            const * sqrdet / sqrdet.min())).float()

    def encode(self, x):
        p = self.vp

        def bn(x, n):
            return (x - p[f"{n}_mean"]) / torch.sqrt(p[f"{n}_var"] + 1e-5) \
                * p[f"{n}_gamma"] + p[f"{n}_beta"]
        x = bn(x, "bn0")
        x = F.leaky_relu(x @ p["enc_w1"] + p["enc_b1"], 0.01)
        x = bn(x, "bn1")
        x = x @ p["enc_w2"] + p["enc_b2"]
        x = x @ p["enc_w3"] + p["enc_b3"]
        return x @ p["mu_w"] + p["mu_b"], F.softplus(
            x @ p["logvar_w"] + p["logvar_b"])

    def decode_aa(self, z):
        p = self.vp
        x = F.leaky_relu(z @ p["dec_w1"] + p["dec_b1"], 0.01)
        x = F.leaky_relu(x @ p["dec_w2"] + p["dec_b2"], 0.01)
        x = x @ p["dec_w3"] + p["dec_b3"]
        return rotmat_to_aa(rot6d_to_rotmat(x.reshape(-1, 21, 6)))

    def gmm_nll(self, pose):
        diff = pose[:, None, :] - self.means[None]
        quad = torch.einsum('bmi,mij,bmj->bm', diff, self.precisions, diff)
        return (0.5 * quad - torch.log(self.nll_weights)[None]).min(1).values


def _warp(shifts, scales, x):
    def one(x):
        return torch.sigmoid(F.relu(scales) * (x - F.relu(shifts))).mean(
            -1, keepdim=True)
    y0, y1 = one(torch.zeros_like(x)), one(torch.ones_like(x))
    return (one(x) - y0) / (y1 - y0 + 1e-6)


def _motion(P, x):
    h = F.relu(x @ P["motion.trunk.W1"] + P["motion.trunk.b1"])
    h = F.relu(h @ P["motion.trunk.W2"] + P["motion.trunk.b2"])
    z = F.relu(h @ P["motion.trunk.W3"] + P["motion.trunk.b3"])
    return (z @ P["motion.W_rot"] + P["motion.b_rot"],
            z @ P["motion.W_lin"] + P["motion.b_lin"])


def _embed(P, phase, codes):
    K = P["rbf.log_sigmas"].shape[0]
    c = torch.linspace(0.0, 1.0, K, device=phase.device)
    d = (phase - c[None]) ** 2 / torch.exp(P["rbf.log_sigmas"])[None]
    return torch.cat([d ** 2, codes], -1)       # the quadratic kernel


def loss_and_grad(P: Dict[str, torch.Tensor], problem: dict, body: Body,
                  priors: Priors, cfg: dict, block: int = 2048,
                  half: bool = False) -> Tuple[float, Dict[str, float]]:
    """The main-stage loss over the full (view x frame) grid, with its
    terms; its gradient lands in the parameters' .grad. The network's
    outputs (rotations, translations, poses) are taken once; the SMPL
    passes run in blocks of ``block`` rows, each block's share of the loss
    differentiated on its own down to those outputs, so one block's graph
    is held at a time; the outputs' gradients then go back through the
    network with the terms of the poses alone (KL, GMM, 3D). half: a fault,
    every other frame of each view left out and the means taken over the
    rest."""
    labels = problem["labels"]                   # (V, Fr, 25, 3)
    V, Fr = labels.shape[:2]
    dev = labels.device
    frames = torch.arange(0, Fr, 2 if half else 1, device=dev)
    n = frames.shape[0]
    vi = torch.arange(V, device=dev).repeat_interleave(n)
    fi = frames.repeat(V)
    B = vi.shape[0]
    phase = (fi.float() / (Fr - 1))[:, None]
    warped = _warp(P["phase.shifts"][vi], P["phase.scales"][vi], phase)
    rot6d, trans = _motion(P, _embed(P, warped, P["instance"][vi]))
    _, trans0 = _motion(P, _embed(P, torch.zeros((1, 1), device=dev),
                                  torch.zeros_like(P["instance"][:1])))
    trans = trans - trans0
    rot = rot6d_to_rotmat(rot6d.reshape(B, 24, 6))
    poses = rotmat_to_aa(rot[:, 1:]).reshape(B, 69)
    outs = (rot, trans, poses)
    leaf = [x.detach().requires_grad_() for x in outs]

    # VPoser's mean-latent reconstruction, detached, for the v2v prior
    mu, scale = priors.encode(poses[:, :63])
    with torch.no_grad():
        recon = torch.cat([priors.decode_aa(mu).reshape(B, 63),
                           poses[:, 63:]], 1)
    d0, d1 = problem["img_hw"]
    center = torch.tensor([d0 // 2, d1 // 2], dtype=torch.float32,
                          device=dev)
    gt = labels[vi, fi]
    proj = list(PROJ_JOINTS)
    # kp is the mean over the views of each view's mean over its rows,
    # every view holding n rows: the sum over rows / (V n 25 2)
    w_kp = 1.0 / (V * n * 25 * 2)
    w_v2v = cfg["weight_vp_loss"] / (B * 3 * body.num_vertices)
    kp = v2v_sum = 0.0
    for s in range(0, B, block):
        e = min(B, s + block)
        r, t, p = (x[s:e] for x in leaf)
        # 2D keypoints through each view's camera
        cam = P["cameras"][vi[s:e]]
        j = body.joints49(P["betas"], r)[:, proj] + t[:, None]
        pts = torch.einsum('bij,bkj->bki', rot6d_to_rotmat(cam[:, 3:]),
                           j) + cam[:, None, :3]
        z = pts[..., 2:]
        z = torch.where(z.abs() < 1e-9, torch.where(
            z < 0, torch.full_like(z, -1e-9), torch.full_like(z, 1e-9)), z)
        xy = FOCAL * pts[..., :2] / z + center
        g = gt[s:e]
        gate = (g[..., 2:] > 0.5).float()
        kp_blk = (gate * gmof(xy - g[..., :2]) * g[..., 2:]).sum()
        # the v2v prior: the predicted pose's mesh against its
        # reconstruction's, the reconstruction detached
        v_o, _ = body.posed(P["betas"], torch.cat(
            [r[:, :1], rodrigues(p.reshape(-1, 23, 3))], 1))
        with torch.no_grad():
            v_r, _ = body.posed(P["betas"], torch.cat(
                [r[:, :1], rodrigues(recon[s:e].reshape(-1, 23, 3))], 1))
        v2v_blk = (v_r - v_o).abs().sum()
        (w_kp * kp_blk + w_v2v * v2v_blk).backward()
        kp += float(kp_blk.detach())
        v2v_sum += float(v2v_blk.detach())
    kl = (-torch.log(scale) + (scale ** 2 + mu ** 2) / 2 - 0.5).sum(1).mean()
    gmm = priors.gmm_nll(poses).mean()
    theta = problem["hmr_theta"][vi, fi]
    mask = (problem["hmr_mask"][vi, fi] > 0.5).float()
    l3d = (mask * gmof(poses - theta)).mean()
    rest = (cfg["weight_vp_z_loss"] * kl + cfg["weight_gmm_loss"] * gmm
            + cfg["weight_3d_loss"] * l3d)
    (rest + sum((x * lf.grad).sum() for x, lf in zip(outs, leaf))).backward()
    kp, v2v = kp * w_kp, v2v_sum / (B * 3 * body.num_vertices)
    terms = {"kp_loss": kp, "vp_recon_loss": v2v,
             **{k: float(v.detach()) for k, v in (
                 ("vp_kl_loss", kl), ("gmm_loss", gmm), ("loss_3d", l3d))}}
    total = (kp + cfg["weight_vp_loss"] * v2v + float(rest.detach()))
    return total, {**terms, "total_loss": total}


def group_of(name: str) -> str:
    return name.split(".")[0]


def group_settings(cfg: dict) -> Dict[str, Tuple[float, float]]:
    """{group: (lr, L2 weight decay)} of the groups that step; a group at
    lr 0 (the phase warps and the betas here) never moves."""
    decay = cfg["wd_human"]
    out = {"cameras": (cfg["lr_camera"], 0.0),
           "motion": (cfg["lr_human"], decay),
           "rbf": (cfg["lr_human"], decay),
           "instance": (cfg["lr_instance"], 0.0),
           "phase": (cfg["lr_phase"], 0.0)}
    return {g: s for g, s in out.items() if s[0] > 0}


def run_steps(init: Dict[str, torch.Tensor], problem: dict, body: Body,
              priors: Priors, cfg: dict, steps: int, tf32: bool = False,
              half: bool = False) -> dict:
    """``steps`` main-stage steps from ``init``: each step's total loss, the
    first step's gradients as Adam takes them (decay included), and the
    parameters after the last step. tf32: the control, every float32
    product of the reference in TF32; half: the half-batch fault
    (loss_and_grad)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        P = {k: v.detach().clone().float() for k, v in init.items()}
        settings = group_settings(cfg)
        opts = []
        for g, (lr, wd) in settings.items():
            leaves: List[torch.Tensor] = [P[k].requires_grad_()
                                          for k in P if group_of(k) == g]
            opts.append(torch.optim.Adam(leaves, lr=lr, weight_decay=wd,
                                         foreach=False))
        losses, grad1 = [], {}
        for step in range(steps):
            for o in opts:
                o.zero_grad(set_to_none=True)
            total, _ = loss_and_grad(P, problem, body, priors, cfg,
                                     half=half)
            losses.append(total)
            if step == 0:
                for k, v in P.items():
                    g, (lr, wd) = group_of(k), settings.get(
                        group_of(k), (0.0, 0.0))
                    if v.grad is not None and g in settings:
                        grad1[k] = (v.grad + wd * v.detach()).clone()
            for o in opts:
                o.step()
        return {"losses": losses, "grad1": grad1,
                "params": {k: v.detach().clone() for k, v in P.items()}}
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
