"""A multi-view action from the seed, made on the device: one smooth SMPL
motion seen by ``instances`` cameras on a ring, each instance on its own
monotone time warp, projected to 2D keypoints through the reference body,
with pixel noise and dropped detections as a keypoint detector gives
them, and a per-frame initializer theta with the error of a video
regressor. The traffic file sets every size and level."""

from __future__ import annotations

import math

import torch

from ..reference.body import Body, rodrigues
from ..reference.nemo_fit import FOCAL, PROJ_JOINTS


def _smooth(gen, frames, channels, amp, harmonics, device):
    kw = dict(generator=gen, device=device)
    t = torch.linspace(0, 1, frames, device=device)[:, None]
    k = torch.arange(1, harmonics + 1, device=device)[None].float()
    a = torch.randn((channels, harmonics), **kw) * amp / k
    b = torch.randn((channels, harmonics), **kw) * amp / k
    base = 0.5 * amp * torch.randn((channels,), **kw)
    ang = 2 * math.pi * t * k
    return base + torch.sin(ang) @ a.t() + (torch.cos(ang) - 1) @ b.t()


def make_action(gen: torch.Generator, body: Body, traffic: dict,
                block: int = 2048) -> dict:
    """{labels (V, F, 25, 3), hmr_theta (V, F, 69), hmr_mask (V, F, 1),
    img_hw (d0, d1)}: V instances of F frames."""
    dev = body.v_template.device
    kw = dict(generator=gen, device=dev)
    V, Fr = traffic["instances"], traffic["frames"]
    pose = _smooth(gen, Fr, 72, traffic["pose_amplitude"], 3, dev)
    trans = _smooth(gen, Fr, 3, traffic["trans_amplitude"], 3, dev)
    trans = trans - trans[:1]
    # monotone warps: cumulative sums of positive densities
    dens = 1 + traffic["warp_strength"] * (torch.rand((V, Fr), **kw) - 0.5)
    cdf = torch.cumsum(dens, 1)
    cdf = (cdf - cdf[:, :1]) / (cdf[:, -1:] - cdf[:, :1])
    tidx = (cdf * (Fr - 1)).round().long()                 # (V, F)
    pose_vf, trans_vf = pose[tidx], trans[tidx]            # (V, F, .)
    # cameras on a ring around the person, looking at it
    yaw = 2 * math.pi * torch.arange(V, device=dev) / V \
        + 0.1 * torch.randn((V,), **kw)
    c, s, o = torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw)
    Ry = torch.stack([c, o, s, o, o + 1, o, -s, o, c], 1).reshape(V, 3, 3)
    cam_t = torch.stack([0.1 * torch.randn((V,), **kw),
                         0.1 * torch.randn((V,), **kw),
                         traffic["camera_depth"] + torch.randn((V,), **kw)], 1)
    d0, d1 = traffic["img_hw"]
    center = torch.tensor([d0 // 2, d1 // 2], device=dev, dtype=torch.float32)
    rot = rodrigues(pose_vf.reshape(V * Fr, 24, 3))
    betas = torch.zeros((1, 10), device=dev)
    pts = []
    with torch.no_grad():
        for s0 in range(0, V * Fr, block):
            j = body.joints49(betas, rot[s0:s0 + block])[:, list(PROJ_JOINTS)]
            pts.append(j + trans_vf.reshape(-1, 1, 3)[s0:s0 + block])
    j = torch.cat(pts).reshape(V, Fr, 25, 3)
    p = torch.einsum('vij,vfkj->vfki', Ry, j) + cam_t[:, None, None]
    xy = FOCAL * p[..., :2] / p[..., 2:] + center
    xy = xy + traffic["noise_px"] * torch.randn(xy.shape, **kw)
    conf = (torch.rand((V, Fr, 25, 1), **kw)
            >= traffic["dropout"]).float()
    theta = pose_vf[..., 3:] + traffic["theta_noise"] * torch.randn(
        (V, Fr, 69), **kw)
    return {"labels": torch.cat([xy, conf], -1), "hmr_theta": theta,
            "hmr_mask": torch.ones((V, Fr, 1), device=dev),
            "img_hw": (float(d0), float(d1))}


def init_params(gen: torch.Generator, cfg: dict, instances: int,
                img_d0: float, device) -> dict:
    """The fit's starting parameters by name, drawn as the reference NeMo
    initialises them: cameras 1e-4 N(0, 1) about an identity rotation at
    depth 2 f / d0, the MotionNet's layers uniform in torch's default
    bounds with the rotation head at 1e-5 of Xavier's about the identity,
    instance codes 1e-4 N(0, 1), RBF log-widths 0, linear phase warps at
    scale 15, betas 0."""
    kw = dict(generator=gen, device=device)
    H, K, C = cfg["h_dim"], cfg["phase_rbf_dim"], cfg["instance_code_size"]
    n = cfg["monotonic_network_n_nodes"]

    def uniform(shape, bound):
        return (2 * torch.rand(shape, **kw) - 1) * bound

    cams = 1e-4 * torch.randn((instances, 9), **kw)
    cams[:, 3] += 1
    cams[:, 6] += 1
    cams[:, 2] += 2 * FOCAL / img_d0
    P = {"cameras": cams,
         "phase.shifts": torch.linspace(0, 1, n, device=device).repeat(
             instances, 1),
         "phase.scales": torch.full((instances, n), 15.0, device=device),
         "betas": torch.zeros((1, 10), device=device)}
    for i, (a, b) in enumerate(((K + C, H), (H, H), (H, H)), start=1):
        P[f"motion.trunk.W{i}"] = uniform((a, b), a ** -0.5)
        P[f"motion.trunk.b{i}"] = uniform((b,), a ** -0.5)
    P["motion.W_rot"] = uniform((H, 144), 1e-5 * math.sqrt(6 / (H + 144)))
    P["motion.b_rot"] = torch.tensor([1.0, 0, 0, 1, 0, 0],
                                     device=device).repeat(24)
    P["motion.W_lin"] = uniform((H, 3), H ** -0.5)
    P["motion.b_lin"] = uniform((3,), H ** -0.5)
    P["instance"] = 1e-4 * torch.randn((instances, C), **kw)
    P["rbf.log_sigmas"] = torch.zeros((K,), device=device)
    return P
