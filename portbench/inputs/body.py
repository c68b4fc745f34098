"""Weights from the seed, made on the device in a few large draws: a
kinematically valid SMPL-sized body, VPoser's weights and statistics, and
an 8-component GMM over the 69 body-pose dimensions. Both sides of a run
take these same tensors; the program through its own loaders."""

from __future__ import annotations

import torch

from ..reference.body import PARENTS


def smpl_arrays(gen: torch.Generator, device, V: int = 6890,
                betas: int = 10) -> dict:
    """Raw SMPL arrays in the published layout: v_template (V, 3),
    shapedirs (V, 3, betas), posedirs (207, 3 V), J_regressor (24, V),
    weights (V, 24), J_regressor_extra (9, V), parents (24,)."""
    kw = dict(generator=gen, device=device)
    offsets = 0.25 * torch.randn((24, 3), **kw)
    offsets[:, 1] -= 0.1
    rest = [torch.zeros(3, device=device)]
    for j in range(1, 24):
        rest.append(rest[PARENTS[j]] + offsets[j])
    rest = torch.stack(rest)
    owner = torch.randint(0, 24, (V,), **kw)
    v_template = rest[owner] + 0.08 * torch.randn((V, 3), **kw)
    d = torch.cdist(v_template, rest)                       # (V, 24)
    # skinning weights: a softmax over the 4 nearest joints
    near = d.topk(4, dim=1, largest=False)
    w = torch.zeros_like(d).scatter_(1, near.indices,
                                     torch.softmax(-near.values / 0.05, 1))
    # each joint regressed as the mean of its 16 nearest vertices
    jreg = torch.zeros((24, V), device=device).scatter_(
        1, d.t().topk(16, dim=1, largest=False).indices, 1.0 / 16)
    extra = torch.rand((9, V), **kw)
    return {"v_template": v_template,
            "shapedirs": 0.01 * torch.randn((V, 3, betas), **kw),
            "posedirs": 0.001 * torch.randn((207, 3 * V), **kw),
            "J_regressor": jreg, "weights": w,
            "J_regressor_extra": extra / extra.sum(1, keepdim=True),
            "parents": torch.tensor(PARENTS)}


def vposer_weights(gen: torch.Generator, device, neurons: int = 512,
                   latent: int = 32) -> dict:
    """VPoser V02_05's eval-mode weights, (in, out) layout, with torch's
    default uniform bounds, and batch-norm statistics near 0 and 1."""
    kw = dict(generator=gen, device=device)
    shapes = {"enc_w1": (63, neurons), "enc_w2": (neurons, neurons),
              "enc_w3": (neurons, neurons), "mu_w": (neurons, latent),
              "logvar_w": (neurons, latent), "dec_w1": (latent, neurons),
              "dec_w2": (neurons, neurons), "dec_w3": (neurons, 126)}
    p = {}
    for w, (i, o) in shapes.items():
        bound = i ** -0.5
        p[w] = (2 * torch.rand((i, o), **kw) - 1) * bound
        p[w.replace("_w", "_b")] = (2 * torch.rand((o,), **kw) - 1) * bound
    for n, size in (("bn0", 63), ("bn1", neurons)):
        p[f"{n}_mean"] = 0.1 * torch.randn((size,), **kw)
        p[f"{n}_var"] = 0.5 + torch.rand((size,), **kw)
        p[f"{n}_gamma"] = 1 + 0.1 * torch.randn((size,), **kw)
        p[f"{n}_beta"] = 0.1 * torch.randn((size,), **kw)
    return p


def gmm_arrays(gen: torch.Generator, device, components: int = 8,
               dim: int = 69) -> dict:
    """gmm_08.pkl's fields: means (M, D), covars (M, D, D) in float64,
    weights (M,) summing to 1."""
    kw = dict(generator=gen, device=device)
    A = 0.1 * torch.randn((components, dim, dim), **kw, dtype=torch.float64)
    covs = A @ A.transpose(1, 2) + 0.5 * torch.eye(
        dim, device=device, dtype=torch.float64)
    w = torch.rand((components,), **kw, dtype=torch.float64) + 0.1
    return {"means": 0.3 * torch.randn((components, dim), **kw),
            "covars": covs, "weights": w / w.sum()}
