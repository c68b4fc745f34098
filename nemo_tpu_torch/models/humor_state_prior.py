"""HuMoR initial-state GMM prior training (EM), in PyTorch.

Port of nemo_tpu/models/humor_state_prior.py (behavioral reference:
humor/humor/train/train_state_prior.py:33-130): collect initial states
(joints + joints_vel + trans_vel + root_orient_vel, D = 138) and fit a
full-covariance GaussianMixture, saving prior_gmm.npz {weights, means,
covariances}, which models/humor_fit.load_init_motion_prior reads.

EM runs on the states' device: the E-step whitens with one batched
triangular solve over the K components, the M-step is two contractions.
As in the JAX package, a covariance that is not positive definite gives
NaN factors instead of an error (``cholesky_ex``, its flag never read on
the host), and the log-likelihood curve stays on the device until the
end. k-means++ seeding (``torch.multinomial`` with a ``torch.Generator``)
and 10 Lloyd iterations start the means, or the caller gives them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_LOG2PI = math.log(2.0 * math.pi)


def _component_log_prob(x: torch.Tensor, means: torch.Tensor,
                        chols: torch.Tensor) -> torch.Tensor:
    """log N(x | mu_k, L_k L_k^T) for all (n, k). x: (N, D); means: (K, D);
    chols: (K, D, D) lower. Returns (N, K)."""
    D = x.shape[1]
    diff = (x[None] - means[:, None]).transpose(1, 2)          # (K, D, N)
    y = torch.linalg.solve_triangular(chols, diff, upper=False)
    maha = (y * y).sum(dim=1)                                   # (K, N)
    logdet = 2.0 * torch.log(torch.diagonal(chols, dim1=1, dim2=2)).sum(1)
    return (-0.5 * (D * _LOG2PI + logdet[:, None] + maha)).T


def _kmeans_init(x: torch.Tensor, k: int,
                 generator: Optional[torch.Generator] = None,
                 lloyd_iters: int = 10) -> torch.Tensor:
    """k-means++ seeding + Lloyd refinement (sklearn's default GMM init),
    the draws from ``generator`` (on x's device)."""
    N = x.shape[0]
    first = torch.randint(0, N, (1,), generator=generator, device=x.device)
    centers = x.new_zeros((k, x.shape[1]))
    centers[0] = x[first[0]]
    for i in range(1, k):
        d2 = ((x[:, None, :] - centers[None, :i, :]) ** 2).sum(-1).amin(1)
        idx = torch.multinomial(d2 + 1e-12, 1, generator=generator)
        centers[i] = x[idx[0]]
    for _ in range(lloyd_iters):
        d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        onehot = torch.nn.functional.one_hot(d2.argmin(1), k).to(x.dtype)
        cnt = onehot.sum(0)
        new = (onehot.T @ x) / torch.clamp(cnt, min=1.0)[:, None]
        centers = torch.where(cnt[:, None] > 0, new, centers)
    return centers


def _cholesky_nan(covs: torch.Tensor) -> torch.Tensor:
    """Cholesky factors, NaN where a matrix is not positive definite
    (jnp.linalg.cholesky's behaviour), with no host read of the flag."""
    L, info = torch.linalg.cholesky_ex(covs)
    return torch.where((info == 0)[:, None, None], L,
                       torch.full_like(L, float("nan")))


def fit_state_prior_gmm(states, n_components: int = 12, n_iter: int = 100,
                        generator: Optional[torch.Generator] = None,
                        reg_covar: float = 1e-6,
                        init_means: Optional[torch.Tensor] = None,
                        device=None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Fit a full-covariance GMM to (N, D) states by EM on ``device`` (the
    states' own when they are a tensor and device is None).

    Mirrors train_state_prior.py:99-112 (GaussianMixture(n_components=12,
    covariance_type='full', init kmeans, reg 1e-6)). The means start at
    init_means (K, D) when given, else at _kmeans_init's from
    ``generator``. Returns ({'weights' (K,), 'means' (K, D), 'covariances'
    (K, D, D)}, the (n_iter,) mean log-likelihood curve).
    """
    x = torch.as_tensor(states, dtype=torch.float32, device=device)
    N, D = x.shape
    K = n_components
    eye = torch.eye(D, device=x.device)
    means = (_kmeans_init(x, K, generator) if init_means is None else
             torch.as_tensor(init_means, dtype=torch.float32,
                             device=x.device))
    weights = torch.full((K,), 1.0 / K, device=x.device)
    var0 = torch.clamp(x.var(dim=0, unbiased=False).mean(), min=1e-3)
    covs = (var0 * eye)[None].repeat(K, 1, 1)
    lls = []
    for _ in range(n_iter):
        log_prob = _component_log_prob(x, means, _cholesky_nan(covs))
        joint = log_prob + torch.log(weights)[None, :]
        norm = torch.logsumexp(joint, dim=1, keepdim=True)
        resp = torch.exp(joint - norm)                          # (N, K)
        lls.append(norm.mean())
        nk = resp.sum(0) + 1e-10
        means = (resp.T @ x) / nk[:, None]
        diff = x[:, None, :] - means[None, :, :]                # (N, K, D)
        wd = resp[:, :, None] * diff
        covs = (torch.einsum("nkd,nke->kde", wd, diff)
                / nk[:, None, None] + reg_covar * eye[None])
        weights = nk / nk.sum()
    ll = torch.stack(lls) if lls else x.new_zeros((0,))
    return {"weights": weights, "means": means, "covariances": covs}, ll


def save_state_prior_gmm(path: str, gmm: Dict[str, torch.Tensor]) -> None:
    """Write prior_gmm.npz as train_state_prior.py:123 does (float64), in
    the layout models/humor_fit.load_init_motion_prior reads."""
    f64 = lambda t: np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t)
                               else t, np.float64)
    np.savez(path, weights=f64(gmm["weights"]), means=f64(gmm["means"]),
             covariances=f64(gmm["covariances"]))


def states_from_sequences(seqs: torch.Tensor) -> torch.Tensor:
    """Init-state prior features of packed (B, T, 207) HuMoR state
    sequences: each frame gives (joints 66, joints_vel 66, trans_vel 3,
    root_orient_vel 3) -> (B*T, 138), the field set
    train_state_prior.py:92-97 concatenates."""
    from .humor import split_state
    d = split_state(seqs.reshape(-1, seqs.shape[-1]))
    return torch.cat([d["joints"], d["joints_vel"], d["trans_vel"],
                      d["root_orient_vel"]], dim=-1)
