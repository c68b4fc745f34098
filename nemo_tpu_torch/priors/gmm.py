"""GMM max-mixture pose prior (port of nemo_tpu/priors/gmm.py)."""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GMMPrior:
    means: torch.Tensor        # (M, 69)
    precisions: torch.Tensor   # (M, 69, 69)
    nll_weights: torch.Tensor  # (1, M)

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    def to(self, device) -> "GMMPrior":
        return GMMPrior(self.means.to(device), self.precisions.to(device),
                        self.nll_weights.to(device))


def gmm_from_numpy(means, precisions, nll_weights, device=None) -> GMMPrior:
    """GMMPrior from numpy arrays (e.g. a nemo_tpu GMMPrior's fields)."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return GMMPrior(t(means), t(precisions), t(nll_weights))


def _build(means: np.ndarray, covs: np.ndarray,
           weights: np.ndarray, device=None) -> GMMPrior:
    """Precisions and normalized NLL weights (reference prior.py:142-160)."""
    means = means.astype(np.float32)
    covs = covs.astype(np.float64)
    precisions = np.stack([np.linalg.inv(c) for c in covs]).astype(np.float32)
    sqrdets = np.array([np.sqrt(np.linalg.det(c)) for c in covs])
    const = (2 * np.pi) ** (means.shape[1] / 2.0)
    nll_weights = (weights / (const * (sqrdets / sqrdets.min()))).astype(
        np.float32)[None]
    return gmm_from_numpy(means, precisions, nll_weights, device)


def load_gmm_prior(path: str, device=None) -> GMMPrior:
    """A SPIN gmm_08.pkl: a latin-1 pickle of a dict (means, covars,
    weights) or of an sklearn-style mixture (means_, covars_, weights_)."""
    with open(path, "rb") as f:
        gmm = pickle.load(f, encoding="latin1")
    if isinstance(gmm, dict):
        means, covs, weights = gmm["means"], gmm["covars"], gmm["weights"]
    else:
        means, covs, weights = gmm.means_, gmm.covars_, gmm.weights_
    return _build(np.asarray(means), np.asarray(covs), np.asarray(weights),
                  device)


def synthetic_gmm_arrays(num_gaussians: int = 8, dim: int = 69,
                         seed: int = 0):
    """(means, covariances, weights) of the synthetic prior, float64, in
    the layout of a gmm_08.pkl."""
    rng = np.random.RandomState(seed)
    means = 0.3 * rng.randn(num_gaussians, dim)
    A = 0.1 * rng.randn(num_gaussians, dim, dim)
    covs = np.einsum('mij,mkj->mik', A, A) + 0.5 * np.eye(dim)
    weights = rng.dirichlet(np.ones(num_gaussians))
    return means, covs, weights


def synthetic_gmm_prior(num_gaussians: int = 8, dim: int = 69,
                        seed: int = 0) -> GMMPrior:
    """The same deterministic synthetic prior as nemo_tpu's."""
    return _build(*synthetic_gmm_arrays(num_gaussians, dim, seed))


def gmm_log_likelihood(prior: GMMPrior, pose: torch.Tensor) -> torch.Tensor:
    """Merged max-mixture NLL per sample (B,): min over components of
    0.5 (x - mu)^T P (x - mu) - log(nll_weight)."""
    diff = pose[:, None, :] - prior.means[None]
    pd = torch.einsum('mij,bmj->bmi', prior.precisions, diff)
    quad = torch.sum(pd * diff, dim=-1)
    nll = 0.5 * quad - torch.log(prior.nll_weights)
    return torch.min(nll, dim=1).values
