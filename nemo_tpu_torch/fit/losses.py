"""Loss functions of the NeMo fit (port of nemo_tpu/fit/losses.py)."""

from __future__ import annotations

from typing import Optional

import torch

from ..priors.robustifiers import gmof

KEYPOINT_LOSS_TYPES = ("rmse", "rmse_resized", "mse", "rmse_robust",
                       "mse_robust", "mse_robust_resized")


def keypoint_loss(pred: torch.Tensor, gt: torch.Tensor,
                  gt_weight: torch.Tensor,
                  gt_size: Optional[torch.Tensor] = None,
                  loss_type: str = "mse_robust",
                  rho: float = 100.0) -> torch.Tensor:
    """Per-element keypoint loss, confidence-gated at > 0.5: (..., K, 1) for
    the rmse variants, (..., K, D) otherwise."""
    gate = (gt_weight > 0.5).to(pred.dtype)
    if loss_type == "rmse":
        return gate * torch.sqrt(1e-6 + ((pred - gt) ** 2).sum(-1, keepdim=True))
    if loss_type == "rmse_resized":
        s = gt_size[..., None, None]
        return gate * torch.sqrt(
            1e-6 + (((pred - gt) / s) ** 2).sum(-1, keepdim=True))
    if loss_type == "mse":
        return gate * (pred - gt) ** 2
    if loss_type == "rmse_robust":
        return gate * gmof(pred - gt, rho=rho, sqrt=True)
    if loss_type == "mse_robust":
        return gate * gmof(pred - gt, rho=rho, sqrt=False)
    if loss_type == "mse_robust_resized":
        s = gt_size[..., None, None]
        return gate * gmof((pred - gt) / s * 1000.0, rho=rho, sqrt=False)
    raise ValueError(f"unknown loss type {loss_type!r}")


def batch_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """x.mean() over the global batch. Under a data-parallel mesh x holds
    this rank's rows, and the result is their sum over the global count,
    so that the ranks' results sum to the mean over every row (and their
    gradients to its gradient). Without a mesh, or on one rank, it is
    x.mean() itself."""
    if mesh is None or mesh.size == 1:
        return x.mean()
    return x.sum() / (x.numel() * mesh.size)


def per_view_average(loss_all: torch.Tensor, conf: torch.Tensor,
                     view_idx: torch.Tensor, num_views: int,
                     mesh=None) -> torch.Tensor:
    """Mean loss per view present in the batch, then the mean over those
    views (reference :3839-3846), fixed-shape through a (B, V) one-hot.

    The one-hot is a comparison, not ``F.one_hot``, which validates its
    input on the host and so would synchronise with the device. Under a
    data-parallel mesh the per-view counts are summed over the ranks
    first (they depend on the batch alone, so no gradient flows through
    that sum): each rank's result is its rows' share of the global
    value."""
    views = torch.arange(num_views, device=view_idx.device)
    onehot = (view_idx[:, None] == views[None]).to(loss_all.dtype)
    weighted = loss_all * conf
    per_item = weighted.reshape(weighted.shape[0], -1).sum(-1)
    denom_per_item = weighted.shape[1] * weighted.shape[2]
    sums = onehot.T @ per_item
    counts = onehot.sum(dim=0)
    if mesh is not None and mesh.size > 1:
        counts = mesh.all_reduce(counts)
    present = counts > 0
    avg = sums / (torch.clamp(counts, min=1) * denom_per_item)
    n_present = torch.clamp(present.sum(), min=1)
    return torch.where(present, avg, torch.zeros_like(avg)).sum() / n_present


def camera_fitting_loss(points2d: torch.Tensor, points2d_gt: torch.Tensor,
                        gt_size: torch.Tensor,
                        loss_type: str = "mse_robust",
                        mesh=None) -> torch.Tensor:
    """Camera-stage loss: plain mean of the keypoint loss."""
    return batch_mean(keypoint_loss(points2d, points2d_gt[..., :2],
                                    points2d_gt[..., 2:], gt_size,
                                    loss_type), mesh)
