"""Norms and pointcloud normalisation of the losses; counterpart of
mapanything_tpu/geometry/norm.py (safe_norm, normalize_multiple_pointclouds,
apply_log_to_norm), on stacked views (B, V, ...)."""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim: int = -1,
              keepdim: bool = False) -> torch.Tensor:
    """L2 norm with a zero subgradient at x == 0.

    Masked pixels are exact zero vectors; the gradient of a plain norm there
    is not something to rely on, so the square root only ever sees 1 where
    the squared norm is 0, and the where() passes no gradient to it.
    """
    sq = (x * x).sum(dim=dim, keepdim=keepdim)
    zero = sq == 0
    return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq)))


def normalize_multiple_pointclouds(pts: torch.Tensor,
                                   valid_masks: torch.Tensor | None = None,
                                   norm_mode: str = "avg_dis",
                                   ret_factor: bool = False):
    """Jointly normalise multi-view pointmaps by their average distance.

    pts (B, V, H, W, 3), valid_masks (B, V, H, W) bool, norm_mode
    "avg_{dis|log1p|warp-log1p}". Returns the normalised points and, with
    ret_factor, the (B, 1, 1, 1, 1) factor.
    """
    norm, dis_mode = norm_mode.split("_")
    if norm != "avg":
        raise ValueError(f"unsupported norm {norm}")
    b = pts.shape[0]
    if valid_masks is None:
        valid_masks = torch.ones(pts.shape[:-1], dtype=torch.bool,
                                 device=pts.device)
    all_dis = safe_norm(pts * valid_masks[..., None])  # (B, V, H, W)
    if dis_mode == "log1p":
        all_dis = torch.log1p(all_dis)
    elif dis_mode == "warp-log1p":
        log_dis = torch.log1p(all_dis)
        pts = pts * (log_dis / all_dis.clamp_min(1e-8))[..., None]
        all_dis = log_dis
    elif dis_mode != "dis":
        raise ValueError(f"bad dis_mode {dis_mode}")
    nnz = valid_masks.reshape(b, -1).sum(-1)
    norm_factor = ((all_dis * valid_masks).reshape(b, -1).sum(-1)
                   / (nnz + 1e-8)).clamp_min(1e-8)
    factor = norm_factor[:, None, None, None, None]
    res = pts / factor
    return (res, factor) if ret_factor else res


def apply_log_to_norm(x: torch.Tensor) -> torch.Tensor:
    """Rescale vectors (..., C) to length log1p(|x|)."""
    d = safe_norm(x, keepdim=True)
    return x / d.clamp_min(1e-8) * torch.log1p(d)
