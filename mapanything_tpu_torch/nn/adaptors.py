"""Output adaptors for the released scene representation
(raydirs + depth + pose + confidence + mask, plus the metric scale).

Counterparts of mapanything_tpu/nn/adaptors.py: pure functions on the raw
head channels.
"""

from __future__ import annotations

import torch


def normalize_to_unit_sphere(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(eps)


def depth_adaptor(x: torch.Tensor, vmin: float = 0.0) -> torch.Tensor:
    """(..., 1) raw -> positive depth: vmin + exp(x)."""
    return vmin + torch.exp(x)


def confidence_adaptor(x: torch.Tensor, vmin: float = 1.0) -> torch.Tensor:
    """(..., 1) raw -> confidence >= vmin."""
    return vmin + torch.exp(x)


def mask_adaptor(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """(..., 1) raw -> {"mask": sigmoid prob, "logits": raw}."""
    return {"mask": 1.0 / (1.0 + torch.exp(-x)), "logits": x}


def pose_adaptor(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """(..., 7) raw -> {"trans": (..., 3), "quats": (..., 4) unit xyzw}."""
    return {"trans": x[..., :3], "quats": normalize_to_unit_sphere(x[..., 3:7])}


def scale_adaptor(x: torch.Tensor, vmin: float = 1e-8) -> torch.Tensor:
    """(..., 1) raw -> positive metric scale."""
    return vmin + torch.exp(x)
