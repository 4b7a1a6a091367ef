"""Output adaptors for the released scene representation
(raydirs + depth + pose + confidence + mask, plus the metric scale).

Counterparts of mapanything_tpu/nn/adaptors.py: pure functions on the raw
head channels.
"""

from __future__ import annotations

import torch


def normalize_to_unit_sphere(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(eps)


def ray_dirs_adaptor(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) raw -> unit-sphere ray directions."""
    return normalize_to_unit_sphere(x)


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


def dense_adaptor_raydirs_depth_conf_mask(
        x: torch.Tensor) -> dict[str, torch.Tensor]:
    """The released dense head's 6 channels (ray directions 3, log-depth 1,
    confidence 1, mask 1) through their activations."""
    if x.shape[-1] != 6:
        raise ValueError(f"expected 6 channels, got {x.shape[-1]}")
    return {
        "ray_directions": ray_dirs_adaptor(x[..., 0:3]),
        "depth_along_ray": depth_adaptor(x[..., 3:4]),
        "conf": confidence_adaptor(x[..., 4:5]),
        **mask_adaptor(x[..., 5:6]),
    }


def dense_adaptor_pointmap(x: torch.Tensor, with_conf: bool = False,
                           with_mask: bool = False) -> dict[str, torch.Tensor]:
    """Pointmap-style dense channels (the ablations): linear xyz, then a
    confidence and a mask channel where asked."""
    out = {"pts3d": x[..., 0:3]}
    c = 3
    if with_conf:
        out["conf"] = confidence_adaptor(x[..., c:c + 1])
        c += 1
    if with_mask:
        out.update(mask_adaptor(x[..., c:c + 1]))
    return out
