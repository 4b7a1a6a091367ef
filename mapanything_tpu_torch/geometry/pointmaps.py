"""Factored-geometry recombination; counterpart of
mapanything_tpu/geometry/pointmaps.py."""

from __future__ import annotations

import torch

from .norm import safe_norm
from .quats import quaternion_to_rotation_matrix


def convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap(
    ray_directions: torch.Tensor,
    depth_along_ray: torch.Tensor,
    pose_trans: torch.Tensor,
    pose_quats: torch.Tensor,
) -> torch.Tensor:
    """pts_world = R(q) @ (depth * dirs) + t.

    ray_directions (..., H, W, 3), depth_along_ray (..., H, W, 1),
    pose_trans (..., 3), pose_quats (..., 4) xyzw, cam2world.
    The rotation is applied with elementwise products and sums, in full
    fp32 whatever the TF32 settings.
    """
    pose_quats = pose_quats / torch.linalg.vector_norm(
        pose_quats, dim=-1, keepdim=True)
    rot = quaternion_to_rotation_matrix(pose_quats)  # (..., 3, 3)
    local = depth_along_ray * ray_directions  # (..., H, W, 3)
    world = (rot[..., None, None, :, :] * local[..., None, :]).sum(-1)
    return world + pose_trans[..., None, None, :]


def angle_diff_vec3(v1: torch.Tensor, v2: torch.Tensor,
                    eps: float = 1e-12) -> torch.Tensor:
    """Angle in radians between 3D vectors (..., 3). The cross product's
    norm has a zero subgradient where the vectors are parallel."""
    cross_norm = safe_norm(torch.linalg.cross(v1, v2, dim=-1)) + eps
    return torch.atan2(cross_norm, (v1 * v2).sum(-1))
