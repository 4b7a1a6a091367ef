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


def rigid_points_registration(pts_a: torch.Tensor, pts_b: torch.Tensor,
                              weights: torch.Tensor | None = None,
                              with_scale: bool = False):
    """Weighted Kabsch/Umeyama: the rigid transform (R, t[, s]) minimising
    sum_i w_i || s R a_i + t - b_i ||^2, closed form through a 3x3 SVD,
    batched over the leading axes, on the points' device.

    pts_a, pts_b (..., N, 3); weights (..., N), nonnegative. Returns
    (R (..., 3, 3), t (..., 3)) or, with_scale, (R, t, s (...,)).

    The SVD's U and V are unique only up to sign (cuSOLVER and LAPACK may
    differ); the det correction makes R, t and s agree. The fp32 products
    run without TF32, as the JAX package's precision="highest".
    """
    from ..utils.device import full_fp32

    if weights is None:
        weights = torch.ones(pts_a.shape[:-1], dtype=pts_a.dtype,
                             device=pts_a.device)
    w = weights / weights.sum(-1, keepdim=True).clamp_min(1e-12)
    with full_fp32():
        mu_a = (pts_a * w[..., None]).sum(-2)  # (..., 3)
        mu_b = (pts_b * w[..., None]).sum(-2)
        ac = pts_a - mu_a[..., None, :]
        bc = pts_b - mu_b[..., None, :]
        cov = torch.einsum("...ni,...nj->...ij", bc * w[..., None], ac)
        u, s, vt = torch.linalg.svd(cov)
        det = torch.linalg.det(u @ vt)
        d = torch.cat([torch.ones(det.shape + (2,), dtype=cov.dtype,
                                  device=cov.device), det[..., None]], -1)
        r = (u * d[..., None, :]) @ vt
        rot_mu_a = (r * mu_a[..., None, :]).sum(-1)
    if with_scale:
        var_a = (w * (ac * ac).sum(-1)).sum(-1)
        scale = (s * d).sum(-1) / var_a.clamp_min(1e-12)
        return r, mu_b - scale[..., None] * rot_mu_a, scale
    return r, mu_b - rot_mu_a
