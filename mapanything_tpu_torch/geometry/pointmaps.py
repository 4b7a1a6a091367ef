"""Factored-geometry recombination and SE3 helpers; counterpart of
mapanything_tpu/geometry/pointmaps.py. Every product of a transform with
points is written as elementwise products and sums, in full fp32 whatever
the TF32 settings."""

from __future__ import annotations

import torch

from .norm import safe_norm
from .quats import quaternion_to_rotation_matrix, rotate, unit_w


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
    differ); the det correction makes R, t and s agree. The sums run in
    fp64 and the results come back in the points' dtype: in fp32 the
    weighted sums over an image's H x W points, ordered as each device
    orders them, put the card's translation 1e-5 off the CPU's.
    """
    dtype = pts_a.dtype
    pts_a, pts_b = pts_a.double(), pts_b.double()
    if weights is None:
        weights = torch.ones(pts_a.shape[:-1], dtype=torch.float64,
                             device=pts_a.device)
    w = weights.double()
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-12)
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
    out = (r, mu_b - rot_mu_a)
    if with_scale:
        var_a = (w * (ac * ac).sum(-1)).sum(-1)
        scale = (s * d).sum(-1) / var_a.clamp_min(1e-12)
        out = (r, mu_b - scale[..., None] * rot_mu_a, scale)
    return tuple(x.to(dtype) for x in out)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., m, k) @ b (..., k, n) by elementwise products and sums."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _expand(trf: torch.Tensor, pts: torch.Tensor,
            mat: bool = True) -> torch.Tensor:
    """Insert singleton axes so that trf broadcasts against the point axes
    of pts (..., *, d)."""
    trailing = 2 if mat else 1
    n_extra = (pts.dim() - 1) - (trf.dim() - trailing)
    if n_extra <= 0:
        return trf
    lead = trf.shape[:trf.dim() - trailing]
    return trf.reshape(lead + (1,) * n_extra
                       + trf.shape[trf.dim() - trailing:])


def geotrf(trf: torch.Tensor, pts: torch.Tensor,
           ncol: int | None = None) -> torch.Tensor:
    """A linear (..., d, d) or homogeneous (..., d+1, d+1) transform applied
    to points (..., *, d), broadcast over the leading axes; the first `ncol`
    coordinates of the result."""
    d = pts.shape[-1]
    ncol = ncol or d
    if trf.shape[-1] == d:
        out = rotate(_expand(trf, pts), pts)
    elif trf.shape[-1] == d + 1:
        out = (rotate(_expand(trf[..., :d, :d], pts), pts)
               + _expand(trf[..., :d, d], pts, mat=False))
    else:
        raise ValueError(f"bad transform shape {tuple(trf.shape)} for "
                         f"points {tuple(pts.shape)}")
    return out[..., :ncol]


def inv(mat: torch.Tensor) -> torch.Tensor:
    """Matrix inverse of (..., n, n)."""
    return torch.linalg.inv(mat)


def closed_form_pose_inverse(
    pose_matrices: torch.Tensor,
    rotation_matrices: torch.Tensor | None = None,
    translation_vectors: torch.Tensor | None = None,
) -> torch.Tensor:
    """Inverse of SE3 matrices (..., 4, 4) in closed form: [R^T, -R^T t].
    R (..., 3, 3) and t (..., 3, 1) default to the matrices' own."""
    if rotation_matrices is None:
        rotation_matrices = pose_matrices[..., :3, :3]
    if translation_vectors is None:
        translation_vectors = pose_matrices[..., :3, 3:]
    rot_t = rotation_matrices.transpose(-1, -2)
    top = torch.cat([rot_t, -_matmul(rot_t, translation_vectors)], dim=-1)
    bottom = unit_w(pose_matrices).expand(
        pose_matrices.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def transform_pts3d(pts3d: torch.Tensor,
                    transformation: torch.Tensor) -> torch.Tensor:
    """A homogeneous (..., 4, 4) transform applied to a pointmap
    (..., H, W, 3)."""
    rot = transformation[..., None, None, :3, :3]
    return rotate(rot, pts3d) + transformation[..., None, None, :3, 3]


def relative_pose_transformation(trans_01: torch.Tensor,
                                 trans_02: torch.Tensor) -> torch.Tensor:
    """T_1^2 = (T_0^1)^-1 T_0^2 of homogeneous transforms (..., 4, 4)."""
    return _matmul(inv(trans_01), trans_02)


def convert_raymap_z_depth_quats_to_pointmap(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    depth: torch.Tensor,
    quats: torch.Tensor,
) -> torch.Tensor:
    """World pointmap from a raymap, z-depth and per-pixel rotations:
    origins + R(q) (depth * dirs).

    ray_origins, ray_directions (..., H, W, 3), depth (..., H, W, 1),
    quats (..., H, W, 4) xyzw, normalised here.
    """
    quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    rot = quaternion_to_rotation_matrix(quats)  # (..., H, W, 3, 3)
    return ray_origins + rotate(rot, depth * ray_directions)
