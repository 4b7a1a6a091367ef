"""Quaternion math, scalar-last (x, y, z, w); counterpart of
mapanything_tpu/geometry/quats.py."""

from __future__ import annotations

import torch


def quaternion_to_rotation_matrix(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4) xyzw -> rotation matrices (..., 3, 3)."""
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    x, y, z, w = quat.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rot = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return rot.reshape(quat.shape[:-1] + (3, 3))


def standardize_quaternion(quat: torch.Tensor) -> torch.Tensor:
    """Flip the sign of (..., 4) xyzw quaternions so that w >= 0."""
    return torch.where(quat[..., 3:4] < 0, -quat, quat)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at x == 0."""
    positive = x > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, 1.0)),
                       0.0)


def rotation_matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> standardised xyzw quaternions
    (..., 4): of the four candidate quaternions, the one divided by the
    largest of |w|, |x|, |y|, |z| (branch-free, as the JAX package)."""
    if matrix.shape[-2:] != (3, 3):
        raise ValueError(f"Invalid rotation matrix shape {tuple(matrix.shape)}.")
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = matrix.reshape(
        matrix.shape[:-2] + (9,)).unbind(-1)
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1))
    # candidates in wxyz, row i scaled by component i of (w, x, y, z)
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], dim=-2)
    candidates = quat_by_rijk / (2.0 * q_abs[..., None].clamp_min(0.1))
    best = q_abs.argmax(dim=-1)
    out = torch.take_along_dim(
        candidates, best[..., None, None].expand(best.shape + (1, 4)),
        dim=-2)[..., 0, :]
    return standardize_quaternion(out[..., [1, 2, 3, 0]])  # wxyz -> xyzw


def unit_w(like: torch.Tensor) -> torch.Tensor:
    """[0, 0, 0, 1] in `like`'s dtype and on its device (the identity xyzw
    quaternion, a homogeneous matrix's last row), made there: no copy from
    the host, which a CUDA graph's capture cannot hold."""
    return torch.eye(4, dtype=like.dtype, device=like.device)[3]


def pose_quats_trans_to_matrix(quats: torch.Tensor,
                               trans: torch.Tensor) -> torch.Tensor:
    """(..., 4) quats + (..., 3) trans -> (..., 4, 4) SE3 matrices."""
    rot = quaternion_to_rotation_matrix(quats)
    top = torch.cat([rot, trans[..., :, None]], dim=-1)
    bottom = unit_w(rot).expand(rot.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def quaternion_inverse(quat: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4) xyzw quaternions: the conjugate over |q|^2."""
    conj = torch.cat([-quat[..., :3], quat[..., 3:]], dim=-1)
    return conj / (quat * quat).sum(-1, keepdim=True)


def quaternion_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two xyzw quaternions (..., 4)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def rotate(rot: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """rot (..., 3, 3) applied to vec (..., 3) with elementwise products and
    sums: full fp32 whatever the TF32 settings."""
    return (rot * vec[..., None, :]).sum(-1)


def transform_pose_using_quats_and_trans_2_to_1(
    quats1: torch.Tensor, trans1: torch.Tensor, quats2: torch.Tensor,
    trans2: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pose 2 (cam2 -> world) expressed in pose 1's frame (cam2 -> cam1)."""
    inv_q1 = quaternion_inverse(quats1)
    r1_inv = quaternion_to_rotation_matrix(inv_q1)
    quats = quaternion_multiply(inv_q1, quats2)
    trans = rotate(r1_inv, trans2) - rotate(r1_inv, trans1)
    return quats, trans


def quaternion_slerp(q1: torch.Tensor, q2: torch.Tensor,
                     alpha) -> torch.Tensor:
    """Spherical interpolation between xyzw quaternions (..., 4) along the
    shorter arc: q1 at alpha = 0, q2 at 1. Normalised linear interpolation
    where the two are nearly parallel (sin of the angle < 1e-5)."""
    q1 = q1 / torch.linalg.vector_norm(q1, dim=-1, keepdim=True)
    q2 = q2 / torch.linalg.vector_norm(q2, dim=-1, keepdim=True)
    dot = (q1 * q2).sum(-1, keepdim=True)
    q2 = torch.where(dot < 0, -q2, q2)  # the shorter arc
    theta = torch.arccos(dot.abs().clamp(-1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = sin_theta < 1e-5
    safe_sin = torch.where(near, 1.0, sin_theta)
    w1 = torch.where(near, 1.0 - alpha,
                     torch.sin((1.0 - alpha) * theta) / safe_sin)
    w2 = torch.where(near, alpha, torch.sin(alpha * theta) / safe_sin)
    out = w1 * q1 + w2 * q2
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
