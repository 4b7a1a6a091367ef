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


def pose_quats_trans_to_matrix(quats: torch.Tensor,
                               trans: torch.Tensor) -> torch.Tensor:
    """(..., 4) quats + (..., 3) trans -> (..., 4, 4) SE3 matrices."""
    rot = quaternion_to_rotation_matrix(quats)
    top = torch.cat([rot, trans[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype,
                          device=rot.device).expand(rot.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def quaternion_inverse(quat: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4) xyzw quaternions: the conjugate over |q|^2."""
    conj = quat * quat.new_tensor([-1.0, -1.0, -1.0, 1.0])
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
