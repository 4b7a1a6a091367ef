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
