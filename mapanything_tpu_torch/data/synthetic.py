"""Synthetic multi-view batches with geometrically consistent ground truth;
counterpart of mapanything_tpu/data/synthetic.py.

Random smooth depth, known intrinsics and small random poses become the GT
fields the losses read (pointmaps, rays, depth along the ray, masks). The
random numbers come from the same numpy stream as the JAX package's, so a
seed gives both packages the same batch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import geometry as G
from ..utils.device import resolve_device


def make_synthetic_batch(batch_size: int = 1, num_views: int = 2,
                         height: int = 28, width: int = 42, seed: int = 0,
                         device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"views": model inputs, "gt": supervision}, all (B, V, ...) fp32 on
    `device` (the card when None) but the per-sample flags."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    b, v, h, w = batch_size, num_views, height, width

    f = 0.8 * max(h, w)
    k = np.zeros((b, v, 3, 3), np.float32)
    k[..., 0, 0] = f
    k[..., 1, 1] = f
    k[..., 0, 2] = w / 2
    k[..., 1, 2] = h / 2
    k[..., 2, 2] = 1

    base = rng.uniform(2.0, 4.0, size=(b, v, 1, 1)).astype(np.float32)
    ramp = np.linspace(0, 1, h, dtype=np.float32)[None, None, :, None]
    depth_z = base + ramp + 0.1 * rng.standard_normal(
        (b, v, h, w)).astype(np.float32) ** 2

    quats = rng.normal(size=(b, v, 4)).astype(np.float32) * np.array(
        [0.05, 0.05, 0.05, 1.0], np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    trans = 0.2 * rng.standard_normal((b, v, 3)).astype(np.float32)
    imgs = rng.normal(size=(b, v, h, w, 3)).astype(np.float32) * 0.5

    def dev(x):
        return torch.from_numpy(x).to(device)

    kt, dz, qt, tt = dev(k), dev(depth_z), dev(quats), dev(trans)
    poses = G.pose_quats_trans_to_matrix(qt, tt)
    pts3d, valid = G.depthmap_to_world_frame(dz, kt, poses)
    pts3d_cam, _ = G.depthmap_to_camera_frame(dz, kt)
    _, rays = G.get_rays_in_camera_frame(kt, h, w,
                                         normalize_to_unit_sphere=True)
    depth_along_ray = torch.linalg.vector_norm(pts3d_cam, dim=-1,
                                               keepdim=True)

    def flags(shape, value):
        return torch.full(shape, value, dtype=torch.bool, device=device)

    views = {
        "img": dev(imgs),
        "ray_directions_cam": rays,
        "depth_along_ray": depth_along_ray,
        "camera_pose_quats": qt,
        "camera_pose_trans": tt,
        "is_metric_scale": flags((b, v), True),
    }
    gt = {
        "pts3d": pts3d,
        "pts3d_cam": pts3d_cam,
        "ray_directions_cam": rays,
        "depth_along_ray": depth_along_ray,
        "camera_pose_quats": qt,
        "camera_pose_trans": tt,
        "valid_mask": valid,
        "non_ambiguous_mask": flags((b, v, h, w), True),
        "is_metric_scale": flags((b,), True),
        "is_synthetic": flags((b,), False),
    }
    return {"views": views, "gt": gt}
