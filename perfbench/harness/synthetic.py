"""Synthetic multi-view training batches with geometrically consistent
ground truth, on the host.

Copied from mapanything_tpu_torch/data/synthetic.py::make_synthetic_batch
and frozen here (the program may change, the yardstick may not): the same
numpy stream of random numbers, and the geometry (pinhole rays, camera and
world pointmaps) written out in numpy float32 instead of the program's
torch helpers. Random smooth depth, one pinhole camera per view and small
random poses; every pixel valid, metric, non-ambiguous, real (not
synthetic) data.
"""

from __future__ import annotations

import numpy as np


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    x, y, z, w = np.moveaxis(q / np.linalg.norm(q, axis=-1, keepdims=True),
                             -1, 0)
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(q.shape[:-1] + (3, 3))


def make_batch(batch: int, views: int, height: int, width: int,
               seed) -> dict:
    """{"views": the model's inputs, "gt": the supervision}, numpy arrays
    (B, V, ...) float32 but the flags."""
    rng = np.random.default_rng(seed)
    b, v, h, w = batch, views, height, width
    f = np.float32(0.8 * max(h, w))
    cx, cy = np.float32(w / 2), np.float32(h / 2)

    base = rng.uniform(2.0, 4.0, size=(b, v, 1, 1)).astype(np.float32)
    ramp = np.linspace(0, 1, h, dtype=np.float32)[None, None, :, None]
    depth_z = base + ramp + 0.1 * rng.standard_normal(
        (b, v, h, w)).astype(np.float32) ** 2
    quats = rng.normal(size=(b, v, 4)).astype(np.float32) * np.array(
        [0.05, 0.05, 0.05, 1.0], np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    trans = 0.2 * rng.standard_normal((b, v, 3)).astype(np.float32)
    imgs = rng.normal(size=(b, v, h, w, 3)).astype(np.float32) * 0.5

    x = np.arange(w, dtype=np.float32)[None, :]
    y = np.arange(h, dtype=np.float32)[:, None]
    xx = np.broadcast_to((x - cx) / f, (h, w))
    yy = np.broadcast_to((y - cy) / f, (h, w))
    dirs = np.stack([xx, yy, np.ones((h, w), np.float32)], axis=-1)
    rays = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays = np.broadcast_to(rays, (b, v, h, w, 3)).astype(np.float32)
    pts_cam = np.stack([(x - cx) * depth_z / f, (y - cy) * depth_z / f,
                        depth_z], axis=-1).astype(np.float32)
    rot = _quat_to_rot(quats)  # (B, V, 3, 3)
    pts = ((rot[:, :, None, None] * pts_cam[..., None, :]).sum(-1)
           + trans[:, :, None, None, :]).astype(np.float32)
    depth_along_ray = np.linalg.norm(pts_cam, axis=-1, keepdims=True)
    ones_bv = np.ones((b, v), bool)
    return {
        "views": {"img": imgs, "ray_directions_cam": rays,
                  "depth_along_ray": depth_along_ray,
                  "camera_pose_quats": quats, "camera_pose_trans": trans,
                  "is_metric_scale": ones_bv},
        "gt": {"pts3d": pts, "pts3d_cam": pts_cam,
               "ray_directions_cam": rays,
               "depth_along_ray": depth_along_ray,
               "camera_pose_quats": quats, "camera_pose_trans": trans,
               "valid_mask": depth_z > 0,
               "non_ambiguous_mask": np.ones((b, v, h, w), bool),
               "is_metric_scale": np.ones((b,), bool),
               "is_synthetic": np.zeros((b,), bool)},
    }
