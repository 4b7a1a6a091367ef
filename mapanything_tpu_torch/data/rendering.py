"""Mesh -> z-depth rendering by ray casting, in torch on the card;
counterpart of mapanything_tpu/data/rendering.py.

The WAI rendering stage (reference
data_processing/wai_processing/scripts/run_rendering.py:38-455) bakes GT
depth from scene meshes with nvdiffrast or pyrender. Like the JAX package,
the port ray-casts instead: every pixel's ray meets every triangle
(Moller-Trumbore), pixels in chunks and triangles in chunks with a running
z-min, rays scaled so that the hit parameter t is z-depth. The tests are
JAX's: |det| > 1e-12, barycentrics padded by 1e-5 (a ray on an edge shared
by two triangles hits at least one of them), t > 1e-6; misses become 0.

With the ray origin at the camera centre, Moller-Trumbore's determinant
and both barycentric numerators are dot products of the ray direction with
three per-triangle vectors, and t's numerator is per triangle alone:

    det = e1 . (d x e2) = d . (e2 x e1)
    u   = -a . (d x e2) / det = d . (e2 x -a) / det
    v   = d . (-a x e1) / det,   t = e2 . (-a x e1) / det

So one (C, 3) x (3, 3 Tc) fp32 product gives a chunk's three (C, Tc)
planes, and the inside test and the z-min are elementwise. Stock torch
ops, TF32 off; the cost is O(pixels x triangles), about 0.13 kB of memory
traffic a (pixel, triangle) pair over a chunk's dozen passes. The default
chunk, 16384 pixels x 4096 triangles, is a 0.8 GB (C, 3 Tc) product and,
with u, v, t and the masks beside it, 2.8 GB at the peak; at that size
the passes run near the card's memory rate (2.0e10 pairs/s on an H100:
5.2 s for a 1752 x 1168 frame of 52272 triangles).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import full_fp32, resolve_device

__all__ = ["render_mesh_depth", "render_scene_depths"]

PIXEL_CHUNK = 16384
TRI_CHUNK = 4096
_EPS = 1e-5  # the padded inside test


def _triangle_planes(verts, tris, w2c):
    """(3, 3 T) per-triangle vectors [e2 x e1 | e2 x -a | -a x e1] and the
    (T,) numerators of t, in the camera frame."""
    v_cam = verts @ w2c[:3, :3].T + w2c[:3, 3]
    a = v_cam[tris[:, 0]]
    e1 = v_cam[tris[:, 1]] - a
    e2 = v_cam[tris[:, 2]] - a
    tvec = -a
    qvec = torch.linalg.cross(tvec, e1)
    planes = torch.cat([torch.linalg.cross(e2, e1),
                        torch.linalg.cross(e2, tvec), qvec]).T
    return planes.contiguous(), (e2 * qvec).sum(-1)


def _raycast_depth(verts, tris, K, cam2world, hw, pixel_chunk, tri_chunk):
    h, w = hw
    dev = verts.device
    w2c = torch.linalg.inv(cam2world)
    planes, t_num = _triangle_planes(verts, tris, w2c)
    n_tri = tris.shape[0]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    dirs = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                        torch.ones_like(xs)], dim=-1).reshape(-1, 3)
    z = torch.full((dirs.shape[0],), float("inf"), device=dev)
    for p0 in range(0, dirs.shape[0], pixel_chunk):
        d = dirs[p0:p0 + pixel_chunk]
        zmin = z[p0:p0 + pixel_chunk]
        for t0 in range(0, n_tri, tri_chunk):
            tc = min(tri_chunk, n_tri - t0)
            cols = torch.cat([planes[:, k * n_tri + t0:k * n_tri + t0 + tc]
                              for k in range(3)], dim=1)
            det, u_num, v_num = (d @ cols).view(-1, 3, tc).unbind(1)
            ok = det.abs() > 1e-12
            inv = torch.where(ok, det.reciprocal(), 0.0)
            u = u_num * inv
            v = v_num * inv
            t = t_num[t0:t0 + tc] * inv
            hit = (ok & (u >= -_EPS) & (v >= -_EPS) & (u + v <= 1 + _EPS)
                   & (t > 1e-6))
            torch.minimum(zmin, torch.where(hit, t, float("inf")).amin(1),
                          out=zmin)
    z = z.reshape(h, w)
    return torch.where(torch.isfinite(z), z, 0.0)


def render_mesh_depth(
    vertices: np.ndarray,
    faces: np.ndarray,
    intrinsics: np.ndarray,
    cam2world: np.ndarray,
    hw,
    pixel_chunk: int = PIXEL_CHUNK,
    tri_chunk: int = TRI_CHUNK,
    device=None,
) -> np.ndarray:
    """z-depth render of a triangle mesh from a pinhole camera.

    Args:
        vertices: (N, 3) world-frame positions.
        faces: (T, 3) int vertex indices.
        intrinsics: (3, 3) K; cam2world: (4, 4) OpenCV pose.
        hw: (height, width) of the output.
        device: where the rays are cast; the card when None.

    Returns:
        (H, W) float32 z-depth, 0 where no surface is hit.
    """
    return render_scene_depths(vertices, faces, np.asarray(intrinsics)[None],
                               np.asarray(cam2world)[None], hw,
                               pixel_chunk, tri_chunk, device)[0]


def render_scene_depths(
    vertices: np.ndarray,
    faces: np.ndarray,
    intrinsics: np.ndarray,
    cam2worlds: np.ndarray,
    hw,
    pixel_chunk: int = PIXEL_CHUNK,
    tri_chunk: int = TRI_CHUNK,
    device=None,
) -> np.ndarray:
    """Every frame of a scene: (F, H, W) depths from (F, 3, 3) / (F, 4, 4)
    cameras against one shared mesh, moved to the device once (the
    reference stage's per-scene loop, run_rendering.py:213-455)."""
    device = resolve_device(device)
    verts = torch.as_tensor(np.asarray(vertices, np.float32), device=device)
    tris = torch.as_tensor(np.asarray(faces, np.int64), device=device)
    Ks = torch.as_tensor(np.asarray(intrinsics, np.float32), device=device)
    poses = torch.as_tensor(np.asarray(cam2worlds, np.float32),
                            device=device)
    hw = (int(hw[0]), int(hw[1]))
    with full_fp32():
        out = [_raycast_depth(verts, tris, Ks[i], poses[i], hw, pixel_chunk,
                              tri_chunk) for i in range(len(poses))]
    return torch.stack(out).cpu().numpy()
