"""Pixel-grid, ray and intrinsics math; counterpart of
mapanything_tpu/geometry/rays.py."""

from __future__ import annotations

import torch

from .quats import rotate


def xy_grid(width: int, height: int, dtype=torch.float32, device=None):
    """Pixel coordinate grids (H, W) each: x[j, i] = i, y[j, i] = j."""
    x = torch.arange(width, dtype=dtype, device=device)[None, :]
    y = torch.arange(height, dtype=dtype, device=device)[:, None]
    return x.expand(height, width), y.expand(height, width)


def _k_params(intrinsics: torch.Tensor):
    """fx, fy, cx, cy of (..., 3, 3) intrinsics, each (..., 1, 1)."""
    return tuple(intrinsics[..., i, j][..., None, None]
                 for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))


def depthmap_to_camera_frame(depthmap: torch.Tensor, intrinsics: torch.Tensor):
    """Depth (..., H, W) and K (..., 3, 3) -> camera-frame pointmap
    (..., H, W, 3) and the valid mask depth > 0."""
    height, width = depthmap.shape[-2:]
    x, y = xy_grid(width, height, depthmap.dtype, depthmap.device)
    fx, fy, cx, cy = _k_params(intrinsics)
    pts = torch.stack([(x - cx) * depthmap / fx, (y - cy) * depthmap / fy,
                       depthmap], dim=-1)
    return pts, depthmap > 0.0


def depthmap_to_world_frame(depthmap: torch.Tensor, intrinsics: torch.Tensor,
                            camera_pose: torch.Tensor | None = None):
    """Depth, K and an optional cam2world (..., 4, 4) -> world-frame
    pointmap (..., H, W, 3) and the valid mask."""
    pts, valid = depthmap_to_camera_frame(depthmap, intrinsics)
    if camera_pose is None:
        return pts, valid
    rot = camera_pose[..., None, None, :3, :3]
    return rotate(rot, pts) + camera_pose[..., None, None, :3, 3], valid


def get_rays_in_camera_frame(intrinsics: torch.Tensor, height: int,
                             width: int, normalize_to_unit_sphere: bool):
    """K (..., 3, 3) -> ray origins (zeros) and directions (..., H, W, 3)."""
    x, y = xy_grid(width, height, intrinsics.dtype, intrinsics.device)
    fx, fy, cx, cy = _k_params(intrinsics)
    xx = (x - cx) / fx
    yy = (y - cy) / fy
    dirs = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)
    if normalize_to_unit_sphere:
        dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    origins = torch.zeros(intrinsics.shape[:-2] + (height, width, 3),
                          dtype=intrinsics.dtype, device=intrinsics.device)
    return origins, dirs


def project_pts3d_to_image(pts3d: torch.Tensor, intrinsics: torch.Tensor,
                          return_z_dim: bool) -> torch.Tensor:
    """Camera-frame points (..., H, W, 3) through K (..., 3, 3) to pixel
    coordinates (..., H, W, 2), the z divisor clamped to >= 1e-6; with
    return_z_dim, the projected z as a third channel."""
    proj = rotate(intrinsics[..., None, None, :, :], pts3d)
    xy = proj[..., :2] / proj[..., 2:3].clamp_min(1e-6)
    return torch.cat([xy, proj[..., 2:3]], dim=-1) if return_z_dim else xy


def transform_rays(ray_origins: torch.Tensor, ray_directions: torch.Tensor,
                   transformation: torch.Tensor):
    """An SE3 transform (..., 4, 4) applied to ray origins (as points) and
    directions (as vectors), both (..., H, W, 3)."""
    rot = transformation[..., None, None, :3, :3]
    return (rotate(rot, ray_origins) + transformation[..., None, None, :3, 3],
            rotate(rot, ray_directions))


def get_rays_in_world_frame(intrinsics: torch.Tensor, height: int,
                            width: int, normalize_to_unit_sphere: bool,
                            camera_pose: torch.Tensor | None = None):
    """get_rays_in_camera_frame, moved to the world frame by a cam2world
    (..., 4, 4) pose when one is given."""
    origins, dirs = get_rays_in_camera_frame(intrinsics, height, width,
                                             normalize_to_unit_sphere)
    if camera_pose is None:
        return origins, dirs
    return transform_rays(origins, dirs, camera_pose)


def convert_z_depth_to_depth_along_ray(z_depth: torch.Tensor,
                                       intrinsics: torch.Tensor
                                       ) -> torch.Tensor:
    """Z-depth (..., H, W) and K (..., 3, 3) -> the Euclidean depth along
    each pixel's ray (..., H, W)."""
    pts3d_cam, _ = depthmap_to_camera_frame(z_depth, intrinsics)
    return torch.linalg.vector_norm(pts3d_cam, dim=-1)


def depth_along_ray_from_z_depth_and_rays(
        depth_z: torch.Tensor, ray_directions: torch.Tensor) -> torch.Tensor:
    """Z-depth (..., H, W, 1) and unit rays (..., H, W, 3) -> the depth
    along each ray (..., H, W, 1): the rays scaled to the z = 1 plane,
    times the z-depth, and the length of that point."""
    pts3d_cam = depth_z * (ray_directions / ray_directions[..., 2:3])
    return torch.linalg.vector_norm(pts3d_cam, dim=-1, keepdim=True)


def recover_pinhole_intrinsics_from_ray_directions(
    ray_directions: torch.Tensor, use_geometric_calculation: bool = False
) -> torch.Tensor:
    """Pinhole K (..., 3, 3) from unit ray directions (..., H, W, 3).

    Least squares on x = cx + fx * dx/dz (and the same for y) over a pixel
    grid subsampled with step max(1, dim // 50); above 1 MP, or on request,
    the direct 5-point geometric calculation.
    """
    batch_shape = ray_directions.shape[:-3]
    height, width, _ = ray_directions.shape[-3:]
    dirs = ray_directions.reshape(-1, height, width, 3)
    bsz = dirs.shape[0]
    dtype, dev = dirs.dtype, dirs.device

    if height * width > 1_000_000 or use_geometric_calculation:
        ch, cw = height // 2, width // 2
        qw, tqw = width // 4, 3 * width // 4
        qh, tqh = height // 4, 3 * height // 4

        def unit_z(p):
            return p / p[:, 2:3]

        center = unit_z(dirs[:, ch, cw])
        left, right = unit_z(dirs[:, ch, qw]), unit_z(dirs[:, ch, tqw])
        top, bottom = unit_z(dirs[:, qh, cw]), unit_z(dirs[:, tqh, cw])
        fx = ((qw - cw) / (left[:, 0] - center[:, 0])
              + (tqw - cw) / (right[:, 0] - center[:, 0])) / 2
        cx = cw - fx * center[:, 0]
        fy = ((qh - ch) / (top[:, 1] - center[:, 1])
              + (tqh - ch) / (bottom[:, 1] - center[:, 1])) / 2
        cy = ch - fy * center[:, 1]
    else:
        h_idx = torch.arange(0, height, max(1, height // 50), device=dev)
        w_idx = torch.arange(0, width, max(1, width // 50), device=dev)
        x_s = w_idx.to(dtype)[None, :].expand(len(h_idx), -1).reshape(-1)
        y_s = h_idx.to(dtype)[:, None].expand(-1, len(w_idx)).reshape(-1)
        rays = dirs[:, h_idx[:, None], w_idx[None, :], :].reshape(bsz, -1, 3)
        dx, dy, dz = rays.unbind(-1)

        def solve_axis(ratio, coord):
            # normal equations for coord = c + f * ratio
            n = ratio.shape[-1]
            s_r = ratio.sum(-1)
            s_rr = (ratio * ratio).sum(-1)
            s_c = coord.sum()
            s_rc = (ratio * coord[None, :]).sum(-1)
            det = n * s_rr - s_r * s_r
            return (s_rr * s_c - s_r * s_rc) / det, (n * s_rc - s_r * s_c) / det

        cx, fx = solve_axis(dx / dz, x_s)
        cy, fy = solve_axis(dy / dz, y_s)

    k = torch.zeros(bsz, 3, 3, dtype=dtype, device=dev)
    k[:, 0, 0] = fx
    k[:, 1, 1] = fy
    k[:, 0, 2] = cx
    k[:, 1, 2] = cy
    k[:, 2, 2] = 1.0
    return k.reshape(batch_shape + (3, 3))


def _principal_point_shift(k: torch.Tensor, sign: float) -> torch.Tensor:
    offset = torch.zeros_like(k)
    offset[..., 0, 2] = 0.5
    offset[..., 1, 2] = 0.5
    return k + sign * offset


def colmap_to_opencv_intrinsics(k: torch.Tensor) -> torch.Tensor:
    """The principal point of (..., 3, 3) intrinsics moved by -0.5 px (the
    COLMAP convention to OpenCV's)."""
    return _principal_point_shift(k, -1.0)


def opencv_to_colmap_intrinsics(k: torch.Tensor) -> torch.Tensor:
    """The principal point moved by +0.5 px (OpenCV's convention to
    COLMAP's)."""
    return _principal_point_shift(k, 1.0)
