"""Intrinsics recovery from ray directions; counterpart of
mapanything_tpu/geometry/rays.py::recover_pinhole_intrinsics_from_ray_directions.
"""

from __future__ import annotations

import torch


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
