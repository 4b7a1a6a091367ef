"""Edge masks of the inference postprocess; counterparts of
mapanything_tpu/geometry/edges.py (max_pool_2d, depth_edge,
points_normal_edges, points_to_normals)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def max_pool_2d(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Stride-1 max pool over the last two axes, -inf padding of
    kernel_size // 2 (the output keeps the input's shape)."""
    shape = x.shape
    y = F.max_pool2d(x.reshape(-1, 1, *shape[-2:]), kernel_size, stride=1,
                     padding=kernel_size // 2)
    return y.reshape(shape)


def depth_edge(depth: torch.Tensor, atol: float | None = None,
               rtol: float | None = None, kernel_size: int = 3,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Depth-discontinuity mask over (..., H, W): the window's max - min
    exceeds atol, or rtol * depth. Masked pixels do not take part."""
    if mask is None:
        diff = max_pool_2d(depth, kernel_size) + max_pool_2d(-depth, kernel_size)
    else:
        neg_inf = torch.full_like(depth, -math.inf)
        diff = (max_pool_2d(torch.where(mask, depth, neg_inf), kernel_size)
                + max_pool_2d(torch.where(mask, -depth, neg_inf), kernel_size))
    edge = torch.zeros(depth.shape, dtype=torch.bool, device=depth.device)
    if atol is not None:
        edge |= diff > atol
    if rtol is not None:
        edge |= (diff / depth) > rtol
    return edge


def _pad_hw(x: torch.Tensor, mode: str = "constant") -> torch.Tensor:
    shape = x.shape
    y = F.pad(x.reshape(-1, 1, *shape[-2:]), (1, 1, 1, 1), mode=mode)
    return y.reshape(*shape[:-2], shape[-2] + 2, shape[-1] + 2)


def _slice_hw(arr: torch.Tensor, di: int, dj: int, h: int,
              w: int) -> torch.Tensor:
    """The (h, w) window at offset (di, dj) of the last two axes."""
    return arr[..., di:di + h, dj:dj + w]


def _normal_planes(point: torch.Tensor, mask: torch.Tensor | None):
    """The normal map of a pointmap (..., H, W, 3) as three (..., H, W)
    planes and its mask: the normalised sum of the unit cross products of
    the four quads around each pixel whose three points are valid (zero
    padding, 1e-12 in every normalisation), zero where no quad is."""
    h, w = point.shape[-3], point.shape[-2]
    if mask is None:
        mask = torch.ones(point.shape[:-1], dtype=torch.bool,
                          device=point.device)
    pp = [_pad_hw(point[..., i]) for i in range(3)]
    mp = _pad_hw(mask.float()) > 0.5

    def sl(arr, di, dj):
        return _slice_hw(arr, di, dj, h, w)

    c = [sl(p, 1, 1) for p in pp]
    up = [sl(p, 0, 1) - cc for p, cc in zip(pp, c)]
    left = [sl(p, 1, 0) - cc for p, cc in zip(pp, c)]
    down = [sl(p, 2, 1) - cc for p, cc in zip(pp, c)]
    right = [sl(p, 1, 2) - cc for p, cc in zip(pp, c)]
    m_c = sl(mp, 1, 1)
    m_u, m_l, m_d, m_r = sl(mp, 0, 1), sl(mp, 1, 0), sl(mp, 2, 1), sl(mp, 1, 2)

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def unit(vec):
        inv = 1.0 / (torch.sqrt(vec[0] * vec[0] + vec[1] * vec[1]
                                + vec[2] * vec[2]) + 1e-12)
        return (vec[0] * inv, vec[1] * inv, vec[2] * inv)

    nx = ny = nz = 0.0
    nmask = torch.zeros_like(m_c)
    for a, b, m2 in ((up, left, m_u & m_l), (left, down, m_l & m_d),
                     (down, right, m_d & m_r), (right, up, m_r & m_u)):
        cr = unit(cross(a, b))
        valid = m2 & m_c
        nx = nx + cr[0] * valid
        ny = ny + cr[1] * valid
        nz = nz + cr[2] * valid
        nmask = nmask | valid
    nx, ny, nz = unit((nx, ny, nz))
    return (nx * nmask, ny * nmask, nz * nmask), nmask


def points_to_normals(point: torch.Tensor, mask: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-product normal map of a pointmap, batched over any leading
    axes, on the pointmap's device.

    Args:
        point: (..., H, W, 3) pointmap.
        mask: optional (..., H, W) bool of valid pixels.

    Returns:
        (normals (..., H, W, 3), normal_mask (..., H, W)); the normals are
        zero where normal_mask is False.

    The JAX package's XLA fuses the cross products and norms (with FMA);
    on a smooth surface the two lie within ~2e-7, but where the four unit
    normals nearly cancel (random points) fp32 rounding grows past 1e-5.
    """
    planes, nmask = _normal_planes(point, mask)
    return torch.stack(planes, dim=-1), nmask


def points_normal_edges(point: torch.Tensor, tol: float, kernel_size: int = 3,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Pointmap (..., H, W, 3) -> normals -> normal-edge mask (..., H, W).

    Normals are the normalised sum of the four quad cross products around
    each pixel (zero padding); a pixel is an edge when the largest angle
    between its normal and a valid neighbour's, dilated over the window,
    exceeds `tol` degrees (tested as a minimum cosine).
    """
    h, w = point.shape[-3], point.shape[-2]
    (nx, ny, nz), nmask = _normal_planes(point, mask)

    def sl(arr, di, dj):
        return _slice_hw(arr, di, dj, h, w)

    # window minimum of the cosine (== maximum angle), edge-replicate padding
    npx, npy, npz = (_pad_hw(t, mode="replicate") for t in (nx, ny, nz))
    nmp = _pad_hw(nmask.float(), mode="replicate") > 0.5
    min_cos = torch.ones_like(nx)
    for di in range(kernel_size):
        for dj in range(kernel_size):
            cos = (nx * sl(npx, di, dj) + ny * sl(npy, di, dj)
                   + nz * sl(npz, di, dj))
            cos = torch.where(sl(nmp, di, dj), cos, 1.0)
            min_cos = torch.minimum(min_cos, cos.clamp(-1.0, 1.0))
    min_cos = -max_pool_2d(-min_cos, kernel_size)
    return min_cos < math.cos(math.radians(tol))
