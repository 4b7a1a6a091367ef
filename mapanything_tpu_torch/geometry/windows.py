"""Sliding windows, max pooling and the depth-aliasing mask over tensors;
counterpart of mapanything_tpu/geometry/windows.py.

The long tail of mapanything/utils/geometry.py's window machinery
(sliding_window_1d:1830, sliding_window_nd:1850, sliding_window_2d:1868,
max_pool_1d:1905, max_pool_nd:1960, depth_aliasing:2075), on the tensor's
device. The window counts are the reference's, (size - window + 1) //
stride, not the conventional (size - window) // stride + 1.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from .edges import max_pool_2d

__all__ = ["depth_aliasing", "max_pool_1d", "max_pool_2d", "max_pool_nd",
           "sliding_window_1d", "sliding_window_2d", "sliding_window_nd"]


def sliding_window_1d(x: torch.Tensor, window_size: int, stride: int,
                      axis: int = -1) -> torch.Tensor:
    """Windows along one axis; the window dim is appended.

    Output shape: x.shape with `axis` replaced by (n_windows,), plus a
    trailing (window_size,) dim. Ref: geometry.py:1830."""
    axis = axis % x.ndim
    n = (x.shape[axis] - window_size + 1) // stride
    lead = (slice(None),) * axis
    return torch.stack([x[lead + (slice(w, w + (n - 1) * stride + 1, stride),)]
                        for w in range(window_size)], dim=-1)


def sliding_window_nd(x: torch.Tensor, window_size: Tuple[int, ...],
                      stride: Tuple[int, ...],
                      axis: Tuple[int, ...]) -> torch.Tensor:
    """sliding_window_1d along several axes; the window dims append in the
    order given. Ref: geometry.py:1850."""
    axis = tuple(a % x.ndim for a in axis)
    for i, a in enumerate(axis):
        x = sliding_window_1d(x, window_size[i], stride[i], a)
    return x


def sliding_window_2d(x: torch.Tensor,
                      window_size: Union[int, Tuple[int, int]],
                      stride: Union[int, Tuple[int, int]],
                      axis: Tuple[int, int] = (-2, -1)) -> torch.Tensor:
    """2D sliding windows; (win_h, win_w) dims append to the shape.
    Ref: geometry.py:1868."""
    if isinstance(window_size, int):
        window_size = (window_size, window_size)
    if isinstance(stride, int):
        stride = (stride, stride)
    return sliding_window_nd(x, window_size, stride, axis)


def max_pool_1d(x: torch.Tensor, kernel_size: int, stride: int,
                padding: int = 0, axis: int = -1) -> torch.Tensor:
    """1D max pool along `axis`, padded with the dtype's lowest value (the
    reference pads with NaN and takes nanmax: the same on finite data).
    Ref: geometry.py:1905."""
    axis = axis % x.ndim
    lowest = (float("-inf") if x.dtype.is_floating_point
              else torch.iinfo(x.dtype).min)
    if padding:
        shape = list(x.shape)
        shape[axis] = padding
        pad = x.new_full(shape, lowest)
        x = torch.cat([pad, x, pad], dim=axis)
    n = (x.shape[axis] - kernel_size + 1) // stride
    return x.unfold(axis, kernel_size, stride).amax(-1).narrow(axis, 0, n)


def max_pool_nd(x: torch.Tensor, kernel_size: Tuple[int, ...],
                stride: Tuple[int, ...], padding: Tuple[int, ...],
                axis: Tuple[int, ...]) -> torch.Tensor:
    """Per-axis max pooling, one axis after another. Ref: geometry.py:1960."""
    for i, a in enumerate(axis):
        x = max_pool_1d(x, kernel_size[i], stride[i], padding[i], a)
    return x


def depth_aliasing(depth: torch.Tensor, atol: float | None = None,
                   rtol: float | None = None, kernel_size: int = 3,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Aliasing mask over (..., H, W): pixels near neither the max nor the
    min of their window (mid-edge samples straddling a depth jump); `mask`
    (..., H, W) names the valid pixels. Ref: geometry.py:2075."""
    if mask is None:
        diff_max = max_pool_2d(depth, kernel_size) - depth
        diff_min = max_pool_2d(-depth, kernel_size) + depth
    else:
        neg_inf = torch.full_like(depth, float("-inf"))
        diff_max = max_pool_2d(torch.where(mask, depth, neg_inf),
                               kernel_size) - depth
        diff_min = max_pool_2d(torch.where(mask, -depth, neg_inf),
                               kernel_size) + depth
    diff = torch.minimum(diff_max, diff_min)
    edge = torch.zeros(depth.shape, dtype=torch.bool, device=depth.device)
    if atol is not None:
        edge |= diff > atol
    if rtol is not None:
        edge |= (diff / depth) > rtol
    return edge
