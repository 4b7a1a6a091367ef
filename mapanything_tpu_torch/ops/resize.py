"""Bilinear and nearest resizes with torch semantics (bilinear with
align_corners=True by default).

Counterparts of mapanything_tpu/ops/resize.py, which builds torch-exact
interpolation matrices (bilinear) and index gathers (nearest) for XLA; here
F.interpolate and indexing are the operations themselves. In fp32 the
bilinear resizes agree to rounding; in bf16 the JAX version rounds between
its two separable passes and this one does not. Nearest is a gather: equal.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


# CUDA's bilinear upsample indexes its output in 32 bits: a call may write
# at most this many elements (the 100-view dense head's (100, 256, 296,
# 296) and (100, 128, 518, 518) exceed it)
MAX_OUTPUT_ELEMENTS = 2**31 - 1


def bilinear_resize_nchw(x: torch.Tensor, out_hw: tuple[int, int],
                         align_corners: bool = True) -> torch.Tensor:
    """Resize (N, C, H, W) to (N, C, h, w), in batch slices small enough
    for one upsample call each."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    h, w = out_hw
    step = max(1, MAX_OUTPUT_ELEMENTS // (x.shape[1] * h * w))
    if x.shape[0] <= step:
        return F.interpolate(x, size=(h, w), mode="bilinear",
                             align_corners=align_corners)
    fmt = (torch.channels_last
           if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    out = torch.empty((x.shape[0], x.shape[1], h, w), dtype=x.dtype,
                      device=x.device, memory_format=fmt)
    for i in range(0, x.shape[0], step):
        out[i:i + step] = F.interpolate(x[i:i + step], size=(h, w),
                                        mode="bilinear",
                                        align_corners=align_corners)
    return out


def bilinear_resize(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Resize (N, H, W, C) to (N, h, w, C)."""
    y = bilinear_resize_nchw(x.permute(0, 3, 1, 2), out_hw, align_corners)
    return y.permute(0, 2, 3, 1)


def nearest_resize(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize (..., H, W, C) to (..., h, w, C) by torch's "nearest" rule:
    output row i reads input row floor(i * H / h), the same for columns."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    rows = torch.arange(oh, device=x.device) * h // oh
    cols = torch.arange(ow, device=x.device) * w // ow
    return x[..., rows, :, :][..., :, cols, :]
