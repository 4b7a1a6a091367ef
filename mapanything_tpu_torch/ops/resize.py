"""Bilinear resize with torch semantics (align_corners=True by default).

Counterpart of mapanything_tpu/ops/resize.py::bilinear_resize, which builds
torch-exact interpolation matrices for XLA; here F.interpolate is the
operation itself. In fp32 the two agree to rounding; in bf16 the JAX version
rounds between its two separable passes and this one does not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_resize_nchw(x: torch.Tensor, out_hw: tuple[int, int],
                         align_corners: bool = True) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def bilinear_resize(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Resize (N, H, W, C) to (N, h, w, C)."""
    y = bilinear_resize_nchw(x.permute(0, 3, 1, 2), out_hw, align_corners)
    return y.permute(0, 2, 3, 1)
