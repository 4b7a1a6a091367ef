"""Geometric-prior encoders; counterpart of mapanything_tpu/nn/encoders.py.

The model fuses optional geometric inputs into the image features with
small encoders that compute in fp32:

  * `DenseRepEncoder`: a k = s = patch-size convolution (no positional
    encoding) over a dense per-pixel map, for the 3-channel ray directions
    and the 1-channel log-depth;
  * `GlobalRepEncoder`: fc1 -> exact-erf GELU -> fc2 on a per-view vector
    (4-d quaternion, 3-d translation, 1-d log-scale), one embedding per
    view. Its GELU is exact whatever the model's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Dense


class DenseRepEncoder(nn.Module):
    """(B, H, W, C_in) -> (B, H/p, W/p, embed_dim), fp32."""

    def __init__(self, in_channels: int, embed_dim: int, patch_size: int = 14,
                 device=None):
        super().__init__()
        self.proj = Conv2d(in_channels, embed_dim, patch_size,
                           stride=patch_size, dtype=torch.float32,
                           device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.proj(x.float().permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1)


class GlobalRepEncoder(nn.Module):
    """(B, C_in) -> (B, embed_dim), fp32."""

    def __init__(self, in_dim: int, embed_dim: int, device=None):
        super().__init__()
        self.fc1 = Dense(in_dim, embed_dim, dtype=torch.float32, device=device)
        self.fc2 = Dense(embed_dim, embed_dim, dtype=torch.float32,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x.float()), approximate="none"))
