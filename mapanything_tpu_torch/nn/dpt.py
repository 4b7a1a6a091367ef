"""DPT dense-prediction head: feature pyramid + regression processor.

Counterpart of mapanything_tpu/nn/dpt.py. The public interface keeps the JAX
package's channel-last layout (hooks (N, gh, gw, C) in, (N, H, W, C_out) fp32
out); inside, tensors are NCHW for PyTorch's convolutions.

Details that carry the reference's math: the residual unit's skip adds
relu(x), not x; FeatureFusionBlock applies its 1x1 out_conv before the 2x
bilinear upsample (the two commute); the x4/x2 resizes are transposed
convolutions with kernel == stride and no padding; upsampling is bilinear
with align_corners=True.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import bilinear_resize_nchw
from .layers import Conv2d, ConvTranspose2d


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3, plus relu(x)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1, dtype=dtype,
                            device=device)
        self.conv2 = Conv2d(features, features, 3, padding=1, dtype=dtype,
                            device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = F.relu(x)
        return self.conv2(F.relu(self.conv1(act))) + act


class FeatureFusionBlock(nn.Module):
    """Fuse a pyramid level with the upsampled coarser path."""

    def __init__(self, features: int, has_residual: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.res_conv_unit1 = (ResidualConvUnit(features, dtype, device)
                               if has_residual else None)
        self.res_conv_unit2 = ResidualConvUnit(features, dtype, device)
        self.out_conv = Conv2d(features, features, 1, dtype=dtype,
                               device=device)

    def forward(self, x: torch.Tensor, res: torch.Tensor | None,
                out_hw: tuple[int, int]) -> torch.Tensor:
        if self.res_conv_unit1 is not None:
            x = x + self.res_conv_unit1(res)
        x = self.out_conv(self.res_conv_unit2(x))
        return bilinear_resize_nchw(x, out_hw)


class DPTFeature(nn.Module):
    """4-hook feature pyramid -> `feature_dim` map at 8x the patch grid."""

    def __init__(self, input_feature_dims: Sequence[int] = (1024,) * 4,
                 feature_dim: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        oc = tuple(out_channels)
        for i, (ic, o) in enumerate(zip(input_feature_dims, oc)):
            self.add_module(f"project_{i}", Conv2d(ic, o, 1, **kw))
        self.resize_0 = ConvTranspose2d(oc[0], oc[0], 4, stride=4, **kw)
        self.resize_1 = ConvTranspose2d(oc[1], oc[1], 2, stride=2, **kw)
        self.resize_3 = Conv2d(oc[3], oc[3], 3, stride=2, padding=1, **kw)
        for i, o in enumerate(oc):
            self.add_module(f"layer_rn_{i}",
                            Conv2d(o, feature_dim, 3, padding=1, bias=False,
                                   **kw))
        self.refinenet4 = FeatureFusionBlock(feature_dim, False, **kw)
        self.refinenet3 = FeatureFusionBlock(feature_dim, **kw)
        self.refinenet2 = FeatureFusionBlock(feature_dim, **kw)
        self.refinenet1 = FeatureFusionBlock(feature_dim, **kw)

    def forward(self, hooks: Sequence[torch.Tensor]) -> torch.Tensor:
        """hooks: 4 maps (N, gh, gw, C_i) -> (N, feature_dim, 8gh, 8gw)."""
        gh, gw = hooks[0].shape[1:3]
        lv = [getattr(self, f"project_{i}")(h.permute(0, 3, 1, 2))
              for i, h in enumerate(hooks)]
        lv = [self.resize_0(lv[0]), self.resize_1(lv[1]), lv[2],
              self.resize_3(lv[3])]
        rn = [getattr(self, f"layer_rn_{i}")(x) for i, x in enumerate(lv)]
        path = self.refinenet4(rn[3], None, rn[2].shape[-2:])
        path = self.refinenet3(path, rn[2], rn[1].shape[-2:])
        path = self.refinenet2(path, rn[1], rn[0].shape[-2:])
        return self.refinenet1(path, rn[0], (gh * 8, gw * 8))


class DPTRegressionProcessor(nn.Module):
    """conv3x3 -> bilinear to (H, W) -> conv3x3 -> relu -> conv1x1."""

    def __init__(self, input_feature_dim: int = 256, output_dim: int = 6,
                 hidden_dims: Sequence[int] = (128, 64),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        h0, h1 = hidden_dims
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv2d(input_feature_dim, h0, 3, padding=1, **kw)
        self.conv2 = Conv2d(h0, h1, 3, padding=1, **kw)
        self.conv_out = Conv2d(h1, output_dim, 1, **kw)

    def forward(self, x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
        """(N, C, h, w) -> (N, H, W, output_dim) fp32."""
        x = bilinear_resize_nchw(self.conv1(x), out_hw)
        x = self.conv_out(F.relu(self.conv2(x)))
        return x.permute(0, 2, 3, 1).float()
