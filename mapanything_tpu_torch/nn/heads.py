"""Pose and scale heads, counterparts of mapanything_tpu/nn/heads.py.

PoseHead: token map -> 1x1 conv -> residual conv units -> mean over patches
-> fc1 -> GELU (erf) -> fc_out in fp32 -> (trans 3, quat 4).
MLPHead: scale token -> fc1 -> GELU (erf) -> fc2 in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .dpt import ResidualConvUnit
from .layers import Conv2d, Dense


class PoseHead(nn.Module):
    def __init__(self, input_feature_dim: int = 1024,
                 num_resconv_block: int = 2, rot_representation_dim: int = 4,
                 trans_dim: int = 3, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        hidden = input_feature_dim // 2
        self.proj = Conv2d(input_feature_dim, hidden, 1, dtype=dtype,
                           device=device)
        self.num_resconv_block = num_resconv_block
        for i in range(num_resconv_block):
            self.add_module(f"res_conv_{i}",
                            ResidualConvUnit(hidden, dtype, device))
        self.fc1 = Dense(hidden, hidden, dtype=dtype, device=device)
        self.fc_out = Dense(hidden, trans_dim + rot_representation_dim,
                            dtype=torch.float32, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, gh, gw, C) -> (N, trans + rot) fp32."""
        x = self.proj(x.permute(0, 3, 1, 2))
        for i in range(self.num_resconv_block):
            x = getattr(self, f"res_conv_{i}")(x)
        x = F.gelu(self.fc1(x.mean(dim=(-2, -1))))
        return self.fc_out(x.float())


class MLPHead(nn.Module):
    def __init__(self, input_feature_dim: int = 1024, output_dim: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        hidden = input_feature_dim // 2
        self.fc1 = Dense(input_feature_dim, hidden, dtype=dtype, device=device)
        self.fc2 = Dense(hidden, output_dim, dtype=torch.float32,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)).float())
