"""Shared transformer building blocks.

Counterparts of mapanything_tpu/nn/layers.py: the DINOv2/timm pre-norm block
(LN -> MHA -> LayerScale -> residual; LN -> MLP(GELU) -> LayerScale ->
residual) that the encoder and the trunk share.

Dtype policy, as in the JAX package: parameters live in fp32, each layer
computes in its `dtype` (bf16 on the serving path), LayerNorm takes fp32
statistics and casts its output.

Parameters are created uninitialised (`reset_parameters` is a no-op): a model
gets its values from :func:`init_weights_` with an explicit
`torch.Generator`, or from a JAX checkpoint (utils/weights.py). Submodules
carry the names of the JAX package's flax scopes so that conversion is
mechanical.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa


class Dense(nn.Linear):
    """nn.Linear computing in `dtype` from fp32 parameters (flax nn.Dense)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        pass

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """nn.Conv2d (NCHW) computing in `dtype` from fp32 parameters."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias, device=device)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        pass

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (NCHW, padding 0) computing in `dtype`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         device=device)
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        pass

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), stride=self.stride)


class FusedLayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, output cast to `dtype`."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.dtype)


class LayerScale(nn.Module):
    """Per-channel learned residual scaling (gamma), DINOv2-style."""

    def __init__(self, dim: int, init_value: float = 1.0, device=None):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.full((dim,), init_value, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Mlp(nn.Module):
    """Linear -> GELU -> Linear. GELU is tanh-approximate in bf16 and exact
    (erf) otherwise, as in the JAX package."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden_dim, dtype=dtype, device=device)
        self.fc2 = Dense(hidden_dim, out_dim, dtype=dtype, device=device)
        self.approximate = "tanh" if dtype == torch.bfloat16 else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection.

    `attn_impl` picks the ops/attention.py::sdpa path; it is "auto" unless
    models/mapanything.py::MapAnything.set_attn_impl switches it."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.attn_impl = "auto"
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                n_valid: Optional[int] = None) -> torch.Tensor:
        b, n, _ = x.shape
        qkv = self.qkv(x)
        if n_valid is not None and n_valid < n:
            # aligned-token mode: the pad rows are not zero after LayerNorm
            # (its bias revives them); zero their q/k/v
            qkv[:, n_valid:] = 0
        qkv = qkv.view(b, n, 3, self.num_heads, self.dim // self.num_heads)
        q, k, v = qkv.unbind(2)  # strided (B, N, H, D) views
        out = sdpa(q, k, v, impl=self.attn_impl, n_valid=n_valid)
        return self.proj(out.reshape(b, n, self.dim))


class Block(nn.Module):
    """Pre-norm transformer block (MLP ratio 4) with optional LayerScale."""

    def __init__(self, dim: int, num_heads: int,
                 layerscale_init: Optional[float] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.norm1 = FusedLayerNorm(dim, dtype=dtype, device=device)
        self.attn = Attention(dim, num_heads, dtype=dtype, device=device)
        self.norm2 = FusedLayerNorm(dim, dtype=dtype, device=device)
        self.mlp = Mlp(dim, 4 * dim, dim, dtype=dtype, device=device)
        if layerscale_init is not None:
            self.ls1 = LayerScale(dim, layerscale_init, device=device)
            self.ls2 = LayerScale(dim, layerscale_init, device=device)
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x: torch.Tensor,
                n_valid: Optional[int] = None) -> torch.Tensor:
        h = self.attn(self.norm1(x), n_valid=n_valid)
        if self.ls1 is not None:
            h = self.ls1(h)
        x = x + h
        h = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            h = self.ls2(h)
        return x + h


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator,
                  std: float = 0.02) -> nn.Module:
    """Random init from an explicit generator: every weight and embedding
    ~ N(0, std^2), biases 0, LayerNorm and LayerScale at their constants."""
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == "bias":
                p.zero_()
            elif isinstance(mod, FusedLayerNorm):
                p.fill_(1.0)
            elif isinstance(mod, LayerScale):
                p.fill_(mod.init_value)
            else:
                p.normal_(0.0, std, generator=generator)
    return module
