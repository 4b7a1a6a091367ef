"""DINOv2 ViT encoder, counterpart of mapanything_tpu/nn/dinov2.py::DinoViT.

Torch-hub DINOv2 (patch 14, img_size 518, LayerScale init 1.0, pos-embed
interpolation with the +0.1 offset), optionally with register tokens
(`num_register_tokens`, no pos-embed, between the class token and the
patches). Inputs are NHWC images already normalised with the encoder's
mean/std; the output is the (B, H/14, W/14, C) patch-token map after the
final norm. With `fold_layerscale` the blocks hold no LayerScale: the
conversion folds each gamma into the layer before it (`proj`, `fc2`;
utils/weights.py::convert_dinov2), a serving-only form.

The patch pos-embed resize uses the same torch-exact bicubic matrices as the
JAX package (numpy, cubic convolution a = -0.75, border clamp), applied as
two fp32 matmuls. The token axis can be padded once to a multiple of
`pad_tokens_to` (1370 -> 1408 at 518^2); every block then masks the pad
keys through `n_valid`. With `gradient_checkpointing` each block is
recomputed in the backward (the JAX package's `nn.remat` per block).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import device_constant
from .layers import Block, Conv2d, FusedLayerNorm, checkpointed

DINOV2_CONFIGS = {
    # "test" is not a real DINOv2: a 2-layer stub for unit tests
    "test": dict(embed_dim=64, depth=2, num_heads=2),
    "small": dict(embed_dim=384, depth=12, num_heads=6),
    "base": dict(embed_dim=768, depth=12, num_heads=12),
    "large": dict(embed_dim=1024, depth=24, num_heads=16),
    "giant": dict(embed_dim=1536, depth=40, num_heads=24),
}
IMG_SIZE = 518  # the pos-embed grid is 518 / patch_size square
LAYERSCALE_INIT = 1.0


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (Keys), a=-0.75: torch's bicubic."""
    ax = np.abs(x)
    w = np.zeros_like(ax)
    m1 = ax <= 1
    m2 = (ax > 1) & (ax < 2)
    w[m1] = (a + 2) * ax[m1] ** 3 - (a + 3) * ax[m1] ** 2 + 1
    w[m2] = a * ax[m2] ** 3 - 5 * a * ax[m2] ** 2 + 8 * a * ax[m2] - 4 * a
    return w


@functools.lru_cache(maxsize=64)
def torch_bicubic_resize_matrix(src: int, dst: int, scale: float) -> np.ndarray:
    """(dst, src) matrix M with M @ x == F.interpolate(x, bicubic,
    align_corners=False, scale_factor=scale) along one axis.

    The returned array is shared between callers: do not modify it."""
    mat = np.zeros((dst, src), dtype=np.float64)
    for i in range(dst):
        s = (i + 0.5) / scale - 0.5
        s_floor = math.floor(s)
        frac = s - s_floor
        idx = np.array([s_floor - 1, s_floor, s_floor + 1, s_floor + 2])
        w = _cubic_kernel(np.array([1 + frac, frac, 1 - frac, 2 - frac]))
        idx = np.clip(idx, 0, src - 1)  # border replication, like torch
        for j, ww in zip(idx, w):
            mat[i, j] += ww
    mat = mat.astype(np.float32)
    mat.setflags(write=False)
    return mat


@device_constant
def _bicubic_matrices(src_hw: tuple, dst_hw: tuple, offset: float,
                      device) -> tuple:
    """interpolate_pos_embed's two resize matrices on `device`."""
    return tuple(torch.tensor(torch_bicubic_resize_matrix(s, d, (d + offset)
                                                          / s), device=device)
                 for s, d in zip(src_hw, dst_hw))


def interpolate_pos_embed(patch_pos_embed: torch.Tensor,
                          src_hw: tuple[int, int], dst_hw: tuple[int, int],
                          interpolate_offset: float = 0.1) -> torch.Tensor:
    """Bicubic-resample (src_h*src_w, C) patch pos-embeds to (dst_h*dst_w, C)
    in fp32, with the DINOv2 +offset on the scale factors."""
    sh, sw = src_hw
    dh, dw = dst_hw
    if (sh, sw) == (dh, dw):
        return patch_pos_embed
    c = patch_pos_embed.shape[-1]
    grid = patch_pos_embed.reshape(sh, sw, c).float()
    mh, mw = _bicubic_matrices((sh, sw), (dh, dw), interpolate_offset,
                               patch_pos_embed.device)
    out = torch.einsum("ij,jkc->ikc", mh, grid)
    out = torch.einsum("kj,ijc->ikc", mw, out)
    return out.reshape(dh * dw, c)


class PatchEmbed(Conv2d):
    """The k=p, s=p patch-embedding conv; the bias is added in the working
    dtype after the convolution, as in the JAX package."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        out = F.conv2d(x.to(dt), self.weight.to(dt), stride=self.stride)
        return out + self.bias.to(dt)[:, None, None]


class DinoViT(nn.Module):
    """DINOv2 vision transformer returning the patch-token map."""

    def __init__(self, size: str = "large", patch_size: int = 14,
                 dtype: torch.dtype = torch.float32,
                 pad_tokens_to: Optional[int] = None,
                 gradient_checkpointing: bool = False,
                 num_register_tokens: int = 0, fold_layerscale: bool = False,
                 device=None):
        super().__init__()
        cfg = DINOV2_CONFIGS[size]
        self.gradient_checkpointing = gradient_checkpointing
        dim = cfg["embed_dim"]
        self.embed_dim = dim
        self.patch_size = patch_size
        self.grid = IMG_SIZE // patch_size
        self.dtype = dtype
        self.pad_tokens_to = pad_tokens_to
        self.patch_embed = PatchEmbed(3, dim, patch_size, stride=patch_size,
                                      dtype=dtype, device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, device=device))
        self.pos_embed = nn.Parameter(
            torch.empty(1 + self.grid * self.grid, dim, device=device))
        self.num_register_tokens = num_register_tokens
        self.register_tokens = (
            nn.Parameter(torch.empty(1, num_register_tokens, dim,
                                     device=device))
            if num_register_tokens else None)
        self.blocks = nn.ModuleList(
            Block(dim, cfg["num_heads"],
                  layerscale_init=None if fold_layerscale else LAYERSCALE_INIT,
                  dtype=dtype, device=device)
            for _ in range(cfg["depth"]))
        for blk in self.blocks:
            blk.mlp.checkpoint_chunks = gradient_checkpointing
        self.norm = FusedLayerNorm(dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                mlp_chunk: Optional[int] = None) -> torch.Tensor:
        """x (B, H, W, 3) -> (B, H/p, W/p, C); `mlp_chunk` bounds the rows
        each MLP runs at once (layers.py::Mlp)."""
        b, h, w, _ = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        dim = self.embed_dim
        x = self.patch_embed(x.permute(0, 3, 1, 2))  # (B, dim, gh, gw)
        x = x.flatten(2).transpose(1, 2)

        patch_pos = interpolate_pos_embed(
            self.pos_embed[1:], (self.grid, self.grid), (gh, gw))
        x = x + patch_pos[None].to(self.dtype)
        cls = (self.cls_token + self.pos_embed[:1][None]).to(self.dtype)
        tokens = [cls.expand(b, 1, dim)]
        if self.register_tokens is not None:
            tokens.append(self.register_tokens.to(self.dtype).expand(
                b, self.num_register_tokens, dim))
        x = torch.cat(tokens + [x], dim=1)

        n_tok = x.shape[1]
        n_valid = None
        if self.pad_tokens_to:
            n_pad = -(-n_tok // self.pad_tokens_to) * self.pad_tokens_to
            if n_pad != n_tok:
                x = F.pad(x, (0, 0, 0, n_pad - n_tok))
                n_valid = n_tok
        for blk in self.blocks:
            if self.gradient_checkpointing:
                x = checkpointed(blk, x, n_valid, mlp_chunk)
            else:
                x = blk(x, n_valid, mlp_chunk)
        start = 1 + self.num_register_tokens
        x = self.norm(x)
        return x[:, start:start + gh * gw].reshape(b, gh, gw, dim)
