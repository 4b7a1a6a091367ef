"""CroCo ViT encoder and DUSt3R decoder blocks; counterpart of
mapanything_tpu/nn/croco.py.

The CroCo encoder family (the reference's croco_512 encoder config, the
UniCeption CroCo encoder, the DUSt3R architecture): a ViT with a fixed 2D
sin-cos positional embedding and no class token, and decoder blocks of
self-attention, cross-attention and MLP. Every attention goes through
ops/attention.py::sdpa, so on the card the self- and cross-attentions run
the flash forward kernel: the cross-attention hands it q from one
projection and k, v as the strided halves of another, (B, M, 2, H, D).

Submodules carry the JAX package's flax scope names (utils/weights.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.attention import sdpa
from .dinov2 import PatchEmbed
from .layers import Attention, Block, Dense, FusedLayerNorm, Mlp

CROCO_CONFIGS = {
    # "test" is a 2-layer stub with the same module structure, for unit
    # tests only
    "test": dict(embed_dim=64, depth=2, num_heads=2),
    "base": dict(embed_dim=768, depth=12, num_heads=12),
    "large": dict(embed_dim=1024, depth=24, num_heads=16),
}
MASK_ITEM = "ROADMAP queue A item 7 (A1: sdpa with a key mask)"


def sincos_pos_embed_2d(gh: int, gw: int, dim: int) -> np.ndarray:
    """The 2D sin-cos positional embedding (gh*gw, dim) fp32, CroCo's:
    [sin, cos] of the row index, then of the column index, at dim/4
    frequencies each."""
    assert dim % 4 == 0
    d4 = dim // 4
    omega = 1.0 / (10000 ** (np.arange(d4, dtype=np.float64) / d4))
    y = np.arange(gh, dtype=np.float64)
    x = np.arange(gw, dtype=np.float64)
    oy = np.einsum("h,f->hf", y, omega)
    ox = np.einsum("w,f->wf", x, omega)
    emb_y = np.concatenate([np.sin(oy), np.cos(oy)], axis=-1)  # (gh, dim/2)
    emb_x = np.concatenate([np.sin(ox), np.cos(ox)], axis=-1)  # (gw, dim/2)
    grid = np.concatenate(
        [np.repeat(emb_y[:, None, :], gw, axis=1),
         np.repeat(emb_x[None, :, :], gh, axis=0)], axis=-1)
    return grid.reshape(gh * gw, dim).astype(np.float32)


class CrossAttention(nn.Module):
    """Multi-head cross-attention: queries from x, keys and values from
    context, through separate `q` and `kv` projections."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.attn_impl = "auto"
        self.q = Dense(dim, dim, dtype=dtype, device=device)
        self.kv = Dense(dim, 2 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if key_mask is not None:
            raise NotImplementedError(
                f"attention with a key mask is {MASK_ITEM}; ModularDUSt3R "
                "passes none")
        b, n, _ = x.shape
        m = context.shape[1]
        hd = self.dim // self.num_heads
        q = self.q(x).view(b, n, self.num_heads, hd)
        # k and v: strided (B, M, H, D) views of one (B, M, 2, H, D) tensor
        k, v = self.kv(context).view(b, m, 2, self.num_heads, hd).unbind(2)
        out = sdpa(q, k, v, impl=self.attn_impl)
        return self.proj(out.reshape(b, n, self.dim))


class DecoderBlock(nn.Module):
    """CroCo/DUSt3R decoder block: self-attention, cross-attention to the
    other view's (normed) tokens, MLP; pre-norm, residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.norm1 = FusedLayerNorm(dim, dtype=dtype, device=device)
        self.self_attn = Attention(dim, num_heads, dtype=dtype, device=device)
        self.norm2 = FusedLayerNorm(dim, dtype=dtype, device=device)
        self.norm_context = FusedLayerNorm(dim, dtype=dtype, device=device)
        self.cross_attn = CrossAttention(dim, num_heads, dtype=dtype,
                                         device=device)
        self.norm3 = FusedLayerNorm(dim, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype,
                       device=device)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x))
        x = x + self.cross_attn(self.norm2(x), self.norm_context(context),
                                key_mask=key_mask)
        return x + self.mlp(self.norm3(x))


class CroCoViT(nn.Module):
    """CroCo image encoder: patch 16, 2D sin-cos positional embedding, no
    class token. (B, H, W, 3) -> (B, H/p, W/p, C) patch features."""

    def __init__(self, size: str = "base", patch_size: int = 16,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        cfg = CROCO_CONFIGS[size]
        dim = cfg["embed_dim"]
        self.embed_dim = dim
        self.patch_size = patch_size
        self.dtype = dtype
        self.patch_embed = PatchEmbed(3, dim, patch_size, stride=patch_size,
                                      dtype=dtype, device=device)
        self.blocks = nn.ModuleList(
            Block(dim, cfg["num_heads"], dtype=dtype, device=device)
            for _ in range(cfg["depth"]))
        self.norm = FusedLayerNorm(dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        x = self.patch_embed(x.permute(0, 3, 1, 2))  # (B, C, gh, gw)
        x = x.flatten(2).transpose(1, 2)
        pos = torch.from_numpy(sincos_pos_embed_2d(gh, gw, self.embed_dim))
        x = x + pos.to(x.device, self.dtype)[None]
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x).reshape(b, gh, gw, self.embed_dim)
