"""CroCo ViT encoder and DUSt3R decoder blocks; counterpart of
mapanything_tpu/nn/croco.py.

The CroCo encoder family (the reference's croco_512 encoder config, the
UniCeption CroCo encoder, the DUSt3R architecture): a ViT with a fixed 2D
sin-cos positional embedding and no class token, and decoder blocks of
self-attention, cross-attention and MLP. Every attention goes through
ops/attention.py::sdpa, so on the card the self- and cross-attentions run
the flash forward kernel: the cross-attention hands it q from one
projection and k, v as the strided halves of another, (B, M, 2, H, D).

The cross-attention takes the JAX package's `key_mask` (the math path:
dense scores, the yardstick) or a `context_index` (G, M') that gathers,
for each of G query groups, the context rows it attends to from one kv
projection of the whole context: the same softmax over the same keys,
through the kernel, with no score matrix in memory (the N-view
cross-attention trunk, nn/trunk.py::CrossAttentionTrunk).

Submodules carry the JAX package's flax scope names (utils/weights.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.attention import sdpa
from ..utils.device import device_constant
from .dinov2 import PatchEmbed
from .layers import Attention, Block, Dense, FusedLayerNorm, Mlp

CROCO_CONFIGS = {
    # "test" is a 2-layer stub with the same module structure, for unit
    # tests only
    "test": dict(embed_dim=64, depth=2, num_heads=2),
    "base": dict(embed_dim=768, depth=12, num_heads=12),
    "large": dict(embed_dim=1024, depth=24, num_heads=16),
}


@device_constant
def _pos_embed(gh: int, gw: int, dim: int, device,
               dtype: torch.dtype) -> torch.Tensor:
    """sincos_pos_embed_2d in `dtype` on `device`."""
    return torch.from_numpy(sincos_pos_embed_2d(gh, gw, dim)).to(device,
                                                                 dtype)


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
                key_mask: Optional[torch.Tensor] = None,
                context_index: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x (B, N, C) queries, context (B, M, C).

        key_mask: (M,) or (B, M) bool, True = attendable (ops/attention.py
            ::sdpa: the math path).
        context_index: (G, M') long; x is then (B, G, N, C) and group g
            attends to the context rows context_index[g]. Returns the
            shape of x.
        """
        hd = self.dim // self.num_heads
        kv = self.kv(context)  # (B, M, 2C), one projection for all groups
        if context_index is not None:
            b, g, n, _ = x.shape
            kv = kv[:, context_index].reshape(b * g, -1, 2 * self.dim)
            x = x.reshape(b * g, n, self.dim)
        b, n, _ = x.shape
        q = self.q(x).view(b, n, self.num_heads, hd)
        # k and v: strided (B, M, H, D) views of one (B, M, 2, H, D) tensor
        k, v = kv.view(b, kv.shape[1], 2, self.num_heads, hd).unbind(2)
        out = self.proj(sdpa(q, k, v, impl=self.attn_impl, key_mask=key_mask
                             ).reshape(b, n, self.dim))
        if context_index is not None:
            out = out.reshape(-1, context_index.shape[0], n, self.dim)
        return out


class DecoderBlock(nn.Module):
    """CroCo/DUSt3R decoder block: self-attention, cross-attention to the
    other view's (normed) tokens, MLP; pre-norm, residual. `key_mask` and
    `context_index` are CrossAttention's (x is (B, G, N, C) with the
    latter)."""

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
                key_mask: Optional[torch.Tensor] = None,
                context_index: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        h = self.self_attn(self.norm1(x.reshape(-1, *x.shape[-2:])))
        x = x + h.reshape(x.shape)
        x = x + self.cross_attn(self.norm2(x), self.norm_context(context),
                                key_mask=key_mask,
                                context_index=context_index)
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

    def forward(self, x: torch.Tensor,
                mlp_chunk: Optional[int] = None) -> torch.Tensor:
        """`mlp_chunk` bounds the rows each MLP runs at once
        (layers.py::Mlp)."""
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        x = self.patch_embed(x.permute(0, 3, 1, 2))  # (B, C, gh, gw)
        x = x.flatten(2).transpose(1, 2)
        x = x + _pos_embed(gh, gw, self.embed_dim, x.device, self.dtype)[None]
        for blk in self.blocks:
            x = blk(x, None, mlp_chunk)
        return self.norm(x).reshape(b, gh, gw, self.embed_dim)
