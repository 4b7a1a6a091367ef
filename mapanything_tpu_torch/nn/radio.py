"""RADIO (NVIDIA AM-RADIO) ViT encoder; counterpart of
mapanything_tpu/nn/radio.py.

The third encoder family of the reference (encoder_str "radio",
radio_v2.5-{b,l,h}), as the JAX package rebuilds the published RADIOModel:

  * the input conditioner: [0, 1] images (data_norm_type "radio" is the
    identity at the data layer) normalised inside the model by the CLIP
    statistics, kept as parameters so a checkpoint carries its own;
  * the patch embedding, a Linear over (p, p, 3)-flattened patches, as a
    p-stride conv (the same product; utils/weights.py::convert_radio
    reshapes the Linear);
  * an absolute pos-embed stored at the pretraining grid `img_size / p` and
    resized bilinearly (align_corners=False) to the input grid by two fp32
    matmuls with the JAX package's matrices;
  * a class token and optional register tokens with no pos-embed;
  * timm pre-norm blocks without LayerScale, then a plain fp32 LayerNorm;
    the output is the patch tokens.

The blocks take the whole ragged sequence (1 + registers + patches, 769 at
512x384) with no aligned-token padding, as the JAX package's RadioViT
calls its blocks without `n_valid`: on the card the kernel masks the tail
of its last tiles itself. The kernel takes head dim 64 only, so "huge"
(head dim 80) raises on CUDA tensors (ops/flash_attention.py) and runs
on the CPU through the plain version.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..utils.device import device_constant
from .layers import Block, Conv2d, FusedLayerNorm, checkpointed

RADIO_CONFIGS = {
    # "test" is a 2-layer stub with the same module structure, for unit
    # tests only
    "test": dict(embed_dim=64, depth=2, num_heads=2),
    # radio_v2.5-b / -l / -h
    "base": dict(embed_dim=768, depth=12, num_heads=12),
    "large": dict(embed_dim=1024, depth=24, num_heads=16),
    "huge": dict(embed_dim=1280, depth=32, num_heads=16),
}

# RADIO's default conditioner: the OpenAI-CLIP normalisation of [0, 1] input
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


@functools.lru_cache(maxsize=64)
def bilinear_resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) matrix M with M @ x == F.interpolate(x, bilinear,
    align_corners=False) along one axis (no antialias). Shared between
    callers: do not modify it."""
    mat = np.zeros((dst, src), dtype=np.float64)
    scale = dst / src
    for i in range(dst):
        s = (i + 0.5) / scale - 0.5
        lo = int(np.floor(s))
        frac = s - lo
        for j, w in ((lo, 1.0 - frac), (lo + 1, frac)):
            mat[i, int(np.clip(j, 0, src - 1))] += w
    mat = mat.astype(np.float32)
    mat.setflags(write=False)
    return mat


@device_constant
def _bilinear_matrices(src_hw: tuple, dst_hw: tuple, device) -> tuple:
    """resample_pos_embed_bilinear's two resize matrices on `device`."""
    return tuple(torch.tensor(bilinear_resize_matrix(s, d), device=device)
                 for s, d in zip(src_hw, dst_hw))


def resample_pos_embed_bilinear(pos: torch.Tensor, src_hw: tuple,
                                dst_hw: tuple) -> torch.Tensor:
    """Bilinear-resample (src_h*src_w, C) pos-embeds to (dst_h*dst_w, C) in
    fp32, as two matmuls."""
    (sh, sw), (dh, dw) = src_hw, dst_hw
    if (sh, sw) == (dh, dw):
        return pos
    c = pos.shape[-1]
    grid = pos.reshape(sh, sw, c).float()
    mh, mw = _bilinear_matrices((sh, sw), (dh, dw), pos.device)
    out = torch.einsum("ij,jkc->ikc", mh, grid)
    out = torch.einsum("kj,ijc->ikc", mw, out)
    return out.reshape(dh * dw, c)


class RadioViT(nn.Module):
    """RADIO vision transformer returning the patch-token map: (B, H, W, 3)
    NHWC images in [0, 1] -> (B, H/p, W/p, C)."""

    def __init__(self, size: str = "large", patch_size: int = 16,
                 img_size: int = 1024, num_register_tokens: int = 0,
                 dtype: torch.dtype = torch.float32,
                 gradient_checkpointing: bool = False, device=None):
        super().__init__()
        cfg = RADIO_CONFIGS[size]
        dim = cfg["embed_dim"]
        self.embed_dim = dim
        self.patch_size = patch_size
        self.grid = img_size // patch_size
        self.num_register_tokens = num_register_tokens
        self.dtype = dtype
        self.gradient_checkpointing = gradient_checkpointing
        self.norm_mean = nn.Parameter(torch.tensor(CLIP_MEAN, device=device))
        self.norm_std = nn.Parameter(torch.tensor(CLIP_STD, device=device))
        self.patch_embed = Conv2d(3, dim, patch_size, stride=patch_size,
                                  dtype=dtype, device=device)
        self.pos_embed = nn.Parameter(
            torch.empty(self.grid * self.grid, dim, device=device))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, device=device))
        self.register_tokens = (
            nn.Parameter(torch.empty(1, num_register_tokens, dim,
                                     device=device))
            if num_register_tokens else None)
        self.blocks = nn.ModuleList(
            Block(dim, cfg["num_heads"], dtype=dtype, device=device)
            for _ in range(cfg["depth"]))
        for blk in self.blocks:
            blk.mlp.checkpoint_chunks = gradient_checkpointing
        self.norm = FusedLayerNorm(dim, dtype=torch.float32, device=device)
        # what a random init (nn/layers.py::init_weights_) leaves as it is
        self.init_constants = {"norm_mean": CLIP_MEAN, "norm_std": CLIP_STD}

    def forward(self, x: torch.Tensor,
                mlp_chunk: Optional[int] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        dim, dt = self.embed_dim, self.dtype
        x = (x.float() - self.norm_mean) / self.norm_std
        x = self.patch_embed(x.permute(0, 3, 1, 2))  # (B, dim, gh, gw)
        x = x.flatten(2).transpose(1, 2)
        pos = resample_pos_embed_bilinear(self.pos_embed,
                                          (self.grid, self.grid), (gh, gw))
        x = x + pos[None].to(dt)
        tokens = [self.cls_token.to(dt).expand(b, 1, dim)]
        if self.register_tokens is not None:
            tokens.append(self.register_tokens.to(dt).expand(
                b, self.num_register_tokens, dim))
        x = torch.cat(tokens + [x], dim=1)
        for blk in self.blocks:
            if self.gradient_checkpointing:
                x = checkpointed(blk, x, None, mlp_chunk)
            else:
                x = blk(x, None, mlp_chunk)
        x = self.norm(x)[:, 1 + self.num_register_tokens:]
        return x.reshape(b, gh, gw, dim).to(dt)
