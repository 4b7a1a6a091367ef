"""ModularDUSt3R: the two-view DUSt3R built from the port's parts;
counterpart of mapanything_tpu/models/modular_dust3r.py (the reference's
mapanything/models/mapanything/modular_dust3r.py:46).

A CroCo ViT encoder over both images, `decoder_embed` to the decoder
width, two weight-separate decoder branches cross-attending to each other
(DUSt3R's dec_blocks / dec_blocks2), the fp32 `dec_norm`, and a linear
pointmap + confidence head per branch. View 1's pointmap is in its own
frame, view 2's in view 1's frame: the DUSt3R output convention.

Submodules carry the JAX package's flax scope names, so
utils/weights.py::from_jax_params carries a JAX tree across unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..nn.adaptors import confidence_adaptor
from ..nn.croco import CroCoViT, CrossAttention, DecoderBlock
from ..nn.heads import LinearFeature
from ..nn.layers import Attention, Dense, FusedLayerNorm, init_weights_
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ModularDUSt3RConfig:
    """The JAX package's fields and defaults; `dtype` is a torch dtype."""

    encoder_size: str = "base"
    patch_size: int = 16
    decoder_dim: int = 768
    decoder_depth: int = 12
    decoder_num_heads: int = 12
    dtype: Any = torch.bfloat16


def _split_pointmap(out: torch.Tensor):
    """DUSt3R's "exp" pointmap activation: (..., 4) raw -> points (..., 3)
    with norm expm1(|xyz|) along xyz, and the confidence (..., 1)."""
    xyz, conf = out[..., :3], out[..., 3:4]
    d = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    return xyz / d.clamp_min(1e-8) * torch.expm1(d), confidence_adaptor(conf)


class ModularDUSt3R(nn.Module):
    """Two-view pointmap regression (the DUSt3R architecture).

    Args:
        cfg: the architecture.
        device: where the parameters live: the card when None (raises
            without one), "cpu" when asked.
        generator: random init of the parameters (nn/layers.py::
            init_weights_); None leaves them uninitialised, for a caller
            that loads weights next.
    """

    def __init__(self, cfg: ModularDUSt3RConfig = ModularDUSt3RConfig(),
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dt, dim = cfg.dtype, cfg.decoder_dim
        self.encoder = CroCoViT(cfg.encoder_size, cfg.patch_size, dtype=dt,
                                device=device)
        self.decoder_embed = Dense(self.encoder.embed_dim, dim, dtype=dt,
                                   device=device)
        for i in range(cfg.decoder_depth):
            for branch in (1, 2):
                self.add_module(
                    f"dec{branch}_{i}",
                    DecoderBlock(dim, cfg.decoder_num_heads, dtype=dt,
                                 device=device))
        self.dec_norm = FusedLayerNorm(dim, dtype=torch.float32,
                                       device=device)
        self.head1 = LinearFeature(dim, 4, cfg.patch_size, device=device)
        self.head2 = LinearFeature(dim, 4, cfg.patch_size, device=device)
        if generator is not None:
            init_weights_(self, generator)

    def set_attn_impl(self, impl: str) -> None:
        """Switch every self- and cross-attention to `impl`: "auto" |
        "flash" | "math" (ops/attention.py::sdpa)."""
        for mod in self.modules():
            if isinstance(mod, (Attention, CrossAttention)):
                mod.attn_impl = impl

    def forward(self, views: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """views["img"] (B, 2, H, W, 3) -> pts3d (B, 2, H, W, 3) in view
        1's frame and conf (B, 2, H, W), fp32."""
        cfg = self.cfg
        imgs = views["img"]
        b, v, h, w, _ = imgs.shape
        if v != 2:
            raise ValueError(f"ModularDUSt3R is a 2-view model, got {v} views")
        gh, gw = h // cfg.patch_size, w // cfg.patch_size

        feats = self.encoder(imgs.reshape(b * v, h, w, 3))
        feats = feats.reshape(b, v, gh * gw, self.encoder.embed_dim)
        x1 = self.decoder_embed(feats[:, 0])
        x2 = self.decoder_embed(feats[:, 1])
        for i in range(cfg.decoder_depth):
            x1, x2 = (getattr(self, f"dec1_{i}")(x1, x2),
                      getattr(self, f"dec2_{i}")(x2, x1))
        x1, x2 = self.dec_norm(x1), self.dec_norm(x2)

        dim = cfg.decoder_dim
        pts1, conf1 = _split_pointmap(self.head1(x1.reshape(b, gh, gw, dim)))
        pts2, conf2 = _split_pointmap(self.head2(x2.reshape(b, gh, gw, dim)))
        return {"pts3d": torch.stack([pts1, pts2], dim=1),
                "conf": torch.stack([conf1, conf2], dim=1)[..., 0]}
