"""Alternating frame/global multi-view trunk with IFR taps.

Counterpart of mapanything_tpu/nn/trunk.py::AlternatingAttentionTrunk, the
unrolled layer loop (no RoPE, no view PE): `depth` pre-norm blocks
alternating per-frame self-attention (even layers, tokens of one view) and
global self-attention (odd layers, all views' patch tokens plus the extra
scale token). The global sequence is padded to a multiple of
`pad_tokens_to` and the pad keys are masked through `n_valid`. Layers in
`indices` are tapped, each through its own LayerNorm; the final norm covers
the patches and the extra tokens.

Sequence parallelism: with a process group (`seq_group`), the views are
sharded over its ranks, each rank holding V/p of them. Global layers run
their block as a `RingGlobalBlock` on the local views' patches and the
replicated token, with no padding; the ref/non-ref embedding uses the global
view index rank * V_local + i. Frame layers are per view and unchanged.

With `gradient_checkpointing` every frame `Block` and every global block
(`RingGlobalBlock` on the ring) is recomputed in the backward, as the JAX
package wraps them in `nn.remat`; on the ring the recompute reissues the
block's rotations, in the same order on every rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .layers import (Block, Dense, FusedLayerNorm, RingGlobalBlock,
                     checkpointed)


class AlternatingAttentionTrunk(nn.Module):
    def __init__(self, input_embed_dim: int = 1024, dim: int = 1024,
                 depth: int = 24, num_heads: int = 16,
                 distinguish_ref_and_non_ref_views: bool = True,
                 indices: Sequence[int] = (11, 17),
                 dtype: torch.dtype = torch.float32,
                 pad_tokens_to: Optional[int] = None,
                 gradient_checkpointing: bool = False, device=None):
        super().__init__()
        self.gradient_checkpointing = gradient_checkpointing
        self.input_embed_dim = input_embed_dim
        self.dim = dim
        self.indices = tuple(indices)
        self.dtype = dtype
        self.pad_tokens_to = pad_tokens_to
        self.proj = Dense(input_embed_dim, dim, dtype=dtype, device=device)
        self.ref_nonref_embed = (
            nn.Parameter(torch.empty(2, dim, device=device))
            if distinguish_ref_and_non_ref_views else None)
        self.layers = nn.ModuleList(
            Block(dim, num_heads, dtype=dtype, device=device)
            for _ in range(depth))
        for blk in self.layers:
            blk.mlp.checkpoint_chunks = gradient_checkpointing
        for i in self.indices:
            self.add_module(f"norm_intermediate_{i}",
                            FusedLayerNorm(dim, dtype=dtype, device=device))
        self.norm = FusedLayerNorm(dim, dtype=dtype, device=device)

    def forward(self, features: torch.Tensor, extra_tokens: torch.Tensor,
                seq_group=None, mlp_chunk: Optional[int] = None):
        """features (B, V, gh, gw, C_in), extra_tokens (B, T, C_in) ->
        (final (B, V, gh, gw, dim), [tap (B, V, gh, gw, dim)], tok (B, T, dim))

        With `seq_group`, V counts this rank's views (see the module
        docstring); the token is the same on every rank. `mlp_chunk` bounds
        the rows each MLP runs at once (layers.py::Mlp).
        """
        b, v, gh, gw, _ = features.shape
        p = gh * gw
        dt, dim = self.dtype, self.dim
        x = self.proj(features.reshape(b, v, p, self.input_embed_dim).to(dt))
        tok = self.proj(extra_tokens.to(dt))

        if self.ref_nonref_embed is not None:
            emb = self.ref_nonref_embed.to(dt)
            first = 0 if seq_group is None else dist.get_rank(seq_group) * v
            is_ref = (torch.arange(first, first + v, device=x.device) == 0
                      ).to(dt)[None, :, None, None]
            x = x + is_ref * emb[0] + (1.0 - is_ref) * emb[1]

        def run(fn, *args):
            if self.gradient_checkpointing:
                return checkpointed(fn, *args)
            return fn(*args)

        intermediates = []
        for i, blk in enumerate(self.layers):
            if i % 2 and seq_group is not None:  # global, view-sharded
                x, tok = run(RingGlobalBlock(blk), x.reshape(b, v * p, dim),
                             tok, seq_group, mlp_chunk)
                x = x.reshape(b, v, p, dim)
            elif i % 2:  # global: [all views' patches | extra tokens | pad]
                n_tot = v * p + tok.shape[1]
                flat = torch.cat([x.reshape(b, v * p, dim), tok], dim=1)
                n_valid = None
                if self.pad_tokens_to:
                    n_pad = -(-n_tot // self.pad_tokens_to) * self.pad_tokens_to
                    if n_pad != n_tot:
                        flat = F.pad(flat, (0, 0, 0, n_pad - n_tot))
                        n_valid = n_tot
                flat = run(blk, flat, n_valid, mlp_chunk)
                x = flat[:, :v * p].reshape(b, v, p, dim)
                tok = flat[:, v * p:n_tot]
            else:  # frame: each view on its own
                x = run(blk, x.reshape(b * v, p, dim), None,
                        mlp_chunk).reshape(b, v, p, dim)
            if i in self.indices:
                feat = getattr(self, f"norm_intermediate_{i}")(x)
                intermediates.append(feat.reshape(b, v, gh, gw, dim))

        x = self.norm(x)
        tok = self.norm(tok)
        return x.reshape(b, v, gh, gw, dim), intermediates, tok
