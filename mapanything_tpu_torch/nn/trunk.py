"""The multi-view information-sharing trunks with IFR taps; counterparts of
mapanything_tpu/nn/trunk.py.

  * `AlternatingAttentionTrunk` (the released trunk): `depth` pre-norm
    blocks alternating per-frame self-attention (even layers, tokens of one
    view) and global self-attention (odd layers, all views' patch tokens
    plus the extra scale token). Options: a learned view-index embedding
    (`use_view_pe`), 2D RoPE on the frame layers (`rope_freq`) and entropy
    scaling of the global layers with the patches per view as its base
    (`use_entropy_scaling`).
  * `GlobalAttentionTrunk`: every layer global (the VGGT-global ablation).
  * `CrossAttentionTrunk`: two-branch DUSt3R-style decoder blocks (the
    cat_ifr_dust3r ablation); see its docstring for how the card runs it.

The global sequence is padded to a multiple of `pad_tokens_to` and the pad
keys are masked through `n_valid`. Layers in `indices` are tapped, each
through its own LayerNorm; the final norm covers the patches and the extra
tokens.

Sequence parallelism (the alternating trunk only): with a process group
(`seq_group`), the views are sharded over its ranks, each rank holding V/p
of them. Global layers run their block as a `RingGlobalBlock` on the local
views' patches and the replicated token, with no padding; the ref/non-ref
embedding and the view PE use the global view index rank * V_local + i.
Frame layers are per view and unchanged.

With `gradient_checkpointing` every block is recomputed in the backward
(`RingGlobalBlock` on the ring), as the JAX package wraps them in
`nn.remat`; on the ring the recompute reissues the block's rotations, in
the same order on every rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..utils.device import device_constant
from .croco import DecoderBlock
from .layers import (Block, Dense, FusedLayerNorm, RingGlobalBlock,
                     checkpointed)
from .rope import rope_tables


class _Trunk(nn.Module):
    """What the trunks share: the input projection (applied to the patch
    features and the extra tokens), the IFR tap norms and the final norm.
    Subclasses register their layers between them."""

    def __init__(self, input_embed_dim: int, dim: int, indices: Sequence[int],
                 dtype: torch.dtype, pad_tokens_to: Optional[int],
                 gradient_checkpointing: bool, device):
        super().__init__()
        self.gradient_checkpointing = gradient_checkpointing
        self.input_embed_dim = input_embed_dim
        self.dim = dim
        self.indices = tuple(indices)
        self.dtype = dtype
        self.pad_tokens_to = pad_tokens_to
        self.proj = Dense(input_embed_dim, dim, dtype=dtype, device=device)

    def _add_norms(self, device) -> None:
        for i in self.indices:
            self.add_module(f"norm_intermediate_{i}",
                            FusedLayerNorm(self.dim, dtype=self.dtype,
                                           device=device))
        self.norm = FusedLayerNorm(self.dim, dtype=self.dtype, device=device)

    def _project(self, features, extra_tokens):
        b, v, gh, gw, _ = features.shape
        x = self.proj(features.reshape(b, v, gh * gw,
                                       self.input_embed_dim).to(self.dtype))
        return x, self.proj(extra_tokens.to(self.dtype))

    def _run(self, fn, *args):
        if self.gradient_checkpointing:
            return checkpointed(fn, *args)
        return fn(*args)

    def _tap(self, i, x, taps, grid) -> None:
        if i in self.indices:
            feat = getattr(self, f"norm_intermediate_{i}")(x)
            taps.append(feat.reshape(*x.shape[:2], *grid, self.dim))

    def _finish(self, x, taps, tok, grid):
        x = self.norm(x)
        return x.reshape(*x.shape[:2], *grid, self.dim), taps, self.norm(tok)

    def _global(self, blk, x, tok, mlp_chunk, base=None):
        """One global layer over [all views' patches | extra tokens | pad]."""
        b, v, p, dim = x.shape
        n_tot = v * p + tok.shape[1]
        flat = torch.cat([x.reshape(b, v * p, dim), tok], dim=1)
        n_valid = None
        if self.pad_tokens_to:
            n_pad = -(-n_tot // self.pad_tokens_to) * self.pad_tokens_to
            if n_pad != n_tot:
                flat = F.pad(flat, (0, 0, 0, n_pad - n_tot))
                n_valid = n_tot
        flat = self._run(blk, flat, n_valid, mlp_chunk, None, base)
        return flat[:, :v * p].reshape(b, v, p, dim), flat[:, v * p:n_tot]


class AlternatingAttentionTrunk(_Trunk):
    def __init__(self, input_embed_dim: int = 1024, dim: int = 1024,
                 depth: int = 24, num_heads: int = 16,
                 distinguish_ref_and_non_ref_views: bool = True,
                 indices: Sequence[int] = (11, 17),
                 dtype: torch.dtype = torch.float32,
                 pad_tokens_to: Optional[int] = None,
                 gradient_checkpointing: bool = False,
                 use_view_pe: bool = False, max_views_for_pe: int = 1000,
                 rope_freq: Optional[float] = None,
                 use_entropy_scaling: bool = False, device=None):
        super().__init__(input_embed_dim, dim, indices, dtype, pad_tokens_to,
                         gradient_checkpointing, device)
        self.num_heads = num_heads
        self.rope_freq = rope_freq
        self.use_entropy_scaling = use_entropy_scaling
        self.max_views_for_pe = max_views_for_pe
        self.ref_nonref_embed = (
            nn.Parameter(torch.empty(2, dim, device=device))
            if distinguish_ref_and_non_ref_views else None)
        self.view_pe = (
            nn.Parameter(torch.empty(max_views_for_pe, dim, device=device))
            if use_view_pe else None)
        self.layers = nn.ModuleList(
            Block(dim, num_heads, dtype=dtype, device=device)
            for _ in range(depth))
        for blk in self.layers:
            blk.mlp.checkpoint_chunks = gradient_checkpointing
        self._add_norms(device)

    def forward(self, features: torch.Tensor, extra_tokens: torch.Tensor,
                seq_group=None, mlp_chunk: Optional[int] = None,
                view_indices: Optional[torch.Tensor] = None):
        """features (B, V, gh, gw, C_in), extra_tokens (B, T, C_in) ->
        (final (B, V, gh, gw, dim), [tap (B, V, gh, gw, dim)], tok (B, T, dim))

        With `seq_group`, V counts this rank's views (see the module
        docstring); the token is the same on every rank. `mlp_chunk` bounds
        the rows each MLP runs at once (layers.py::Mlp). `view_indices`
        (B, V) long picks the view-PE rows (the global view index when
        None).
        """
        b, v, gh, gw, _ = features.shape
        p = gh * gw
        dt, dim = self.dtype, self.dim
        x, tok = self._project(features, extra_tokens)
        first = 0 if seq_group is None else dist.get_rank(seq_group) * v
        if self.ref_nonref_embed is not None:
            emb = self.ref_nonref_embed.to(dt)
            is_ref = (torch.arange(first, first + v, device=x.device) == 0
                      ).to(dt)[None, :, None, None]
            x = x + is_ref * emb[0] + (1.0 - is_ref) * emb[1]
        if self.view_pe is not None:
            if view_indices is None:
                view_indices = torch.arange(
                    first, first + v, device=x.device).expand(b, v)
            x = x + self.view_pe[view_indices].to(dt)[:, :, None, :]
        rope = (None if self.rope_freq is None else rope_tables(
            gh, gw, dim // self.num_heads, self.rope_freq, x.device))
        base = p if self.use_entropy_scaling else None

        taps = []
        for i, blk in enumerate(self.layers):
            if i % 2 and seq_group is not None:  # global, view-sharded
                x, tok = self._run(RingGlobalBlock(blk, base),
                                   x.reshape(b, v * p, dim), tok, seq_group,
                                   mlp_chunk)
                x = x.reshape(b, v, p, dim)
            elif i % 2:
                x, tok = self._global(blk, x, tok, mlp_chunk, base)
            else:  # frame: each view on its own, RoPE'd
                x = self._run(blk, x.reshape(b * v, p, dim), None, mlp_chunk,
                              rope).reshape(b, v, p, dim)
            self._tap(i, x, taps, (gh, gw))
        return self._finish(x, taps, tok, (gh, gw))


class GlobalAttentionTrunk(_Trunk):
    """Every layer attends over all views' patches and the extra tokens
    (the reference's MultiViewGlobalAttentionTransformer). As in the JAX
    package it takes no view PE, RoPE or entropy scaling."""

    def __init__(self, input_embed_dim: int = 1024, dim: int = 1024,
                 depth: int = 24, num_heads: int = 16,
                 distinguish_ref_and_non_ref_views: bool = True,
                 indices: Sequence[int] = (11, 17),
                 dtype: torch.dtype = torch.float32,
                 pad_tokens_to: Optional[int] = None,
                 gradient_checkpointing: bool = False, device=None):
        super().__init__(input_embed_dim, dim, indices, dtype, pad_tokens_to,
                         gradient_checkpointing, device)
        self.ref_nonref_embed = (
            nn.Parameter(torch.empty(2, dim, device=device))
            if distinguish_ref_and_non_ref_views else None)
        self.layers = nn.ModuleList(
            Block(dim, num_heads, dtype=dtype, device=device)
            for _ in range(depth))
        for blk in self.layers:
            blk.mlp.checkpoint_chunks = gradient_checkpointing
        self._add_norms(device)

    def forward(self, features: torch.Tensor, extra_tokens: torch.Tensor,
                mlp_chunk: Optional[int] = None):
        """As AlternatingAttentionTrunk.forward, without a process group."""
        b, v, gh, gw, _ = features.shape
        x, tok = self._project(features, extra_tokens)
        if self.ref_nonref_embed is not None:
            emb = self.ref_nonref_embed.to(self.dtype)
            is_ref = (torch.arange(v, device=x.device) == 0).to(
                self.dtype)[None, :, None, None]
            x = x + is_ref * emb[0] + (1.0 - is_ref) * emb[1]
        taps = []
        for i, blk in enumerate(self.layers):
            x, tok = self._global(blk, x, tok, mlp_chunk)
            self._tap(i, x, taps, (gh, gw))
        return self._finish(x, taps, tok, (gh, gw))


@device_constant
def _other_views_index(v: int, p: int, t: int, device) -> torch.Tensor:
    """other_views_index on `device`."""
    return torch.from_numpy(other_views_index(v, p, t)).to(device)


def other_views_index(v: int, p: int, t: int) -> np.ndarray:
    """(V, (V-1)*P + T) int64: row i lists the positions in [all views'
    patches | T extra tokens] of every key but view i's own patches."""
    keys = np.arange(v * p + t)
    view = np.concatenate([np.repeat(np.arange(v), p), np.full(t, -1)])
    return np.stack([keys[view != i] for i in range(v)])


class CrossAttentionTrunk(_Trunk):
    """Two-branch cross-attention trunk (the reference's
    MultiViewCrossAttentionTransformer, the cat_ifr_dust3r ablation).

    Each layer is a `DecoderBlock` per view: self-attention over the view's
    tokens, then cross-attention to every other view's tokens and the extra
    tokens. The reference view runs `ref_layers_i`, the other views share
    `layers_i` and run as one batch. The extra (scale) token rides the
    reference weights and attends to every view, so that it is updated
    through the layers (the JAX package's extension).

    The JAX package gives every view one shared context [all views |
    tokens] with a key mask hiding the view's own keys. Here each view's
    cross-attention gathers its context rows (`other_views_index`) from one
    kv projection per branch and the kernel runs over them, one call for
    the reference view and one for the batch of the others: the same
    softmax over the same keys, without the dense masked score matrix
    (V x H x P x (V*P + T) floats a layer). Under `attn_impl` "math" the
    trunk runs the JAX package's masked form instead, the yardstick.
    """

    def __init__(self, input_embed_dim: int = 1024, dim: int = 1024,
                 depth: int = 24, num_heads: int = 16,
                 indices: Sequence[int] = (11, 17),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(input_embed_dim, dim, indices, dtype, None, False,
                         device)
        self.ref_layers = nn.ModuleList(
            DecoderBlock(dim, num_heads, dtype=dtype, device=device)
            for _ in range(depth))
        self.layers = nn.ModuleList(
            DecoderBlock(dim, num_heads, dtype=dtype, device=device)
            for _ in range(depth))
        self._add_norms(device)

    def forward(self, features: torch.Tensor, extra_tokens: torch.Tensor,
                mlp_chunk: Optional[int] = None):
        """As AlternatingAttentionTrunk.forward, without a process group;
        the MLPs run unchunked."""
        b, v, gh, gw, _ = features.shape
        p, t, dim = gh * gw, extra_tokens.shape[1], self.dim
        x, tok = self._project(features, extra_tokens)
        index = _other_views_index(v, p, t, x.device)
        masked = self.layers[0].cross_attn.attn_impl == "math"
        if masked:  # (V, V*P + T): True = attendable
            mask = torch.zeros((v, v * p + t), dtype=torch.bool,
                               device=x.device).scatter_(1, index, True)
        taps = []
        for i, (ref_blk, blk) in enumerate(zip(self.ref_layers,
                                               self.layers)):
            ctx = torch.cat([x.reshape(b, v * p, dim), tok], dim=1)
            if masked:
                x_new = torch.stack([
                    (ref_blk if j == 0 else blk)(x[:, j], ctx,
                                                 key_mask=mask[j])
                    for j in range(v)], dim=1)
            else:
                x_new = ref_blk(x[:, :1], ctx, context_index=index[:1])
                if v > 1:
                    x_new = torch.cat([x_new, blk(x[:, 1:], ctx,
                                                  context_index=index[1:])],
                                      dim=1)
            if t:
                tok = ref_blk(tok, ctx)
            x = x_new
            self._tap(i, x, taps, (gh, gw))
        return self._finish(x, taps, tok, (gh, gw))
