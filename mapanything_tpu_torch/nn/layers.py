"""Shared transformer building blocks.

Counterparts of mapanything_tpu/nn/layers.py: the DINOv2/timm pre-norm block
(LN -> MHA -> LayerScale -> residual; LN -> MLP(GELU) -> LayerScale ->
residual) that the encoder and the trunk share, and its sequence-parallel
form over view-sharded patches (`RingGlobalBlock`).

Gradient checkpointing (`checkpointed`) recomputes a block's activations
in its backward instead of keeping them, as the JAX package's `nn.remat`.

Tensor parallelism (parallel/mesh.py::shard_params): an `Attention` or
`Mlp` whose `tp_group` is set holds its share of the heads (of the hidden
features) of a model group's ranks. Its input enters through
`copy_to_model_group` (identity forward, the cotangents summed over the
group in the backward) and its output leaves through
`reduce_from_model_group` (the partial products summed over the group in
the forward, identity backward): Megatron's pair, where the XLA GSPMD of
the JAX package inserts the same collectives. The sums run in the compute
dtype. Without a group both are the identity and the layers compute as
before.

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

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import ring_attention as ring
from ..ops.attention import sdpa
from .rope import apply_rope


class _CopyToGroup(torch.autograd.Function):
    """Megatron's copy-to-group: identity forward; the backward sums the
    cotangents over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's reduce-from-group: the sum over the group forward;
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model_group(x: torch.Tensor, group) -> torch.Tensor:
    """x, replicated over a model group, entering a tensor-parallel layer
    (identity without a group)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_model_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every model-group rank's partial x (identity without a
    group)."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def row_parallel(dense: "Dense", x: torch.Tensor, group) -> torch.Tensor:
    """dense(x) where x's features and dense's input features are split
    over `group`: the local products summed over the group, then the
    (replicated) bias once; dense(x) itself without a group."""
    if group is None:
        return dense(x)
    dt = dense.compute_dtype
    y = F.linear(x.to(dt), dense.weight.to(dt))
    return reduce_from_model_group(y, group) + dense.bias.to(dt)


def checkpointed(fn, *args):
    """fn(*args) whose activations are recomputed in the backward instead
    of kept (torch.utils.checkpoint, non-reentrant), where grad is on;
    plainly otherwise. `fn` draws nothing at random, so no RNG state is
    stashed. A checkpointed attention launches its forward with lse twice
    per step: once in the forward, once in the recompute."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


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
    (erf) otherwise, as in the JAX package.

    With `token_chunk`, the rows run `token_chunk` at a time, so the
    (rows, hidden) GELU transient exists only at chunk size (the
    memory-efficient path); each row's result is computed as without it.
    With `checkpoint_chunks` (set under gradient checkpointing), each chunk
    is also recomputed in the backward, so the transient stays at chunk
    size there too."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden_dim, dtype=dtype, device=device)
        self.fc2 = Dense(hidden_dim, out_dim, dtype=dtype, device=device)
        self.approximate = "tanh" if dtype == torch.bfloat16 else "none"
        self.checkpoint_chunks = False
        self.tp_group = None  # hidden features split over it (module doc)

    def _body(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(copy_to_model_group(x, self.tp_group))
        return row_parallel(self.fc2, F.gelu(h, approximate=self.approximate),
                            self.tp_group)

    def forward(self, x: torch.Tensor,
                token_chunk: Optional[int] = None) -> torch.Tensor:
        rows = x[..., 0].numel()
        if token_chunk is None or rows <= token_chunk:
            return self._body(x)
        flat = x.reshape(rows, x.shape[-1])
        if self.checkpoint_chunks:
            out = torch.cat([checkpointed(self._body, part)
                             for part in flat.split(token_chunk)])
        else:
            out = torch.cat([self._body(part)
                             for part in flat.split(token_chunk)])
        return out.reshape(*x.shape[:-1], out.shape[-1])


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection.

    `attn_impl` picks the ops/attention.py::sdpa path; it is "auto" unless
    models/mapanything.py::MapAnything.set_attn_impl switches it.

    `rope` (a (cos, sin) pair of (N, D) tables, nn/rope.py) rotates q and k
    before the attention; v stays a strided view of the fused qkv tensor.
    With `entropy_scaling_base`, q is multiplied by log(n)/log(base) when
    the count n of real tokens exceeds the base (the JAX package's
    entropy-invariant scaling of the global layers; the trunk passes the
    patches per view, known at call time).

    With `tp_group` set (parallel/mesh.py::shard_params), qkv holds this
    rank's heads of each of q, k and v and proj the matching input columns:
    the heads run here, and proj's partial products are summed over the
    group."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.attn_impl = "auto"
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)
        self.tp_group = None

    def forward(self, x: torch.Tensor, n_valid: Optional[int] = None,
                rope: Optional[tuple] = None,
                entropy_scaling_base: Optional[int] = None) -> torch.Tensor:
        b, n, _ = x.shape
        qkv = self.qkv(copy_to_model_group(x, self.tp_group))
        if n_valid is not None and n_valid < n:
            # aligned-token mode: the pad rows are not zero after LayerNorm
            # (its bias revives them); zero their q/k/v
            qkv[:, n_valid:] = 0
        head_dim = self.dim // self.num_heads
        heads = qkv.shape[-1] // (3 * head_dim)  # this rank's, under TP
        qkv = qkv.view(b, n, 3, heads, head_dim)
        q, k, v = qkv.unbind(2)  # strided (B, N, H, D) views
        if rope is not None:
            q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        n_eff = n if n_valid is None else n_valid
        if entropy_scaling_base is not None and n_eff > entropy_scaling_base:
            q = q * (math.log(n_eff) / math.log(entropy_scaling_base))
        out = sdpa(q, k, v, impl=self.attn_impl, n_valid=n_valid)
        return row_parallel(self.proj, out.reshape(b, n, heads * head_dim),
                            self.tp_group)


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

    def forward(self, x: torch.Tensor, n_valid: Optional[int] = None,
                mlp_chunk: Optional[int] = None, rope: Optional[tuple] = None,
                entropy_scaling_base: Optional[int] = None) -> torch.Tensor:
        h = self.attn(self.norm1(x), n_valid=n_valid, rope=rope,
                      entropy_scaling_base=entropy_scaling_base)
        if self.ls1 is not None:
            h = self.ls1(h)
        x = x + h
        h = self.mlp(self.norm2(x), mlp_chunk)
        if self.ls2 is not None:
            h = self.ls2(h)
        return x + h


class _RingAttention(nn.Module):
    """`Attention`'s parameters over [view-sharded patch tokens | replicated
    extra tokens] (JAX `_RingAttention`). Wraps an `Attention`, so the
    parameters and the state dict stay the block's own.

      * patch rows attend to every rank's patches through the ring
        (ops/ring_attention.py) and to the extra tokens by their exact
        stats, merged through the ring's lse;
      * extra-token rows attend to each rank's patches by partial stats,
        all-gathered and merged in rank order, plus their own
        self-attention: every rank computes the same token rows.
    """

    def __init__(self, attn: Attention,
                 entropy_scaling_base: Optional[int] = None):
        super().__init__()
        self.attn = attn
        self.entropy_scaling_base = entropy_scaling_base

    def forward(self, x: torch.Tensor, tok: torch.Tensor, group):
        a = self.attn
        if a.tp_group is not None:
            raise ValueError("a tensor-parallel Attention cannot run on the "
                             "ring: both use the model axis")
        b, nl, dim = x.shape
        t = tok.shape[1]

        def split(z):
            z = a.qkv(z)
            return z.view(z.shape[0], z.shape[1], 3, a.num_heads,
                          dim // a.num_heads).unbind(2)

        qx, kx, vx = split(x)
        factor = 1.0
        if self.entropy_scaling_base is not None:
            # the global sequence's real tokens over every rank
            n_global = nl * dist.get_world_size(group) + t
            factor = max(math.log(n_global)
                         / math.log(self.entropy_scaling_base), 1.0)
            qx = qx * factor
        if not t:
            out_x = ring.ring_flash_attention(qx, kx, vx, group)
            return a.proj(out_x.reshape(b, nl, dim)), tok
        qt, kt, vt = split(tok)
        if factor != 1.0:
            qt = qt * factor

        # patch rows: 2^lse_p is the ring side's softmax mass, (acc, m, l)
        # of the tokens their exact side
        out_p, lse_p = ring.ring_flash_attention_with_lse(qx, kx, vx, group)
        acc_t, m_t, l_t = ring.attention_stats(qx, kt, vt)
        m_tot = torch.maximum(lse_p, m_t)
        w_p = torch.exp2(lse_p - m_tot)
        w_t = torch.exp2(m_t - m_tot)
        out_x = ((out_p * w_p[..., None] + acc_t * w_t[..., None])
                 / (w_p + l_t * w_t)[..., None]).to(x.dtype)
        out_x = a.proj(out_x.reshape(b, nl, dim))

        # token rows: every rank's partial stats against its own patches
        parts = [ring.all_gather(s, group)
                 for s in ring.attention_stats(qt, kx, vx)]
        acc, m, l = ring.attention_stats(qt, kt, vt)
        for i in range(parts[0].shape[0]):
            acc, m, l = ring.merge_stats(acc, m, l, *(s[i] for s in parts))
        out_t = (acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]
                 ).to(tok.dtype)
        return out_x, a.proj(out_t.reshape(b, t, dim))


class RingGlobalBlock(nn.Module):
    """A `Block` over the global sequence [patches; extra tokens] with the
    patch tokens view-sharded over the ranks of a process group (JAX
    `RingGlobalBlock`). Wraps the `Block` and uses its parameters, so a
    trunk runs any global layer either way with one state dict. LayerNorm,
    MLP and LayerScale act on the local patches and the replicated tokens
    alike; only attention needs the ring.

    Training: `tok` and its output are replicated, every rank computing the
    same token rows. A loss summed over ranks that includes the token
    output counts it once per rank; divide that term by the group size.
    """

    def __init__(self, block: Block,
                 entropy_scaling_base: Optional[int] = None):
        super().__init__()
        self.block = block
        self.attn = _RingAttention(block.attn, entropy_scaling_base)

    def forward(self, x: torch.Tensor, tok: torch.Tensor, group,
                mlp_chunk: Optional[int] = None):
        """x (B, N_local, C), tok (B, T, C) -> the same two shapes."""
        blk = self.block
        hx, ht = self.attn(blk.norm1(x), blk.norm1(tok), group)
        if blk.ls1 is not None:
            hx, ht = blk.ls1(hx), blk.ls1(ht)
        x, tok = x + hx, tok + ht
        hx, ht = blk.mlp(blk.norm2(x), mlp_chunk), blk.mlp(blk.norm2(tok))
        if blk.ls2 is not None:
            hx, ht = blk.ls2(hx), blk.ls2(ht)
        return x + hx, tok + ht


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator,
                  std: float = 0.02) -> nn.Module:
    """Random init from an explicit generator: every weight and embedding
    ~ N(0, std^2), biases 0, LayerNorm and LayerScale at their constants,
    and a module's `init_constants` ({parameter name: array}, e.g. RADIO's
    input conditioner) at theirs."""
    for mod in module.modules():
        consts = getattr(mod, "init_constants", {})
        for name, p in mod.named_parameters(recurse=False):
            if name in consts:
                p.copy_(torch.as_tensor(consts[name]))
            elif name == "bias":
                p.zero_()
            elif isinstance(mod, FusedLayerNorm):
                p.fill_(1.0)
            elif isinstance(mod, LayerScale):
                p.fill_(mod.init_value)
            else:
                p.normal_(0.0, std, generator=generator)
    return module
