"""Plain PyTorch operations that the references are written in.

Every product goes through :func:`matmul`, :func:`conv2d` or
:func:`attention`, which compute in float32 with TF32 off (see
:func:`fp32_matmuls`), or with both operands rounded first and the sums in
float32: to bfloat16 ("bf16", the configurations' precision, whose gap to
float32 is a call's rounding floor) or, in the control's "fp8", to float8
e4m3 (one scale per tensor, its largest magnitude at 448), the precision
a later change might be tempted to serve the model in. Rounded attention
runs in blocks of query rows, so that the (rows, keys) scores of one block
are the only ones in memory; float32 attention is PyTorch's
`scaled_dot_product_attention`.

This file and the references beside it import nothing of the program under
test.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32_matmuls():
    """TF32 off for matmuls and convolutions inside the block; the earlier
    settings come back after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x in float32, or rounded to bfloat16, or to float8 e4m3 with one
    per-tensor scale, and widened back to float32."""
    x = x.float()
    if precision == "fp32":
        return x
    if precision == "bf16":
        r = x.detach().to(torch.bfloat16).float()
    elif precision == "fp8":
        scale = x.detach().abs().amax().clamp_min(1e-30) / _E4M3_MAX
        r = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    else:
        raise ValueError(f"unknown precision {precision!r}")
    # the rounded value forward, the identity backward
    return x + (r - x).detach() if x.requires_grad else r


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return torch.matmul(round_operand(a, precision), round_operand(b, precision))


def linear(x: torch.Tensor, sd: dict, name: str, precision: str) -> torch.Tensor:
    """x @ W^T + b for the parameters `name`.weight and `name`.bias."""
    return (matmul(x, sd[name + ".weight"].t(), precision)
            + sd[name + ".bias"].float())


def conv2d(x: torch.Tensor, sd: dict, name: str, precision: str,
           stride: int = 1, padding: int = 0, bias: bool = True
           ) -> torch.Tensor:
    b = sd[name + ".bias"].float() if bias else None
    return F.conv2d(round_operand(x, precision),
                    round_operand(sd[name + ".weight"], precision), b,
                    stride=stride, padding=padding)


def conv_transpose2d(x: torch.Tensor, sd: dict, name: str, precision: str,
                     stride: int) -> torch.Tensor:
    return F.conv_transpose2d(round_operand(x, precision),
                              round_operand(sd[name + ".weight"], precision),
                              sd[name + ".bias"].float(), stride=stride)


def layer_norm(x: torch.Tensor, sd: dict, name: str,
               eps: float = 1e-6) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), sd[name + ".weight"].float(),
                        sd[name + ".bias"].float(), eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU of the published models."""
    return F.gelu(x)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              precision: str, block_rows: int = 1024) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, H, N, D) q and (B, H, M, D) k, v,
    `block_rows` query rows at a time where the operands are rounded.
    Returns (B, H, N, D) float32."""
    if precision == "fp32":
        return F.scaled_dot_product_attention(q.float(), k.float(), v.float())
    scale = 1.0 / math.sqrt(q.shape[-1])
    k = round_operand(k, precision)
    v = round_operand(v, precision)
    if torch.is_grad_enabled():  # differentiable: out of place, one block
        s = torch.matmul(round_operand(q, precision), k.transpose(-1, -2))
        s = torch.softmax(s * scale, dim=-1)
        return torch.matmul(round_operand(s, precision), v)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for i in range(0, q.shape[2], block_rows):
        qb = round_operand(q[:, :, i:i + block_rows], precision)
        s = torch.matmul(qb, k.transpose(-1, -2))
        s.mul_(scale)
        s.sub_(s.amax(dim=-1, keepdim=True))
        s.exp_()
        denom = s.sum(dim=-1, keepdim=True)
        out[:, :, i:i + block_rows] = (
            torch.matmul(round_operand(s, precision), v) / denom)
        del s
    return out


def self_attention(x: torch.Tensor, sd: dict, name: str, heads: int,
                   precision: str, block_rows: int = 1024) -> torch.Tensor:
    """The fused-qkv multi-head self-attention `name` over (B, N, C)."""
    b, n, c = x.shape
    qkv = linear(x, sd, name + ".qkv", precision)
    q, k, v = qkv.view(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    del qkv
    out = attention(q, k, v, precision, block_rows)
    out = out.transpose(1, 2).reshape(b, n, c)
    return linear(out, sd, name + ".proj", precision)


def mlp(x: torch.Tensor, sd: dict, name: str, precision: str) -> torch.Tensor:
    return linear(gelu(linear(x, sd, name + ".fc1", precision)), sd,
                  name + ".fc2", precision)


def vit_block(x: torch.Tensor, sd: dict, name: str, heads: int,
              precision: str, layerscale: bool) -> torch.Tensor:
    """The pre-norm ViT block: x + [ls1] attn(norm1 x), then
    x + [ls2] mlp(norm2 x). Under differentiation its activations are
    recomputed in the backward, so that a training step's fit."""
    if torch.is_grad_enabled():
        return checkpoint(_vit_block, x, sd, name, heads, precision,
                          layerscale, use_reentrant=False)
    return _vit_block(x, sd, name, heads, precision, layerscale)


def _vit_block(x, sd, name, heads, precision, layerscale):
    h = self_attention(layer_norm(x, sd, name + ".norm1"), sd, name + ".attn",
                       heads, precision)
    if layerscale:
        h = h * sd[name + ".ls1.gamma"].float()
    x = x + h
    h = mlp(layer_norm(x, sd, name + ".norm2"), sd, name + ".mlp", precision)
    if layerscale:
        h = h * sd[name + ".ls2.gamma"].float()
    return x + h


# --- parameter specs ---------------------------------------------------------
# A spec maps a parameter's name to (shape, init): "normal" (N(0, 0.02^2)),
# "zeros" or "ones". perfbench/harness/weights.py makes the state dict from it.


def spec_linear(spec: dict, name: str, n_in: int, n_out: int) -> None:
    spec[name + ".weight"] = ((n_out, n_in), "normal")
    spec[name + ".bias"] = ((n_out,), "zeros")


def spec_conv(spec: dict, name: str, c_in: int, c_out: int, k: int,
              bias: bool = True, transpose: bool = False) -> None:
    shape = (c_in, c_out, k, k) if transpose else (c_out, c_in, k, k)
    spec[name + ".weight"] = (shape, "normal")
    if bias:
        spec[name + ".bias"] = ((c_out,), "zeros")


def spec_norm(spec: dict, name: str, dim: int) -> None:
    spec[name + ".weight"] = ((dim,), "ones")
    spec[name + ".bias"] = ((dim,), "zeros")


def spec_vit_block(spec: dict, name: str, dim: int, mlp_dim: int,
                   layerscale: bool) -> None:
    spec_norm(spec, name + ".norm1", dim)
    spec_linear(spec, name + ".attn.qkv", dim, 3 * dim)
    spec_linear(spec, name + ".attn.proj", dim, dim)
    spec_norm(spec, name + ".norm2", dim)
    spec_linear(spec, name + ".mlp.fc1", dim, mlp_dim)
    spec_linear(spec, name + ".mlp.fc2", mlp_dim, dim)
    if layerscale:
        spec[name + ".ls1.gamma"] = ((dim,), "ones")
        spec[name + ".ls2.gamma"] = ((dim,), "ones")


# --- FLOP counts --------------------------------------------------------------
# A multiply-accumulate counts 2. These count the products of the reference
# (matmul, conv, attention), which the program computes as well.


def linear_flops(rows: int, n_in: int, n_out: int) -> int:
    return 2 * rows * n_in * n_out


def conv_flops(n: int, h_out: int, w_out: int, c_in: int, c_out: int,
               k: int) -> int:
    return 2 * n * h_out * w_out * c_in * c_out * k * k


def attention_flops(b: int, heads: int, nq: int, nk: int, head_dim: int) -> int:
    """QK^T and PV."""
    return 2 * 2 * b * heads * nq * nk * head_dim


def vit_block_flops(b: int, n: int, dim: int, mlp_dim: int, heads: int) -> int:
    return (linear_flops(b * n, dim, 3 * dim) + linear_flops(b * n, dim, dim)
            + attention_flops(b, heads, n, n, dim // heads)
            + linear_flops(b * n, dim, mlp_dim)
            + linear_flops(b * n, mlp_dim, dim))
