"""2D rotary positional embeddings (RoPE) for patch grids; counterpart of
mapanything_tpu/nn/rope.py.

The RoPE2D option of the ablations (`trunk_rope_freq`, the reference's
"RoPE<freq>" positional encoding): half the head dims rotate with the
patch row index, half with the column index. The tables are built in
numpy float64 and handed over in fp32; `apply_rope` casts them to the
tokens' dtype, as the JAX package does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import device_constant


@functools.lru_cache(maxsize=16)
def rope_2d_cos_sin(gh: int, gw: int, head_dim: int, freq: float = 100.0):
    """(cos, sin) tables for a (gh, gw) grid, each (gh*gw, head_dim) fp32
    numpy arrays, shared between callers (read-only). Dims [0, d/2) encode
    the row, [d/2, d) the column; within each half, standard RoPE pairs at
    base `freq`."""
    assert head_dim % 4 == 0, "head_dim must be divisible by 4 for 2D RoPE"
    d_half = head_dim // 2
    inv = 1.0 / (freq ** (np.arange(0, d_half, 2, dtype=np.float64) / d_half))
    ang_y = np.einsum("h,f->hf", np.arange(gh, dtype=np.float64), inv)
    ang_x = np.einsum("w,f->wf", np.arange(gw, dtype=np.float64), inv)
    ay = np.repeat(ang_y[:, None, :], gw, axis=1)
    ax = np.repeat(ang_x[None, :, :], gh, axis=0)
    ang = np.concatenate([ay, ax], axis=-1)  # (gh, gw, d_half)
    ang = np.concatenate([ang, ang], axis=-1).reshape(gh * gw, head_dim)
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    cos.setflags(write=False)
    sin.setflags(write=False)
    return cos, sin


@device_constant
def rope_tables(gh: int, gw: int, head_dim: int, freq: float,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """`rope_2d_cos_sin` as fp32 tensors on `device`, made once a size
    (utils/device.py::device_constant)."""
    return tuple(torch.tensor(t, device=device)
                 for t in rope_2d_cos_sin(gh, gw, head_dim, freq))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, N, H, D) tokens by per-position (N, D) tables, in x's
    dtype. Returns a new contiguous (B, N, H, D) tensor."""
    d = x.shape[-1]
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    cos = cos[None, :, None, :].to(x.dtype)
    sin = sin[None, :, None, :].to(x.dtype)
    return x * cos + rotated * sin
