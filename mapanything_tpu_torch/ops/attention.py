"""Scaled dot-product attention behind one functional interface.

  * "flash" - the hand-written flash attention (ops/flash_attention.py), a
              torch.autograd.Function: the CUDA forward and backward kernels
              for CUDA tensors, their plain fp32 twins for CPU tensors. The
              counterpart of the JAX package's flash_attention_trainable;
  * "math"  - scores in fp32, fp32 softmax, probabilities cast back to the
              input dtype for the PV product; materialises the (N, N) score
              matrix and is differentiated by torch autograd. Counterpart of
              the JAX package's "xla" path
              (mapanything_tpu/ops/attention.py::_sdpa_xla);
  * "auto"  - "flash".
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         impl: str = "auto", n_valid: int | None = None) -> torch.Tensor:
    """Multi-head attention over (B, N, H, D) q, k, v.

    n_valid: count of real tokens when the token axis arrives padded; keys
    at index >= n_valid are masked. Returns (B, N, H, D) in q's dtype.
    """
    if impl in ("auto", "flash"):
        return flash_attention(q, k, v, n_valid=n_valid)
    if impl == "math":
        return sdpa_math(q, k, v, n_valid=n_valid)
    raise ValueError(f"unknown attention impl: {impl!r}")


def sdpa_math(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              n_valid: int | None = None) -> torch.Tensor:
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if n_valid is not None and n_valid < k.shape[1]:
        scores[..., n_valid:] = float("-inf")
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(dtype)
