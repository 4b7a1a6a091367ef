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

A `key_mask` (the JAX package's, True = attendable) runs the math path, as
the JAX package routes every masked call to its XLA path. On the card that
needs the dense score matrix, so there it runs only where the caller asks
for "math" (the yardstick) and raises otherwise: the callers that need a
mask pass the attendable keys gathered instead (the cross-attention
trunk, nn/croco.py::CrossAttention's `context_index`).
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         impl: str = "auto", n_valid: int | None = None,
         key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-head attention over (B, N, H, D) q, k, v.

    n_valid: count of real tokens when the token axis arrives padded; keys
    at index >= n_valid are masked. key_mask: (K,) or (B, K) bool, True
    where a key is attendable; the math path (see the module docstring).
    Returns (B, N, H, D) in q's dtype.
    """
    if impl not in ("auto", "flash", "math"):
        raise ValueError(f"unknown attention impl: {impl!r}")
    if key_mask is not None:
        if q.is_cuda and impl != "math":
            raise ValueError(
                "sdpa with a key mask on the card computes the dense masked "
                "score matrix: ask for impl='math', or pass the attendable "
                "keys gathered (nn/croco.py::CrossAttention context_index)")
        return sdpa_math(q, k, v, n_valid=n_valid, key_mask=key_mask)
    if impl in ("auto", "flash"):
        return flash_attention(q, k, v, n_valid=n_valid)
    return sdpa_math(q, k, v, n_valid=n_valid)


def sdpa_math(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              n_valid: int | None = None,
              key_mask: torch.Tensor | None = None) -> torch.Tensor:
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if n_valid is not None and n_valid < k.shape[1]:
        scores[..., n_valid:] = float("-inf")
    if key_mask is not None:  # (K,) or (B, K) -> broadcast over (h, q)
        mask = key_mask[:, None, None, :] if key_mask.dim() == 2 else key_mask
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(dtype)
