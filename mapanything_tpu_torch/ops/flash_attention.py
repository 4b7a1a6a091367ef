"""Flash-attention forward: the hand-written CUDA kernel and its plain twin.

The kernel (``csrc/flash_attn_fwd.cu``) replaces the JAX package's two
serving-path Pallas kernels,
``mapanything_tpu/ops/flash_attention.py::_flash_kernel_1pass_T`` (whole kv
in one block, <= 2816 keys: encoder, frame layers, 1- and 2-view global
layers) and ``::_flash_kernel_T`` (online softmax over kv blocks: global
layers from 3 views at 518^2). One CUDA kernel does both: an online softmax
over 64-key tiles, where a short sequence is simply a short loop.

What bounds it on an H100 and what the design does about it: at head dim 64
the forward does ~256 flops per byte of Q/K/V/O it moves, so it is bound by
arithmetic, not by device memory. The score and probability tiles stay in
registers and shared memory, so the (N, N) score matrix never reaches
device memory. Both products run on the tensor cores with mma.sync (bf16
in, fp32 accumulate, P rounded to bf16 as in the JAX package); the kernel
takes bf16 only, the serving path's dtype. The TPU-specific
tricks of the Pallas kernels (transposed S/acc layout, the ones-row row
sum, padding kv to a block multiple) are not carried over: the kernel masks
keys past ``n_valid`` explicitly and reads the (B, N, H, D) strides
directly.

:func:`flash_attention` launches the kernel for a CUDA tensor and runs
:func:`flash_attention_plain` for a CPU tensor; nothing falls back from one
to the other. ``flash_attention.kernel_launches`` and
``flash_attention.plain_launches`` count the calls of each path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_LOG2E = 1.4426950408889634
_HEAD_DIM = 64


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          n_valid: int | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v in fp32, keys >= n_valid masked.

    The plain PyTorch version of the kernel's function: q (B, Nq, H, D),
    k and v (B, Nk, H, D). A row that sees no key gives 0. Returns
    (B, Nq, H, D) in q's dtype.
    """
    kv_eff = k.shape[1] if n_valid is None else min(k.shape[1], n_valid)
    scale = q.shape[-1] ** -0.5
    qf, kf, vf = q.float(), k[:, :kv_eff].float(), v[:, :kv_eff].float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    m = s.amax(dim=-1, keepdim=True) if kv_eff else s.sum(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / torch.where(l == 0, 1.0, l), vf)
    return out.to(q.dtype)


def _check_kernel_args(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} is not on CUDA")
        if x.dim() != 4:
            raise ValueError(
                f"flash_attention: {name} must be (B, N, H, D), got "
                f"{tuple(x.shape)}")
        if x.dtype != torch.bfloat16:
            raise TypeError(
                f"flash_attention kernel takes bfloat16, {name} is {x.dtype}")
        if x.shape[-1] != _HEAD_DIM:
            raise ValueError(
                f"flash_attention kernel takes head dim {_HEAD_DIM}, {name} "
                f"has {x.shape[-1]}")
        vec = 16 // x.element_size()
        if (x.stride(-1) != 1 or any(s % vec for s in x.stride()[:3])
                or x.data_ptr() % 16):
            raise ValueError(
                f"flash_attention kernel: {name} needs unit stride along D, "
                f"(B, N, H) strides in multiples of {vec} elements and a "
                f"16-byte aligned base; got strides {x.stride()}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    b, _, h, _ = q.shape
    if k.shape[0] != b or k.shape[2] != h or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not agree")
    if q.shape[1] >= 2**31 or k.shape[1] >= 2**31 or b * h >= 2**16:
        raise ValueError("flash_attention kernel: sequence or batch*heads "
                         "too large for its grid")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from ._build import load_library

    fn = load_library("flash_attn_fwd").flash_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
    ]
    return fn


def _flash_attention_cuda(q, k, v, n_valid):
    _check_kernel_args(q, k, v)
    fn = _kernel_fn()
    b, nq, h, d = q.shape
    kv_eff = k.shape[1] if n_valid is None else min(k.shape[1], n_valid)
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, nq, max(kv_eff, 0), strides, d**-0.5 * _LOG2E, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
    flash_attention.kernel_launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_valid: int | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v without materialising the score matrix.

    Args:
        q: (B, Nq, H, D); k, v: (B, Nk, H, D).
        n_valid: keys at index >= n_valid are masked (aligned-token mode:
            the caller padded the token axis). Query pad rows are computed
            like any other row; the caller slices them off.

    A CUDA tensor goes to the CUDA kernel (bf16, D = 64; anything else
    raises). A CPU tensor goes to :func:`flash_attention_plain`.
    """
    if q.is_cuda:
        return _flash_attention_cuda(q, k, v, n_valid)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    flash_attention.plain_launches += 1
    return flash_attention_plain(q, k, v, n_valid)


flash_attention.kernel_launches = 0
flash_attention.plain_launches = 0


def reset_launch_counts() -> None:
    flash_attention.kernel_launches = 0
    flash_attention.plain_launches = 0


def attention_flops(b: int, nq: int, nk: int, h: int, d: int) -> float:
    """Multiply-add flops of one forward (QK^T and PV), 2 per multiply-add."""
    return 4.0 * b * h * nq * nk * d


__all__ = [
    "attention_flops",
    "flash_attention",
    "flash_attention_plain",
    "reset_launch_counts",
]
