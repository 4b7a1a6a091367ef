"""Flash attention, forward and backward: the hand-written CUDA kernels,
their plain twins, and the autograd Function that joins them.

:func:`flash_attention` applies :class:`FlashAttention`, a
``torch.autograd.Function`` and the counterpart of the JAX package's
``flash_attention_trainable`` custom VJP
(``mapanything_tpu/ops/flash_attention_bwd.py``). It is used on both
devices; the device of the tensors picks the implementation, and nothing
falls back from one to the other:

  * forward, when none of q, k, v needs a gradient (serving under
    ``torch.inference_mode``): ``csrc/flash_attn_fwd.cu``'s
    ``flash_attn_fwd`` on CUDA, :func:`flash_attention_plain` on the CPU.
    No lse is written.
  * forward under differentiation: ``flash_attn_fwd_lse`` (the same kernel
    writing the base-2 log-sum-exp per row) or
    :func:`flash_attention_fwd_lse_plain`; q, k, v, the output and the lse
    are saved.
  * backward: ``delta = rowsum(dO * O)`` in fp32 (a torch op, as in JAX),
    then ``csrc/flash_attn_bwd.cu``'s dK/dV and dQ kernels, or on the CPU
    :func:`flash_attention_bwd_plain`, which writes out the same formulas
    (not torch autograd of the plain forward).

The kernels replace the JAX package's Pallas kernels
``flash_attention.py::_flash_kernel_1pass_T`` / ``_flash_kernel_T``
(forward), ``flash_attention_bwd.py::_fwd_with_lse_kernel_1pass_T`` /
``_fwd_with_lse_kernel_T`` (forward with lse), ``::_dkv_kernel`` and
``::_dq_kernel``. At head dim 64 all of them do a few hundred flops per byte
they move, so they are bound by arithmetic: the score and probability tiles
stay in registers and shared memory (the (N, N) matrices never reach device
memory) and every product runs on the tensor cores with ``mma.sync`` (bf16
operands, fp32 accumulation). The kernels take bf16 only, D = 64. The TPU
tricks of the Pallas kernels (transposed S/acc layouts, the ones-row row
sum, padding kv to a block multiple) are not carried over: the kernels mask
keys past ``n_valid`` explicitly and read the (B, N, H) strides directly.

Each kernel has a wrapper that takes tensors of either device:
:func:`flash_attention_fwd_lse`, :func:`flash_attention_dkv` and
:func:`flash_attention_dq`; :func:`flash_attention_bwd` computes delta and
calls the two backward ones.

Launch counters: ``flash_attention.kernel_counts`` counts the launches of
each CUDA kernel ("fwd", "fwd_lse", "dkv", "dq"), each wrapper adding one
where it launches; ``flash_attention.kernel_launches`` is their sum and
``flash_attention.plain_launches`` counts the wrappers' calls of their
plain twins (on CPU tensors). :func:`reset_launch_counts` zeroes them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_LOG2E = 1.4426950408889634
_HEAD_DIM = 64
KERNELS = ("fwd", "fwd_lse", "dkv", "dq")


def _kv_eff(k: torch.Tensor, n_valid: int | None) -> int:
    return k.shape[1] if n_valid is None else max(min(k.shape[1], n_valid), 0)


# --- plain twins ------------------------------------------------------------


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          n_valid: int | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v in fp32, keys >= n_valid masked.

    The plain PyTorch version of the forward kernel: q (B, Nq, H, D), k and
    v (B, Nk, H, D). A row that sees no key gives 0. Returns (B, Nq, H, D)
    in q's dtype.
    """
    return flash_attention_fwd_lse_plain(q, k, v, n_valid)[0]


def flash_attention_fwd_lse_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  n_valid: int | None = None):
    """The forward and its base-2 log-sum-exp, in fp32.

    Returns (out (B, Nq, H, D) in q's dtype, lse (B, H, Nq) fp32) with
    lse = m + log2(l) over the scaled base-2 logits
    s' = q.k * d^-1/2 * log2(e): m their row max, l = sum exp2(s' - m).
    A row that sees no key has out 0 and lse +inf.
    """
    kv_eff = _kv_eff(k, n_valid)
    qscale = q.shape[-1] ** -0.5 * _LOG2E
    qf, kf, vf = q.float(), k[:, :kv_eff].float(), v[:, :kv_eff].float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * qscale
    m = s.amax(dim=-1, keepdim=True) if kv_eff else s.sum(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / torch.where(l == 0, 1.0, l), vf)
    lse = torch.where(l == 0, torch.inf, m + torch.log2(l))[..., 0]
    return out.to(q.dtype), lse


def attention_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, Nq, H, D) -> (B, H, Nq)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _probs_and_dscores(q, k, v, dout, lse, delta, kv_eff):
    """P = exp2(s' - lse) and dS = P * (dO V^T - delta), (B, H, Nq, kv_eff)
    fp32, over the real keys."""
    qscale = q.shape[-1] ** -0.5 * _LOG2E
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k[:, :kv_eff].float()) * qscale
    p = torch.exp2(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(),
                      v[:, :kv_eff].float())
    return p, p * (dp - delta[..., None])


def flash_attention_dkv_plain(q, k, v, dout, lse, delta,
                              n_valid: int | None = None):
    """The plain version of the dK/dV kernel: dV = P^T dO and
    dK = dS^T Q * d^-1/2, rows of keys >= n_valid zero. Returns (dk, dv),
    (B, Nk, H, D) in q's dtype."""
    kv_eff = _kv_eff(k, n_valid)
    p, ds = _probs_and_dscores(q, k, v, dout, lse, delta, kv_eff)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    dv[:, :kv_eff] = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk[:, :kv_eff] = torch.einsum("bhqk,bqhd->bkhd", ds,
                                  q.float()) * q.shape[-1] ** -0.5
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_dq_plain(q, k, v, dout, lse, delta,
                             n_valid: int | None = None) -> torch.Tensor:
    """The plain version of the dQ kernel: dQ = dS K * d^-1/2,
    (B, Nq, H, D) in q's dtype."""
    kv_eff = _kv_eff(k, n_valid)
    _, ds = _probs_and_dscores(q, k, v, dout, lse, delta, kv_eff)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k[:, :kv_eff].float())
    return (dq * q.shape[-1] ** -0.5).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, out, lse, dout,
                              n_valid: int | None = None):
    """dq, dk, dv of flash attention from the saved output and lse, by the
    formulas of mapanything_tpu/ops/flash_attention_bwd.py:9-13:
    delta = rowsum(dO * O), P = exp2(s' - lse), dV = P^T dO,
    dS = P * (dO V^T - delta), dK = dS^T Q / sqrt(d), dQ = dS K / sqrt(d).
    Keys >= n_valid get zero gradient rows."""
    delta = attention_delta(dout, out)
    dk, dv = flash_attention_dkv_plain(q, k, v, dout, lse, delta, n_valid)
    dq = flash_attention_dq_plain(q, k, v, dout, lse, delta, n_valid)
    return dq, dk, dv


# --- CUDA kernels -----------------------------------------------------------


def _check_layout(name: str, x: torch.Tensor) -> None:
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
    if not _kernel_layout(x):
        raise ValueError(
            f"flash_attention kernel: {name} needs unit stride along D, "
            f"(B, N, H) strides in multiples of 8 elements and a "
            f"16-byte aligned base; got strides {x.stride()}")


def _kernel_layout(x: torch.Tensor) -> bool:
    """Unit stride along D, 16-byte rows and base: what the kernels read."""
    vec = 16 // x.element_size()
    return (x.stride(-1) == 1 and not any(s % vec for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _check_kernel_args(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} is not on CUDA")
        _check_layout(name, x)
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


_P, _I = ctypes.c_void_p, ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _kernel_fn(library: str, entry: str):
    from ._build import load_library

    fn = getattr(load_library(library), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = {
        "flash_attn_fwd": [_P] * 4 + [_I] * 4 + [_P, ctypes.c_float, _P],
        "flash_attn_fwd_lse": [_P] * 5 + [_I] * 4
        + [_P, ctypes.c_float, _P],
        "flash_attn_bwd_dkv": [_P] * 8 + [_I] * 5
        + [_P, ctypes.c_float, ctypes.c_float, _P],
        "flash_attn_bwd_dq": [_P] * 7 + [_I] * 4
        + [_P, ctypes.c_float, ctypes.c_float, _P],
    }[entry]
    return fn


def _strides(*tensors) -> ctypes.Array:
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(vals))(*vals)


def _launch(kernel: str, library: str, entry: str, device, *args) -> None:
    fn = _kernel_fn(library, entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    flash_attention.kernel_counts[kernel] += 1
    flash_attention.kernel_launches += 1


def _fwd_cuda(q, k, v, n_valid, with_lse: bool):
    """Launch the forward kernel; returns out, and the lse if asked."""
    _check_kernel_args(q, k, v)
    b, nq, h, d = q.shape
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if with_lse:
        ptrs.append(lse.data_ptr())
    _launch("fwd_lse" if with_lse else "fwd", "flash_attn_fwd",
            "flash_attn_fwd_lse" if with_lse else "flash_attn_fwd", q.device,
            *ptrs, b, h, nq, _kv_eff(k, n_valid), _strides(q, k, v, out),
            d**-0.5 * _LOG2E)
    return (out, lse) if with_lse else out


def _check_bwd_args(q, k, v, dout, lse, delta):
    _check_kernel_args(q, k, v)
    _check_layout("dout", dout)
    b, nq, h, _ = q.shape
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"flash_attention: dout {tuple(dout.shape)} does "
                         f"not match q {tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != (b, h, nq) or x.dtype != torch.float32
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"({b}, {h}, {nq}) float32 tensor on {q.device}")


def _bwd_common(q, k, v, dout, lse, delta):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


# --- one wrapper per kernel: the kernel on CUDA, the plain twin on the CPU ---


def _plain(fn, *args):
    flash_attention.plain_launches += 1
    return fn(*args)


def flash_attention_fwd_lse(q, k, v, n_valid: int | None = None):
    """(out, lse) of the forward: the CUDA kernel (flash_attn_fwd_lse) on
    CUDA tensors, :func:`flash_attention_fwd_lse_plain` on CPU tensors."""
    if q.is_cuda:
        return _fwd_cuda(q, k, v, n_valid, with_lse=True)
    return _plain(flash_attention_fwd_lse_plain, q, k, v, n_valid)


def flash_attention_dkv(q, k, v, dout, lse, delta,
                        n_valid: int | None = None):
    """(dk, dv): the dK/dV kernel on CUDA tensors, its plain twin on CPU
    tensors. dout needs the kernels' layout (see _kernel_layout); lse and
    delta are contiguous (B, H, Nq) fp32."""
    if not q.is_cuda:
        return _plain(flash_attention_dkv_plain, q, k, v, dout, lse, delta,
                      n_valid)
    _check_bwd_args(q, k, v, dout, lse, delta)
    b, nq, h, d = q.shape
    nk = k.shape[1]
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch("dkv", "flash_attn_bwd", "flash_attn_bwd_dkv", q.device,
            *_bwd_common(q, k, v, dout, lse, delta), dk.data_ptr(),
            dv.data_ptr(), b, h, nq, nk, _kv_eff(k, n_valid),
            _strides(q, k, v, dout, dk, dv), d**-0.5 * _LOG2E, d**-0.5)
    return dk, dv


def flash_attention_dq(q, k, v, dout, lse, delta,
                       n_valid: int | None = None) -> torch.Tensor:
    """dq: the dQ kernel on CUDA tensors, its plain twin on CPU tensors
    (arguments as :func:`flash_attention_dkv`)."""
    if not q.is_cuda:
        return _plain(flash_attention_dq_plain, q, k, v, dout, lse, delta,
                      n_valid)
    _check_bwd_args(q, k, v, dout, lse, delta)
    b, nq, h, d = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch("dq", "flash_attn_bwd", "flash_attn_bwd_dq", q.device,
            *_bwd_common(q, k, v, dout, lse, delta), dq.data_ptr(), b, h, nq,
            _kv_eff(k, n_valid), _strides(q, k, v, dout, dq),
            d**-0.5 * _LOG2E, d**-0.5)
    return dq


def flash_attention_bwd(q, k, v, out, lse, dout, n_valid: int | None = None):
    """(dq, dk, dv) from the saved output and lse: delta = rowsum(dO * O) in
    torch, then the dK/dV and dQ kernels on CUDA tensors;
    :func:`flash_attention_bwd_plain` on CPU tensors."""
    if not q.is_cuda:
        return _plain(flash_attention_bwd_plain, q, k, v, out, lse, dout,
                      n_valid)
    if not _kernel_layout(dout):
        dout = dout.contiguous()
    delta = attention_delta(dout, out)
    dk, dv = flash_attention_dkv(q, k, v, dout, lse, delta, n_valid)
    dq = flash_attention_dq(q, k, v, dout, lse, delta, n_valid)
    return dq, dk, dv


# --- the autograd Function --------------------------------------------------


class FlashAttention(torch.autograd.Function):
    """softmax(q k^T / sqrt(d)) v with a flash backward; see the module
    docstring for which implementation runs where."""

    @staticmethod
    def forward(ctx, q, k, v, n_valid):
        ctx.n_valid = n_valid
        if not any(ctx.needs_input_grad[:3]):
            if q.is_cuda:
                return _fwd_cuda(q, k, v, n_valid, with_lse=False)
            return _plain(flash_attention_plain, q, k, v, n_valid)
        out, lse = flash_attention_fwd_lse(q, k, v, n_valid)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.n_valid)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_valid: int | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v without materialising the score matrix,
    differentiable in q, k and v.

    Args:
        q: (B, Nq, H, D); k, v: (B, Nk, H, D).
        n_valid: keys at index >= n_valid are masked (aligned-token mode:
            the caller padded the token axis). Query pad rows are computed
            like any other row; the caller slices them off.

    CUDA tensors go to the CUDA kernels (bf16, D = 64; anything else
    raises), CPU tensors to the plain twins.
    """
    if not (q.is_cuda or q.device.type == "cpu"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return FlashAttention.apply(q, k, v, n_valid)


def reset_launch_counts() -> None:
    flash_attention.kernel_counts = dict.fromkeys(KERNELS, 0)
    flash_attention.kernel_launches = 0
    flash_attention.plain_launches = 0


reset_launch_counts()


def attention_flops(b: int, nq: int, nk: int, h: int, d: int) -> float:
    """Multiply-add flops of one forward (QK^T and PV), 2 per multiply-add."""
    return 4.0 * b * h * nq * nk * d


__all__ = [
    "FlashAttention",
    "KERNELS",
    "attention_delta",
    "attention_flops",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_dkv",
    "flash_attention_dkv_plain",
    "flash_attention_dq",
    "flash_attention_dq_plain",
    "flash_attention_fwd_lse",
    "flash_attention_fwd_lse_plain",
    "flash_attention_plain",
    "reset_launch_counts",
]
