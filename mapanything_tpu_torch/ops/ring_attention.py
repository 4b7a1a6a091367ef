"""Ring (sequence-parallel) flash attention over a torch.distributed group;
counterpart of mapanything_tpu/ops/ring_attention.py.

The token axis is sharded over the ranks of a process group: each rank
holds one shard of q, k and v, attends to the k/v shard it currently holds
and passes k/v on around the ring (rank r sends to r+1 and receives from
r-1). After p steps every q row has attended to the whole sequence while no
rank ever held more than 1/p of k/v. Partial results merge by the online
softmax: m = max(m1, m2), acc = acc1 2^(m1-m) + acc2 2^(m2-m), l alike;
the output is acc / l.

The kernels, each with a wrapper that launches it on CUDA tensors and runs
its plain twin on CPU tensors (and counts either, in
ops/flash_attention.py's counters):

  * :func:`flash_attention_stats`: ``csrc/flash_attn_fwd_sm90.cu``'s
    ``flash_attn_fwd_stats`` (replaces the Pallas ``_flash_stats_kernel``),
    the forward writing the unnormalised fp32 accumulator and the base-2
    stats m and l;
  * :func:`flash_attention_pt_do`: ``csrc/flash_attn_pt_do_sm90.cu``'s
    ``flash_attn_bwd_pt_do`` (replaces ``_pt_do_kernel``), P^T dO in fp32
    on TMA and wgmma (``csrc/flash_pt_do_sm90.cuh``);
  * the dK/dV and dQ kernels of ops/flash_attention.py in their fp32-output
    form, for the ring backward's per-pair partials (:func:`_pair_bwd`).

Conventions, as in the JAX module: q, k, v are (B, N, H, D); the stats m
and l are (B, N, H) in the base-2, scale-folded logit domain; a row that
sees no key has m = -inf and l = 0, which :func:`merge_stats` guards. The
ring's lse (lse2 = m + log2(l)) is (B, N, H) as in JAX. The backward
kernels take it as a contiguous (B, H, N) tensor with +inf for a row that
saw no key (their P is then 0); the ring transposes it once per layer.

The two autograd Functions, :class:`RingFlashAttention` and
:class:`RingFlashAttentionWithLse`, are the JAX custom VJPs. Their backward
keeps q, dO and the saved lse resident, accumulates dq locally, and sends
(k, v, dk, dv) around the ring together; a final hop brings dk and dv home.
Every rank runs the same sequence of collectives.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from . import flash_attention as fa
from .flash_attention import _LOG2E, _check_kernel_args, _check_layout

# --- plain twins ------------------------------------------------------------


def flash_attention_stats_plain(q, k, v):
    """The plain version of the stats kernel, in fp32: (acc (B, Nq, H, D),
    m (B, Nq, H), l (B, Nq, H)) with s' = q.k * d^-1/2 * log2(e),
    m = max_j s', l = sum_j exp2(s' - m) and acc = sum_j exp2(s' - m) v_j.
    With no key, m = -inf, l = 0 and acc = 0."""
    b, nq, h, d = q.shape
    if k.shape[1] == 0:
        return (torch.zeros(b, nq, h, d, device=q.device),
                torch.full((b, nq, h), -torch.inf, device=q.device),
                torch.zeros(b, nq, h, device=q.device))
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * (
        d**-0.5 * _LOG2E)
    m = s.amax(dim=-1)
    p = torch.exp2(s - m[..., None])
    return torch.einsum("bqhk,bkhd->bqhd", p, v.float()), m, p.sum(-1)


def flash_attention_pt_do_plain(q, k, dout, lse):
    """The plain version of the P^T dO kernel: out_j = sum_i
    exp2(s'_ij - lse_i) dO_i, (B, Nk, H, D) fp32. lse is (B, H, Nq);
    a row with lse = +inf contributes 0."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        q.shape[-1] ** -0.5 * _LOG2E)
    p = torch.exp2(s - lse[..., None])
    return torch.einsum("bhqk,bqhd->bkhd", p, dout.float())


# --- the kernels' wrappers --------------------------------------------------


def flash_attention_stats(q, k, v):
    """(acc, m, l) fp32 of one shard: the CUDA kernel (flash_attn_fwd_stats)
    on CUDA tensors, :func:`flash_attention_stats_plain` on CPU tensors.
    `acc / l` is the attention output. v may be k itself."""
    if not q.is_cuda:
        return fa._plain(flash_attention_stats_plain, q, k, v)
    _check_kernel_args(q, k, v)
    b, nq, h, d = q.shape
    acc = torch.empty((b, nq, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, nq, h), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    fa._launch("fwd_stats", "flash_attn_fwd", "flash_attn_fwd_stats",
               q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, nq,
               k.shape[1], fa._strides(q, k, v, acc), d**-0.5 * _LOG2E)
    return acc, m, l


def _pt_do_cuda(launch, q, k, dout, lse):
    """Check the P^T dO arguments, allocate the output, and hand the
    entry's arguments to `launch(device, *args)`."""
    _check_kernel_args(q, k, k)
    _check_layout("dout", dout)
    b, nq, h, d = q.shape
    nk = k.shape[1]
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"flash_attention_pt_do: dout {tuple(dout.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if (lse.shape != (b, h, nq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention_pt_do: lse must be a contiguous "
                         f"({b}, {h}, {nq}) float32 tensor on {q.device}")
    out = torch.empty((b, nk, h, d), dtype=torch.float32, device=q.device)
    launch(q.device, q.data_ptr(), k.data_ptr(), dout.data_ptr(),
           lse.data_ptr(), out.data_ptr(), b, h, nq, nk,
           fa._strides(q, k, dout, out), d**-0.5 * _LOG2E)
    return out


def flash_attention_pt_do(q, k, dout, lse):
    """P^T dO (B, Nk, H, D) fp32: the CUDA kernel (flash_attn_bwd_pt_do) on
    CUDA tensors, :func:`flash_attention_pt_do_plain` on CPU tensors. lse is
    a contiguous (B, H, Nq) fp32 tensor, +inf for a row that saw no key."""
    if not q.is_cuda:
        return fa._plain(flash_attention_pt_do_plain, q, k, dout, lse)
    return _pt_do_cuda(functools.partial(fa._launch, "pt_do", "flash_attn_bwd",
                                         "flash_attn_bwd_pt_do"),
                       q, k, dout, lse)


# --- merging partial states -------------------------------------------------


def merge_stats(acc1, m1, l1, acc2, m2, l2):
    """Online-softmax merge of two partial attention states (JAX `_merge`):
    a side with m = -inf (no key seen yet) weighs 0, and the merged m of
    two such sides stays -inf."""
    m = torch.maximum(m1, m2)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    a1 = torch.where(m1 == -torch.inf, zero, torch.exp2(m1 - m))
    a2 = torch.where(m2 == -torch.inf, zero, torch.exp2(m2 - m))
    return acc1 * a1[..., None] + acc2 * a2[..., None], m, l1 * a1 + l2 * a2


def attention_stats(q, k, v):
    """Exact partial-attention state (acc, m, l) in fp32, mergeable with the
    kernel's by :func:`merge_stats`, for tiny key sets (the trunk's
    replicated scale token). Plain torch, as JAX computes it with XLA; it
    counts as no kernel and no plain launch. q, k, v are (B, N, H, D)."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (
        q.shape[-1] ** -0.5 * _LOG2E)
    m = s.amax(dim=-1)
    p = torch.exp2(s - m[..., None])
    acc = torch.einsum("bhnm,bmhd->bnhd", p, v.float())
    return acc, m.transpose(1, 2), p.sum(-1).transpose(1, 2)


# --- the ring ---------------------------------------------------------------


def rotate(tensors, group):
    """Send each tensor to rank + 1 of `group` and receive the one of rank -
    1, with one dist.batch_isend_irecv on the current stream. The identity
    on a group of one rank."""
    p = dist.get_world_size(group)
    if p == 1:
        return list(tensors)
    rank = dist.get_rank(group)
    dst = dist.get_global_rank(group, (rank + 1) % p)
    src = dist.get_global_rank(group, (rank - 1) % p)
    ops, received = [], []
    for t in tensors:
        t = t.contiguous()
        buf = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, dst, group))
        ops.append(dist.P2POp(dist.irecv, buf, src, group))
        received.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


class AllGather(torch.autograd.Function):
    """(p, ...) stack of every rank's x, in rank order. Every rank consumes
    every slot, so the backward sums the slots' cotangents over the ranks
    (one all_reduce) and keeps the rank's own: the semantics of the JAX
    package's ``all_gather_grad_correct``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g[dist.get_rank(ctx.group)], None


def all_gather(x, group):
    """Differentiable all-gather: see :class:`AllGather`."""
    return AllGather.apply(x, group)


class AllReduce(torch.autograd.Function):
    """The sum of every rank's x, on every rank. Every rank consumes the
    sum, so the backward sums the cotangents over the ranks as well (one
    all_reduce): the semantics of the JAX package's
    ``psum_grad_correct``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x, group):
    """Differentiable all-reduce (sum): see :class:`AllReduce`."""
    return AllReduce.apply(x, group)


def ring_flash_stats(q, k, v, group):
    """The full-ring partial state (acc, m, l) fp32 of the LOCAL q rows
    after attending to every rank's k/v shard. A caller that merges more
    context in (the replicated extra tokens) does so with
    :func:`merge_stats` before dividing by l."""
    acc, m, l = flash_attention_stats(q, k, v)
    kc, vc = k, v
    for _ in range(dist.get_world_size(group) - 1):
        kc, vc = rotate((kc, vc), group)
        acc, m, l = merge_stats(acc, m, l, *flash_attention_stats(q, kc, vc))
    return acc, m, l


def _finish(acc, m, l):
    """(out fp32, lse2 (B, N, H) in JAX's convention, lse for the backward
    kernels: contiguous (B, H, N), +inf where no key was seen)."""
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    out = acc / safe_l[..., None]
    lse2 = m + torch.log2(safe_l)
    lse_t = torch.where(l == 0, torch.full_like(l, torch.inf), lse2)
    return out, lse2, lse_t.transpose(1, 2).contiguous()


def _kernel_operand(x: torch.Tensor, dtype) -> torch.Tensor:
    """x in `dtype`, in a layout the kernels read."""
    x = x.to(dtype)
    return x if fa._kernel_layout(x) else x.contiguous()


def _pair_bwd(q, k, v, dout, lse, delta):
    """One (q shard, kv shard) pair of the flash backward with the GLOBAL
    row stats (JAX `_pair_bwd`): the dK/dV and dQ kernels with fp32
    outputs. The probabilities come from the full-sequence lse, so pair
    gradients are exact partials that add up across shards. lse and delta
    are contiguous (B, H, Nq) fp32. Returns (dq, dk, dv) fp32."""
    dk, dv = fa.flash_attention_dkv(q, k, v, dout, lse, delta,
                                    out_dtype=torch.float32)
    dq = fa.flash_attention_dq(q, k, v, dout, lse, delta,
                               out_dtype=torch.float32)
    return dq, dk, dv


def _ring_backward(q, k, v, group, pair):
    """The rotation schedule both Functions share: `pair(kc, vc)` returns
    the pair's (dq, dk, dv) fp32 partials; dq accumulates here, (k, v, dk,
    dv) travel together, and a last hop brings dk and dv home."""
    p = dist.get_world_size(group)
    kc, vc = k, v
    dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvc = torch.zeros_like(dkc)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for step in range(p):
        dq_p, dk_p, dv_p = pair(kc, vc)
        dq += dq_p
        dkc += dk_p
        dvc += dv_p
        if step < p - 1:  # the last pair's k/v need no hop
            kc, vc, dkc, dvc = rotate((kc, vc, dkc, dvc), group)
    dkc, dvc = rotate((dkc, dvc), group)
    return dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype)


class RingFlashAttention(torch.autograd.Function):
    """Ring attention of the local shard, differentiable (JAX
    `ring_flash_attention_trainable`): returns (B, N/p, H, D) in q's
    dtype."""

    @staticmethod
    def forward(ctx, q, k, v, group):
        out, _, lse_t = _finish(*ring_flash_stats(q, k, v, group))
        out = out.to(q.dtype)
        if any(ctx.needs_input_grad[:3]):
            ctx.group = group
            ctx.save_for_backward(q, k, v, out, lse_t)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse_t = ctx.saved_tensors
        g = _kernel_operand(g, q.dtype)
        delta = fa.attention_delta(g, out)

        def pair(kc, vc):
            return _pair_bwd(q, kc, vc, g, lse_t, delta)

        return (*_ring_backward(q, k, v, ctx.group, pair), None)


class RingFlashAttentionWithLse(torch.autograd.Function):
    """Ring attention that also returns the base-2 row log-sum-exp (JAX
    `ring_flash_attention_with_lse`): (out (B, N/p, H, D) fp32, lse2
    (B, N/p, H) fp32). The extra-token merge of nn/layers.py weights the
    ring output by 2^lse2, so the backward takes cotangents for both. The
    lse cotangent g_lse decomposes into the same kernel patterns, with
    c = d^-1/2 log2(e):

        dq_i += g_i c sum_j p_ij k_j   (the stats kernel with V := K, rescaled
                                        from the pair max to the global lse)
        dk_j += c sum_i g_i p_ij q_i   (the P^T dO kernel with dO := g c q)
    """

    @staticmethod
    def forward(ctx, q, k, v, group):
        out, lse2, lse_t = _finish(*ring_flash_stats(q, k, v, group))
        if any(ctx.needs_input_grad[:3]):
            ctx.group = group
            ctx.save_for_backward(q, k, v, out, lse_t)
        return out, lse2

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse_t = ctx.saved_tensors
        c2 = q.shape[-1] ** -0.5 * _LOG2E
        if g_out is None:
            g_out = torch.zeros_like(out)
        if g_lse is None:
            g_lse = torch.zeros(out.shape[:-1], device=out.device)
        delta = fa.attention_delta(g_out, out)
        g = _kernel_operand(g_out, q.dtype)
        do_lse = _kernel_operand(g_lse[..., None] * q.float() * c2, q.dtype)
        lse_rows = lse_t.transpose(1, 2)  # (B, N, H) view, +inf: no key

        def pair(kc, vc):
            dq_p, dk_p, dv_p = _pair_bwd(q, kc, vc, g, lse_t, delta)
            dk_p += flash_attention_pt_do(q, kc, do_lse, lse_t)
            acc_k, m_pair, _ = flash_attention_stats(q, kc, kc)
            # a row that saw no key in this pair (m = -inf) or at all
            # (lse = +inf) gets 0, not -inf - -inf or 0 * inf
            w = torch.where(m_pair == -torch.inf, torch.zeros_like(m_pair),
                            torch.exp2(m_pair - lse_rows))
            dq_p += (g_lse * c2 * w)[..., None] * acc_k
            return dq_p, dk_p, dv_p

        return (*_ring_backward(q, k, v, ctx.group, pair), None)


def ring_flash_attention(q, k, v, group):
    """Full-sequence attention of the local shard (B, N/p, H, D), in q's
    dtype, differentiable. Every rank's shard must have the same length."""
    return RingFlashAttention.apply(q, k, v, group)


def ring_flash_attention_with_lse(q, k, v, group):
    """(out fp32, lse2) of the local shard; see
    :class:`RingFlashAttentionWithLse`."""
    return RingFlashAttentionWithLse.apply(q, k, v, group)


__all__ = [
    "AllGather",
    "AllReduce",
    "RingFlashAttention",
    "RingFlashAttentionWithLse",
    "all_gather",
    "all_reduce",
    "attention_stats",
    "flash_attention_pt_do",
    "flash_attention_pt_do_plain",
    "flash_attention_stats",
    "flash_attention_stats_plain",
    "merge_stats",
    "ring_flash_attention",
    "ring_flash_attention_with_lse",
    "ring_flash_stats",
    "rotate",
]
