"""The card's peaks and an attention's least work.

Copied from mapanything_tpu_torch/utils/flops.py (H100_SXM_* and
attention_kernel_work, roofline_ms) and frozen here: the program may
change, the yardstick may not. The backward's work is what the algorithm
needs, counted once however the program splits it into kernels (the copy
counted each kernel's own products and reads). The benchmark calls them
with the real token counts of each attention, never padded ones, so that
no share of a roofline can read above 100% on a sound program.
"""

from __future__ import annotations

# NVIDIA H100 SXM, bf16 tensor cores, dense (no sparsity), at the 700 W
# limit: 989 TFLOP/s; its HBM3 moves 3.35 TB/s (NVIDIA's H100 data sheet).
H100_SXM_BF16_DENSE_PEAK_FLOPS = 989e12
H100_SXM_HBM_BYTES_PER_S = 3.35e12

# tensor-core products of 2 * Nq * Nk * D flops per (batch, head) that an
# attention needs: the forward 2 (S, PV); the backward 5 (S recomputed from
# the saved row stats, dP, dV, dQ, dK)
_ATTENTION_PRODUCTS = {"fwd": 2, "fwd_lse": 2, "bwd": 5}


def attention_kernel_work(kernel: str, b: int, nq: int, nk: int, h: int,
                          d: int, out_bytes: int = 2) -> tuple[int, int]:
    """(flops, bytes) that one attention's forward ("fwd", "fwd_lse": with
    its log-sum-exp) or backward ("bwd") needs at q (b, nq, h, d) against
    nk real keys: its tensor-core products, and every input read once and
    every output written once (bf16 operands; `out_bytes` per output
    element; fp32 row stats). The backward reads q, k, v, the output, its
    gradient and the log-sum-exp, and writes dQ, dK and dV. The softmax's
    exponentials are not counted."""
    tok, rows = b * h * d, b * h
    q = nq * tok * 2  # q, and the output and dO of the same shape
    kv = nk * tok * 2
    nbytes = {
        "fwd": q + 2 * kv + nq * tok * out_bytes,
        "fwd_lse": q + 2 * kv + nq * tok * out_bytes + rows * nq * 4,
        "bwd": (3 * q + 2 * kv + rows * nq * 4
                + (nq + 2 * nk) * tok * out_bytes),
    }[kernel]
    return 2 * _ATTENTION_PRODUCTS[kernel] * rows * nq * nk * d, nbytes


def roofline_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time an H100 SXM takes for this work, in ms: the larger of
    flops at the bf16 dense peak and bytes at the HBM rate; and which of
    the two ("operations" or "bytes") sets it."""
    t_ops = flops / H100_SXM_BF16_DENSE_PEAK_FLOPS
    t_bytes = nbytes / H100_SXM_HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")
