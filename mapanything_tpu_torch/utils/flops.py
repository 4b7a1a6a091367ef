"""Analytic FLOP counts of the released architecture; counterpart of
mapanything_tpu/utils/flops.py, with the peak of the card the port runs on.

A multiply-accumulate counts as 2 FLOPs. The counts come from the shapes
alone (DINOv2 ViT-L/14 encoder, 24-layer alternating trunk, DPT head); the
same numbers divide every utilisation the port reports.
"""

from __future__ import annotations

# NVIDIA H100 SXM, bf16 tensor cores, dense (no sparsity), at the 700 W
# limit: 989 TFLOP/s; its HBM3 moves 3.35 TB/s (NVIDIA's H100 data sheet).
H100_SXM_BF16_DENSE_PEAK_FLOPS = 989e12
H100_SXM_HBM_BYTES_PER_S = 3.35e12

# tensor-core products of 2 * Nq * Nk * D flops per (batch, head) that each
# attention kernel runs. "bwd" is the whole backward (delta, dK/dV and dQ)
# as one function: the 5 products it needs (S, dP, dV, dK, dQ); the dK/dV
# and dQ kernels together run 7, since each computes S and dP
_ATTENTION_PRODUCTS = {"fwd": 2, "fwd_lse": 2, "dkv": 4, "dq": 3, "bwd": 5,
                       "fwd_stats": 2, "pt_do": 2}


def attention_kernel_work(kernel: str, b: int, nq: int, nk: int, h: int,
                          d: int, out_bytes: int = 2,
                          v_is_k: bool = False) -> tuple[int, int]:
    """(flops, bytes) one attention kernel needs at q (b, nq, h, d) against
    nk real keys: its tensor-core products, and every input read once and
    every output written once (bf16 operands; `out_bytes` per output
    element; fp32 row stats). The softmax's exponentials are not counted.
    "bwd" reads q, k, v, the output, dO and the lse and writes dq, dk and
    dv (delta is its own intermediate)."""
    tok, rows = b * h * d, b * h
    q = nq * tok * 2  # q, and dO of the same shape
    kv = nk * tok * 2
    nbytes = {
        "fwd": q + 2 * kv + nq * tok * out_bytes,
        "fwd_lse": q + 2 * kv + nq * tok * out_bytes + rows * nq * 4,
        "dkv": 2 * q + 2 * kv + 2 * rows * nq * 4 + 2 * nk * tok * out_bytes,
        "dq": 2 * q + 2 * kv + 2 * rows * nq * 4 + nq * tok * out_bytes,
        "bwd": (3 * q + 2 * kv + rows * nq * 4
                + (nq + 2 * nk) * tok * out_bytes),
        "fwd_stats": (q + (1 if v_is_k else 2) * kv + nq * tok * 4
                      + 2 * rows * nq * 4),
        "pt_do": 2 * q + kv + rows * nq * 4 + nk * tok * 4,
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


def vit_layer_flops(tokens: int, dim: int) -> int:
    """One pre-LN transformer block: fused qkv + proj, QK^T and PV, MLP x4."""
    attn_lin = 2 * tokens * 4 * dim * dim
    attn_mm = 2 * 2 * tokens * tokens * dim
    mlp = 2 * tokens * 2 * 4 * dim * dim
    return attn_lin + attn_mm + mlp


def attention_matmul_flops(n: int, dim: int) -> int:
    """The two products of one attention over n tokens, QK^T and PV: the
    part a flash kernel executes."""
    return 2 * 2 * n * n * dim


def analytic_flops(res_h: int, views: int, res_w: int | None = None) -> dict:
    """Forward FLOPs at (res_h, res_w) per view: encoder / trunk / dpt /
    total / per_view."""
    if res_w is None:
        res_w = res_h
    p = 14
    gh, gw = res_h // p, res_w // p
    g2 = gh * gw
    n = g2 + 1  # patches + cls
    dim = 1024

    enc = views * (24 * vit_layer_flops(n, dim) + 2 * n * (p * p * 3) * dim)
    frame = 12 * views * vit_layer_flops(n, dim)
    glob = 12 * vit_layer_flops(views * n + 1, dim)
    trunk = frame + glob + views * 2 * n * dim * dim  # input projection
    f = 256
    dpt = views * (
        4 * 2 * g2 * dim * f  # hook 1x1 convs
        + sum(2 * g2 * (k * k) * f * f * 9 * 2 for k in (1, 2, 4, 8))
        + 2 * res_h * res_w * f * (f // 2) * 9  # output_conv1 3x3
        + 2 * res_h * res_w * (f // 2) * 32 * 9  # regressor 3x3
    )
    total = enc + trunk + dpt
    return {"encoder": enc, "trunk": trunk, "dpt": dpt, "total": total,
            "per_view": total / views}


def train_step_flops(res_h: int, views: int, res_w: int | None = None) -> int:
    """Model FLOPs of one forward and backward (backward = 2x forward;
    recomputation not counted), the numerator of the train MFU."""
    return 3 * analytic_flops(res_h, views, res_w)["total"]


def global_attention_tokens(res_h: int, views: int,
                            res_w: int | None = None) -> int:
    """Tokens one trunk global-attention layer sees (before padding)."""
    if res_w is None:
        res_w = res_h
    p = 14
    return views * ((res_h // p) * (res_w // p) + 1) + 1
