"""Analytic FLOP counts of the released architecture; counterpart of
mapanything_tpu/utils/flops.py, with the peak of the card the port runs on.

A multiply-accumulate counts as 2 FLOPs. The counts come from the shapes
alone (DINOv2 ViT-L/14 encoder, 24-layer alternating trunk, DPT head); the
same numbers divide every utilisation the port reports.
"""

from __future__ import annotations

# NVIDIA H100 SXM, bf16 tensor cores, dense (no sparsity), at the 700 W
# limit: 989 TFLOP/s (NVIDIA's H100 data sheet).
H100_SXM_BF16_DENSE_PEAK_FLOPS = 989e12


def vit_layer_flops(tokens: int, dim: int) -> int:
    """One pre-LN transformer block: fused qkv + proj, QK^T and PV, MLP x4."""
    attn_lin = 2 * tokens * 4 * dim * dim
    attn_mm = 2 * 2 * tokens * tokens * dim
    mlp = 2 * tokens * 2 * 4 * dim * dim
    return attn_lin + attn_mm + mlp


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
