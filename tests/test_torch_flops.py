"""utils/flops.py: the work of the backward's attention kernels and its
bound on an H100 SXM, as chip_smoke.py and PERF.md's kernel table use them.

At the three attention shapes of the 1 x 4-view x 518^2 train step the
dK/dV kernel runs 4 products of 2 * Nq * Nk * D flops per (batch, head)
(S^T, dP^T, dV, dK), the dQ kernel 3 (S, dP, dQ), and the backward as one
call ("bwd": delta, dK/dV and dQ) the 5 that function needs (S, dP, dV, dK,
dQ), not the 7 its two kernels run; each input is read once and each output
written once. This module imports no JAX.
"""

import pytest

from mapanything_tpu_torch.utils import flops as F

# (B, N, H, D) and the real keys of the train step's attention shapes:
# encoder (4 views of 1370 tokens, padded to 1408), frame layers (4 views of
# 1369 patches), global (5477 tokens, padded to 5504)
TRAIN_SHAPES = [((4, 1408, 16, 64), 1370), ((4, 1369, 16, 64), 1369),
                ((1, 5504, 16, 64), 5477)]
PRODUCTS = {"dkv": 4, "dq": 3, "bwd": 5}


@pytest.mark.parametrize("kernel", list(PRODUCTS))
@pytest.mark.parametrize("shape,kv", TRAIN_SHAPES)
def test_backward_work_counts_products_and_bytes(kernel, shape, kv):
    b, n, h, d = shape
    flops, nbytes = F.attention_kernel_work(kernel, b, n, kv, h, d)
    assert flops == PRODUCTS[kernel] * 2 * b * h * n * kv * d
    rows, q, k = b * h * n * 4, b * n * h * d * 2, b * kv * h * d * 2
    # q and dO (and O for the whole backward) in, k and v in, fp32 lse
    # (and delta for the kernels) in; dq (n rows) and dk, dv (kv rows) out
    want = {"dkv": 2 * q + 2 * k + 2 * rows + 2 * k,
            "dq": 2 * q + 2 * k + 2 * rows + q,
            "bwd": 3 * q + 2 * k + rows + q + 2 * k}[kernel]
    assert nbytes == want


@pytest.mark.parametrize("shape,kv", TRAIN_SHAPES)
def test_backward_is_bound_by_operations(shape, kv):
    """At every train shape the tensor cores bound the backward kernels:
    the bound is their flops at 989 TFLOP/s, and the whole backward's is
    5/7 of the sum of its two kernels', which compute S and dP twice."""
    b, n, h, d = shape
    bounds = {}
    for kernel in PRODUCTS:
        flops, _ = F.attention_kernel_work(kernel, b, n, kv, h, d)
        ms, by = F.roofline_ms(*F.attention_kernel_work(kernel, b, n, kv, h,
                                                        d))
        assert by == "operations"
        assert ms == pytest.approx(flops / 989e12 * 1e3, rel=1e-12)
        bounds[kernel] = ms
    assert bounds["bwd"] == pytest.approx(
        (bounds["dkv"] + bounds["dq"]) * 5 / 7, rel=1e-12)


def test_bounds_at_the_global_training_shape():
    """PERF.md's bounds of dK/dV, dQ and the whole backward at
    (1, 5504, 16, 64), 5477 keys."""
    work = {kernel: F.attention_kernel_work(kernel, 1, 5504, 5477, 16, 64)
            for kernel in PRODUCTS}
    ms = {kernel: F.roofline_ms(*w)[0] for kernel, w in work.items()}
    assert round(ms["dkv"], 4) == 0.2497
    assert round(ms["dq"], 4) == 0.1873
    assert round(ms["bwd"], 4) == 0.3121


def test_fp32_outputs_add_bytes_not_flops():
    """The ring's fp32 partials write 4 bytes per output element."""
    for kernel, outputs in (("dkv", 2 * 5476), ("dq", 5476)):
        f2, b2 = F.attention_kernel_work(kernel, 1, 5476, 5476, 16, 64)
        f4, b4 = F.attention_kernel_work(kernel, 1, 5476, 5476, 16, 64,
                                         out_bytes=4)
        assert f4 == f2 and b4 - b2 == outputs * 16 * 64 * 2


def test_few_keys_are_bound_by_bytes():
    """With one key the products vanish and the bytes set the bound."""
    for kernel in PRODUCTS:
        assert F.roofline_ms(*F.attention_kernel_work(
            kernel, 1, 5504, 1, 16, 64))[1] == "bytes"
