"""Each configuration's count of a call's products against a count made
by PyTorch's FlopCounterMode of its reference at a small shape."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from . import tiny
from perfbench.harness import weights


@pytest.mark.parametrize("name", tiny.cells())
def test_flops_match_a_count_of_the_reference(name):
    c = tiny.cell(name)
    tr = c.traffic
    sd = weights.make_state_dict(c.family.spec(c.config), 1, "cpu")
    images = np.zeros((tr["batch"], tr["views"], tr["height"], tr["width"], 3),
                      np.float32)
    # the rounded precision runs attention as two matmuls, which the
    # counter sees (float32 runs PyTorch's fused attention)
    with FlopCounterMode(display=False) as counter:
        c.family.run_reference(sd, c.config, images, "cpu", "bf16")
    # a training step counts three forwards
    forwards = 3 if tr["entry"] == "train" else 1
    assert counter.get_total_flops() * forwards == c.family.call_flops(
        c.config, tr)


@pytest.mark.parametrize("name", tiny.cells())
def test_attention_flops_are_part_of_the_count(name):
    from perfbench.harness.flops import attention_kernel_work

    c = tiny.cell(name)
    tr = c.traffic
    attn = sum(n * attention_kernel_work("fwd", b, nq, nk, h, d)[0]
               for b, nq, nk, h, d, n in c.family.attention_calls(c.config, tr))
    assert 0 < attn < c.family.call_flops(c.config, tr)


def test_the_attention_backward_counts_its_needed_work_once():
    """The backward's least work, by hand: five products (S recomputed,
    dP, dV, dQ, dK) and one read of q, k, v, the output, its gradient and
    the log-sum-exp, one write of dQ, dK and dV, whatever kernels the
    program splits it into."""
    from perfbench.harness.flops import attention_kernel_work

    b, nq, nk, h, d = 2, 100, 120, 4, 64
    flops, nbytes = attention_kernel_work("bwd", b, nq, nk, h, d)
    assert flops == 5 * 2 * b * h * nq * nk * d
    bf16, f32 = 2, 4
    reads = (3 * nq + 2 * nk) * b * h * d * bf16 + b * h * nq * f32
    writes = (nq + 2 * nk) * b * h * d * bf16
    assert nbytes == reads + writes
    fwd_flops, _ = attention_kernel_work("fwd_lse", b, nq, nk, h, d)
    assert 2 * flops == 5 * fwd_flops
