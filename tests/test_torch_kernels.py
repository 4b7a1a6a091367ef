"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on the GPU machine:
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``. The
`cuda`-marked tests skip where no GPU is present. Tolerance 1e-2 (abs and
rel for the forward; max-abs over the reference's max-abs and rel-L2 for
the training kernels): the kernels keep fp32 scores, round P and dS to bf16
for the tensor-core products and their outputs once to bf16.
"""

import numpy as np
import pytest
import torch

from mapanything_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_fwd_lse,
    flash_attention_fwd_lse_plain,
    flash_attention_plain,
    reset_launch_counts,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(seed, b, n, h, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, n, h, d))
                             .astype(np.float32)) for _ in range(3)]


class TestDispatch:
    def test_cpu_tensor_runs_plain_and_counts(self):
        reset_launch_counts()
        qkv = _qkv(5, 1, 64, 2, 64)
        out = flash_attention(*qkv)
        assert flash_attention.plain_launches == 1
        assert flash_attention.kernel_launches == 0
        torch.testing.assert_close(out, flash_attention_plain(*qkv))
        reset_launch_counts()

    def test_cpu_training_runs_plain_twins(self):
        q, k, v = (x.requires_grad_() for x in _qkv(9, 1, 64, 2, 64))
        reset_launch_counts()
        out = flash_attention(q, k, v)
        assert flash_attention.plain_launches == 1  # forward with lse
        out.sum().backward()
        assert flash_attention.plain_launches == 2  # and the backward
        assert flash_attention.kernel_launches == 0
        assert all(x.grad is not None for x in (q, k, v))
        reset_launch_counts()

    def test_fully_masked_rows_are_zero(self):
        qkv = _qkv(6, 1, 64, 2, 64)
        out = flash_attention_plain(*qkv, n_valid=0)
        assert torch.equal(out, torch.zeros_like(out))

    def test_strided_views_match_contiguous(self):
        rng = np.random.default_rng(8)
        qkv = torch.from_numpy(
            rng.standard_normal((2, 100, 3, 4, 64)).astype(np.float32))
        views = qkv.unbind(2)
        contig = [t.contiguous() for t in views]
        torch.testing.assert_close(flash_attention_plain(*views, n_valid=90),
                                   flash_attention_plain(*contig, n_valid=90))


# (B, N, H, D) and n_valid of the main path at 518^2: encoder (one view),
# frame layers (two views), 2-view global layer; and a row that sees no key.
_KERNEL_CASES = [
    ((1, 1408, 16, 64), 1370),
    ((2, 1369, 16, 64), None),
    ((1, 2816, 16, 64), 2739),
    ((1, 100, 2, 64), 0),
]


def _cuda_qkv(shape, n_valid, layout, device):
    """bf16 q, k, v: three contiguous tensors, or the strided (B, N, H, D)
    views of one fused (B, N, 3, H, D) tensor with the rows at or past
    n_valid zeroed, as nn/layers.py::Attention hands them to the kernel."""
    gen = torch.Generator(device=device).manual_seed(0)
    if layout == "contiguous":
        return [torch.randn(shape, generator=gen, device=device)
                .to(torch.bfloat16) for _ in range(3)]
    b, n, h, d = shape
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device=device).to(
        torch.bfloat16)
    if n_valid is not None:
        qkv[:, n_valid:] = 0
    return list(qkv.unbind(2))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "fused_qkv"])
@pytest.mark.parametrize("shape,n_valid", _KERNEL_CASES)
def test_cuda_kernel_matches_plain(cuda_device, shape, n_valid, layout):
    q, k, v = _cuda_qkv(shape, n_valid, layout, cuda_device)
    reset_launch_counts()
    out = flash_attention(q, k, v, n_valid=n_valid)
    torch.cuda.synchronize()
    assert flash_attention.kernel_launches == 1
    assert flash_attention.plain_launches == 0
    ref = flash_attention_plain(q, k, v, n_valid=n_valid)
    rows = shape[1] if n_valid is None else max(n_valid, 1)
    torch.testing.assert_close(out[:, :rows].float(), ref[:, :rows].float(),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 64, 2, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    for dtype in (torch.float16, torch.float32):
        q = torch.zeros(1, 64, 2, 64, device=cuda_device, dtype=dtype)
        with pytest.raises(TypeError, match="takes bfloat16"):
            flash_attention(q, q, q)


# the training shapes: encoder (4 views), frame layers (4 views), 2- and
# 4-view global layers at 518^2, and a row that sees no key
_TRAIN_CASES = [
    ((4, 1408, 16, 64), 1370),
    ((4, 1369, 16, 64), None),
    ((1, 2816, 16, 64), 2739),
    ((1, 5504, 16, 64), 5477),
    ((1, 100, 2, 64), 0),
]


def _err(out, ref):
    """(max-abs over the reference's max-abs, rel-L2), fp64."""
    out, ref = out.double(), ref.double()
    scale = ref.abs().max().clamp_min(1e-30)
    return (float((out - ref).abs().max() / scale),
            float((out - ref).norm() / ref.norm().clamp_min(1e-30)))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "fused_qkv"])
@pytest.mark.parametrize("shape,n_valid", _TRAIN_CASES)
def test_cuda_training_kernels_match_plain(cuda_device, shape, n_valid,
                                           layout):
    """The Function on the card, forward and backward, against the plain
    twins. With the fused layout, the gradient lands in the fused leaf:
    the repaired fault (a forward without grad_fn gave q, k, v none)."""
    if layout == "fused_qkv":
        b, n, h, d = shape
        gen = torch.Generator(device=cuda_device).manual_seed(1)
        leaf = torch.randn((b, n, 3, h, d), generator=gen,
                           device=cuda_device).to(torch.bfloat16)
        if n_valid is not None:
            leaf[:, n_valid:] = 0
        leaf.requires_grad_()
        q, k, v = leaf.unbind(2)
    else:
        q, k, v = (x.requires_grad_()
                   for x in _cuda_qkv(shape, n_valid, layout, cuda_device))
    real = shape[1] if n_valid is None else n_valid
    dout = torch.randn(shape, device=cuda_device).to(torch.bfloat16)
    dout[:, real:] = 0
    reset_launch_counts()
    out = flash_attention(q, k, v, n_valid=n_valid)
    out.backward(dout)
    torch.cuda.synchronize()
    assert flash_attention.kernel_counts == {"fwd": 0, "fwd_lse": 1,
                                             "dkv": 1, "dq": 1}
    assert flash_attention.plain_launches == 0

    qd, kd, vd = (x.detach() for x in (q, k, v))
    ref_out, ref_lse = flash_attention_fwd_lse_plain(qd, kd, vd, n_valid)
    _, lse = flash_attention_fwd_lse(qd, kd, vd, n_valid)
    if real == 0:
        assert not out.detach().any() and torch.isinf(lse).all()
    else:
        for got, ref in ((out.detach()[:, :real], ref_out[:, :real]),
                         (lse[..., :real], ref_lse[..., :real])):
            assert max(_err(got, ref)) <= 1e-2
    refs = flash_attention_bwd_plain(qd, kd, vd, ref_out, ref_lse, dout,
                                     n_valid)
    if layout == "fused_qkv":
        grads = leaf.grad.unbind(2)
    else:
        grads = [x.grad for x in (q, k, v)]
    for name, g, r in zip("qkv", grads, refs):
        assert g is not None, f"d{name}"
        if real == 0:
            assert not g.any(), f"d{name}"
        else:
            assert max(_err(g[:, :real], r[:, :real])) <= 1e-2, f"d{name}"
            assert not g[:, real:].any(), f"d{name} pad rows"
