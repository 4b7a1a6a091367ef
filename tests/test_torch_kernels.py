"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on the GPU machine:
``python -m pytest tests/test_torch_kernels.py -m cuda``. The `cuda`-marked
tests skip where no GPU is present. Tolerance 1e-2 (abs and rel): the
kernel keeps fp32 scores, rounds P to bf16 for the PV product and the output
once to bf16.
"""

import numpy as np
import pytest
import torch

from mapanything_tpu_torch.ops.flash_attention import (
    flash_attention,
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
