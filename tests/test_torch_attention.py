"""Port attention (mapanything_tpu_torch.ops) against the JAX package.

The plain fp32 twin of the CUDA flash kernel is held against the JAX Pallas
flash kernel in interpret mode and against the XLA attention, at fp32, on
inputs from a seeded numpy generator. Tolerance 1e-5 (abs and rel): both
sides compute softmax attention in fp32 and differ only in summation order.
The CUDA kernel itself is compared with its plain twin in
tests/test_torch_kernels.py, which needs no JAX and runs where a GPU is.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu.ops.attention import _sdpa_xla
from mapanything_tpu.ops.flash_attention import flash_attention as jax_flash
from mapanything_tpu_torch.ops import attention as port_attention
from mapanything_tpu_torch.ops.flash_attention import flash_attention_plain

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, b, n, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, h, d)).astype(np.float32)
            for _ in range(3)]


def _port(fn, arrays, **kw):
    return fn(*(torch.from_numpy(a) for a in arrays), **kw).numpy()


def _pad(arrays, n_pad):
    return [np.pad(a, ((0, 0), (0, n_pad - a.shape[1]), (0, 0), (0, 0)))
            for a in arrays]


class TestPlainVsJaxFlash:
    @pytest.mark.parametrize("n", [256, 384, 500])
    def test_one_pass(self, n):
        qkv = _qkv(n, 2, n, 4, 64)
        with jax.default_matmul_precision("highest"):
            ref = jax_flash(*map(jnp.asarray, qkv), block_q=128, block_k=128,
                            interpret=True)
        np.testing.assert_allclose(_port(flash_attention_plain, qkv),
                                   np.asarray(ref), **TOL)

    def test_n_valid_300_in_384(self):
        qkv = _pad(_qkv(1, 1, 300, 2, 64), 384)
        with jax.default_matmul_precision("highest"):
            ref = jax_flash(*map(jnp.asarray, qkv), block_q=128, block_k=128,
                            interpret=True, n_valid=300, onepass_t=True)
        out = _port(flash_attention_plain, qkv, n_valid=300)
        # pad query rows hold garbage by contract: real rows only
        np.testing.assert_allclose(out[:, :300], np.asarray(ref)[:, :300],
                                   **TOL)

    @pytest.mark.parametrize("n", [256, 500])
    def test_row_major_one_pass(self, n):
        qkv = _qkv(2 * n, 2, n, 4, 64)
        with jax.default_matmul_precision("highest"):
            ref = jax_flash(*map(jnp.asarray, qkv), block_q=128, block_k=128,
                            interpret=True, onepass_t=False)
        np.testing.assert_allclose(_port(flash_attention_plain, qkv),
                                   np.asarray(ref), **TOL)

    @pytest.mark.parametrize("n", [384, 500])
    def test_online_multiblock(self, n):
        qkv = _qkv(3 * n, 2, n, 4, 64)
        with jax.default_matmul_precision("highest"):
            ref = jax_flash(*map(jnp.asarray, qkv), block_q=128, block_k=128,
                            interpret=True, single_pass_max=128)
        np.testing.assert_allclose(_port(flash_attention_plain, qkv),
                                   np.asarray(ref), **TOL)


class TestAgainstXla:
    @pytest.mark.parametrize("impl", ["auto", "flash", "math"])
    @pytest.mark.parametrize("n_valid", [None, 300])
    def test_sdpa_impls(self, impl, n_valid):
        qkv = _pad(_qkv(7, 2, 300, 4, 64), 384)
        mask = None if n_valid is None else jnp.asarray(
            np.arange(384) < n_valid)
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(_sdpa_xla(*map(jnp.asarray, qkv), key_mask=mask))
        out = _port(port_attention.sdpa, qkv, impl=impl, n_valid=n_valid)
        np.testing.assert_allclose(out[:, :300], ref[:, :300], **TOL)

    def test_math_bf16_rounds_like_xla(self):
        qkv = _qkv(11, 1, 200, 2, 64)
        q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in qkv)
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(_sdpa_xla(q, k, v).astype(jnp.float32))
        tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                      .to(torch.bfloat16) for a in (q, k, v))
        out = port_attention.sdpa_math(tq, tk, tv).float().numpy()
        # one bf16 rounding of the output apart at most
        np.testing.assert_allclose(out, ref, atol=1e-2, rtol=1e-2)

    def test_unknown_impl_raises(self):
        q = torch.zeros(1, 4, 1, 64)
        with pytest.raises(ValueError, match="unknown attention impl"):
            port_attention.sdpa(q, q, q, impl="xla")
