"""The port's flash-attention backward against the JAX package's.

The plain twins of the three training kernels (forward with lse, dK/dV, dQ)
are held against the JAX Pallas kernels of
mapanything_tpu/ops/flash_attention_bwd.py run in interpret mode (the
`pallas_call` swap of tests/test_attention.py), on the same seeded numpy
inputs at fp32. The JAX side runs under jax.default_matmul_precision
("highest"). Tolerance atol=2e-4, rtol=1e-3, the JAX package's own for its
backward kernels. The JAX lse is unpacked from its (B*H, nq, 8, bq) tiles;
both are base 2.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu.ops import flash_attention_bwd as fb
from mapanything_tpu_torch.ops.attention import sdpa_math
from mapanything_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_fwd_lse_plain,
    reset_launch_counts,
)

TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture
def interpret_pallas():
    orig = fb.pl.pallas_call
    fb.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        yield
    finally:
        fb.pl.pallas_call = orig


def _inputs(seed, b, n, h, d=64, n_valid=None):
    """q, k, v, dO (B, N, H, D) fp32. With n_valid, the token axis is padded
    to n as the model pads it: zero k/v rows, garbage q rows (0.7), zero dO
    rows (the row mask's backward zeroes their cotangents)."""
    rng = np.random.default_rng(seed)
    real = n if n_valid is None else n_valid
    q, k, v, g = (rng.standard_normal((b, real, h, d)).astype(np.float32)
                  for _ in range(4))
    if n_valid is not None:
        pad = ((0, 0), (0, n - n_valid), (0, 0), (0, 0))
        q = np.pad(q, pad, constant_values=0.7)
        k, v, g = (np.pad(x, pad) for x in (k, v, g))
    return q, k, v, g


def _jax_fwd_bwd(q, k, v, g, single_pass_max=2816, n_valid=None):
    with jax.default_matmul_precision("highest"):
        out, res = fb._fwd_with_lse(*map(jnp.asarray, (q, k, v)), 128, 128,
                                    single_pass_max=single_pass_max,
                                    n_valid=n_valid)
        dq, dk, dv = fb._bwd(res, jnp.asarray(g))
    b, n, h, _ = q.shape
    lse = np.asarray(res[4])  # (B*H, n_pad // bq, 8, bq)
    lse = lse[:, :, 0, :].reshape(b * h, -1)[:, :n].reshape(b, h, n)
    return [np.asarray(x) for x in (out, lse, dq, dk, dv)]


def _port_fwd_bwd(q, k, v, g, n_valid=None):
    qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
    out, lse = flash_attention_fwd_lse_plain(qt, kt, vt, n_valid)
    grads = flash_attention_bwd_plain(qt, kt, vt, out, lse, gt, n_valid)
    return [x.numpy() for x in (out, lse, *grads)]


@pytest.mark.parametrize("n,single_pass_max", [
    (256, 2816),  # one k block: _fwd_with_lse_kernel_1pass_T
    (256, 128),   # several k blocks: _fwd_with_lse_kernel_T
    (300, 2816),  # ragged, one block
    (300, 128),   # ragged, several blocks
])
def test_plain_matches_jax_pallas(interpret_pallas, n, single_pass_max):
    q, k, v, g = _inputs(n + single_pass_max, 1, n, 2)
    ref = _jax_fwd_bwd(q, k, v, g, single_pass_max)
    out = _port_fwd_bwd(q, k, v, g)
    for name, a, r in zip(("out", "lse", "dq", "dk", "dv"), out, ref):
        np.testing.assert_allclose(a, r, err_msg=name, **TOL)


@pytest.mark.parametrize("single_pass_max", [2816, 128])
def test_plain_matches_jax_pallas_n_valid(interpret_pallas, single_pass_max):
    """Aligned-token mode: 300 real tokens padded to 384. Real rows agree;
    the port's dK/dV rows of masked keys are exact zeros (JAX leaves them to
    the caller's mask)."""
    q, k, v, g = _inputs(7, 2, 384, 2, n_valid=300)
    ref = _jax_fwd_bwd(q, k, v, g, single_pass_max, n_valid=300)
    out = _port_fwd_bwd(q, k, v, g, n_valid=300)
    for name, a, r in zip(("out", "lse", "dq", "dk", "dv"), out, ref):
        real = (slice(None), slice(None), slice(0, 300)) if name == "lse" \
            else (slice(None), slice(0, 300))
        np.testing.assert_allclose(a[real], r[real], err_msg=name, **TOL)
    for grad in out[3:]:
        assert not grad[:, 300:].any()


@pytest.mark.parametrize("n_valid", [None, 70])
def test_function_backward_matches_autograd_of_math(n_valid):
    """The Function (plain twins on the CPU) against torch autograd of the
    materialised attention, fp32: tolerance 1e-5 (summation order only)."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(3, 2, 96, 2, 64))
    if n_valid is not None:
        g[:, n_valid:] = 0
    grads = []
    for fn in (flash_attention, sdpa_math):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, n_valid=n_valid)
        (out * g).sum().backward()
        grads.append([x.grad for x in leaves])
    real = slice(None) if n_valid is None else slice(0, n_valid)
    for name, a, r in zip("qkv", *grads):
        torch.testing.assert_close(a[:, real], r[:, real], atol=1e-5,
                                   rtol=1e-5, msg=f"d{name}")


def test_row_without_keys_has_zero_gradients():
    """n_valid = 0: no row sees a key; out 0, lse +inf, every gradient 0."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(4, 1, 64, 2))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    reset_launch_counts()
    out = flash_attention(*leaves, n_valid=0)
    (out * g).sum().backward()
    assert flash_attention.plain_launches == 2  # forward with lse, backward
    assert not out.detach().any()
    for x in leaves:
        assert torch.equal(x.grad, torch.zeros_like(x))
    _, lse = flash_attention_fwd_lse_plain(q, k, v, 0)
    assert torch.isinf(lse).all() and (lse > 0).all()
