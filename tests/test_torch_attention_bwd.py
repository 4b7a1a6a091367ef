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
    flash_attention_dkv_plain,
    flash_attention_dq_plain,
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
    # the Hopper backward's tile edges (64-row q and key tiles and
    # blocks): Nq = kv_eff one under, at and over each
    (1, 2816),
    (63, 2816),
    (65, 2816),
    (127, 2816),
    (129, 2816),
    (193, 2816),
    (193, 128),
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


@pytest.mark.parametrize("n_valid", [0, 1, 63, 65, 127, 129, 193])
def test_plain_matches_jax_pallas_n_valid_edges(interpret_pallas, n_valid):
    """Aligned-token mode at the Hopper backward's tile edges: n_valid real
    keys of 256 tokens (0: every key masked, every gradient 0). Real rows
    agree with JAX; the port's dK/dV rows of masked keys are exact zeros,
    and so is dQ where no key is real."""
    q, k, v, g = _inputs(11 + n_valid, 1, 256, 2, n_valid=n_valid)
    ref = _jax_fwd_bwd(q, k, v, g, n_valid=n_valid)
    out = _port_fwd_bwd(q, k, v, g, n_valid=n_valid)
    for name, a, r in zip(("out", "lse", "dq", "dk", "dv"), out, ref):
        real = (slice(None), slice(None), slice(0, n_valid)) \
            if name == "lse" else (slice(None), slice(0, n_valid))
        np.testing.assert_allclose(a[real], r[real], err_msg=name, **TOL)
    for grad in out[3:]:
        assert not grad[:, n_valid:].any()
    if n_valid == 0:
        assert not out[2].any() and np.isposinf(out[1]).all()


def _bf16_inputs(seed, b, n, h, n_valid=None):
    """_inputs rounded to bf16 values, kept in fp32 numpy arrays."""
    return [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
            for x in _inputs(seed, b, n, h, n_valid=n_valid)]


def _jax_f32_grads(q, k, v, g, n_valid):
    """JAX's forward with lse, then its `_run_dkv` / `_run_dq` with fp32
    outputs (the ring's per-pair partials), as `_bwd` calls them. Returns
    (dq, dk, dv, lse (B, H, N), delta (B, H, N))."""
    with jax.default_matmul_precision("highest"):
        out, res = fb._fwd_with_lse(*map(jnp.asarray, (q, k, v)), 128, 128,
                                    n_valid=n_valid)
        qb, kb, vb, ob, lse_t, meta = res
        b, n, h, d, kv_len, n_pad, _, block_q, block_k = meta
        gb = fb._prep(jnp.asarray(g), n_pad, b, h, d)
        delta = jnp.sum(gb * ob, axis=-1)
        delta_t = jnp.broadcast_to(
            delta.reshape(b * h, n_pad // block_q, 1, block_q),
            (b * h, n_pad // block_q, 8, block_q))
        kw = dict(scale=d**-0.5, n=n, kv_len=kv_len, d=d, block_q=block_q,
                  block_k=block_k, out_dtype=jnp.float32)
        dk, dv = fb._run_dkv(qb, kb, vb, gb, lse_t, delta_t, **kw)
        dq = fb._run_dq(qb, kb, vb, gb, lse_t, delta_t, **kw)

    def unprep(x, length):
        return np.swapaxes(np.asarray(x)[:, :length].reshape(b, h, length, d),
                           1, 2)

    lse = np.asarray(lse_t)[:, :, 0, :].reshape(b * h, -1)[:, :n]
    return (unprep(dq, n), unprep(dk, kv_len), unprep(dv, kv_len),
            lse.reshape(b, h, n), np.asarray(delta)[:, :n].reshape(b, h, n))


@pytest.mark.parametrize("n,n_valid", [(65, None), (193, None), (256, 129),
                                       (128, 0)])
def test_plain_matches_jax_pallas_f32_partials(interpret_pallas, n, n_valid):
    """out_dtype=float32, the ring's per-pair partials: bf16 q, k, v, dO
    into the port's dK/dV and dQ plain twins, fp32 gradients out, against
    JAX's `_run_dkv` / `_run_dq` with fp32 outputs on the same (bf16-exact)
    values, both fed JAX's lse and delta. Masked keys' rows are zeros."""
    q, k, v, g = _bf16_inputs(20 + n, 1, n, 2, n_valid=n_valid)
    ref_dq, ref_dk, ref_dv, lse, delta = _jax_f32_grads(q, k, v, g, n_valid)
    args = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, g)]
    args += [torch.from_numpy(np.array(x)) for x in (lse, delta)]
    dk, dv = flash_attention_dkv_plain(*args, n_valid,
                                       out_dtype=torch.float32)
    dq = flash_attention_dq_plain(*args, n_valid, out_dtype=torch.float32)
    real = n if n_valid is None else n_valid
    for name, a, r in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                       ("dv", dv, ref_dv)):
        assert a.dtype == torch.float32, name
        rows = slice(None) if name == "dq" else slice(0, real)
        np.testing.assert_allclose(a.numpy()[:, rows], r[:, rows],
                                   err_msg=name, **TOL)
    for grad in (dk, dv):
        assert not grad[:, real:].any()


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
