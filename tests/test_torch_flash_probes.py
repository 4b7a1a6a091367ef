"""The Hopper tuning probes' plain versions against the JAX package's TPU
probes (scripts/perf/, ROADMAP queue B, B9).

mapanything_tpu_torch/perf/flash_probes.py runs the plain version of every
probe on CPU tensors (its CUDA kernels are held against the same plain
versions on the card, by chip_smoke.py and tests/test_torch_kernels.py).
Here those plain versions meet the TPU probes on the same seeded numpy
inputs at fp32, at (1, 256, 2, 64) with 128-row blocks, so that no probe
pads its keys (the TPU probes count zero pad keys in their row sums):

  * flash_bottleneck_probe.py::variant (modes prod, nomax, noexp),
    flash_sumfuse_experiment.py::flash_sumfuse and
    qkv_layout_experiment.py::flash_bh run with `pl.pallas_call` in
    interpret mode (the swap of tests/test_torch_attention_bwd.py);
  * flash_longseq_tuning.py::_kernel_bf16p,
    flash_multihead_experiment.py::_kernel_g and
    attn_alignment_experiment.py::_kernel_nhd are written out in numpy from
    their kernels' bodies instead: importing those scripts has side effects
    (the first two set JAX's persistent compilation cache, the last two run
    their experiments at import).

Tolerance: atol 2e-5, rtol 1e-4 (fp32 on both sides, sums in another
order); for the noexp mode, 1e-4 of the output's max-abs (its TPU output,
divided by a row sum near zero and multiplied back, keeps fewer digits);
and where a TPU kernel rounds its scores to bf16 (_kernel_nhd):
there 2e-2 absolute, the effect of a 2^-9 relative score error on the
output.
"""

import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu_torch.ops.flash_attention import flash_attention_plain
from mapanything_tpu_torch.perf import flash_probes as fp

TOL = dict(atol=2e-5, rtol=1e-4)
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts" / "perf"
SHAPE = (1, 256, 2, 64)
_LOG2E = 1.4426950408889634


def _load(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret_pallas():
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        yield
    finally:
        pl.pallas_call = orig


def _inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


def _scores(q, k):
    """s' = q.k * d^-1/2 * log2(e), (B, H, Nq, Nk), numpy fp32."""
    return np.einsum("bqhd,bkhd->bhqk", q, k) * (q.shape[-1] ** -0.5 * _LOG2E)


@pytest.mark.parametrize("mode,probe", [("prod", "main"), ("nomax", "nomax"),
                                        ("noexp", "noexp")])
def test_bottleneck_probe_modes_match_jax(interpret_pallas, mode, probe):
    """flash_bottleneck_probe.py::_kernel in each mode against the probe's
    plain version. The TPU noexp output divides by rowsum(s'), the plain
    one does not (that sum crosses zero): it is compared times the sum."""
    mod = _load("flash_bottleneck_probe")
    q, k, v = _inputs(1)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(mod.variant(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), block_q=128,
                                      block_k=128, mode=mode))
    got = fp.flash_probe(probe, *_torch(q, k, v)).numpy()
    tol = TOL
    if mode == "noexp":  # the division by a sum near zero and back costs
        want = want * _scores(q, k).sum(-1).transpose(0, 2, 1)[..., None]
        tol = dict(atol=1e-4 * np.abs(want).max(), rtol=0)  # digits: 1e-4
    np.testing.assert_allclose(got, want, **tol)


def test_sumfuse_probe_matches_jax(interpret_pallas):
    """flash_sumfuse_experiment.py::flash_sumfuse (the row sum from a ones
    column of V) against the "sumfuse" probe's plain version."""
    mod = _load("flash_sumfuse_experiment")
    q, k, v = _inputs(2)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(mod.flash_sumfuse(*map(jnp.asarray, (q, k, v)),
                                            block_q=128))
    got = fp.flash_probe("sumfuse", *_torch(q, k, v)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_layout_probe_matches_jax(interpret_pallas):
    """qkv_layout_experiment.py::flash_bh on pre-laid-out (B*H, N, D)
    inputs (a ones column on V) against the probe on a (B, H, N, D) copy.
    The script predates the kernel's present signature: it passes kv_len,
    which _flash_kernel_1pass no longer takes (pad keys now carry zero V
    rows, ones column included). The test drops that argument, at a key
    count that needs no padding."""
    mod = _load("qkv_layout_experiment")
    kernel = mod._flash_kernel_1pass
    mod._flash_kernel_1pass = (
        lambda *refs, scale, kv_len, d: kernel(*refs, scale=scale, d=d))
    q, k, v = _inputs(3)
    b, n, h, d = SHAPE

    def to_bh(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, n, d)

    vb = np.concatenate([to_bh(v), np.ones((b * h, n, 1), np.float32)], -1)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(mod.flash_bh(jnp.asarray(to_bh(q)),
                                       jnp.asarray(to_bh(k)),
                                       jnp.asarray(vb), block_q=128))
    want = want.reshape(b, h, n, d).transpose(0, 2, 1, 3)
    got = fp.flash_probe("main", *_torch(q, k, v), layout="bhnd").numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _kernel_bf16p(q, k, v):
    """flash_longseq_tuning.py::_kernel_bf16p at fp32 (its S dtype is then
    fp32): the online softmax over key blocks, written as one pass (the
    same sums), with its ones-column row sum."""
    s = _scores(q, k)
    m = s.max(-1, keepdims=True)
    p = np.exp2(s - m)
    acc = np.einsum("bhqk,bkhd->bqhd", p, v)
    return acc / p.sum(-1).transpose(0, 2, 1)[..., None]


def _kernel_g(q, k, v, kv_len):
    """flash_multihead_experiment.py::_kernel_g for one head group: keys
    padded to a multiple of 128, pads masked to -inf before the max."""
    s = _scores(q, k)
    s[..., kv_len:] = -np.inf
    p = np.exp2(s - s.max(-1, keepdims=True))
    acc = np.einsum("bhqk,bkhd->bqhd", p, v)
    l = p.sum(-1).transpose(0, 2, 1)[..., None]
    return acc / np.where(l == 0, 1.0, l)


def _kernel_nhd(q, k, v):
    """attn_alignment_experiment.py::_kernel_nhd: scores rounded to bf16,
    p = exp2(s - max) in bf16, the row sum in fp32."""
    s = torch.from_numpy(_scores(q, k)).to(torch.bfloat16)
    p = torch.exp2(s - s.amax(-1, keepdim=True)).float().numpy()
    acc = np.einsum("bhqk,bkhd->bqhd", p, v)
    return acc / p.sum(-1).transpose(0, 2, 1)[..., None]


@pytest.mark.parametrize("kernel", ["bf16p", "kernel_g", "kernel_nhd"])
def test_plain_matches_tpu_kernel_formulas(kernel):
    """The forward's plain version against the three TPU probe kernels that
    cannot be imported, written from their bodies (module docstring)."""
    q, k, v = _inputs(4)
    if kernel == "kernel_g":  # 200 real keys, zero pads up to 256
        k[:, 200:] = 0
        v[:, 200:] = 0
        want = _kernel_g(q, k, v, 200)
        got = flash_attention_plain(*_torch(q, k, v), n_valid=200).numpy()
    else:
        want = (_kernel_bf16p if kernel == "bf16p" else _kernel_nhd)(q, k, v)
        got = flash_attention_plain(*_torch(q, k, v)).numpy()
    tol = dict(atol=2e-2, rtol=0) if kernel == "kernel_nhd" else TOL
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("name", list(fp.VARIANTS))
def test_cpu_probe_runs_its_plain_version(name):
    """On CPU tensors every probe wrapper runs its plain version and
    launches nothing."""
    q, k, v = _torch(*_inputs(5, (1, 96, 2, 64)))
    fp.reset_probe_counts()
    got = fp.flash_probe(name, q, k, v, n_valid=80)
    assert fp.probe_counts["plain"] == 1
    assert sum(fp.probe_counts.values()) == 1
    torch.testing.assert_close(got, fp.VARIANTS[name][1](q, k, v, 80),
                               rtol=0, atol=0)


def test_cpu_baseline_wrappers_run_plain():
    """The mma.sync baseline's wrappers run their plain versions on the
    CPU: the forward, with lse, and the ring's stats."""
    from mapanything_tpu_torch.ops.flash_attention import (
        flash_attention_fwd_lse_plain,
    )
    from mapanything_tpu_torch.ops.ring_attention import (
        flash_attention_stats_plain,
    )

    q, k, v = _torch(*_inputs(6, (1, 96, 2, 64)))
    fp.reset_probe_counts()
    torch.testing.assert_close(fp.flash_attention_mma(q, k, v, 70),
                               flash_attention_plain(q, k, v, 70))
    for got, ref in zip(fp.flash_attention_fwd_lse_mma(q, k, v, 70),
                        flash_attention_fwd_lse_plain(q, k, v, 70)):
        torch.testing.assert_close(got, ref)
    for got, ref in zip(fp.flash_attention_stats_mma(q, k, v),
                        flash_attention_stats_plain(q, k, v)):
        torch.testing.assert_close(got, ref)
    assert fp.probe_counts["plain"] == 3
    assert not any(fp.probe_counts[key] for key in fp.BASELINE)


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_cpu_backward_baseline_wrappers_run_plain(out_dtype):
    """The mma.sync backward's wrappers (dK/dV, dQ; bf16 or fp32 outputs)
    run their plain versions on the CPU and launch nothing."""
    from mapanything_tpu_torch.ops.flash_attention import (
        attention_delta,
        flash_attention_dkv_plain,
        flash_attention_dq_plain,
        flash_attention_fwd_lse_plain,
    )

    q, k, v = _torch(*_inputs(8, (1, 96, 2, 64)))
    dout = _torch(*_inputs(9, (1, 96, 2, 64)))[0]
    out, lse = flash_attention_fwd_lse_plain(q, k, v, 70)
    args = (q, k, v, dout, lse, attention_delta(dout, out), 70)
    fp.reset_probe_counts()
    for got, ref in zip(fp.flash_attention_dkv_mma(*args, out_dtype=out_dtype),
                        flash_attention_dkv_plain(*args, out_dtype=out_dtype)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(
        fp.flash_attention_dq_mma(*args, out_dtype=out_dtype),
        flash_attention_dq_plain(*args, out_dtype=out_dtype), rtol=0, atol=0)
    assert fp.probe_counts["plain"] == 2
    assert not any(fp.probe_counts[key] for key in fp.BASELINE)


def test_cpu_pt_do_baseline_runs_plain():
    """P^T dO's mma.sync baseline runs the plain P^T dO on the CPU and
    launches nothing."""
    from mapanything_tpu_torch.ops.flash_attention import (
        flash_attention_fwd_lse_plain,
    )
    from mapanything_tpu_torch.ops.ring_attention import (
        flash_attention_pt_do_plain,
    )

    q, k, _ = _torch(*_inputs(10, (1, 96, 2, 64)))
    dout = _torch(*_inputs(11, (1, 96, 2, 64)))[0]
    lse = flash_attention_fwd_lse_plain(q, k[:, :70], k[:, :70])[1]
    fp.reset_probe_counts()
    got = fp.flash_attention_pt_do_mma(q, k[:, :70], dout, lse)
    torch.testing.assert_close(
        got, flash_attention_pt_do_plain(q, k[:, :70], dout, lse),
        rtol=0, atol=0)
    assert fp.probe_counts["plain"] == 1
    assert sum(fp.probe_counts.values()) == 1


def test_probe_plain_formulas():
    """nomax equals the softmax for small scores; noexp is s' V; and the
    (B, H, N, D) layout copy changes nothing on the CPU."""
    q, k, v = _torch(*_inputs(7, (1, 64, 2, 64)))
    torch.testing.assert_close(fp.flash_nomax_plain(q, k, v),
                               flash_attention_plain(q, k, v), **TOL)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (64**-0.5 * _LOG2E)
    torch.testing.assert_close(fp.flash_noexp_plain(q, k, v),
                               torch.einsum("bhqk,bkhd->bqhd", s, v), **TOL)
    torch.testing.assert_close(fp.flash_probe("main", q, k, v, layout="bhnd"),
                               flash_attention_plain(q, k, v), rtol=0, atol=0)
    with pytest.raises(ValueError, match="layout"):
        fp.flash_probe("main", q, k, v, layout="nhd")


def test_perf_imports_without_jax():
    """The probes and the timing helpers import torch alone."""
    code = ("import sys\n"
            "import mapanything_tpu_torch.perf.flash_probes\n"
            "import mapanything_tpu_torch.perf.timing\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'mapanything_tpu')]\n"
            "assert not bad, bad\n")
    root = Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True)
