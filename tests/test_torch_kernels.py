"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs on the GPU machine:
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``. The
`cuda`-marked tests skip where no GPU is present. Tolerance 1e-2 (abs and
rel for the forward; max-abs over the reference's max-abs and rel-L2 for
the training kernels): the kernels keep fp32 scores, round P and dS to bf16
for the tensor-core products and their outputs once to bf16.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from mapanything_tpu_torch.ops import flash_attention as fa_module
from mapanything_tpu_torch.ops.flash_attention import (
    KERNELS,
    attention_delta,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_dkv,
    flash_attention_dkv_plain,
    flash_attention_dq,
    flash_attention_dq_plain,
    flash_attention_fwd_lse,
    flash_attention_fwd_lse_plain,
    flash_attention_plain,
    reset_launch_counts,
)
from mapanything_tpu_torch.ops.ring_attention import (
    flash_attention_pt_do,
    flash_attention_pt_do_plain,
    flash_attention_stats,
    flash_attention_stats_plain,
    merge_stats,
)


def _counts(**launched):
    """flash_attention.kernel_counts with `launched` and zeros elsewhere."""
    return dict.fromkeys(KERNELS, 0) | launched


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

    @pytest.mark.parametrize("entry,key", [
        ("flash_attn_bwd_dkv", "dkv"), ("flash_attn_bwd_dkv_f32", "dkv_f32"),
        ("flash_attn_bwd_dq", "dq"), ("flash_attn_bwd_dq_f32", "dq_f32")])
    def test_fp32_entries_count_apart(self, monkeypatch, entry, key):
        """A launch of an fp32-output entry counts under its own key, so a
        run's bf16 and fp32 launches of one kernel are read apart."""
        monkeypatch.setattr(fa_module, "_kernel_fn",
                            lambda library, name: lambda *args: 0)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda device: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device: types.SimpleNamespace(
                                cuda_stream=0))
        reset_launch_counts()
        fa_module._launch(key.removesuffix("_f32"), "flash_attn_bwd", entry,
                          None)
        assert flash_attention.kernel_counts == _counts(**{key: 1})
        assert flash_attention.kernel_launches == 1
        reset_launch_counts()

    def test_fully_masked_rows_are_zero(self):
        qkv = _qkv(6, 1, 64, 2, 64)
        out = flash_attention_plain(*qkv, n_valid=0)
        assert torch.equal(out, torch.zeros_like(out))

    def test_tma_entry_errors_are_named(self):
        """The codes the TMA entries (forward and backward) return beyond
        cudaError_t raise with their meaning; nothing falls back."""
        from mapanything_tpu_torch.ops.flash_attention import _check_err

        _check_err("flash_attn_bwd_dkv", 0)
        for code, text in ((10001, "cuTensorMapEncodeTiled"),
                           (10002, "refused a TMA tensor map"),
                           (1, "cudaError 1")):
            with pytest.raises(RuntimeError, match=text):
                _check_err("flash_attn_bwd_dkv", code)

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
    assert flash_attention.kernel_counts == _counts(fwd_lse=1, dkv=1, dq=1)
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


# the ring's shards at 518^2 with p = 1: 4 and 8 views of 1369 patches (no
# padding, a ragged last tile), and a small ragged shard with two batches
_RING_CASES = [(1, 5476, 16, 64), (1, 10952, 16, 64), (2, 300, 2, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _RING_CASES)
def test_cuda_ring_kernels_match_plain(cuda_device, shape):
    """The ring's kernels on the fused-qkv layout against their plain
    twins: the stats forward (and with V := K), P^T dO, and the fp32 forms
    of dK/dV and dQ fed the global lse; a 4-way split of the keys merges
    to the forward kernel's output."""
    q, k, v = _cuda_qkv(shape, None, "fused_qkv", cuda_device)
    reset_launch_counts()
    stats = flash_attention_stats(q, k, v)
    stats_kk = flash_attention_stats(q, k, k)
    torch.cuda.synchronize()
    for got, ref in ((stats, flash_attention_stats_plain(q, k, v)),
                     (stats_kk, flash_attention_stats_plain(q, k, k))):
        for name, a, r in zip(("acc", "m", "l"), got, ref):
            assert max(_err(a, r)) <= 1e-2, name
    acc, m, l = flash_attention_stats_plain(q, k, v)
    lse = (m + torch.log2(l)).transpose(1, 2).contiguous()
    dout = torch.randn(shape, device=cuda_device).to(torch.bfloat16)
    delta = attention_delta(dout, (acc / l[..., None]).to(torch.bfloat16))
    args = (q, k, v, dout, lse, delta)
    for got, ref in (
            (flash_attention_pt_do(q, k, dout, lse),
             flash_attention_pt_do_plain(q, k, dout, lse)),
            (flash_attention_dkv(*args, out_dtype=torch.float32),
             flash_attention_dkv_plain(*args, out_dtype=torch.float32)),
            (flash_attention_dq(*args, out_dtype=torch.float32),
             flash_attention_dq_plain(*args, out_dtype=torch.float32))):
        for a, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert a.dtype == torch.float32
            assert max(_err(a, r)) <= 1e-2
    torch.cuda.synchronize()
    assert flash_attention.kernel_counts == _counts(
        dkv_f32=1, dq_f32=1, fwd_stats=2, pt_do=1)
    assert flash_attention.plain_launches == 0

    n = shape[1]
    cuts = [0, n // 4, n // 2, 3 * n // 4, n]
    merged = flash_attention_stats(q, k[:, :cuts[1]], v[:, :cuts[1]])
    for a, b in zip(cuts[1:-1], cuts[2:]):
        merged = merge_stats(*merged,
                             *flash_attention_stats(q, k[:, a:b], v[:, a:b]))
    out = merged[0] / merged[2][..., None]
    assert max(_err(out, flash_attention(q, k, v))) <= 1e-2


@pytest.mark.cuda
def test_cuda_stats_without_keys(cuda_device):
    """A shard with no key: m = -inf, l = 0, acc = 0 (the merge's guard)."""
    q, k, v = _cuda_qkv((1, 100, 2, 64), None, "fused_qkv", cuda_device)
    acc, m, l = flash_attention_stats(q, k[:, :0], v[:, :0])
    torch.cuda.synchronize()
    assert torch.isneginf(m).all() and not l.any() and not acc.any()


# --- the TMA/wgmma kernels (csrc/flash_fwd_sm90.cuh, flash_bwd_sm90.cuh) ----

# q rows and keys that are not multiples of their 64- to 192-row tiles: a
# single key, no key, a ragged last key tile at 129 and 10952 keys, three
# batches
_TILING_CASES = [
    ((1, 200, 2, 64), 77),
    ((1, 300, 2, 64), 1),
    ((1, 300, 2, 64), 0),
    ((1, 129, 2, 64), None),
    ((1, 10952, 16, 64), None),
    ((3, 250, 4, 64), 129),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_valid", _TILING_CASES)
def test_cuda_forward_tiling_matches_plain(cuda_device, shape, n_valid):
    """The three entries (forward, with lse, stats with V and with V := K)
    against their plain versions where the tiles are ragged."""
    q, k, v = _cuda_qkv(shape, n_valid, "fused_qkv", cuda_device)
    real = shape[1] if n_valid is None else n_valid
    rows = max(real, 1)
    reset_launch_counts()
    out = flash_attention(q, k, v, n_valid=n_valid)
    out_l, lse = flash_attention_fwd_lse(q, k, v, n_valid)
    ref, ref_lse = flash_attention_fwd_lse_plain(q, k, v, n_valid)
    kk, vv = k[:, :real], v[:, :real]
    stats = [flash_attention_stats(q, kk, vv),
             flash_attention_stats(q, kk, kk)]
    refs = [flash_attention_stats_plain(q, kk, vv),
            flash_attention_stats_plain(q, kk, kk)]
    torch.cuda.synchronize()
    assert flash_attention.kernel_counts == _counts(fwd=1, fwd_lse=1,
                                                    fwd_stats=2)
    if real == 0:
        assert not out.any() and not out_l.any() and torch.isinf(lse).all()
        for acc, m, l in stats:
            assert torch.isneginf(m).all() and not l.any() and not acc.any()
        return
    for got in (out, out_l):
        assert max(_err(got[:, :rows], ref[:, :rows])) <= 1e-2
    assert max(_err(lse[..., :rows], ref_lse[..., :rows])) <= 1e-2
    for got, want in zip(stats, refs):
        for name, a, r in zip(("acc", "m", "l"), got, want):
            assert max(_err(a, r)) <= 1e-2, name


def _nan_filled_pool(shape, dtype, device, count=2):
    """Leave `count` freed NaN-filled blocks in the caching allocator, so
    that outputs allocated next start as NaN where a kernel skips a row."""
    blocks = [torch.full(shape, float("nan"), dtype=dtype, device=device)
              for _ in range(count)]
    del blocks


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,n_valid", _TILING_CASES + [
    ((4, 1369, 16, 64), None)])
def test_cuda_backward_tiling_matches_plain(cuda_device, shape, n_valid,
                                            out_dtype):
    """The TMA/wgmma dK/dV and dQ (csrc/flash_bwd_sm90.cuh), bf16 and fp32
    outputs, against their plain versions where the tiles are ragged, and
    at the frame layers' 1369 tokens, where the lse rows are not 16-byte
    aligned. Key rows in [kv_eff, nk) are written as zeros."""
    q, k, v = _cuda_qkv(shape, n_valid, "fused_qkv", cuda_device)
    real = shape[1] if n_valid is None else n_valid
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    dout = torch.randn(shape, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    dout[:, real:] = 0
    ref_out, lse = flash_attention_fwd_lse_plain(q, k, v, n_valid)
    args = (q, k, v, dout, lse, attention_delta(dout, ref_out), n_valid)
    reset_launch_counts()
    _nan_filled_pool(k.shape, out_dtype, cuda_device)
    dk, dv = flash_attention_dkv(*args, out_dtype=out_dtype)
    _nan_filled_pool(q.shape, out_dtype, cuda_device, count=1)
    dq = flash_attention_dq(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    suffix = "_f32" if out_dtype == torch.float32 else ""
    assert flash_attention.kernel_counts == _counts(
        **{"dkv" + suffix: 1, "dq" + suffix: 1})
    refs = (*flash_attention_dkv_plain(*args, out_dtype=out_dtype),
            flash_attention_dq_plain(*args, out_dtype=out_dtype))
    for name, got, ref in zip(("dk", "dv", "dq"), (dk, dv, dq), refs):
        assert got.dtype == out_dtype and got.shape == ref.shape, name
        assert torch.isfinite(got).all(), name
        if real == 0:
            assert not got.any(), name
            continue
        if name != "dq":
            assert not got[:, real:].any(), f"{name} rows past kv_eff"
        got, ref = got[:, :real], ref[:, :real]
        # one key: softmax is constant, dS and so dK and dQ are exactly 0
        # in the plain version and rounding residue (~1e-8) in the kernel;
        # dV = P^T dO is not small there and stays held relatively
        assert (max(_err(got, ref)) <= 1e-2
                or real == 1 and name in ("dk", "dq")
                and got.abs().max() <= 1e-5), name


# P^T dO where the tiles are ragged: nq != nk, neither a multiple of the
# 64-row tiles or of the 128- and 192-key blocks, several heads and
# batches; and the ring's 4-view shard
_PT_DO_CASES = [
    ((2, 300, 2, 64), 173),
    ((1, 77, 4, 64), 200),
    ((3, 129, 2, 64), 1),
    ((1, 5476, 16, 64), 5476),
]


def _pt_do_inputs(shape, nk, device):
    """q, dO (B, Nq, H, 64) and k (B, nk, H, 64) bf16 on the fused-qkv
    layout, the lse of q against those keys (B, H, Nq), and every seventh
    q row with lse = +inf (a row that saw no key: it adds nothing)."""
    b, nq, h, d = shape
    q = _cuda_qkv(shape, None, "fused_qkv", device)[0]
    k = _cuda_qkv((b, nk, h, d), None, "fused_qkv", device)[1]
    gen = torch.Generator(device=device).manual_seed(3)
    dout = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    lse = flash_attention_fwd_lse_plain(q, k, k)[1]
    lse[..., ::7] = torch.inf
    return q, k, dout, lse.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,nk", _PT_DO_CASES)
def test_cuda_pt_do_matches_plain(cuda_device, shape, nk):
    """The TMA/wgmma P^T dO (csrc/flash_pt_do_sm90.cuh) against its plain
    twin, its output allocated over NaN-filled memory (every row below nk
    is written, the rows of lse = +inf add nothing)."""
    q, k, dout, lse = _pt_do_inputs(shape, nk, cuda_device)
    reset_launch_counts()
    _nan_filled_pool((shape[0], nk, shape[2], 64), torch.float32,
                     cuda_device)
    out = flash_attention_pt_do(q, k, dout, lse)
    torch.cuda.synchronize()
    assert flash_attention.kernel_counts == _counts(pt_do=1)
    ref = flash_attention_pt_do_plain(q, k, dout, lse)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert max(_err(out, ref)) <= 1e-2


@pytest.mark.cuda
def test_cuda_pt_do_without_q_rows_writes_zeros(cuda_device):
    q, k, dout, lse = _pt_do_inputs((1, 100, 2, 64), 150, cuda_device)
    _nan_filled_pool((1, 150, 2, 64), torch.float32, cuda_device)
    out = flash_attention_pt_do(q[:, :0], k, dout[:, :0],
                                lse[..., :0].contiguous())
    torch.cuda.synchronize()
    assert out.shape == (1, 150, 2, 64) and not out.any()


def _probe_inputs(layout, device):
    """B * H = 64 heads of 700 rows (650 real), on one of three layouts."""
    q, k, v = _cuda_qkv((4, 700, 16, 64), 650, "fused_qkv", device)
    if layout != "fused_qkv":
        q, k, v = (x.contiguous() for x in (q, k, v))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", [
    ("fused_qkv", 1, 0), ("fused_qkv", 2, 0), ("fused_qkv", 4, 0),
    ("fused_qkv", 1, 132), ("fused_qkv", 1, 7), ("bnhd", 1, 0),
    ("bhnd", 1, 0)])
def test_cuda_probe_schedules_and_layouts(cuda_device, schedule):
    """The main configuration with G heads per block, a persistent grid
    (also one far smaller than the work), and the three input layouts."""
    from mapanything_tpu_torch.perf import flash_probes as fp

    layout, heads, blocks = schedule
    q, k, v = _probe_inputs(layout, cuda_device)
    fp.reset_probe_counts()
    out = fp.flash_probe("main", q, k, v, 650, heads_per_block=heads,
                         persistent_blocks=blocks,
                         layout="bhnd" if layout == "bhnd" else "as_given")
    torch.cuda.synchronize()
    assert fp.probe_counts["main"] == 1 and fp.probe_counts["plain"] == 0
    ref = flash_attention_plain(q, k, v, 650)
    assert max(_err(out[:, :650], ref[:, :650])) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["main", "simple", "nomax", "noexp",
                                  "bf16exp", "sumfuse", "pingpong",
                                  "t64x128", "t64x176", "t128x64",
                                  "t128x176", "t128x128s3", "t128x176s3",
                                  "t192x64", "t128x128", "t192x128"])
def test_cuda_probe_variants_match_their_plain(cuda_device, name):
    from mapanything_tpu_torch.perf import flash_probes as fp

    q, k, v = _cuda_qkv((2, 1408, 16, 64), 1370, "fused_qkv", cuda_device)
    out = fp.flash_probe(name, q, k, v, 1370)
    ref = fp.VARIANTS[name][1](q, k, v, 1370)
    torch.cuda.synchronize()
    assert max(_err(out[:, :1370], ref[:, :1370])) <= 1e-2


@pytest.mark.cuda
def test_cuda_baseline_matches_plain_and_stays_off_the_main_path(cuda_device):
    """The mma.sync baselines' entries (the forward's three, the backward's
    dK/dV and dQ in bf16 and fp32, P^T dO) against their plain versions;
    the main path's wrappers never launch them."""
    from mapanything_tpu_torch.perf import flash_probes as fp

    q, k, v = _cuda_qkv((1, 2816, 16, 64), 2739, "fused_qkv", cuda_device)
    dout = torch.randn(q.shape, device=cuda_device).to(torch.bfloat16)
    dout[:, 2739:] = 0
    ref, ref_lse = flash_attention_fwd_lse_plain(q, k, v, 2739)
    bwd = (q, k, v, dout, ref_lse, attention_delta(dout, ref), 2739)
    fp.reset_probe_counts()
    flash_attention(q, k, v, n_valid=2739)
    flash_attention_fwd_lse(q, k, v, 2739)
    flash_attention_stats(q, k, v)
    for out_dtype in (None, torch.float32):
        flash_attention_dkv(*bwd, out_dtype=out_dtype)
        flash_attention_dq(*bwd, out_dtype=out_dtype)
    pt_do_args = (q, k[:, :2739], dout, ref_lse)
    flash_attention_pt_do(*pt_do_args)
    torch.cuda.synchronize()
    assert not any(fp.probe_counts.values())
    out = fp.flash_attention_mma(q, k, v, 2739)
    out_l, lse = fp.flash_attention_fwd_lse_mma(q, k, v, 2739)
    stats = fp.flash_attention_stats_mma(q, k, v)
    grads = {out_dtype: (*fp.flash_attention_dkv_mma(*bwd, out_dtype=out_dtype),
                         fp.flash_attention_dq_mma(*bwd, out_dtype=out_dtype))
             for out_dtype in (torch.bfloat16, torch.float32)}
    pt_do = fp.flash_attention_pt_do_mma(*pt_do_args)
    torch.cuda.synchronize()
    assert {key: fp.probe_counts[key] for key in fp.BASELINE} == {
        "mma_fwd": 1, "mma_fwd_lse": 1, "mma_fwd_stats": 1, "mma_dkv": 2,
        "mma_dq": 2, "mma_pt_do": 1}
    assert max(_err(pt_do, flash_attention_pt_do_plain(*pt_do_args))) <= 1e-2
    for got in (out, out_l):
        assert max(_err(got[:, :2739], ref[:, :2739])) <= 1e-2
    assert max(_err(lse[..., :2739], ref_lse[..., :2739])) <= 1e-2
    for a, r in zip(stats, flash_attention_stats_plain(q, k, v)):
        assert max(_err(a, r)) <= 1e-2
    ref_grads = (*flash_attention_dkv_plain(*bwd),
                 flash_attention_dq_plain(*bwd))
    for out_dtype, got in grads.items():
        for a, r in zip(got, ref_grads):
            assert a.dtype == out_dtype
            assert max(_err(a[:, :2739], r[:, :2739])) <= 1e-2
