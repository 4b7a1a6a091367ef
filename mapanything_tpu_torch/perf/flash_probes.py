"""The flash-attention forward's Hopper tuning probes, and the mma.sync
baselines of the forward and the backward.

The JAX package's TPU tuning probes (ROADMAP queue B, B9) are variants of
its forward kernel. Their Hopper counterparts are variants of the port's
TMA/wgmma forward (``csrc/flash_fwd_sm90.cuh``), built into their own
library (``csrc/flash_attn_fwd_probes.cu``, entry ``flash_attn_fwd_probe``),
each keeping its TPU original's question:

==============================================  ===========================
TPU probe (scripts/perf/)                       Hopper counterpart here
==============================================  ===========================
flash_bottleneck_probe.py::_kernel, modes       variants "main" (prod),
prod / nomax / noexp                            "nomax", "noexp": the time
                                                split between tensor cores
                                                and exponentials
flash_longseq_tuning.py::_kernel_bf16p and its  "bf16exp" (ex2 on packed
(block_q, block_k) sweep                        bf16 pairs) and the tiles
                                                "t<rows>x<keys>[s3]"
flash_multihead_experiment.py::_kernel_g        ``heads_per_block`` G of
(G heads per program)                           "main", and a persistent
                                                grid (``persistent_blocks``)
qkv_layout_experiment.py::flash_bh and          ``layout``: the fused
attn_alignment_experiment.py::_kernel_nhd       (B, N, 3, H, D) views, a
(pre-laid-out (B*H, N, D) against reading       contiguous (B, N, H, D), or
(B, N, H, D) in place)                          a (B, H, N, D) copy made in
                                                the call
flash_sumfuse_experiment.py::                   "sumfuse": V padded to 80
_kernel_1pass_sumfuse (row sum through a ones   columns in shared memory
column in V)                                    with a ones column
==============================================  ===========================

Every probe has a plain PyTorch version: :func:`flash_attention_plain` for
all but "nomax" (:func:`flash_nomax_plain`) and "noexp"
(:func:`flash_noexp_plain`, whose output is not normalised: the row sum
of raw scores crosses zero). :func:`flash_probe` launches the variant on
CUDA tensors and runs the plain version on CPU tensors. The baseline
wrappers (:func:`flash_attention_mma`, :func:`flash_attention_fwd_lse_mma`,
:func:`flash_attention_stats_mma`) launch the mma.sync kernel
(``csrc/flash_attn_fwd_mma.cu``) that the main path ran before, and
:func:`flash_attention_dkv_mma` / :func:`flash_attention_dq_mma` the
mma.sync backward (``csrc/flash_attn_bwd_mma.cu``, bf16 or fp32 outputs)
and :func:`flash_attention_pt_do_mma` the mma.sync P^T dO
(``csrc/flash_attn_pt_do_mma.cu``). All are built into the probe
library and nothing on the main path calls them. Launches count in
:data:`probe_counts`.

    python -m mapanything_tpu_torch.perf.flash_probes [--out FILE]

runs the timed sweep on one GPU at the encoder, 2-, 4- and 8-view global
shapes (518^2 views): device ms (perf/timing.py), TFLOP/s, the bound and
the error against the plain version of every probe, the baseline and
PyTorch's flash SDPA, printed and written as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from ..ops import flash_attention as fa
from ..ops import ring_attention as ring
from ..ops.flash_attention import (
    _LOG2E,
    _check_kernel_args,
    _kv_eff,
    _strides,
    flash_attention_fwd_lse_plain,
    flash_attention_plain,
)

LIBRARY = "flash_attn_probes"

# --- plain versions ---------------------------------------------------------


def _scores(q, k, kv_eff):
    """s' = q.k * d^-1/2 * log2(e) over the real keys, (B, H, Nq, kv) fp32."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(),
                        k[:, :kv_eff].float()) * (q.shape[-1] ** -0.5 * _LOG2E)


def flash_nomax_plain(q, k, v, n_valid: int | None = None):
    """The "nomax" probe: exp2(s') with no running max, out = P V / rowsum P
    (0 for a row that sees no key), in q's dtype. The TPU probe's
    flash_bottleneck_probe.py::_kernel, mode "nomax"."""
    kv_eff = _kv_eff(k, n_valid)
    p = torch.exp2(_scores(q, k, kv_eff))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / torch.where(l == 0, 1.0, l),
                       v[:, :kv_eff].float())
    return out.to(q.dtype)


def flash_noexp_plain(q, k, v, n_valid: int | None = None):
    """The "noexp" probe: P = s' (the products alone), out = P V NOT
    normalised, in q's dtype. The TPU probe (mode "noexp") divides by
    rowsum(s'), which crosses zero; the product is what it times."""
    kv_eff = _kv_eff(k, n_valid)
    out = torch.einsum("bhqk,bkhd->bqhd", _scores(q, k, kv_eff),
                       v[:, :kv_eff].float())
    return out.to(q.dtype)


# name -> (index in csrc/flash_attn_fwd_probes.cu, plain version). "main"
# is the main path's configuration (192 x 128, 3 stages), "simple" step (a)
# of the design (one warpgroup, no producer), "pingpong" 128 x 128 with two
# warpgroups taking turns, "t<rows>x<keys>[s3]" the tile sweep.
_PLAIN = flash_attention_plain
VARIANTS = {
    "main": (0, _PLAIN), "simple": (1, _PLAIN),
    "nomax": (2, flash_nomax_plain), "noexp": (3, flash_noexp_plain),
    "bf16exp": (4, _PLAIN), "sumfuse": (5, _PLAIN), "pingpong": (6, _PLAIN),
    "t64x128": (7, _PLAIN), "t64x176": (8, _PLAIN), "t128x64": (9, _PLAIN),
    "t128x176": (10, _PLAIN), "t128x128s3": (11, _PLAIN),
    "t128x176s3": (12, _PLAIN), "t192x64": (13, _PLAIN),
    "t128x128": (14, _PLAIN), "t192x128": (15, _PLAIN),
}

# the TPU probe kernel each case stands in for (def line), as chip_smoke.py
# reports it; the schedule cases are "main" with heads_per_block or
# persistent_blocks, the layout cases "main" on other input layouts
_B9 = "scripts/perf/"
REPLACES = {
    "main": _B9 + "flash_bottleneck_probe.py:93",
    "simple": _B9 + "flash_bottleneck_probe.py:93",
    "nomax": _B9 + "flash_bottleneck_probe.py:93",
    "noexp": _B9 + "flash_bottleneck_probe.py:93",
    "bf16exp": _B9 + "flash_longseq_tuning.py:101",
    "sumfuse": _B9 + "flash_sumfuse_experiment.py:22",
    "pingpong": _B9 + "flash_bottleneck_probe.py:93",
    **{name: _B9 + "flash_longseq_tuning.py:101"
       for name in VARIANTS if name.startswith("t")},
    "heads_per_block": _B9 + "flash_multihead_experiment.py:22",
    "persistent": _B9 + "flash_multihead_experiment.py:22",
    "layout_bnhd": _B9 + "attn_alignment_experiment.py:76",
    "layout_bhnd": _B9 + "qkv_layout_experiment.py:29",
}
LAYOUTS = ("as_given", "bhnd")
BASELINE = ("mma_fwd", "mma_fwd_lse", "mma_fwd_stats", "mma_dkv", "mma_dq",
            "mma_pt_do")


def reset_probe_counts() -> None:
    """Zero :data:`probe_counts` (one count per variant and baseline entry)
    and ``plain`` (the wrappers' plain calls on CPU tensors)."""
    probe_counts.clear()
    probe_counts.update(dict.fromkeys((*VARIANTS, *BASELINE, "plain"), 0))


probe_counts: dict[str, int] = {}
reset_probe_counts()


def _launch(counter: str, entry: str, device, *args) -> None:
    fn = fa._kernel_fn(LIBRARY, entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    fa._check_err(entry, err)
    probe_counts[counter] += 1


def _plain(fn, *args):
    probe_counts["plain"] += 1
    return fn(*args)


def flash_probe(name: str, q, k, v, n_valid: int | None = None,
                heads_per_block: int = 1, persistent_blocks: int = 0,
                layout: str = "as_given"):
    """The forward of probe variant `name` (see :data:`VARIANTS`): the CUDA
    kernel on CUDA tensors, its plain version on CPU tensors. q, k, v are
    (B, N, H, 64) bf16 in the kernels' layout. layout "bhnd" first copies
    them to contiguous (B, H, N, D) tensors (in the call, so timed with it)
    and hands the kernel their (B, N, H, D) views. Returns (B, Nq, H, 64)."""
    index, plain = VARIANTS[name]
    if layout not in LAYOUTS:
        raise ValueError(f"flash_probe: layout {layout!r} not in {LAYOUTS}")
    if layout == "bhnd":
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in (q, k, v))
    if not q.is_cuda:
        return _plain(plain, q, k, v, n_valid)
    _check_kernel_args(q, k, v)
    b, nq, h, d = q.shape
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    _launch(name, "flash_attn_fwd_probe", q.device, index, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, nq,
            _kv_eff(k, n_valid), _strides(q, k, v, out), d**-0.5 * _LOG2E,
            heads_per_block, persistent_blocks)
    return out


def _mma(counter, entry, q, k, v, kv_eff, outs, out_strided):
    _check_kernel_args(q, k, v)
    b, nq, h, d = q.shape
    _launch(counter, entry, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), *(t.data_ptr() for t in outs), b, h, nq, kv_eff,
            _strides(q, k, v, out_strided), d**-0.5 * _LOG2E)


def flash_attention_mma(q, k, v, n_valid: int | None = None):
    """The mma.sync baseline's ``flash_attn_fwd_mma`` (CUDA) or
    :func:`flash_attention_plain` (CPU)."""
    if not q.is_cuda:
        return _plain(flash_attention_plain, q, k, v, n_valid)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _mma("mma_fwd", "flash_attn_fwd_mma", q, k, v, _kv_eff(k, n_valid),
         (out,), out)
    return out


def flash_attention_fwd_lse_mma(q, k, v, n_valid: int | None = None):
    """(out, lse) of the baseline's ``flash_attn_fwd_lse_mma`` (CUDA) or
    :func:`flash_attention_fwd_lse_plain` (CPU)."""
    if not q.is_cuda:
        return _plain(flash_attention_fwd_lse_plain, q, k, v, n_valid)
    b, nq, h, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    _mma("mma_fwd_lse", "flash_attn_fwd_lse_mma", q, k, v,
         _kv_eff(k, n_valid), (out, lse), out)
    return out, lse


def flash_attention_stats_mma(q, k, v):
    """(acc, m, l) of the baseline's ``flash_attn_fwd_stats_mma`` (CUDA) or
    ops/ring_attention.py's :func:`flash_attention_stats_plain` (CPU)."""
    if not q.is_cuda:
        return _plain(ring.flash_attention_stats_plain, q, k, v)
    b, nq, h, d = q.shape
    acc = torch.empty((b, nq, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, nq, h), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _mma("mma_fwd_stats", "flash_attn_fwd_stats_mma", q, k, v, k.shape[1],
         (acc, m, l), acc)
    return acc, m, l


def _mma_bwd(counter):
    """launch(entry, device, *args) of the mma.sync backward's entries."""
    return lambda entry, device, *args: _launch(counter, entry + "_mma",
                                                device, *args)


def flash_attention_dkv_mma(q, k, v, dout, lse, delta,
                            n_valid: int | None = None, out_dtype=None):
    """(dk, dv) of the baseline's ``flash_attn_bwd_dkv_mma`` (or
    ``_dkv_f32_mma`` for out_dtype float32) on CUDA tensors, arguments as
    ops/flash_attention.py's :func:`flash_attention_dkv`; its plain twin on
    the CPU."""
    if not q.is_cuda:
        return _plain(fa.flash_attention_dkv_plain, q, k, v, dout, lse, delta,
                      n_valid, out_dtype)
    return fa._dkv_cuda(_mma_bwd("mma_dkv"), q, k, v, dout, lse, delta,
                        n_valid, out_dtype)


def flash_attention_dq_mma(q, k, v, dout, lse, delta,
                           n_valid: int | None = None, out_dtype=None):
    """dq of the baseline's ``flash_attn_bwd_dq_mma`` (or ``_dq_f32_mma``),
    as :func:`flash_attention_dkv_mma`."""
    if not q.is_cuda:
        return _plain(fa.flash_attention_dq_plain, q, k, v, dout, lse, delta,
                      n_valid, out_dtype)
    return fa._dq_cuda(_mma_bwd("mma_dq"), q, k, v, dout, lse, delta,
                       n_valid, out_dtype)


def flash_attention_pt_do_mma(q, k, dout, lse):
    """P^T dO of the baseline's ``flash_attn_bwd_pt_do_mma`` on CUDA
    tensors, arguments as ops/ring_attention.py's
    :func:`flash_attention_pt_do`; its plain twin on the CPU."""
    if not q.is_cuda:
        return _plain(ring.flash_attention_pt_do_plain, q, k, dout, lse)
    return ring._pt_do_cuda(
        lambda device, *args: _launch("mma_pt_do", "flash_attn_bwd_pt_do_mma",
                                      device, *args), q, k, dout, lse)


# --- the sweep (one GPU) ----------------------------------------------------

# (name, (B, N, H, D), n_valid): the encoder at 2 views and the global
# layers at 2, 4 and 8 views of 518^2 (tokens padded to a multiple of 128)
SWEEP_SHAPES = [
    ("encoder_2view", (2, 1408, 16, 64), 1370),
    ("global_2view", (1, 2816, 16, 64), 2739),
    ("global_4view", (1, 5504, 16, 64), 5477),
    ("global_8view", (1, 11008, 16, 64), 10953),
]
SM_COUNT = 132


def errors(got, ref) -> dict:
    """max-abs over the reference's max-abs, and rel-L2, in fp64."""
    got, ref = got.double(), ref.double()
    return {"max_abs_rel": float((got - ref).abs().max()
                                 / ref.abs().max().clamp_min(1e-30)),
            "rel_l2": float((got - ref).norm()
                            / ref.norm().clamp_min(1e-30))}


def fused_inputs(shape, n_valid, seed):
    """bf16 q, k, v as nn/layers.py::Attention hands them over: views of
    one fused (B, N, 3, H, D) tensor, rows at or past n_valid zeroed."""
    b, n, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    if n_valid is not None:
        qkv[:, n_valid:] = 0
    return qkv.unbind(2)


def _row(fn, plain_out, real, flops, bound_ms, device_ms) -> dict:
    out = fn()
    torch.cuda.synchronize()
    row = errors(out[:, :real].float(), plain_out[:, :real].float())
    row["ms"] = device_ms(fn)
    row["tflops"] = flops / row["ms"] / 1e9
    row["bound_share"] = bound_ms / row["ms"]
    return row


def sweep(shapes=SWEEP_SHAPES) -> dict:
    """Every probe at every shape: {shape name: {case: row}}."""
    from ..utils import flops as F
    from .timing import device_ms

    results = {}
    for si, (at, shape, n_valid) in enumerate(shapes):
        b, n, h, d = shape
        real = n if n_valid is None else n_valid
        q, k, v = fused_inputs(shape, n_valid, seed=500 + si)
        flops, nbytes = F.attention_kernel_work("fwd", b, n, real, h, d)
        bound_ms, bound_by = F.roofline_ms(flops, nbytes)
        plains = {fn: fn(q, k, v, n_valid)
                  for fn in {spec[1] for spec in VARIANTS.values()}}
        rows = {}

        def case(key, fn, plain_fn=flash_attention_plain):
            rows[key] = _row(fn, plains[plain_fn], real, flops, bound_ms,
                             device_ms)
            r = rows[key]
            print(f"{at} {key}: {r['ms']:.4f} ms {r['tflops']:.1f} TFLOP/s "
                  f"({r['bound_share']:.3f} of bound) max_abs_rel "
                  f"{r['max_abs_rel']:.2e} rel_l2 {r['rel_l2']:.2e}",
                  flush=True)

        for name, (_, plain) in VARIANTS.items():
            case(name, lambda name=name: flash_probe(name, q, k, v, n_valid),
                 plain)
        for g in (2, 4):
            case(f"main_G{g}", lambda g=g: flash_probe(
                "main", q, k, v, n_valid, heads_per_block=g))
        for per_sm in (1, 2):
            case(f"main_persistent{per_sm}", lambda per_sm=per_sm: flash_probe(
                "main", q, k, v, n_valid,
                persistent_blocks=per_sm * SM_COUNT))
        contig = [x.contiguous() for x in (q, k, v)]
        case("layout_bnhd", lambda: flash_probe("main", *contig, n_valid))
        case("layout_bhnd_copy", lambda: flash_probe(
            "main", *contig, n_valid, layout="bhnd"))
        case("baseline_mma", lambda: flash_attention_mma(q, k, v, n_valid))
        case("main_path", lambda: fa.flash_attention(q, k, v, n_valid))
        from torch.nn.attention import SDPBackend, sdpa_kernel
        qh, kh, vh = (x[:, :lim].transpose(1, 2).contiguous()
                      for x, lim in ((q, n), (k, real), (v, real)))
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib_ms = device_ms(lambda: torch.nn.functional
                               .scaled_dot_product_attention(qh, kh, vh))
        results[at] = {"shape": list(shape), "n_valid": n_valid,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": lib_ms, "cases": rows}
        print(f"{at}: bound {bound_ms:.4f} ms ({bound_by}), flash SDPA "
              f"{lib_ms:.4f} ms", flush=True)
        del q, k, v, contig, plains, qh, kh, vh
        torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None,
                        help="write the results as JSON to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_probes: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {"card": card, "torch": torch.__version__, "shapes": sweep()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


__all__ = [
    "BASELINE",
    "LAYOUTS",
    "REPLACES",
    "VARIANTS",
    "errors",
    "flash_attention_dkv_mma",
    "flash_attention_dq_mma",
    "flash_attention_fwd_lse_mma",
    "flash_attention_mma",
    "flash_attention_pt_do_mma",
    "flash_attention_stats_mma",
    "flash_noexp_plain",
    "flash_nomax_plain",
    "flash_probe",
    "fused_inputs",
    "probe_counts",
    "reset_probe_counts",
    "sweep",
]

if __name__ == "__main__":
    sys.exit(main())
