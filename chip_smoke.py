#!/usr/bin/env python3
"""Drive the PyTorch port's three slices once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero and prints no result line):

  1. Builds the CUDA libraries from mapanything_tpu_torch/csrc (the
     flash-attention forward with its lse and stats epilogues; the
     backward's dK/dV and dQ in bf16 and fp32, and P^T dO), one nvcc each,
     in parallel, and prints the build times and ptxas register use.
  2. The forward kernel vs its plain PyTorch version, bf16, seeded normal
     inputs laid out as nn/layers.py::Attention passes them (strided views
     of one fused qkv tensor, rows at or past n_valid zeroed), at the five
     attention shapes of the serving path (encoder, frame, 1-, 2- and
     8-view global layers at 518^2): max-abs and rel-L2 error over the real
     rows (limit 1e-2 each) and the median time of each. Every kernel row
     of phases 2-2c also carries its bound (utils/flops.py::roofline_ms:
     the larger of its tensor-core flops at 989 TFLOP/s and its bytes at
     3.35 TB/s) and the time of the one PyTorch call that computes the same
     function where there is one (flash-backend SDPA, its with-lse forward,
     its backward), timed as a yardstick and used nowhere in the port.
  2b. The training kernels against their plain twins on the same layout,
     at those five shapes and the three of the 1 x 4-view training step
     (encoder (4, 1408, 16, 64), frame (4, 1369, 16, 64), global
     (1, 5504, 16, 64)):
     the forward with lse (out and lse), dK/dV and dQ (fed the plain
     forward's lse and delta); each output's max-abs over the plain's
     max-abs and rel-L2 over the real rows (limit 1e-2 each), and the
     median time of each kernel and of its plain twin.
  2c. The ring's kernels against their plain twins, bf16 q/k/v on the
     fused-qkv layout, at the 4- and 8-view shards of a one-rank ring
     ((1, 5476, 16, 64) and (1, 10952, 16, 64), no padding, a ragged last
     key tile): the stats forward (acc, m, l; and with V := K), P^T dO and
     the fp32 forms of dK/dV and dQ fed the plain stats' global lse;
     max-abs over the plain's max-abs and rel-L2 (limit 1e-2 each), median
     times of 20 (plain: 5). At 8 views the stats of 4 key shards merged
     by merge_stats must equal flash_attn_fwd over all keys.
  3. Serving end to end at full width: MapAnythingConfig() (DINOv2-L/14,
     24-layer trunk, dim 1024, DPT 256) in bf16 with seeded random weights
     (numpy normals x 0.02), synthetic 518x518 PNGs through load_images and
     InferencePipeline.infer(apply_mask=True, mask_edges=True) for 1 and 2
     views, 5 timed calls after 2 warm-up calls. Checks finite outputs of
     the expected shapes and exactly 48 launches of the lse-free forward
     (24 encoder + 24 trunk attentions), none of the training kernels and
     0 plain launches per forward; reruns once with
     attn_impl="math" (without the masks, whose 0.5-threshold on near-zero
     random logits would flip pixels) and checks the rel-L2 of pts3d and
     depth_along_ray (limit 1e-2); prints the median ms per infer call.
     Then traces 3 more calls with torch.profiler and prints the device
     time per call, the device ops per call, the busy share (device time
     over the median wall time of the untraced calls) and the ten device
     ops that take the most time; a profiler that cannot trace the card
     leaves these unmeasured and fails nothing.
  4. Training end to end at full width: a second MapAnything(
     MapAnythingConfig()) with the model's own seeded init (weights
     N(0, 0.02^2) from a seeded torch.Generator, biases 0, LayerNorm and
     LayerScale at 1: unlike the all-normal weights of phase 3, the
     attention branch then carries gradient, and the predictions are not so
     flat that the exclude-top-5% ranking of the loss is decided by
     rounding). First, on that fresh model, at 1 view,
     train/grad_check.py::compare: the loss with attn_impl "auto" against
     "math" (limit 1e-2 relative) and the flat parameter gradient of each
     forward pulled back from the math path's d loss / d predictions, over
     all parameters and over the qkv weights alone (limit rel-L2 2e-2
     each); the gradient of the whole loss and of each of its terms is
     printed beside its noise floor, not held to a limit (see
     grad_check.py for why). The seeded init makes this reading the same
     in every run. Then make_synthetic_batch(1, 4, 518, 518) on the card,
     make_train_step with OptimConfig(warmup_steps=2, total_steps=100):
     2 warm-up steps, then 10 timed steps. Checks exactly 48 forward-with-lse,
     48 dK/dV and 48 dQ launches and no plain launch per step, a finite loss
     and grad_norm at every step, and that the parameters changed; prints
     the median step time, the peak device memory and the train MFU
     (utils/flops.py::train_step_flops over the step time and the H100 SXM
     bf16 dense peak). Traces 2 more steps with torch.profiler. Last,
     compare again on the trained model, printed and not held to a limit:
     the training steps are not bitwise deterministic, so that state and
     its reading differ from run to run.
  5. The ring (sequence-parallel) slice at full width on a process group
     of this one process (parallel/distributed.py::init_distributed, NCCL),
     through parallel/ring_check.py's two checks: a model with phase 3's
     weights and images, 8 views,
     InferencePipeline(model, view_shard_group=group).infer against the
     unsharded infer of the same views (pts3d and depth_along_ray rel-L2,
     camera quaternions and translations and the metric scale relative,
     limit 1e-2 each; beside them, not held to a limit, the unsharded call
     with math attention against flash: the floor that bf16-level changes
     of attention set on this model); exactly 36 lse-free forward launches
     (24 encoder + 12 frame) and 12 stats launches per forward, nothing
     else and no plain launch; the median of 5 wall times beside the unsharded call's,
     the busy share and the peak memory. Then RingGlobalBlock's gradients
     at the 4-view training global shape, x (1, 5476, 1024) and the token
     (1, 1, 1024) in bf16, loss sum(out_x^2) + sum(out_t^2), against the
     non-ring Block on [x; tok] (every parameter's and both inputs'
     gradient within rel-L2 2e-2), with exactly 2 stats, 1 P^T dO, 1 dK/dV
     and 1 dQ launch. At one rank the ring does not rotate; the rotation is
     checked over gloo on the CPU (tests/test_torch_ring_attention.py) and,
     across cards, by `torchrun --nproc_per_node=N -m
     mapanything_tpu_torch.parallel.ring_check`.

The last two lines are the kernels' JSON summary and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ERR_LIMIT = 1e-2
FORWARD_LAUNCHES = 48
GRAD_LIMIT = 2e-2  # the 1-view gradient, flash against math attention
TRAIN_STEPS = 10

# (name, (B, N, H, D), n_valid) of every attention shape on the main path
ATTENTION_SHAPES = [
    ("encoder_2view", (2, 1408, 16, 64), 1370),
    ("frame_2view", (2, 1369, 16, 64), None),
    ("global_1view", (1, 1408, 16, 64), 1370),
    ("global_2view", (1, 2816, 16, 64), 2739),
    ("global_8view", (1, 11008, 16, 64), 10953),
]
# the training path adds the three attention shapes of the 1 x 4 x 518^2 step
TRAIN_SHAPES = ATTENTION_SHAPES + [
    ("encoder_4view", (4, 1408, 16, 64), 1370),
    ("frame_4view", (4, 1369, 16, 64), None),
    ("global_4view", (1, 5504, 16, 64), 5477),
]
TRAINING_KERNELS = {
    # name: (source, the JAX Pallas kernel it replaces)
    "flash_attn_fwd_lse": (
        "mapanything_tpu_torch/csrc/flash_attn_fwd.cu",
        "mapanything_tpu/ops/flash_attention_bwd.py:73"),
    "flash_attn_bwd_dkv": (
        "mapanything_tpu_torch/csrc/flash_attn_bwd.cu",
        "mapanything_tpu/ops/flash_attention_bwd.py:96"),
    "flash_attn_bwd_dq": (
        "mapanything_tpu_torch/csrc/flash_attn_bwd.cu",
        "mapanything_tpu/ops/flash_attention_bwd.py:156"),
}
# the ring path: its two kernels and the fp32-output forms of dK/dV and dQ
# (ring_attention.py::_pair_bwd asks the Pallas pair for out_dtype=float32)
RING_KERNELS = {
    "flash_attn_fwd_stats": (
        "mapanything_tpu_torch/csrc/flash_attn_fwd.cu",
        "mapanything_tpu/ops/ring_attention.py:45"),
    "flash_attn_bwd_pt_do": (
        "mapanything_tpu_torch/csrc/flash_attn_bwd.cu",
        "mapanything_tpu/ops/ring_attention.py:358"),
    "flash_attn_bwd_dkv_f32": (
        "mapanything_tpu_torch/csrc/flash_attn_bwd.cu",
        "mapanything_tpu/ops/flash_attention_bwd.py:96"),
    "flash_attn_bwd_dq_f32": (
        "mapanything_tpu_torch/csrc/flash_attn_bwd.cu",
        "mapanything_tpu/ops/flash_attention_bwd.py:156"),
}
# kernel name -> its counter in flash_attention.kernel_counts
COUNTER = {"flash_attn_fwd": "fwd", "flash_attn_fwd_lse": "fwd_lse",
           "flash_attn_bwd_dkv": "dkv", "flash_attn_bwd_dq": "dq",
           "flash_attn_fwd_stats": "fwd_stats",
           "flash_attn_bwd_pt_do": "pt_do", "flash_attn_bwd_dkv_f32": "dkv",
           "flash_attn_bwd_dq_f32": "dq"}
# the ring's shards with p = 1 at 518^2: every view's 1369 patches, no
# padding (a ragged last 64-key tile)
RING_SHAPES = [("ring_4view", (1, 4 * 1369, 16, 64)),
               ("ring_8view", (1, 8 * 1369, 16, 64))]
RING_VIEWS = 8
# per view-sharded forward at p = 1: 24 encoder + 12 frame attentions, and
# one ring step in each of the 12 global layers
RING_FORWARD_LAUNCHES = {"fwd": 36, "fwd_stats": 12}
# one RingGlobalBlock forward and backward at p = 1
RING_BLOCK_LAUNCHES = {"fwd_stats": 2, "pt_do": 1, "dkv": 1, "dq": 1}


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def median_ms(fn, torch, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def attention_inputs(torch, shape, n_valid, seed):
    """bf16 q, k, v as nn/layers.py::Attention hands them to the kernel: the
    (B, N, H, D) views of one fused (B, N, 3, H, D) tensor (token stride
    3*H*D), with the rows at or past n_valid zeroed."""
    b, n, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    if n_valid is not None:
        qkv[:, n_valid:] = 0
    return qkv.unbind(2)


def kernel_vs_plain(torch, fa, F):
    rows = []
    for name, shape, n_valid in ATTENTION_SHAPES:
        q, k, v = attention_inputs(torch, shape, n_valid, seed=len(rows))
        out = fa.flash_attention(q, k, v, n_valid=n_valid)
        ref = fa.flash_attention_plain(q, k, v, n_valid=n_valid)
        torch.cuda.synchronize()
        real = shape[1] if n_valid is None else n_valid
        o, r = out[:, :real].float(), ref[:, :real].float()
        row = {
            "shape": list(shape), "n_valid": n_valid,
            "max_abs_err": float((o - r).abs().max()),
            "rel_l2": rel_l2(o, r),
            "ms": median_ms(lambda: fa.flash_attention(q, k, v, n_valid),
                            torch),
            "plain_ms": median_ms(
                lambda: fa.flash_attention_plain(q, k, v, n_valid), torch,
                reps=10),
        }
        flops = fa.attention_flops(shape[0], shape[1], real, shape[2],
                                   shape[3])
        row["tflops"] = flops / row["ms"] / 1e9
        row.update(bound(F, "fwd", shape, real))
        row["library_ms"] = library_fwd_ms(torch, *sdpa_layout(q, k, v, real))
        print(f"attention {name} {tuple(shape)} n_valid={n_valid}: "
              f"max_abs={row['max_abs_err']:.3e} rel_l2={row['rel_l2']:.3e} "
              f"kernel {row['ms']:.4f} ms ({row['tflops']:.2f} TFLOP/s) "
              f"plain {row['plain_ms']:.4f} ms bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']}) library {row['library_ms']:.4f} ms",
              flush=True)
        rows.append((name, row))
        del q, k, v, out, ref, o, r
        torch.cuda.empty_cache()
    return rows


def max_abs_rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def bound(F, kernel, shape, kv, out_bytes=2, v_is_k=False) -> dict:
    """The least time an H100 SXM could take for the kernel's work at this
    shape (utils/flops.py::roofline_ms), and what sets it."""
    b, n, h, d = shape
    ms, by = F.roofline_ms(*F.attention_kernel_work(
        kernel, b, n, kv, h, d, out_bytes=out_bytes, v_is_k=v_is_k))
    return {"bound_ms": ms, "bound_by": by}


def sdpa_layout(q, k, v, real):
    """(B, H, N, D) copies of q and of the real keys' k and v, as PyTorch's
    SDPA calls take them. They time those calls as a yardstick only."""
    return (q.transpose(1, 2).contiguous(),
            k[:, :real].transpose(1, 2).contiguous(),
            v[:, :real].transpose(1, 2).contiguous())


def library_fwd_ms(torch, qh, kh, vh) -> float:
    """F.scaled_dot_product_attention with the flash backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return median_ms(lambda: sdpa(qh, kh, vh), torch)


def library_fwd_lse_ms(torch, qh, kh, vh) -> float:
    """The flash SDPA forward that also writes the lse."""
    op = torch.ops.aten._scaled_dot_product_flash_attention
    return median_ms(lambda: op(qh, kh, vh), torch)


def library_bwd_ms(torch, qh, kh, vh, dout) -> float:
    """The flash SDPA backward: dQ, dK and dV in one call."""
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(qh, kh, vh)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    op = torch.ops.aten._scaled_dot_product_flash_attention_backward
    dout_h = dout.transpose(1, 2)
    return median_ms(lambda: op(dout_h, qh, kh, vh, out, lse, cum_q, cum_k,
                                max_q, max_k, 0.0, False, seed, offset),
                     torch)


def training_kernels_vs_plain(torch, fa, F):
    """Phase 2b: {kernel name: [row per shape]}."""
    rows = {name: [] for name in TRAINING_KERNELS}
    for i, (name, shape, n_valid) in enumerate(TRAIN_SHAPES):
        q, k, v = attention_inputs(torch, shape, n_valid, seed=100 + i)
        real = shape[1] if n_valid is None else n_valid
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        dout = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        dout[:, real:] = 0  # the row mask's backward zeroes them
        out, lse = fa.flash_attention_fwd_lse(q, k, v, n_valid)
        ref_out, ref_lse = fa.flash_attention_fwd_lse_plain(q, k, v, n_valid)
        delta = fa.attention_delta(dout, ref_out)
        bwd_args = (q, k, v, dout, ref_lse, delta, n_valid)
        dk, dv = fa.flash_attention_dkv(*bwd_args)
        ref_dk, ref_dv = fa.flash_attention_dkv_plain(*bwd_args)
        dq = fa.flash_attention_dq(*bwd_args)
        ref_dq = fa.flash_attention_dq_plain(*bwd_args)
        torch.cuda.synchronize()
        checks = {
            "flash_attn_fwd_lse": {"out": (out, ref_out),
                                   "lse": (lse.transpose(1, 2),
                                           ref_lse.transpose(1, 2))},
            "flash_attn_bwd_dkv": {"dk": (dk, ref_dk), "dv": (dv, ref_dv)},
            "flash_attn_bwd_dq": {"dq": (dq, ref_dq)},
        }
        timed = {
            "flash_attn_fwd_lse": (
                lambda: fa.flash_attention_fwd_lse(q, k, v, n_valid),
                lambda: fa.flash_attention_fwd_lse_plain(q, k, v, n_valid)),
            "flash_attn_bwd_dkv": (
                lambda: fa.flash_attention_dkv(*bwd_args),
                lambda: fa.flash_attention_dkv_plain(*bwd_args)),
            "flash_attn_bwd_dq": (
                lambda: fa.flash_attention_dq(*bwd_args),
                lambda: fa.flash_attention_dq_plain(*bwd_args)),
        }
        # matmul flops: 2 (QK^T, PV) forward, 4 (S^T, dP^T, dV, dK) in dK/dV,
        # 3 (S, dP, dQ) in dQ
        products = {"flash_attn_fwd_lse": 2, "flash_attn_bwd_dkv": 4,
                    "flash_attn_bwd_dq": 3}
        # the one PyTorch call of each: the flash SDPA forward with lse, and
        # its backward, which computes dK, dV and dQ together
        lib = sdpa_layout(q, k, v, real)
        lib_bwd = library_bwd_ms(torch, *lib, dout)
        library = {"flash_attn_fwd_lse": library_fwd_lse_ms(torch, *lib),
                   "flash_attn_bwd_dkv": lib_bwd,
                   "flash_attn_bwd_dq": lib_bwd}
        for kname, outputs in checks.items():
            row = {"at": name, "shape": list(shape), "n_valid": n_valid}
            for oname, (got, ref) in outputs.items():
                got, ref = got[:, :real].float(), ref[:, :real].float()
                row[f"{oname}_max_abs_err"] = float((got - ref).abs().max())
                row[f"{oname}_max_abs_rel"] = max_abs_rel(got, ref)
                row[f"{oname}_rel_l2"] = rel_l2(got, ref)
            kernel_fn, plain_fn = timed[kname]
            row["ms"] = median_ms(kernel_fn, torch)
            row["plain_ms"] = median_ms(plain_fn, torch, reps=5, warmup=1)
            fwd_flops = fa.attention_flops(shape[0], shape[1], real,
                                           shape[2], shape[3])
            row["tflops"] = (fwd_flops / 2 * products[kname] / row["ms"]
                             / 1e9)
            row.update(bound(F, COUNTER[kname], shape, real))
            row["library_ms"] = library[kname]
            rows[kname].append(row)
            errs = {key: f"{val:.3e}" for key, val in row.items()
                    if key.endswith(("_rel", "_rel_l2"))}
            print(f"{kname} {name} {tuple(shape)} n_valid={n_valid}: {errs} "
                  f"kernel {row['ms']:.4f} ms ({row['tflops']:.2f} TFLOP/s)"
                  f" plain {row['plain_ms']:.4f} ms bound "
                  f"{row['bound_ms']:.4f} ms library "
                  f"{row['library_ms']:.4f} ms", flush=True)
        del (q, k, v, dout, out, lse, ref_out, ref_lse, delta, dk, dv, dq,
             ref_dk, ref_dv, ref_dq, checks, timed, bwd_args, lib)
        torch.cuda.empty_cache()
    return rows


def ring_kernels_vs_plain(torch, fa, ring, F):
    """Phase 2c: ({kernel name: [row per case]}, the split-and-merge row).
    Each backward kernel gets the plain stats' global lse and delta."""
    rows = {name: [] for name in RING_KERNELS}
    merge = None
    f32, bf16 = torch.float32, torch.bfloat16
    for i, (at, shape) in enumerate(RING_SHAPES):
        q, k, v = attention_inputs(torch, shape, None, seed=300 + i)
        n = shape[1]
        gen = torch.Generator(device="cuda").manual_seed(400 + i)
        dout = torch.randn(shape, generator=gen, device="cuda").to(bf16)
        acc, m, l = ring.flash_attention_stats_plain(q, k, v)
        lse = (m + torch.log2(l)).transpose(1, 2).contiguous()
        delta = fa.attention_delta(dout, (acc / l[..., None]).to(bf16))
        del acc, m, l
        bwd = (q, k, v, dout, lse, delta)
        lib = sdpa_layout(q, k, v, n)
        lib_bwd = library_bwd_ms(torch, *lib, dout)
        cases = [
            ("flash_attn_fwd_stats", at, ("acc", "m", "l"),
             lambda: ring.flash_attention_stats(q, k, v),
             lambda: ring.flash_attention_stats_plain(q, k, v),
             bound(F, "fwd_stats", shape, n),
             library_fwd_lse_ms(torch, *lib)),
            ("flash_attn_fwd_stats", at + "_v_is_k", ("acc", "m", "l"),
             lambda: ring.flash_attention_stats(q, k, k),
             lambda: ring.flash_attention_stats_plain(q, k, k),
             bound(F, "fwd_stats", shape, n, v_is_k=True),
             library_fwd_lse_ms(torch, lib[0], lib[1], lib[1])),
            ("flash_attn_bwd_pt_do", at, ("out",),
             lambda: ring.flash_attention_pt_do(q, k, dout, lse),
             lambda: ring.flash_attention_pt_do_plain(q, k, dout, lse),
             bound(F, "pt_do", shape, n), None),
            ("flash_attn_bwd_dkv_f32", at, ("dk", "dv"),
             lambda: fa.flash_attention_dkv(*bwd, out_dtype=f32),
             lambda: fa.flash_attention_dkv_plain(*bwd, out_dtype=f32),
             bound(F, "dkv", shape, n, out_bytes=4), lib_bwd),
            ("flash_attn_bwd_dq_f32", at, ("dq",),
             lambda: fa.flash_attention_dq(*bwd, out_dtype=f32),
             lambda: fa.flash_attention_dq_plain(*bwd, out_dtype=f32),
             bound(F, "dq", shape, n, out_bytes=4), lib_bwd),
        ]
        for kname, case, names, kernel_fn, plain_fn, cost, library in cases:
            got, ref = kernel_fn(), plain_fn()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            row = {"at": case, "shape": list(shape)}
            for oname, a, r in zip(names, got, ref):
                if a.dtype != f32:
                    return rows, merge, f"{kname} {case}: {oname} {a.dtype}"
                row[f"{oname}_max_abs_err"] = float((a - r).abs().max())
                row[f"{oname}_max_abs_rel"] = max_abs_rel(a, r)
                row[f"{oname}_rel_l2"] = rel_l2(a, r)
            del got, ref
            row["ms"] = median_ms(kernel_fn, torch)
            row["plain_ms"] = median_ms(plain_fn, torch, reps=5, warmup=1)
            row.update(cost)
            row["library_ms"] = library
            rows[kname].append(row)
            errs = {key: f"{val:.3e}" for key, val in row.items()
                    if key.endswith(("_rel", "_rel_l2"))}
            print(f"{kname} {case} {tuple(shape)}: {errs} kernel "
                  f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}) library "
                  f"{library if library is None else round(library, 4)} ms",
                  flush=True)
        if at == "ring_8view":  # 4 kv shards merged = the whole kv
            cuts = [n * j // 4 for j in range(5)]
            st = ring.flash_attention_stats(q, k[:, :cuts[1]], v[:, :cuts[1]])
            for a, b in zip(cuts[1:-1], cuts[2:]):
                st = ring.merge_stats(*st, *ring.flash_attention_stats(
                    q, k[:, a:b], v[:, a:b]))
            out = st[0] / st[2][..., None]
            ref = fa.flash_attention(q, k, v).float()
            torch.cuda.synchronize()
            merge = {"at": at, "shards": 4, "vs": "flash_attn_fwd",
                     "out_max_abs_rel": max_abs_rel(out, ref),
                     "out_rel_l2": rel_l2(out, ref)}
            print(f"split-and-merge {at}: {json.dumps(merge)}", flush=True)
            del st, out, ref
        del q, k, v, dout, lse, delta, bwd, lib, cases
        torch.cuda.empty_cache()
    return rows, merge, None


def write_images(folder: str, n: int) -> list[str]:
    import numpy as np
    import PIL.Image

    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:518, 0:518] / 518.0
    paths = []
    for i in range(n):
        base = np.stack([np.sin(6 * xx + i), np.cos(5 * yy - i),
                         np.sin(4 * (xx + yy))], -1)
        img = 127.5 * (1 + 0.8 * base) + rng.normal(0, 8, base.shape)
        path = os.path.join(folder, f"view{i}.png")
        PIL.Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)
        paths.append(path)
    return paths


def check_outputs(out, num_views, torch) -> str | None:
    expect = {
        "pts3d": (1, 518, 518, 3), "depth_along_ray": (1, 518, 518, 1),
        "intrinsics": (1, 3, 3), "camera_poses": (1, 4, 4),
        "conf": (1, 518, 518), "mask": (1, 518, 518, 1),
        "metric_scaling_factor": (1,),
    }
    if len(out) != num_views:
        return f"{len(out)} views returned, expected {num_views}"
    for i, view in enumerate(out):
        for key, shape in expect.items():
            t = view[key]
            if tuple(t.shape) != shape:
                return f"view {i} {key}: shape {tuple(t.shape)} != {shape}"
            if t.dtype != torch.bool and not torch.isfinite(t).all():
                return f"view {i} {key}: non-finite values"
    return None


def profile_calls(torch, call, wall_ms, calls: int = 3) -> dict:
    """Device time per `call()` from torch.profiler, and its share of
    `wall_ms`, the median wall time of the untraced calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
    except RuntimeError as exc:  # a profiler without CUPTI access
        return {"not_measured": str(exc)[:200]}
    by_name: dict[str, float] = {}
    n_ops = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:90]  # template instances that share a prefix add up
            by_name[name] = (by_name.get(name, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / calls)
            n_ops += 1
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms": device_ms, "device_ops": n_ops / calls,
            "wall_ms": wall_ms, "busy_share": device_ms / wall_ms,
            "top_ops_ms": dict(top)}


def run_slice(torch, fa, model, pipe, load_images, folder, num_views,
              calls: int = 5):
    views = load_images(write_images(folder, num_views))
    for _ in range(2):  # warm-up
        pipe.infer(views, apply_mask=True, mask_edges=True)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = pipe.infer(views, apply_mask=True, mask_edges=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = dict(fa.flash_attention.kernel_counts)
    plain = fa.flash_attention.plain_launches
    res = {"views": num_views, "calls": calls, "kernel_counts": counts,
           "kernel_launches": counts["fwd"], "plain_launches": plain,
           "infer_ms": statistics.median(times), "infer_ms_all": times}
    bad = check_outputs(out, num_views, torch)
    if bad:
        return res, bad
    want = dict.fromkeys(fa.KERNELS, 0) | {"fwd": FORWARD_LAUNCHES * calls}
    if counts != want or plain != 0:
        return res, (f"kernel launches {counts} and {plain} plain in {calls} "
                     f"forwards, expected {want} and 0")
    res["profile"] = profile_calls(
        torch, lambda: pipe.infer(views, apply_mask=True, mask_edges=True),
        res["infer_ms"])

    flash = pipe.infer(views, apply_mask=False)
    model.set_attn_impl("math")
    try:
        math_out = pipe.infer(views, apply_mask=False)
    finally:
        model.set_attn_impl("auto")
    for key in ("pts3d", "depth_along_ray"):
        err = max(rel_l2(f[key], m[key]) for f, m in zip(flash, math_out))
        res[f"{key}_rel_l2_vs_math"] = err
        if not err <= ERR_LIMIT:
            return res, f"{key} rel-L2 vs math attention {err:.3e}"
    return res, None


def finite(x, torch) -> bool:
    return bool(torch.isfinite(x).all())


def run_training(torch, fa, T, model, make_synthetic_batch, geom_cfg,
                 train_step_flops, peak_flops):
    """Phase 4. Returns (results, failure message or None)."""
    batch = make_synthetic_batch(1, 4, 518, 518, seed=0)
    state = T.create_train_state(
        model, T.OptimConfig(warmup_steps=2, total_steps=100))
    step = T.make_train_step(model, geom_cfg)
    res = {"batch": "1 x 4 views x 518 x 518", "steps": TRAIN_STEPS}
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):  # warm-up (lr 0, then lr 1e-4)
        state, m = step(state, batch)
        if not (finite(m["loss"], torch) and finite(m["grad_norm"], torch)):
            return res, f"warm-up step {i}: loss {m['loss']} grad_norm " \
                        f"{m['grad_norm']}"
    torch.cuda.synchronize()
    watched = [p for _, p in model.named_parameters()][::97]
    before = [p.detach().clone() for p in watched]
    times, losses, norms = [], [], []
    for i in range(TRAIN_STEPS):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = dict(fa.flash_attention.kernel_counts)
        plain = fa.flash_attention.plain_launches
        want = dict.fromkeys(fa.KERNELS, 0) | {
            "fwd_lse": FORWARD_LAUNCHES, "dkv": FORWARD_LAUNCHES,
            "dq": FORWARD_LAUNCHES}
        if counts != want or plain != 0:
            return res, (f"step {i}: kernel launches {counts} and {plain} "
                         f"plain, expected {want} and 0")
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if not (math.isfinite(losses[-1]) and math.isfinite(norms[-1])):
            return res, f"step {i}: loss {losses[-1]} grad_norm {norms[-1]}"
        for key in counts:
            res[f"{key}_launches"] = res.get(f"{key}_launches", 0) + counts[key]
    changed = sum(not torch.equal(a, p.detach())
                  for a, p in zip(before, watched))
    del before
    if changed == 0:
        return res, "no watched parameter changed in the timed steps"
    step_ms = statistics.median(times)
    res.update({
        "step_ms": step_ms, "step_ms_all": times, "loss": losses,
        "grad_norm": norms, "watched_params_changed": f"{changed}/"
        f"{len(watched)}",
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "train_step_flops": train_step_flops(518, 4),
    })
    res["mfu"] = res["train_step_flops"] / (step_ms / 1e3) / peak_flops
    res["profile"] = profile_calls(torch, lambda: step(state, batch),
                                   step_ms, calls=2)
    return res, None


def run_ring_slice(torch, fa, RC, model, group, InferencePipeline, views):
    """Phase 5, first part: parallel/ring_check.py::check_inference at p = 1
    on 8 views, held to this script's launch counts, with a trace of the
    view-sharded call."""
    res, out = RC.check_inference(model, group, views, torch.device("cuda"))
    bad = check_outputs(out, RING_VIEWS, torch)
    if bad:
        return res, bad
    want = dict.fromkeys(fa.KERNELS, 0) | {
        key: val * res["forwards_counted"]
        for key, val in RING_FORWARD_LAUNCHES.items()}
    if res["kernel_counts"] != want or res["plain_launches"] != 0:
        return res, (f"kernel launches {res['kernel_counts']} and "
                     f"{res['plain_launches']} plain in "
                     f"{res['forwards_counted']} forwards, expected {want} "
                     f"and 0")
    for key, val in res.items():  # the floor's keys end in _math_vs_flash
        if key.endswith(("_rel_l2", "_rel")) and not val <= ERR_LIMIT:
            return res, f"{key} {val:.3e} against the unsharded infer"
    sharded = InferencePipeline(model, view_shard_group=group)
    res["profile"] = profile_calls(torch, lambda: sharded.infer(views),
                                   res["infer_ms"])
    return res, None


def ring_block_gradient(torch, fa, RC, group):
    """Phase 5, second part: parallel/ring_check.py::check_block_gradient at
    p = 1 and the 4-view training global shape."""
    res = RC.check_block_gradient(1024, 16, 4 * 1369, group,
                                  torch.device("cuda"), torch.bfloat16)
    want = dict.fromkeys(fa.KERNELS, 0) | RING_BLOCK_LAUNCHES
    if res["kernel_counts"] != want or res["plain_launches"] != 0:
        return res, (f"kernel launches {res['kernel_counts']} and "
                     f"{res['plain_launches']} plain, expected {want} and 0")
    bad = {key: val for key, val in res["grad_rel_l2"].items()
           if not val <= GRAD_LIMIT}
    if bad:
        return res, f"ring block gradient against Block: {bad}"
    return res, None


def flash_vs_math_gradient(torch, model, make_synthetic_batch, compare):
    """Phase 4, first part: train/grad_check.py::compare at 1 view, with
    the loss split into its terms."""
    batch = make_synthetic_batch(1, 1, 518, 518, seed=1)
    res = compare(model, batch)
    if not res["loss_rel_diff"] <= ERR_LIMIT:
        return res, f"1-view loss flash vs math {res['loss_rel_diff']:.3e}"
    for key in ("grad_rel_l2", "qkv_grad_rel_l2"):
        if not res[key] <= GRAD_LIMIT:
            return res, f"1-view {key} {res[key]:.3e}"
    return res, None


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this script measures the GPU port")
    sys.path.insert(0, HERE)
    try:
        from mapanything_tpu_torch.data.image import load_images
        from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
        from mapanything_tpu_torch.models import (
            MapAnything,
            MapAnythingConfig,
            images_only_config,
        )
        from mapanything_tpu_torch.ops import _build
        from mapanything_tpu_torch.ops import flash_attention as fa
        from mapanything_tpu_torch.ops import ring_attention as ring
        from mapanything_tpu_torch.parallel import init_distributed
        from mapanything_tpu_torch.parallel import ring_check as RC
        from mapanything_tpu_torch.train import step as T
        from mapanything_tpu_torch.train.grad_check import compare
        from mapanything_tpu_torch.utils import flops as F
        from mapanything_tpu_torch.utils.flops import (
            H100_SXM_BF16_DENSE_PEAK_FLOPS,
            train_step_flops,
        )
        from mapanything_tpu_torch.utils.inference import InferencePipeline
        from mapanything_tpu_torch.utils.weights import random_normal_
    except ImportError as exc:
        return fail(f"the port is not importable next to this script: {exc}")

    # the fp32 islands compute in full fp32 (TF32 off for matmuls and convs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        return fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)  # name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # phase 1: every library, one nvcc each, in parallel
    t0 = time.perf_counter()
    try:
        built = _build.build_all()
    except RuntimeError as exc:
        return fail(str(exc))
    print(f"built {len(built)} libraries in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, (path, log, secs) in built.items():
        print(f"  {os.path.relpath(path, HERE)}: {secs:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")

    # phase 2: the serving forward kernel
    attn = kernel_vs_plain(torch, fa, F)
    for name, row in attn:
        if not (row["max_abs_err"] <= ERR_LIMIT and row["rel_l2"] <= ERR_LIMIT):
            return fail(f"kernel disagrees with plain at {name}: {row}")

    # phase 2b: the training kernels
    train_rows = training_kernels_vs_plain(torch, fa, F)
    for kname, rows in train_rows.items():
        for row in rows:
            bad = {key: val for key, val in row.items()
                   if key.endswith(("_max_abs_rel", "_rel_l2"))
                   and not val <= ERR_LIMIT}
            if bad:
                return fail(f"{kname} disagrees with plain at {row['at']}: "
                            f"{bad}")

    # phase 2c: the ring's kernels
    ring_rows, merge, bad = ring_kernels_vs_plain(torch, fa, ring, F)
    if bad:
        return fail(bad)
    for kname, rows in ring_rows.items():
        for row in rows + ([merge] if kname == "flash_attn_fwd_stats"
                           else []):
            bad = {key: val for key, val in row.items()
                   if key.endswith(("_max_abs_rel", "_rel_l2"))
                   and not val <= ERR_LIMIT}
            if bad:
                return fail(f"{kname} disagrees with plain at {row['at']}: "
                            f"{bad}")

    # phase 3: serving at full width
    t0 = time.perf_counter()
    model = MapAnything(MapAnythingConfig())
    random_normal_(model)
    model.eval()
    pipe = InferencePipeline(model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.1f} M parameters, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    launches = 0
    with tempfile.TemporaryDirectory() as folder:
        for num_views in (1, 2):
            res, bad = run_slice(torch, fa, model, pipe, load_images, folder,
                                 num_views)
            print(f"slice {num_views}-view: {json.dumps(res)}", flush=True)
            if bad:
                return fail(f"{num_views}-view slice: {bad}")
            launches += res["kernel_launches"]
    print(f"peak device memory (serving) "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del model, pipe
    torch.cuda.empty_cache()

    # phase 4: training at full width
    t0 = time.perf_counter()
    model = MapAnything(MapAnythingConfig(),
                        generator=torch.Generator(device="cuda").manual_seed(1))
    print(f"training model built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    grad_check, bad = flash_vs_math_gradient(torch, model,
                                             make_synthetic_batch, compare)
    print(f"train 1-view flash vs math, seeded init: {json.dumps(grad_check)}",
          flush=True)
    if bad:
        return fail(bad)
    train, bad = run_training(torch, fa, T, model, make_synthetic_batch,
                              images_only_config(), train_step_flops,
                              H100_SXM_BF16_DENSE_PEAK_FLOPS)
    print(f"train 1x4v@518: {json.dumps(train)}", flush=True)
    if bad:
        return fail(f"training step: {bad}")
    trained = compare(model, make_synthetic_batch(1, 1, 518, 518, seed=1))
    print(f"train 1-view flash vs math, after {TRAIN_STEPS + 4} steps (not "
          f"held to a limit): {json.dumps(trained)}", flush=True)
    del model
    torch.cuda.empty_cache()

    # phase 5: the ring slice at full width, on a group of this one process
    group = init_distributed()
    try:
        t0 = time.perf_counter()
        model = MapAnything(MapAnythingConfig())
        random_normal_(model)
        model.eval()
        print(f"ring model built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        with tempfile.TemporaryDirectory() as folder:
            views = load_images(write_images(folder, RING_VIEWS))
        ring_res, bad = run_ring_slice(torch, fa, RC, model, group,
                                       InferencePipeline, views)
        print(f"ring slice {RING_VIEWS}-view: {json.dumps(ring_res)}",
              flush=True)
        if bad:
            return fail(f"ring slice: {bad}")
        del model, views
        torch.cuda.empty_cache()
        block_res, bad = ring_block_gradient(torch, fa, RC, group)
        print(f"ring block gradient: {json.dumps(block_res)}", flush=True)
        if bad:
            return fail(bad)
    finally:
        torch.distributed.destroy_process_group()

    def timing(row):
        return {key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}

    g2 = dict(attn)["global_2view"]
    kernels = [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "mapanything_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "mapanything_tpu/ops/flash_attention.py:147",
        "also_replaces": "mapanything_tpu/ops/flash_attention.py:94",
        "launches": launches,
        "max_abs_err": max(row["max_abs_err"] for _, row in attn),
        **timing(g2),
        "ms_at": "global_2view",
        "library_call": "F.scaled_dot_product_attention, flash backend",
        "per_shape": {name: row for name, row in attn},
    }]
    backward = ("aten._scaled_dot_product_flash_attention_backward (dQ, dK "
                "and dV together)")
    library_call = {
        "flash_attn_fwd_lse": "aten._scaled_dot_product_flash_attention",
        "flash_attn_bwd_dkv": backward, "flash_attn_bwd_dq": backward,
        "flash_attn_fwd_stats": ("aten._scaled_dot_product_flash_attention "
                                 "(nearest: normalised output and lse)"),
        "flash_attn_bwd_pt_do": None,
        "flash_attn_bwd_dkv_f32": backward, "flash_attn_bwd_dq_f32": backward,
    }
    # launches on the main path: training kernels from phase 4's steps, the
    # ring's from phase 5 (the fp32 forms are the ring block's dkv and dq)
    main_launches = {kname: train[f"{COUNTER[kname]}_launches"]
                     for kname in TRAINING_KERNELS}
    main_launches["flash_attn_fwd_stats"] = (
        ring_res["kernel_counts"]["fwd_stats"]
        + block_res["kernel_counts"]["fwd_stats"])
    for kname in ("flash_attn_bwd_pt_do", "flash_attn_bwd_dkv_f32",
                  "flash_attn_bwd_dq_f32"):
        main_launches[kname] = block_res["kernel_counts"][COUNTER[kname]]
    for kname, (source, replaces) in (TRAINING_KERNELS | RING_KERNELS).items():
        rows = (train_rows | ring_rows)[kname]
        at = {"flash_attn_fwd_stats": "ring_8view"}.get(
            kname, "ring_4view" if kname in RING_KERNELS else "global_4view")
        main = next(row for row in rows if row["at"] == at)
        entry = {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": main_launches[kname],
            "max_abs_err": max(val for row in rows for key, val in row.items()
                               if key.endswith("_max_abs_err")),
            **timing(main), "ms_at": at,
            "library_call": library_call[kname],
            "per_shape": {row["at"]: row for row in rows},
        }
        if kname == "flash_attn_fwd_lse":
            entry["also_replaces"] = (
                "mapanything_tpu/ops/flash_attention_bwd.py:29")
        if kname == "flash_attn_fwd_stats":
            entry["split_and_merge"] = merge
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
