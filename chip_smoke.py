#!/usr/bin/env python3
"""Drive the PyTorch port's slices once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero and prints no result line):

  1. Builds the CUDA libraries from mapanything_tpu_torch/csrc (the
     TMA/wgmma flash-attention forward with its lse and stats epilogues;
     the TMA/wgmma backward's dK/dV and dQ in bf16 and fp32, with the
     ring's TMA/wgmma P^T dO; the probe library: the forward's probe
     variants and the mma.sync forward, backward and P^T dO, the
     baselines), one nvcc each, in parallel, and prints the build
     times, each kernel's ptxas register use (and any spill), the dynamic
     shared memory of each forward and backward configuration, and the
     HGMMA (wgmma) and UTMALDG (TMA load) counts in the SASS (cuobjdump) of
     the forward's three instances, of the backward's dK/dV and dQ in both
     output types and of P^T dO, failing where either is missing.
  Times: every kernel and library time is device time, a CUDA graph of 20
  back-to-back calls between two CUDA events (perf/timing.py::device_ms);
  the plain versions' by events around 5 calls in a row (::events_ms);
  beside each kernel the wrapper's host microseconds per call (::host_us).
  2. The forward kernel vs its plain PyTorch version, bf16, seeded normal
     inputs laid out as nn/layers.py::Attention passes them (strided views
     of one fused qkv tensor, rows at or past n_valid zeroed), at the five
     attention shapes of the serving path (encoder, frame, 1-, 2- and
     8-view global layers at 518^2): max-abs and rel-L2 error over the real
     rows (limit 1e-2 each), the same for the mma.sync baseline
     (perf/flash_probes.py::flash_attention_mma), and the time of each
     (new kernel, baseline, plain). Every kernel row
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
     forward's lse and delta), and the pair row: delta, dK/dV and dQ as
     the backward runs them in one call (ops/flash_attention.py::
     flash_attention_bwd); each output's max-abs over the plain's max-abs
     and rel-L2 over the real rows (limit 1e-2 each), the same for the
     mma.sync baseline of each kernel, and the time of each kernel, its
     baseline and its plain twin. The pair is timed against FA2's
     backward, which computes the same function, and bound by that
     function's 5 products; dK/dV and dQ alone have no library call.
  2c. The ring's kernels against their plain twins, bf16 q/k/v on the
     fused-qkv layout, at the 4- and 8-view shards of a one-rank ring
     ((1, 5476, 16, 64) and (1, 10952, 16, 64), no padding, a ragged last
     key tile): the stats forward (acc, m, l; and with V := K) and the
     fp32 forms of dK/dV and dQ fed the plain stats' global lse; P^T dO
     there and at (2, 1000, 16, 64) against 1337 keys with every seventh
     lse +inf (PT_DO_RAGGED), with its bound (utils/flops.py "pt_do"),
     its speed-up over the mma.sync baseline and its host µs; max-abs over the
     plain's max-abs and rel-L2 (limit 1e-2 each), every kernel also for
     its mma.sync baseline, and the times. At 8 views the stats of 4 key
     shards merged by merge_stats must equal flash_attn_fwd over all
     keys.
  2d. Every probe of perf/flash_probes.py (the Hopper counterparts of the
     TPU tuning probes: softmax variants, bf16 exp, row sum by the P V
     product, tile shapes, step (a), ping-pong) and the main configuration
     with 2 and 4 heads per block, a persistent grid, and (B, N, H, D) or
     (B, H, N, D)-copied inputs, once at the 2-view global shape against
     its plain version (limit 1e-2 max-abs over the plain's max-abs and
     rel-L2), with its time. Phases 3-6 then require 0 launches of every
     probe and of the baselines.
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
     gradient within rel-L2 2e-2), with exactly 2 stats, 1 P^T dO, 1 fp32
     dK/dV and 1 fp32 dQ launch. At one rank the ring does not rotate; the rotation is
     checked over gloo on the CPU (tests/test_torch_ring_attention.py) and,
     across cards, by `torchrun --nproc_per_node=N -m
     mapanything_tpu_torch.parallel.ring_check`.
  6. The view-sharded train step (train/seq_parallel.py) at full width on
     the same one-process group: a model with phase 4's seeded init and
     phase 4's batch (1 x 4 views x 518^2). First
     train/grad_check.py::compare_sharded against the unsharded loss and
     gradient of the same model and batch: the loss within 1e-2 relative,
     the parameter gradient pulled back from the unsharded path's d loss /
     d predictions within rel-L2 2e-2 (beside its noise floor; the whole
     loss's gradient printed, not held to a limit). Then
     make_view_sharded_train_step, 2 warm-up and 5 timed steps: exactly
     VS_STEP_LAUNCHES per step (12 P^T dO, 24 stats, 36 forward-with-lse,
     36 dK/dV and 36 dQ in bf16, 12 of each in fp32 for the ring, counted
     apart) and no plain
     launch, a finite loss and grad_norm at every step, the first step's
     loss (lr 0, the seeded init) within 1e-2 of phase 4's first; prints
     the median wall ms, the device ms, busy share and P^T dO's device ms
     per step (torch.profiler over 2 more steps) and the peak memory.
     Phases 3-6 require 0 probe and baseline launches. The rotation at
     p > 1 runs over gloo on the CPU (tests/test_torch_seq_parallel.py) and
     across cards in `ring_check --check train`.

  7. The rest of the serving API at full width, a model with phase 3's
     weights, synthetic 518^2 PNGs through load_images:
     7a, BASELINE config 3: 4 views with intrinsics, 4x4 camera poses
     (seeded random unit quaternions and translations) and the metric
     flag; finite outputs of the expected shapes, exactly 48 forward
     launches per call, nothing else; the features the forward fed the
     fusion LayerNorm against the same fusion in fp32 on the CPU from the
     card's own encoder output (the six encoders copied there; limit 1e-4
     of max-abs), with the priors' share of them; the call with math
     attention (pts3d and depth rel-L2, limit 1e-2); median of 5 wall
     times after 2 warm-ups, device ms and busy share (profiler).
     7b, config 4: 32 views, the confidence mask at the 10th percentile,
     "auto" (unchunked on 80 GB) and memory_efficient_inference=True, each
     1 warm-up and 3 timed calls (median wall, views/s, peak GiB, 48
     forward launches per call) and a profiled call; the two programs'
     pts3d and depth within rel-L2 1e-2. 7c, config 5: 100 views, the
     chunked program then "auto", the same readings; demo_colmap's export
     of the chunked call's outputs into a temporary directory, read back
     with utils/colmap_io.py: 100 cameras, 100 images, points, unit
     quaternions whose rotations are the predicted poses' (1e-4). After
     each, B2 at the many-view global shape ((1, 43904, 16, 64) / 43809
     and (1, 136960, 16, 64) / 136901) against its plain version on the
     first and the last 192 real rows (limit 1e-2, as phase 2), its device
     time, bound, flash SDPA's time and host µs. 0 probe and baseline
     launches.
  8. Training with geometric priors at full width and depth, on phase 4's
     seeded init (the released config, bf16 compute, fp32 parameters),
     every batch from make_synthetic_batch with every prior:
     8a, the `aug_training` step (models/tasks.py) at 1 x 4 views x 518^2,
     its masks from a CUDA generator: 2 warm-up and 10 timed steps,
     exactly 48 forward-with-lse, 48 dK/dV and 48 dQ launches a step and
     nothing else; how often each mask was on (the draws replayed from
     the generator states), wall, device ms, busy share, peak GiB; then
     grad_check.compare with every prior on (`pass_through`) on phase 4's
     1-view batch, gated as phase 4 (loss 1e-2, gradients rel-L2 2e-2),
     the noise floor beside it.
     8b, encoder and trunk gradient checkpointing: one forward and
     backward at 1 x 4 views with and without it from the same state and
     generator seed, twice each as training runs them (wall and peak GiB
     of the second, the two calls' run-to-run gradient rel-L2), then once
     each under torch.use_deterministic_algorithms, held to loss 1e-5
     relative and gradient rel-L2 1e-3 (the upsample backward's atomics
     leave two identical passes ~1e-3 apart otherwise); 48 forward-with-lse
     launches more with it (CKPT_LAUNCHES: each attention's forward runs
     again in the recompute). Then the checkpointed `aug_training` step at
     1 x 24 views (the stage-2 recipe; global attention (1, 32896, 16, 64)
     / 32857): 1 warm-up and 2 timed steps, wall and peak GiB.
     8c, train/loop.py::train at full width on 1 x 2-view batches, 2
     epochs of 2 batches and a validation loader, in a temporary
     directory (free disk printed first; too little fails the phase):
     uninterrupted, and killed at (epoch 1, iter 1) then resumed from
     checkpoint-last, both under deterministic algorithms: the same step
     counts, the parameters within rel-L2 1e-3; each checkpoint's GiB and
     save and load seconds (5 writes, 1 load).
     8d, at p = 1 on a one-process NCCL group: config 3 (intrinsics, 4x4
     poses, the metric flag) through InferencePipeline(view_shard_group=)
     against the unsharded call (phase 5's limits and launch counts, with
     phase 3's weights); the view-sharded `aug_training` step against the
     unsharded one with the same generator seed
     (grad_check.compare_sharded: loss 1e-2, gradient 2e-2) and 5 steps
     with phase 6's VS_STEP_LAUNCHES each. 0 probe and baseline launches.
  9. Serving through serve.py at full width, a model with phase 3's
     weights:
     9a, the forward kernel against its plain version (phase 2's method
     and limits, no baseline) at the shapes batched and non-square scenes
     give it (SERVING_SHAPES: 518x392 at 4 scenes x 2 views, 518x168 at 2
     views, the 4-view global layer at 518x392 on B2), with device ms,
     bound, flash SDPA's time and host µs.
     9b, four 2-view 518^2 scenes queued on a BatchingEngine(max_batch=4)
     before its start: exactly one batched call, 48 forward launches and
     nothing else, each scene within rel-L2 1e-2 of its solo batch-1 infer
     (pts3d, depth_z, camera_poses, metric scale; masks off, as phase 3).
     9c, the server as a user starts it: the model written with
     train/checkpoints.py::save_params, then the CLI's composition
     (serve.build_server --checkpoint FILE --port 0 --max-batch 4:
     from_pretrained onto the card, the engine, the server, a 2-view
     warm-up); the served model bitwise the saved one, on the card;
     /healthz 200, a concurrent burst from client threads (BURST: 640x480
     images only, 480x640, 640x480 with intrinsics off the centre and
     z-depth, 1036x336 into 518x168), each response 200, of its bucket's
     shapes, finite and within 1e-2 of the solo infer of the same
     preprocessed scene on phase 3's model; a malformed body 400 and the
     next request 200; /v1/stats errors 0; forward launches exactly 48 x
     the batched calls of the window. Prints the load seconds, the
     checkpoint's GiB, peak GiB, requests/s, latency p50 and max, batched
     calls, scenes padded and bytes per response.
     9d, readings not held to a limit, on the served model alone (phase
     3's freed; masks on; median of 5 after a warm-up): the four scenes
     through the running engine (first submit to last result: the merge,
     the hand-off, the forward, the host copies and the split), the
     pipeline's own batch-4 call and its batch 1: wall, views/s, device
     ms, busy share, peak GiB. Forward launches exactly 48 per batched
     call; 0 probe and baseline launches.

The last two lines are the kernels' JSON summary (each kernel's launches:
the counts phases 3-9 read, summed) and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
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
CSRC = "mapanything_tpu_torch/csrc/"
NEW_FWD = CSRC + "flash_attn_fwd_sm90.cu"
NEW_BWD = CSRC + "flash_attn_bwd_sm90.cu"
NEW_PT_DO = CSRC + "flash_attn_pt_do_sm90.cu"
# the mma.sync kernels the main path ran before, off it as baselines
MMA_SOURCE = {NEW_FWD: CSRC + "flash_attn_fwd_mma.cu",
              NEW_BWD: CSRC + "flash_attn_bwd_mma.cu",
              NEW_PT_DO: CSRC + "flash_attn_pt_do_mma.cu"}
TRAINING_KERNELS = {
    # name: (source, the JAX Pallas kernel it replaces)
    "flash_attn_fwd_lse": (
        NEW_FWD, "mapanything_tpu/ops/flash_attention_bwd.py:73"),
    "flash_attn_bwd_dkv": (
        NEW_BWD, "mapanything_tpu/ops/flash_attention_bwd.py:96"),
    "flash_attn_bwd_dq": (
        NEW_BWD, "mapanything_tpu/ops/flash_attention_bwd.py:156"),
}
# the backward as one call, delta (torch) + dK/dV + dQ (ops/flash_attention.
# py::flash_attention_bwd): no kernel of its own, so it has no counter;
# phase 2b holds it against FA2's backward, which computes the same function
PAIR = "flash_attn_bwd_pair"
# the ring path: its two kernels and the fp32-output forms of dK/dV and dQ
# (ring_attention.py::_pair_bwd asks the Pallas pair for out_dtype=float32)
RING_KERNELS = {
    "flash_attn_fwd_stats": (
        NEW_FWD, "mapanything_tpu/ops/ring_attention.py:45"),
    "flash_attn_bwd_pt_do": (
        NEW_PT_DO, "mapanything_tpu/ops/ring_attention.py:358"),
    "flash_attn_bwd_dkv_f32": (
        NEW_BWD, "mapanything_tpu/ops/flash_attention_bwd.py:96"),
    "flash_attn_bwd_dq_f32": (
        NEW_BWD, "mapanything_tpu/ops/flash_attention_bwd.py:156"),
}
# kernel name -> its counter in flash_attention.kernel_counts
COUNTER = {"flash_attn_fwd": "fwd", "flash_attn_fwd_lse": "fwd_lse",
           "flash_attn_bwd_dkv": "dkv", "flash_attn_bwd_dq": "dq",
           "flash_attn_fwd_stats": "fwd_stats",
           "flash_attn_bwd_pt_do": "pt_do",
           "flash_attn_bwd_dkv_f32": "dkv_f32",
           "flash_attn_bwd_dq_f32": "dq_f32"}
# the ring's shards with p = 1 at 518^2: every view's 1369 patches, no
# padding (a ragged last 64-key tile)
RING_SHAPES = [("ring_4view", (1, 4 * 1369, 16, 64)),
               ("ring_8view", (1, 8 * 1369, 16, 64))]
RING_VIEWS = 8
# per view-sharded forward at p = 1: 24 encoder + 12 frame attentions, and
# one ring step in each of the 12 global layers
RING_FORWARD_LAUNCHES = {"fwd": 36, "fwd_stats": 12}
# one RingGlobalBlock forward and backward at p = 1
RING_BLOCK_LAUNCHES = {"fwd_stats": 2, "pt_do": 1, "dkv_f32": 1,
                       "dq_f32": 1}
# B8 (P^T dO) also where its tiles are ragged: nq != nk, neither a multiple
# of 64, every seventh q row with lse = +inf (a row that saw no key)
PT_DO_RAGGED = ("ragged_lse_inf", (2, 1000, 16, 64), 1337)
# per view-sharded train step at p = 1 (1 x 4 views x 518^2): the 24
# encoder and 12 frame attentions through FlashAttention (the forward with
# lse, then dK/dV and dQ); the 12 global layers on the ring, each one stats
# launch forward and one (V := K) backward, one P^T dO and one fp32 dK/dV
# and dQ
VS_STEP_LAUNCHES = {"fwd_lse": 36, "dkv": 36, "dq": 36, "dkv_f32": 12,
                    "dq_f32": 12, "fwd_stats": 2 * 12, "pt_do": 12}
VS_WARMUP, VS_STEPS = 2, 5
# phase 7: BASELINE configs 3 (4 views with intrinsics and poses), 4 (32
# views, confidence mask) and 5 (100 views, memory-efficient), at 518^2
PRIOR_VIEWS, PRIOR_CALLS = 4, 5
MANY_VIEWS = {32: 3, 100: 3}  # views: timed calls per program
CONF_PERCENTILE = 10.0
FUSION_LIMIT = 1e-4  # the card's fused features against the CPU's, fp32
SAMPLE_ROWS = 192  # B2 at the many-view shapes: first and last real rows
PATCHES = 37 * 37  # per view at 518^2


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def kernel_ms(fn) -> float:
    """Device ms per call of a kernel or a library call: a CUDA graph of 20
    back-to-back calls, replayed between two CUDA events
    (perf/timing.py::device_ms). No host work of the wrapper enters it."""
    from mapanything_tpu_torch.perf.timing import device_ms

    return device_ms(fn)


def plain_ms(fn) -> float:
    """Device ms per call of a plain version: events around 5 calls issued
    back to back (perf/timing.py::events_ms; each call allocates its score
    matrix, which a graph's pool would keep for every call)."""
    from mapanything_tpu_torch.perf.timing import events_ms

    return events_ms(fn)


def host_us(fn) -> float:
    """A wrapper's host µs per call (perf/timing.py::host_us). Phase 2
    holds the forward's own wrapper (ops/flash_attention.py::_fwd_cuda)
    beside the baseline's, which does the same work."""
    from mapanything_tpu_torch.perf.timing import host_us as measure

    return measure(fn)


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


def kernel_vs_plain(torch, fa, fp, F, shapes=ATTENTION_SHAPES, seed=0,
                    baseline=True):
    """The forward kernel against its plain version at each (name, shape,
    n_valid) of `shapes` (the real rows), with its device time, bound,
    flash SDPA's time and host µs; with `baseline`, the same for the
    mma.sync baseline. Returns [(name, row)]."""
    rows = []
    for name, shape, n_valid in shapes:
        q, k, v = attention_inputs(torch, shape, n_valid,
                                   seed=seed + len(rows))
        out = fa.flash_attention(q, k, v, n_valid=n_valid)
        ref = fa.flash_attention_plain(q, k, v, n_valid=n_valid)
        torch.cuda.synchronize()
        real = shape[1] if n_valid is None else n_valid
        o, r = out[:, :real].float(), ref[:, :real].float()
        row = {
            "shape": list(shape), "n_valid": n_valid,
            "max_abs_err": float((o - r).abs().max()),
            "rel_l2": rel_l2(o, r),
            "ms": kernel_ms(lambda: fa.flash_attention(q, k, v, n_valid)),
            "plain_ms": plain_ms(
                lambda: fa.flash_attention_plain(q, k, v, n_valid)),
            "host_us": host_us(
                lambda: fa._fwd_cuda(q, k, v, n_valid, with_lse=False)),
        }
        mma = ""
        if baseline:
            mo = fp.flash_attention_mma(q, k, v, n_valid)[:, :real].float()
            row.update({
                "mma_max_abs_err": float((mo - r).abs().max()),
                "mma_rel_l2": rel_l2(mo, r),
                "mma_ms": kernel_ms(
                    lambda: fp.flash_attention_mma(q, k, v, n_valid)),
                "mma_host_us": host_us(
                    lambda: fp.flash_attention_mma(q, k, v, n_valid)),
            })
            mma = f" mma.sync {row['mma_ms']:.4f} ms"
            del mo
        flops = fa.attention_flops(shape[0], shape[1], real, shape[2],
                                   shape[3])
        row["tflops"] = flops / row["ms"] / 1e9
        row.update(bound(F, "fwd", shape, real))
        row["library_ms"] = library_fwd_ms(torch, *sdpa_layout(q, k, v, real))
        print(f"attention {name} {tuple(shape)} n_valid={n_valid}: "
              f"max_abs={row['max_abs_err']:.3e} rel_l2={row['rel_l2']:.3e} "
              f"kernel {row['ms']:.4f} ms ({row['tflops']:.2f} TFLOP/s)"
              f"{mma} plain {row['plain_ms']:.4f} "
              f"ms bound {row['bound_ms']:.4f} ms ({row['bound_by']}) "
              f"library {row['library_ms']:.4f} ms; host "
              f"{row['host_us']:.1f} us"
              + (f" (mma.sync {row['mma_host_us']:.1f})" if baseline else ""),
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
        return kernel_ms(lambda: sdpa(qh, kh, vh))


def library_fwd_lse_ms(torch, qh, kh, vh) -> float:
    """The flash SDPA forward that also writes the lse."""
    op = torch.ops.aten._scaled_dot_product_flash_attention
    return kernel_ms(lambda: op(qh, kh, vh))


def library_bwd_ms(torch, qh, kh, vh, dout) -> float:
    """The flash SDPA backward: dQ, dK and dV in one call."""
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(qh, kh, vh)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    op = torch.ops.aten._scaled_dot_product_flash_attention_backward
    dout_h = dout.transpose(1, 2)
    return kernel_ms(lambda: op(dout_h, qh, kh, vh, out, lse, cum_q, cum_k,
                                 max_q, max_k, 0.0, False, seed, offset))


def errors_of(outputs) -> dict:
    """{name}_max_abs_err, _max_abs_rel and _rel_l2 of each (got, ref) pair
    of `outputs`, over the rows the caller kept."""
    row = {}
    for oname, (got, ref) in outputs.items():
        got, ref = got.float(), ref.float()
        row[f"{oname}_max_abs_err"] = float((got - ref).abs().max())
        row[f"{oname}_max_abs_rel"] = max_abs_rel(got, ref)
        row[f"{oname}_rel_l2"] = rel_l2(got, ref)
    return row


def baseline_errors(outputs) -> dict:
    """The mma.sync baseline's worst error over its outputs."""
    errs = errors_of(outputs)
    return {f"mma_{kind}": max(val for key, val in errs.items()
                               if key.endswith(f"_{kind}"))
            for kind in ("max_abs_err", "max_abs_rel", "rel_l2")}


def print_row(kname, case, shape, row):
    errs = {key: f"{val:.3e}" for key, val in row.items()
            if key.endswith(("_rel", "_rel_l2"))}
    mma = (f" mma.sync {row['mma_ms']:.4f} ms" if "mma_ms" in row else "")
    lib = row["library_ms"]
    print(f"{kname} {case} {tuple(shape)}: {errs} kernel {row['ms']:.4f} ms"
          + (f" ({row['tflops']:.2f} TFLOP/s)" if "tflops" in row else "")
          + f"{mma} plain {row['plain_ms']:.4f} ms bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}) library "
          f"{'none' if lib is None else f'{lib:.4f} ms'} host "
          f"{row['host_us']:.1f} us", flush=True)


def training_kernels_vs_plain(torch, fa, fp, F):
    """Phase 2b: {kernel name or PAIR: [row per shape]}. The backward
    kernels are fed the plain forward's lse and delta; the pair row times
    delta, dK/dV and dQ as the backward runs them, in one call, against
    FA2's backward, which computes the same function."""
    rows = {name: [] for name in [*TRAINING_KERNELS, PAIR]}
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
        pair_args = (q, k, v, ref_out, ref_lse, dout, n_valid)
        dk, dv = fa.flash_attention_dkv(*bwd_args)
        ref_dk, ref_dv = fa.flash_attention_dkv_plain(*bwd_args)
        dq = fa.flash_attention_dq(*bwd_args)
        ref_dq = fa.flash_attention_dq_plain(*bwd_args)
        pair = fa.flash_attention_bwd(*pair_args)
        mma_fwd = fp.flash_attention_fwd_lse_mma(q, k, v, n_valid)
        mma_dk, mma_dv = fp.flash_attention_dkv_mma(*bwd_args)
        mma_dq = fp.flash_attention_dq_mma(*bwd_args)
        torch.cuda.synchronize()

        def real_rows(**pairs):  # (got, ref) over the real rows
            return {key: (got[:, :real], ref[:, :real])
                    for key, (got, ref) in pairs.items()}

        def lse_rows(got):  # (B, H, N) -> (B, N, H)
            return got.transpose(1, 2)

        # (row, outputs against the plain version's, kernel fn, plain fn,
        # the mma.sync baseline's (outputs, fn) or None, its work in
        # utils/flops.py, library ms) of each row. The pair's work is the
        # backward's own 5 products (S, dP, dV, dK, dQ); its two kernels
        # run 7, computing S and dP once in each. The library call is the
        # flash SDPA forward with lse, and its backward for the pair: no
        # single call computes dK/dV or dQ alone.
        lib = sdpa_layout(q, k, v, real)
        cases = [
            ("flash_attn_fwd_lse",
             real_rows(out=(out, ref_out),
                       lse=(lse_rows(lse), lse_rows(ref_lse))),
             lambda: fa.flash_attention_fwd_lse(q, k, v, n_valid),
             lambda: fa.flash_attention_fwd_lse_plain(q, k, v, n_valid),
             (real_rows(out=(mma_fwd[0], ref_out),
                        lse=(lse_rows(mma_fwd[1]), lse_rows(ref_lse))),
              lambda: fp.flash_attention_fwd_lse_mma(q, k, v, n_valid)),
             "fwd_lse", library_fwd_lse_ms(torch, *lib)),
            ("flash_attn_bwd_dkv",
             real_rows(dk=(dk, ref_dk), dv=(dv, ref_dv)),
             lambda: fa.flash_attention_dkv(*bwd_args),
             lambda: fa.flash_attention_dkv_plain(*bwd_args),
             (real_rows(dk=(mma_dk, ref_dk), dv=(mma_dv, ref_dv)),
              lambda: fp.flash_attention_dkv_mma(*bwd_args)),
             "dkv", None),
            ("flash_attn_bwd_dq", real_rows(dq=(dq, ref_dq)),
             lambda: fa.flash_attention_dq(*bwd_args),
             lambda: fa.flash_attention_dq_plain(*bwd_args),
             (real_rows(dq=(mma_dq, ref_dq)),
              lambda: fp.flash_attention_dq_mma(*bwd_args)),
             "dq", None),
            (PAIR,
             real_rows(dq=(pair[0], ref_dq), dk=(pair[1], ref_dk),
                       dv=(pair[2], ref_dv)),
             lambda: fa.flash_attention_bwd(*pair_args),
             lambda: fa.flash_attention_bwd_plain(*pair_args),
             None, "bwd", library_bwd_ms(torch, *lib, dout)),
        ]
        for (kname, outputs, kernel_fn, plain_fn, mma, work,
             library) in cases:
            row = {"at": name, "shape": list(shape), "n_valid": n_valid,
                   **errors_of(outputs)}
            row["ms"] = kernel_ms(kernel_fn)
            row["plain_ms"] = plain_ms(plain_fn)
            row["host_us"] = host_us(kernel_fn)
            if mma is not None:
                row.update(baseline_errors(mma[0]))
                row["mma_ms"] = kernel_ms(mma[1])
            flops, _ = F.attention_kernel_work(work, shape[0], shape[1],
                                               real, shape[2], shape[3])
            row["tflops"] = flops / row["ms"] / 1e9
            row.update(bound(F, work, shape, real))
            row["library_ms"] = library
            rows[kname].append(row)
            print_row(kname, name, shape, row)
        del (q, k, v, dout, out, lse, ref_out, ref_lse, delta, dk, dv, dq,
             ref_dk, ref_dv, ref_dq, pair, mma_fwd, mma_dk, mma_dv, mma_dq,
             cases, bwd_args, pair_args, lib)
        torch.cuda.empty_cache()
    return rows


def ring_kernels_vs_plain(torch, fa, ring, fp, F):
    """Phase 2c: ({kernel name: [row per case]}, the split-and-merge row).
    Each backward kernel gets the plain stats' global lse and delta. P^T dO
    has its own cases (pt_do_vs_plain)."""
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
        # (kernel, case, outputs, kernel fn, plain fn, mma.sync baseline fn
        # or None, bound, library ms); the fp32 dK/dV and dQ have no single
        # PyTorch call of their own
        cases = [
            ("flash_attn_fwd_stats", at, ("acc", "m", "l"),
             lambda: ring.flash_attention_stats(q, k, v),
             lambda: ring.flash_attention_stats_plain(q, k, v),
             lambda: fp.flash_attention_stats_mma(q, k, v),
             bound(F, "fwd_stats", shape, n),
             library_fwd_lse_ms(torch, *lib)),
            ("flash_attn_fwd_stats", at + "_v_is_k", ("acc", "m", "l"),
             lambda: ring.flash_attention_stats(q, k, k),
             lambda: ring.flash_attention_stats_plain(q, k, k),
             lambda: fp.flash_attention_stats_mma(q, k, k),
             bound(F, "fwd_stats", shape, n, v_is_k=True),
             library_fwd_lse_ms(torch, lib[0], lib[1], lib[1])),
            ("flash_attn_bwd_dkv_f32", at, ("dk", "dv"),
             lambda: fa.flash_attention_dkv(*bwd, out_dtype=f32),
             lambda: fa.flash_attention_dkv_plain(*bwd, out_dtype=f32),
             lambda: fp.flash_attention_dkv_mma(*bwd, out_dtype=f32),
             bound(F, "dkv", shape, n, out_bytes=4), None),
            ("flash_attn_bwd_dq_f32", at, ("dq",),
             lambda: fa.flash_attention_dq(*bwd, out_dtype=f32),
             lambda: fa.flash_attention_dq_plain(*bwd, out_dtype=f32),
             lambda: fp.flash_attention_dq_mma(*bwd, out_dtype=f32),
             bound(F, "dq", shape, n, out_bytes=4), None),
        ]
        for (kname, case, names, kernel_fn, plain_fn, mma_fn, cost,
             library) in cases:
            got, ref = kernel_fn(), plain_fn()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for oname, a in zip(names, got):
                if a.dtype != f32:
                    return rows, merge, f"{kname} {case}: {oname} {a.dtype}"
            row = {"at": case, "shape": list(shape),
                   **errors_of(dict(zip(names, zip(got, ref))))}
            if mma_fn is not None:
                base = mma_fn()
                base = base if isinstance(base, tuple) else (base,)
                row.update(baseline_errors(dict(zip(names, zip(base, ref)))))
                del base
            del got, ref
            row["ms"] = kernel_ms(kernel_fn)
            row["plain_ms"] = plain_ms(plain_fn)
            row["host_us"] = host_us(kernel_fn)
            if mma_fn is not None:
                row["mma_ms"] = kernel_ms(mma_fn)
            row.update(cost)
            row["library_ms"] = library
            rows[kname].append(row)
            print_row(kname, case, shape, row)
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


def pt_do_vs_plain(torch, ring, fp, F):
    """Phase 2c, B8: [row per case]. P^T dO against its plain twin and its
    mma.sync baseline at the ring's shards and at PT_DO_RAGGED, q and k the
    views of one fused tensor, lse the plain stats' (q against those
    keys)."""
    rows = []
    cases = ([(at, shape, shape[1], False) for at, shape in RING_SHAPES]
             + [(*PT_DO_RAGGED, True)])
    for i, (at, shape, nk, inf_rows) in enumerate(cases):
        b, nq, h, d = shape
        gen = torch.Generator(device="cuda").manual_seed(700 + i)
        qkv = torch.randn((b, max(nq, nk), 3, h, d), generator=gen,
                          device="cuda").to(torch.bfloat16)
        q, k = qkv[:, :nq, 0], qkv[:, :nk, 1]
        dout = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        acc, m, l = ring.flash_attention_stats_plain(q, k, k)
        lse = (m + torch.log2(l)).transpose(1, 2).contiguous()
        del acc, m, l
        if inf_rows:
            lse[..., ::7] = torch.inf

        def kernel_fn():
            return ring.flash_attention_pt_do(q, k, dout, lse)

        def plain_fn():
            return ring.flash_attention_pt_do_plain(q, k, dout, lse)

        def mma_fn():
            return fp.flash_attention_pt_do_mma(q, k, dout, lse)

        got, ref, base = kernel_fn(), plain_fn(), mma_fn()
        torch.cuda.synchronize()
        row = {"at": at, "shape": list(shape), "nk": nk,
               "lse_inf_rows": "every 7th" if inf_rows else "none",
               **errors_of({"out": (got, ref)}),
               **baseline_errors({"out": (base, ref)})}
        del got, base
        row["ms"] = kernel_ms(kernel_fn)
        row["mma_ms"] = kernel_ms(mma_fn)
        row["speedup_vs_mma"] = row["mma_ms"] / row["ms"]
        row["plain_ms"] = plain_ms(plain_fn)
        row["host_us"] = host_us(kernel_fn)
        flops, _ = F.attention_kernel_work("pt_do", b, nq, nk, h, d)
        row["tflops"] = flops / row["ms"] / 1e9
        row.update(bound(F, "pt_do", shape, nk))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["library_ms"] = None
        rows.append(row)
        print_row("flash_attn_bwd_pt_do", at, shape, row)
        print(f"  {row['speedup_vs_mma']:.2f}x the mma.sync baseline, "
              f"{row['bound_share']:.3f} of the bound", flush=True)
        del qkv, q, k, dout, lse, ref
        torch.cuda.empty_cache()
    return rows


# phase 2d holds every probe case at one shape: the 2-view global layer
PROBE_SHAPE = ("global_2view", (1, 2816, 16, 64), 2739)


def probes_vs_plain(torch, fa, fp, F):
    """Phase 2d: {case: row}, every probe of perf/flash_probes.py once
    against its plain version, with its device time."""
    at, shape, n_valid = PROBE_SHAPE
    q, k, v = attention_inputs(torch, shape, n_valid, seed=600)
    contig = [x.contiguous() for x in (q, k, v)]
    plain = fa.flash_attention_plain
    cases = {name: (lambda name=name: fp.flash_probe(name, q, k, v, n_valid),
                    spec[1]) for name, spec in fp.VARIANTS.items()}
    for g in (2, 4):
        cases[f"main_G{g}"] = (lambda g=g: fp.flash_probe(
            "main", q, k, v, n_valid, heads_per_block=g), plain)
    cases["main_persistent"] = (lambda: fp.flash_probe(
        "main", q, k, v, n_valid, persistent_blocks=132), plain)
    cases["layout_bnhd"] = (lambda: fp.flash_probe("main", *contig, n_valid),
                            plain)
    cases["layout_bhnd"] = (lambda: fp.flash_probe(
        "main", *contig, n_valid, layout="bhnd"), plain)
    cost = bound(F, "fwd", shape, n_valid)
    lib = library_fwd_ms(torch, *sdpa_layout(q, k, v, n_valid))
    flops = fa.attention_flops(shape[0], shape[1], n_valid, shape[2],
                               shape[3])
    refs, ref_ms, rows = {}, {}, {}
    for case, (fn, plain_fn) in cases.items():
        if plain_fn not in refs:
            refs[plain_fn] = plain_fn(q, k, v, n_valid)[:, :n_valid].float()
            ref_ms[plain_fn] = plain_ms(lambda: plain_fn(q, k, v, n_valid))
        got = fn()[:, :n_valid].float()
        torch.cuda.synchronize()
        ref = refs[plain_fn]
        row = {"at": at, "shape": list(shape), "n_valid": n_valid,
               "max_abs_err": float((got - ref).abs().max()),
               "max_abs_rel": max_abs_rel(got, ref),
               "rel_l2": rel_l2(got, ref), "ms": kernel_ms(fn),
               "plain_ms": ref_ms[plain_fn], "library_ms": lib, **cost}
        row["tflops"] = flops / row["ms"] / 1e9
        rows[case] = row
        print(f"probe {case} {at}: max_abs_rel={row['max_abs_rel']:.3e} "
              f"rel_l2={row['rel_l2']:.3e} {row['ms']:.4f} ms "
              f"({row['tflops']:.1f} TFLOP/s) plain {row['plain_ms']:.4f} ms",
              flush=True)
        del got
    del q, k, v, contig, refs
    torch.cuda.empty_cache()
    return rows


def probe_replaces(fp, case: str) -> str:
    """The TPU probe (file:line) a phase-2d case stands in for."""
    if case.startswith("main_G"):
        return fp.REPLACES["heads_per_block"]
    if case.startswith("main_persistent"):
        return fp.REPLACES["persistent"]
    return fp.REPLACES[case]


def untouched_baseline(fp) -> str | None:
    """None if no probe and no mma.sync baseline entry was launched since
    the last fp.reset_probe_counts()."""
    used = {key: val for key, val in fp.probe_counts.items() if val}
    return f"probe or baseline launches on the main path: {used}" if used \
        else None


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


def check_outputs(out, num_views, torch, batch=1) -> str | None:
    expect = {
        "pts3d": (batch, 518, 518, 3), "depth_along_ray": (batch, 518, 518, 1),
        "intrinsics": (batch, 3, 3), "camera_poses": (batch, 4, 4),
        "conf": (batch, 518, 518), "mask": (batch, 518, 518, 1),
        "metric_scaling_factor": (batch,),
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


def profile_calls(torch, call, wall_ms, calls: int = 3, match=None) -> dict:
    """Device time per `call()` from torch.profiler, and its share of
    `wall_ms`, the median wall time of the untraced calls
    (perf/timing.py::profile_calls)."""
    from mapanything_tpu_torch.perf.timing import profile_calls as profile

    return profile(call, wall_ms, calls, match)


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
        if i == 0:  # the seeded init's loss, phase 6's reference
            res["first_step_loss"] = float(m["loss"])
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
    bad = check_outputs(out, len(views), torch)
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


def run_view_sharded_training(torch, fa, T, SP, compare_sharded, model,
                              make_synthetic_batch, geom_cfg, group,
                              first_step_loss):
    """Phase 6: the view-sharded train step (train/seq_parallel.py) on
    `group` at full width, 1 x 4 views x 518^2, on a model with phase 4's
    seeded init and phase 4's batch. Returns (results, failure or None)."""
    batch = make_synthetic_batch(1, 4, 518, 518, seed=0)
    res = {"batch": "1 x 4 views x 518 x 518",
           "ranks": torch.distributed.get_world_size(group)}
    # against the unsharded loss and gradient of the same model and batch
    cmp = compare_sharded(model, batch, group)
    res["vs_unsharded"] = cmp
    if not cmp["loss_rel_diff"] <= ERR_LIMIT:
        return res, f"loss against the unsharded {cmp['loss_rel_diff']:.3e}"
    if not cmp["grad_rel_l2"] <= GRAD_LIMIT:
        return res, f"gradient against the unsharded {cmp['grad_rel_l2']:.3e}"
    state = T.create_train_state(
        model, T.OptimConfig(warmup_steps=2, total_steps=100))
    step = SP.make_view_sharded_train_step(model, geom_cfg, group=group)
    want = dict.fromkeys(fa.KERNELS, 0) | VS_STEP_LAUNCHES
    torch.cuda.reset_peak_memory_stats()
    times, losses, norms, launches = [], [], [], dict.fromkeys(fa.KERNELS, 0)
    for i in range(VS_WARMUP + VS_STEPS):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = dict(fa.flash_attention.kernel_counts)
        plain = fa.flash_attention.plain_launches
        if counts != want or plain != 0:
            return res, (f"step {i}: kernel launches {counts} and {plain} "
                         f"plain, expected {want} and 0")
        launches = {key: launches[key] + counts[key] for key in launches}
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if not (math.isfinite(losses[-1]) and math.isfinite(norms[-1])):
            return res, f"step {i}: loss {losses[-1]} grad_norm {norms[-1]}"
        if i >= VS_WARMUP:
            times.append(wall)
    # the first step runs at lr 0 on the seeded init: phase 4's first loss
    res["first_step_loss_rel_diff"] = (abs(losses[0] - first_step_loss)
                                       / abs(first_step_loss))
    step_ms = statistics.median(times)
    res.update({"steps": VS_WARMUP + VS_STEPS, "step_ms": step_ms,
                "step_ms_all": times, "loss": losses, "grad_norm": norms,
                "launches": launches,
                "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    if not res["first_step_loss_rel_diff"] <= ERR_LIMIT:
        return res, (f"first step's loss {losses[0]} against phase 4's "
                     f"{first_step_loss}")
    res["profile"] = profile_calls(torch, lambda: step(state, batch),
                                   step_ms, calls=2,
                                   match={"pt_do": "pt_do_sm90"})
    res["pt_do_device_ms_per_step"] = res["profile"].get(
        "matched_ms", {}).get("pt_do")
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


def many_view_shape(views: int):
    """(B, N, H, D) and n_valid of the trunk's global layer at `views`
    views of 518^2: every view's patches and the scale token, padded to a
    multiple of 128."""
    n_valid = views * PATCHES + 1
    return (1, -(-n_valid // 128) * 128, 16, 64), n_valid


def b2_sampled(torch, fa, F, views: int):
    """B2 (the online-softmax forward) at the global shape of `views` views:
    the kernel over every row against its plain version on the first and
    the last SAMPLE_ROWS real rows, each against all keys (the plain
    version of all rows would hold a (1, 16, N, N) fp32 score matrix); its
    device time, bound, flash SDPA's time and host µs."""
    shape, n_valid = many_view_shape(views)
    q, k, v = attention_inputs(torch, shape, n_valid, seed=300 + views)
    rows = torch.cat([torch.arange(SAMPLE_ROWS),
                      torch.arange(n_valid - SAMPLE_ROWS, n_valid)]).cuda()
    out = fa.flash_attention(q, k, v, n_valid)
    q_rows = q[:, rows]
    ref = fa.flash_attention_plain(q_rows, k, v, n_valid).float()
    got = out[:, rows].float()
    torch.cuda.synchronize()
    row = {"at": f"global_{views}view", "shape": list(shape),
           "n_valid": n_valid, "sampled_rows": 2 * SAMPLE_ROWS,
           "max_abs_err": float((got - ref).abs().max()),
           "rel_l2": rel_l2(got, ref),
           "ms": kernel_ms(lambda: fa.flash_attention(q, k, v, n_valid)),
           "plain_ms": plain_ms(
               lambda: fa.flash_attention_plain(q_rows, k, v, n_valid)),
           "plain_ms_of": f"the {2 * SAMPLE_ROWS} sampled rows only",
           "host_us": host_us(
               lambda: fa._fwd_cuda(q, k, v, n_valid, with_lse=False))}
    flops = fa.attention_flops(shape[0], shape[1], n_valid, shape[2],
                               shape[3])
    row["tflops"] = flops / row["ms"] / 1e9
    row.update(bound(F, "fwd", shape, n_valid))
    row["library_ms"] = library_fwd_ms(torch, *sdpa_layout(q, k, v, n_valid))
    print(f"B2 {row['at']} {tuple(shape)} n_valid={n_valid}: max_abs="
          f"{row['max_abs_err']:.3e} rel_l2={row['rel_l2']:.3e} on "
          f"{2 * SAMPLE_ROWS} rows; kernel {row['ms']:.4f} ms "
          f"({row['tflops']:.1f} TFLOP/s) bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}) flash SDPA {row['library_ms']:.4f} ms plain "
          f"(sampled rows) {row['plain_ms']:.4f} ms host "
          f"{row['host_us']:.1f} us", flush=True)
    del q, k, v, out, q_rows, ref, got
    torch.cuda.empty_cache()
    bad = (None if row["max_abs_err"] <= ERR_LIMIT
           and row["rel_l2"] <= ERR_LIMIT
           else f"B2 disagrees with plain at {row['at']}: {row}")
    return row, bad


def timed_infer(torch, fa, pipe, views, calls, **kw):
    """`calls` timed infer calls after one warm-up: median wall ms, the
    launches they made (counts zeroed just before), peak memory, and a
    torch.profiler trace of one more call. Returns (res, last outputs,
    failure or None)."""
    pipe.infer(views, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    times, out = [], None
    for _ in range(calls):
        out = None  # the peak is one call's, not two calls' outputs
        t0 = time.perf_counter()
        out = pipe.infer(views, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = dict(fa.flash_attention.kernel_counts)
    plain = fa.flash_attention.plain_launches
    wall = statistics.median(times)
    batch = len(views[0]["img"])
    res = {"views": len(views), "batch": batch, "calls": calls,
           "wall_ms": wall, "wall_ms_all": times,
           "views_per_s": batch * len(views) / wall * 1e3,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "kernel_counts": counts, "plain_launches": plain}
    bad = check_outputs(out, len(views), torch, batch)
    want = dict.fromkeys(fa.KERNELS, 0) | {"fwd": FORWARD_LAUNCHES * calls}
    if not bad and (counts != want or plain != 0):
        bad = (f"kernel launches {counts} and {plain} plain in {calls} "
               f"forwards, expected {want} and 0")
    if not bad:
        res["profile"] = profile_calls(torch, lambda: pipe.infer(views, **kw),
                                       wall, calls=1)
    return res, out, bad


def outputs_rel_l2(a, b, torch) -> dict:
    """pts3d and depth_along_ray rel-L2 over every view of two infer
    results."""
    return {f"{key}_rel_l2": rel_l2(torch.stack([x[key] for x in a]),
                                    torch.stack([y[key] for y in b]))
            for key in ("pts3d", "depth_along_ray")}


def fusion_check(torch, model, pipe, views, MapAnything, MapAnythingConfig,
                 PI, PRIOR_ENCODERS):
    """The features the card's forward fed the fusion LayerNorm against the
    same fusion in fp32 on the CPU (the six encoders copied there), from the
    card's own encoder output: fails if the priors were dropped or fused
    wrongly. Also the priors' share: |fused - encoder| over |encoder|."""
    import copy

    seen = {}
    hooks = [model.encoder.register_forward_hook(
                 lambda mod, args, out: seen.__setitem__("enc", out)),
             model.fusion_norm.register_forward_pre_hook(
                 lambda mod, args: seen.__setitem__("fused", args[0]))]
    try:
        pipe.infer(views, apply_mask=False)
    finally:
        for h in hooks:
            h.remove()
    cpu_views = PI.stack_views(PI.preprocess_input_views_for_inference(views))
    cpu = MapAnything(MapAnythingConfig(), device="meta")
    for name in PRIOR_ENCODERS:
        setattr(cpu, name, copy.deepcopy(getattr(model, name)).cpu())
    got = seen["fused"].float().cpu()
    enc = seen["enc"].float().cpu().reshape(got.shape)
    with torch.inference_mode():
        ref = cpu.fuse_geometric_priors(enc, cpu_views,
                                        PI.geometric_input_config(cpu_views))
    res = {"fused_max_abs_rel": max_abs_rel(got, ref),
           "fused_rel_l2": rel_l2(got, ref),
           "encoder_norm": float(enc.norm()),
           "prior_norm": float((ref - enc).norm())}
    res["prior_share"] = res["prior_norm"] / res["encoder_norm"]
    if not res["fused_max_abs_rel"] <= FUSION_LIMIT:
        return res, (f"fused features on the card against the CPU's: "
                     f"{res['fused_max_abs_rel']:.3e}")
    if not res["prior_share"] >= 1e-2:
        return res, f"the priors barely reach the features: {res}"
    return res, None


def run_priors(torch, fa, model, pipe, views, fusion):
    """Phase 7a, BASELINE config 3: 4 views with intrinsics, 4x4 poses and
    the metric flag."""
    res, out, bad = timed_infer(torch, fa, pipe, views, PRIOR_CALLS,
                                apply_mask=True, mask_edges=True)
    if bad:
        return res, bad
    res["fusion"], bad = fusion()
    if bad:
        return res, bad
    flash = pipe.infer(views, apply_mask=False)
    model.set_attn_impl("math")
    try:
        math_out = pipe.infer(views, apply_mask=False)
    finally:
        model.set_attn_impl("auto")
    res["vs_math"] = outputs_rel_l2(flash, math_out, torch)
    bad = {k: v for k, v in res["vs_math"].items() if not v <= ERR_LIMIT}
    return res, (f"flash against math attention: {bad}" if bad else None)


def run_many_views(torch, fa, pipe, views, calls, programs):
    """Phase 7b/7c: each program ("auto", True) timed with the confidence
    mask; returns ({program: res}, {program: last outputs}, failure)."""
    res, outs = {}, {}
    for prog in programs:
        res[str(prog)], outs[prog], bad = timed_infer(
            torch, fa, pipe, views, calls, memory_efficient_inference=prog,
            apply_confidence_mask=True, confidence_percentile=CONF_PERCENTILE)
        kept = sum(int(o["mask"].sum()) for o in outs[prog])
        res[str(prog)]["mask_share"] = kept / (len(views) * 518 * 518)
        print(f"  {len(views)} views, memory_efficient_inference={prog!r}: "
              f"{json.dumps(res[str(prog)])}", flush=True)
        if bad:
            return res, outs, f"memory_efficient_inference={prog!r}: {bad}"
    return res, outs, None


def colmap_export_check(torch, out, views, demo_colmap, colmap_io):
    """demo_colmap's export of `out` into a temporary directory, read back:
    one camera and one image per view, points, orthonormal rotations."""
    import numpy as np

    with tempfile.TemporaryDirectory() as folder:
        t0 = time.perf_counter()
        exp = demo_colmap.export_predictions(
            out, demo_colmap.view_names(views), folder)
        sparse = exp["sparse_dir"]
        cams = colmap_io.read_cameras_bin(os.path.join(sparse, "cameras.bin"))
        imgs = colmap_io.read_images_bin(os.path.join(sparse, "images.bin"))
        pts, _ = colmap_io.read_points3d_bin(
            os.path.join(sparse, "points3D.bin"))
        secs = time.perf_counter() - t0
    # each stored rotation: a unit quaternion whose matrix is orthonormal
    # and is the transpose of the predicted camera-to-world rotation
    unit = max(abs(float(np.linalg.norm(im["qvec"])) - 1) for im in imgs)
    rots = [colmap_io.quaternion_wxyz_to_matrix_np(im["qvec"]) for im in imgs]
    ortho = max(float(np.abs(r @ r.T - np.eye(3)).max()) for r in rots)
    vs_pred = max(float(np.abs(
        r.T - o["camera_poses"][0, :3, :3].double().cpu().numpy()).max())
        for r, o in zip(rots, out))
    res = {"cameras": len(cams), "images": len(imgs), "points": len(pts),
           "quaternion_unit_err": unit, "rotation_orthonormal_err": ortho,
           "rotation_vs_prediction_err": vs_pred, "seconds": secs}
    n = len(views)
    if (len(cams), len(imgs)) != (n, n) or not 0 < len(pts) == exp["points"]:
        return res, f"COLMAP model read back: {res}"
    if not (max(unit, ortho, vs_pred) <= 1e-4 and np.isfinite(pts).all()):
        return res, f"COLMAP poses or points: {res}"
    return res, None


def serving_api(torch, fa, F, fp, model, load_images):
    """Phase 7: BASELINE configs 3, 4 and 5 through InferencePipeline.infer
    on `model`. Returns (the kernel counts of each timed run, the B2 rows
    at 32 and 100 views, failure or None)."""
    from mapanything_tpu_torch import demo_colmap
    from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
    from mapanything_tpu_torch.models.mapanything import PRIOR_ENCODERS
    from mapanything_tpu_torch.parallel import ring_check as RC
    from mapanything_tpu_torch.utils import colmap_io
    from mapanything_tpu_torch.utils import inference as PI

    pipe = PI.InferencePipeline(model)
    counts = []
    with tempfile.TemporaryDirectory() as folder:
        # 7a, config 3: intrinsics, 4x4 poses, metric scale on 4 views
        views = RC.config3_views(load_images(write_images(folder,
                                                          PRIOR_VIEWS)))
        priors, bad = run_priors(
            torch, fa, model, pipe, views,
            lambda: fusion_check(torch, model, pipe, views, MapAnything,
                                 MapAnythingConfig, PI, PRIOR_ENCODERS))
        print(f"config 3, {PRIOR_VIEWS} views with intrinsics and poses: "
              f"{json.dumps(priors)}", flush=True)
        if bad:
            return counts, [], f"config 3: {bad}"
        counts.append(priors["kernel_counts"])

        many, b2_rows = {}, []
        for num_views, calls in MANY_VIEWS.items():
            # 7b, config 4 (32 views): "auto" (unchunked at 80 GB) against
            # the chunked program; 7c, config 5 (100 views): chunked, then
            # "auto"
            views = load_images(write_images(folder, num_views))
            programs = ("auto", True) if num_views == 32 else (True, "auto")
            res, outs, bad = run_many_views(torch, fa, pipe, views, calls,
                                            programs)
            many[num_views] = res
            if bad:
                return counts, b2_rows, f"{num_views} views: {bad}"
            counts += [res[str(prog)]["kernel_counts"] for prog in programs]
            if num_views == 32:
                res["auto_vs_memory_efficient"] = outputs_rel_l2(
                    pipe.infer(views, apply_mask=False),
                    pipe.infer(views, apply_mask=False,
                               memory_efficient_inference=True), torch)
                print(f"  32 views, auto against memory_efficient: "
                      f"{json.dumps(res['auto_vs_memory_efficient'])}",
                      flush=True)
                bad = {k: v for k, v in res["auto_vs_memory_efficient"].items()
                       if not v <= ERR_LIMIT}
                if bad:
                    return counts, b2_rows, (f"32 views, auto against "
                                             f"chunked: {bad}")
            else:
                res["colmap"], bad = colmap_export_check(
                    torch, outs[True], views, demo_colmap, colmap_io)
                print(f"  100 views, COLMAP export of the chunked call: "
                      f"{json.dumps(res['colmap'])}", flush=True)
                if bad:
                    return counts, b2_rows, f"100 views: {bad}"
            del outs, views
            torch.cuda.empty_cache()
            row, bad = b2_sampled(torch, fa, F, num_views)
            if bad:
                return counts, b2_rows, bad
            row["launches_per_infer"] = 12
            b2_rows.append((row["at"], row))
    bad = untouched_baseline(fp)
    if bad:
        return counts, b2_rows, f"configs 3-5: {bad}"
    for num_views, res in many.items():
        for prog in ("auto", "True"):
            r = res[prog]
            prof = r.get("profile", {})
            print(f"config {4 if num_views == 32 else 5}, {num_views} views, "
                  f"memory_efficient_inference={prog}: wall {r['wall_ms']:.2f}"
                  f" ms ({r['views_per_s']:.2f} views/s), device "
                  f"{prof.get('device_ms', float('nan')):.2f} ms, busy "
                  f"{prof.get('busy_share', float('nan')):.3f}, peak "
                  f"{r['peak_memory_gib']:.2f} GiB", flush=True)
    return counts, b2_rows, None


# phase 8: training with geometric priors, at full width and depth
TRAIN_LAUNCHES = {"fwd_lse": FORWARD_LAUNCHES, "dkv": FORWARD_LAUNCHES,
                  "dq": FORWARD_LAUNCHES}
# with encoder and trunk checkpointing each of the 48 attentions launches
# its forward with lse again in the backward's recompute
CKPT_LAUNCHES = {"fwd_lse": 2 * FORWARD_LAUNCHES, "dkv": FORWARD_LAUNCHES,
                 "dq": FORWARD_LAUNCHES}
STAGE2_VIEWS = 24  # the stage-2 recipe's views per sample (BASELINE.md)
CKPT_LOSS_LIMIT, CKPT_GRAD_LIMIT = 1e-5, 1e-3
RESUME_LIMIT = 1e-3
MASK_SEED = 8  # the generator of phase 8's stochastic steps
CHECKPOINT_WRITES = 5


def seeded_model(torch, MapAnything, MapAnythingConfig, **flags):
    """Phase 4's model: the released config, its own init from seed 1."""
    return MapAnything(MapAnythingConfig(**flags), generator=torch.Generator(
        device="cuda").manual_seed(1))


def launches_of(fa) -> dict:
    return dict(fa.flash_attention.kernel_counts)


def expect_launches(fa, want: dict, what: str) -> str | None:
    counts, plain = launches_of(fa), fa.flash_attention.plain_launches
    full = dict.fromkeys(fa.KERNELS, 0) | want
    if counts != full or plain != 0:
        return (f"{what}: kernel launches {counts} and {plain} plain, "
                f"expected {full} and 0")
    return None


def add_counts(total: dict, counts: dict) -> dict:
    return {key: total.get(key, 0) + val for key, val in counts.items()}


def mask_shares(torch, draw_prior_masks, geom_cfg, states, views) -> dict:
    """How often each mask of `geom_cfg` was on over the steps whose
    generator states (before the step) are `states`: the draws replayed."""
    gen = torch.Generator(device="cuda")
    shares = {}
    for state in states:
        gen.set_state(state)
        masks = draw_prior_masks(geom_cfg, 1, views, "cuda", gen, (518, 518))
        for key, m in masks.items():
            shares.setdefault(key, []).append(float(m.float().mean()))
    return {key: sum(vals) / len(vals) for key, vals in shares.items()}


def aug_training_steps(torch, fa, T, model, batch, geom_cfg, draw_prior_masks,
                       warmup: int = 2, steps: int = TRAIN_STEPS):
    """Phase 8a: the aug_training step at 1 x 4 views, its masks from a
    CUDA generator. Returns (results, launches, failure or None)."""
    state = T.create_train_state(
        model, T.OptimConfig(warmup_steps=2, total_steps=100))
    step = T.make_train_step(model, geom_cfg)
    gen = torch.Generator(device="cuda").manual_seed(MASK_SEED)
    torch.cuda.reset_peak_memory_stats()
    res, launches = {"batch": "1 x 4 views x 518 x 518, every prior"}, {}
    times, losses, states = [], [], []
    for i in range(warmup + steps):
        states.append(gen.get_state())
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        bad = expect_launches(fa, TRAIN_LAUNCHES, f"aug_training step {i}")
        if bad:
            return res, launches, bad
        launches = add_counts(launches, launches_of(fa))
        losses.append(float(m["loss"]))
        if not (math.isfinite(losses[-1])
                and finite(m["grad_norm"], torch)):
            return res, launches, f"step {i}: loss {losses[-1]}"
        if i >= warmup:
            times.append(wall)
    step_ms = statistics.median(times)
    res.update({"steps": warmup + steps, "step_ms": step_ms,
                "step_ms_all": times, "loss": losses,
                "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                "mask_on_share": mask_shares(torch, draw_prior_masks,
                                             geom_cfg, states, 4)})
    res["profile"] = profile_calls(torch, lambda: step(state, batch, gen),
                                   step_ms, calls=2)
    return res, launches, None


def preset_gradient(torch, model, make_synthetic_batch, compare, task_config):
    """Phase 8a, second part: grad_check.compare with every prior on
    (pass_through), phase 4's 1-view batch, flash against math, gated as
    phase 4 (two views' three math-attention graphs do not fit in 80 GB
    beside each other)."""
    batch = make_synthetic_batch(1, 1, 518, 518, seed=1)
    res = compare(model, batch, geom_cfg=task_config("pass_through"))
    res = {key: val for key, val in res.items() if key != "terms"}
    if not res["loss_rel_diff"] <= ERR_LIMIT:
        return res, f"pass_through loss flash vs math {res['loss_rel_diff']}"
    for key in ("grad_rel_l2", "qkv_grad_rel_l2"):
        if not res[key] <= GRAD_LIMIT:
            return res, f"pass_through {key} {res[key]:.3e}"
    return res, None


@contextlib.contextmanager
def deterministic(torch):
    """torch.use_deterministic_algorithms inside the block (main() sets
    CUBLAS_WORKSPACE_CONFIG before the first GEMM): the atomics of the
    bilinear upsample's backward otherwise leave two identical backward
    passes ~1e-3 apart in rel-L2 (phase 8b prints that run-to-run
    reading beside the gate)."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def checkpointing_check(torch, fa, T, make_model, batch, geom_cfg):
    """Phase 8b, first part: one forward and backward (loss_and_grads) of
    the model with and without encoder and trunk checkpointing, the same
    state and generator seed: each twice as training runs them (the second
    timed, with its peak memory; the two plain calls' gradients give the
    run-to-run floor), then once each with deterministic algorithms, held
    to the limits. Returns (results, launches, failure or None)."""
    plain = make_model()
    ckpt = make_model(encoder_gradient_checkpointing=True,
                      trunk_gradient_checkpointing=True)
    ckpt.load_state_dict(plain.state_dict())
    models = {"plain": (plain, TRAIN_LAUNCHES),
              "checkpointed": (ckpt, CKPT_LAUNCHES)}
    res, launches = {}, {}

    def call(name):
        """(loss, flat gradient, wall ms) of one forward and backward."""
        nonlocal launches
        model, want = models[name]
        params = list(model.parameters())
        gen = torch.Generator(device="cuda").manual_seed(MASK_SEED)
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss, _, grads = T.loss_and_grads(T.make_loss_fn(model, geom_cfg),
                                          params, batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        bad = expect_launches(fa, want, f"{name} forward and backward")
        launches = add_counts(launches, launches_of(fa))
        flat = torch.cat([g.flatten() for g in grads])
        for p in params:
            p.grad = None
        return loss, flat, wall, bad

    for name in models:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        flats = []
        for _ in range(2):
            loss, flat, wall, bad = call(name)
            if bad:
                return res, launches, bad
            flats.append(flat)
            del flat
        res[name] = {"wall_ms": wall, "loss": float(loss),
                     "peak_memory_gib":
                     torch.cuda.max_memory_allocated() / 2**30,
                     "grad_run_to_run_rel_l2": rel_l2(flats[1], flats[0])}
        del flats
    with deterministic(torch):
        (loss_p, grad_p, _, bad_p), (loss_c, grad_c, _, bad_c) = (
            call("plain"), call("checkpointed"))
    if bad_p or bad_c:
        return res, launches, bad_p or bad_c
    res["loss_rel_diff"] = float((loss_c - loss_p).abs() / loss_p.abs())
    res["grad_rel_l2"] = rel_l2(grad_c, grad_p)
    del grad_p, grad_c, models, plain, ckpt
    torch.cuda.empty_cache()
    if not res["loss_rel_diff"] <= CKPT_LOSS_LIMIT:
        return res, launches, f"checkpointed loss {res['loss_rel_diff']:.3e}"
    if not res["grad_rel_l2"] <= CKPT_GRAD_LIMIT:
        return res, launches, (f"checkpointed gradient rel-L2 "
                               f"{res['grad_rel_l2']:.3e}")
    return res, launches, None


def stage2_steps(torch, fa, T, make_model, make_synthetic_batch, geom_cfg,
                 F):
    """Phase 8b, second part: the aug_training step at 1 x 24 views x 518^2
    with encoder and trunk checkpointing: 1 warm-up and 2 timed steps.
    Returns (results, launches, failure or None)."""
    model = make_model(encoder_gradient_checkpointing=True,
                       trunk_gradient_checkpointing=True)
    batch = make_synthetic_batch(1, STAGE2_VIEWS, 518, 518, seed=3)
    state = T.create_train_state(
        model, T.OptimConfig(warmup_steps=2, total_steps=100))
    step = T.make_train_step(model, geom_cfg)
    gen = torch.Generator(device="cuda").manual_seed(MASK_SEED)
    n, n_valid = many_view_shape(STAGE2_VIEWS)
    res = {"batch": f"1 x {STAGE2_VIEWS} views x 518 x 518",
           "global_attention": [list(n), n_valid]}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], {}
    for i in range(3):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        bad = expect_launches(fa, CKPT_LAUNCHES, f"{STAGE2_VIEWS}-view step")
        if bad:
            return res, launches, bad
        launches = add_counts(launches, launches_of(fa))
        if not math.isfinite(float(m["loss"])):
            return res, launches, f"{STAGE2_VIEWS}-view step {i}: loss"
    res.update({"step_ms_all": times[1:],
                "step_ms": statistics.median(times[1:]),
                "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                "train_step_flops": F.train_step_flops(518, STAGE2_VIEWS)})
    return res, launches, None


class TrainLoader:
    """1 x 2-view synthetic batches on the card; raises Killed at
    (epoch, iter) == kill_at."""

    class Killed(RuntimeError):
        pass

    def __init__(self, make_synthetic_batch, seeds, kill_at=None):
        self.batches = [make_synthetic_batch(1, 2, 518, 518, seed=s)
                        for s in seeds]
        self.kill_at, self.epoch = kill_at, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, batch in enumerate(self.batches):
            if self.kill_at == (self.epoch, i):
                raise self.Killed(f"killed at epoch {self.epoch} iter {i}")
            yield batch


def trainer_check(torch, fa, T, L, make_model, make_synthetic_batch):
    """Phase 8c: train() at full width, 2 epochs of 2 batches and a
    validation loader, uninterrupted and killed at (epoch 1, iter 1) then
    resumed, in a temporary directory; each checkpoint's size and its save
    and load seconds (at most CHECKPOINT_WRITES writes). Returns (results,
    launches, failure or None)."""
    import shutil

    res, timing = {}, {"save": [], "load": []}
    save, load = L.save_train_state, L.load_train_state

    def timed(kind, fn):
        def call(path, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(path, *args, **kw)
            torch.cuda.synchronize()
            timing[kind].append({"file": os.path.basename(path),
                                 "seconds": time.perf_counter() - t0,
                                 "gib": os.path.getsize(path) / 2**30})
            return out
        return call

    model = make_model()
    n_params = sum(p.numel() for p in model.parameters())
    need = 3 * 3 * 4 * n_params  # params + m + v, three files at once
    launches = {}
    with tempfile.TemporaryDirectory() as folder:
        free = shutil.disk_usage(folder).free
        res.update({"params": n_params, "disk_free_gib": free / 2**30,
                    "disk_needed_gib": need / 2**30})
        print(f"phase 8c: {free / 2**30:.1f} GiB free for checkpoints in "
              f"{folder}, {need / 2**30:.1f} GiB needed", flush=True)
        if free < need:
            return res, launches, (
                f"phase 8c needs {need / 2**30:.1f} GiB of free disk for "
                f"its checkpoints and {folder} has {free / 2**30:.1f} GiB")
        seeds, val = (100, 101), TrainLoader(make_synthetic_batch, (200,))
        optim = T.OptimConfig(warmup_steps=2, total_steps=100)
        L.save_train_state = timed("save", save)
        L.load_train_state = timed("load", load)
        try:
            def run(out, loader, model, save_freq):
                cfg = L.TrainLoopConfig(output_dir=os.path.join(folder, out),
                                        epochs=2, print_freq=1,
                                        save_freq=save_freq, eval_freq=2,
                                        seed=0)
                return L.train(model, loader, cfg, optim,
                               test_loaders={"val": val})

            fa.reset_launch_counts()
            t0 = time.perf_counter()
            # the uninterrupted run writes checkpoint-best (epoch 0) and
            # checkpoint-last once, at its end; deterministic algorithms
            # make the two runs' trajectories comparable bit for bit
            with deterministic(torch):
                state_a = run("a", TrainLoader(make_synthetic_batch, seeds),
                              model, save_freq=2)
            res["uninterrupted_s"] = time.perf_counter() - t0
            launches = add_counts(launches, launches_of(fa))
            final_a = torch.cat([p.detach().flatten()
                                 for p in state_a.model.parameters()])
            step_a = (state_a.step, state_a.optimizer.count)
            del state_a, model
            shutil.rmtree(os.path.join(folder, "a"))
            torch.cuda.empty_cache()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                with deterministic(torch):
                    run("b", TrainLoader(make_synthetic_batch, seeds,
                                         kill_at=(1, 1)), make_model(), 1)
                return res, launches, "the killed run was not killed"
            except TrainLoader.Killed:
                pass
            torch.cuda.empty_cache()
            with deterministic(torch):
                state_b = run("b", TrainLoader(make_synthetic_batch, seeds),
                              make_model(), 1)
            res["killed_and_resumed_s"] = time.perf_counter() - t0
            launches = add_counts(launches, launches_of(fa))
        finally:
            L.save_train_state, L.load_train_state = save, load
        final_b = torch.cat([p.detach().flatten()
                             for p in state_b.model.parameters()])
        step_b = (state_b.step, state_b.optimizer.count)
        del state_b
    res.update({"steps": [step_a, step_b],
                "resumed_vs_uninterrupted_rel_l2": rel_l2(final_b, final_a),
                "checkpoints": timing})
    del final_a, final_b
    torch.cuda.empty_cache()
    if step_a != step_b or step_a[0] != 4:
        return res, launches, f"step counts {step_a} and {step_b}"
    if not res["resumed_vs_uninterrupted_rel_l2"] <= RESUME_LIMIT:
        return res, launches, (f"resumed parameters rel-L2 "
                               f"{res['resumed_vs_uninterrupted_rel_l2']}")
    if len(timing["save"]) > CHECKPOINT_WRITES or len(timing["load"]) != 1:
        return res, launches, f"checkpoint writes and loads: {timing}"
    return res, launches, None


def sharded_with_priors(torch, fa, T, SP, RC, compare_sharded, make_model,
                        make_synthetic_batch, geom_cfg, group, views,
                        MapAnything, MapAnythingConfig, random_normal_,
                        InferencePipeline):
    """Phase 8d, at p = 1: config 3 through the view-sharded pipeline
    against the unsharded call, then the view-sharded aug_training step
    against the unsharded one with the same generator seed, and its launch
    counts. Returns (results, launches, failure or None)."""
    model = MapAnything(MapAnythingConfig())
    random_normal_(model)
    model.eval()
    res, launches = {}, {}
    infer, bad = run_ring_slice(torch, fa, RC, model, group,
                                InferencePipeline, views)
    res["config3"] = infer
    if bad:
        return res, launches, f"view-sharded config 3: {bad}"
    launches = add_counts(launches, infer["kernel_counts"])
    del model
    torch.cuda.empty_cache()

    model = make_model()
    batch = make_synthetic_batch(1, 4, 518, 518, seed=0)
    cmp = compare_sharded(model, batch, group, geom_cfg=geom_cfg,
                          seed=MASK_SEED)
    res["step_vs_unsharded"] = cmp
    if not cmp["loss_rel_diff"] <= ERR_LIMIT:
        return res, launches, (f"aug_training loss against the unsharded "
                               f"{cmp['loss_rel_diff']:.3e}")
    if not cmp["grad_rel_l2"] <= GRAD_LIMIT:
        return res, launches, (f"aug_training gradient against the "
                               f"unsharded {cmp['grad_rel_l2']:.3e}")
    state = T.create_train_state(
        model, T.OptimConfig(warmup_steps=2, total_steps=100))
    step = SP.make_view_sharded_train_step(model, geom_cfg, group=group)
    gen = torch.Generator(device="cuda").manual_seed(MASK_SEED)
    times = []
    for i in range(VS_WARMUP + 3):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        bad = expect_launches(fa, VS_STEP_LAUNCHES,
                              f"view-sharded aug_training step {i}")
        if bad:
            return res, launches, bad
        launches = add_counts(launches, launches_of(fa))
        if not math.isfinite(float(m["loss"])):
            return res, launches, f"view-sharded step {i}: loss"
    res["step_ms_all"] = times[VS_WARMUP:]
    res["step_ms"] = statistics.median(times[VS_WARMUP:])
    return res, launches, None


def training_with_priors(torch, fa, fp, F, load_images):
    """Phase 8 (8a-8d). Returns (the kernel counts of its runs, failure or
    None)."""
    from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
    from mapanything_tpu_torch.models import (
        MapAnything,
        MapAnythingConfig,
        aug_training_config,
    )
    from mapanything_tpu_torch.models.mapanything import draw_prior_masks
    from mapanything_tpu_torch.models.tasks import task_config
    from mapanything_tpu_torch.parallel import init_distributed
    from mapanything_tpu_torch.parallel import ring_check as RC
    from mapanything_tpu_torch.train import loop as L
    from mapanything_tpu_torch.train import seq_parallel as SP
    from mapanything_tpu_torch.train import step as T
    from mapanything_tpu_torch.train.grad_check import (
        compare,
        compare_sharded,
    )
    from mapanything_tpu_torch.utils.inference import InferencePipeline
    from mapanything_tpu_torch.utils.weights import random_normal_

    def make_model(**flags):
        return seeded_model(torch, MapAnything, MapAnythingConfig, **flags)

    aug = aug_training_config()
    counts = []

    def report(name, t0, res, launches, bad):
        print(f"phase {name} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(res)}", flush=True)
        if launches:
            counts.append(launches)
        return f"phase {name}: {bad}" if bad else None

    t0 = time.perf_counter()
    model = make_model()
    batch = make_synthetic_batch(1, 4, 518, 518, seed=0)
    res, launches, bad = aug_training_steps(torch, fa, T, model, batch, aug,
                                            draw_prior_masks)
    bad = report("8a, aug_training step 1x4v@518", t0, res, launches, bad)
    if bad:
        return counts, bad
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res, bad = preset_gradient(torch, make_model(), make_synthetic_batch,
                               compare, task_config)
    bad = report("8a, pass_through flash vs math, seeded init", t0, res, {},
                 bad)
    if bad:
        return counts, bad
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res, launches, bad = checkpointing_check(torch, fa, T, make_model, batch,
                                             aug)
    bad = report("8b, checkpointing 1x4v@518", t0, res, launches, bad)
    if bad:
        return counts, bad
    del batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res, launches, bad = stage2_steps(torch, fa, T, make_model,
                                      make_synthetic_batch, aug, F)
    bad = report(f"8b, checkpointed step 1x{STAGE2_VIEWS}v@518", t0, res,
                 launches, bad)
    if bad:
        return counts, bad
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res, launches, bad = trainer_check(torch, fa, T, L, make_model,
                                       make_synthetic_batch)
    bad = report("8c, train() with kill and resume", t0, res, launches, bad)
    if bad:
        return counts, bad
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as folder:
        views = RC.config3_views(load_images(write_images(folder,
                                                          PRIOR_VIEWS)))
    group = init_distributed()
    try:
        res, launches, bad = sharded_with_priors(
            torch, fa, T, SP, RC, compare_sharded, make_model,
            make_synthetic_batch, aug, group, views, MapAnything,
            MapAnythingConfig, random_normal_, InferencePipeline)
    finally:
        torch.distributed.destroy_process_group()
    bad = report("8d, view-sharded with priors, p = 1", t0, res, launches,
                 bad)
    if bad:
        return counts, bad
    return counts, untouched_baseline(fp)


# phase 9: serving through serve.py at full width. The forward at the
# shapes batched and non-square scenes give it (patches = 37 x rows of 14;
# the encoder adds a class token and the global layer the scale token, both
# padded to 128 keys):
SERVING_SHAPES = [
    # 518x392 (37 x 28 = 1036 patches), a batch of 4 scenes of 2 views
    ("encoder_518x392_b4x2", (8, 1152, 16, 64), 1037),
    ("frame_518x392_b4x2", (8, 1036, 16, 64), None),
    ("global_518x392_b4x2", (4, 2176, 16, 64), 2073),
    # 518x168 (37 x 12 = 444 patches), 2 views
    ("encoder_518x168_2view", (2, 512, 16, 64), 445),
    ("global_518x168_2view", (1, 896, 16, 64), 889),
    # 4 views of 518x392: 4145 keys, past the one-pass limit (B2)
    ("global_518x392_4view", (1, 4224, 16, 64), 4145),
]
SERVE_BATCH = 4  # scenes per batched call: bench.py's headline batch
SERVE_CALLS = 5
HTTP_TIMEOUT = 300.0
# the HTTP burst: (raw width, raw height, with intrinsics and depth_z,
# scenes); each scene 2 views
BURST = [(640, 480, False, 4), (480, 640, False, 2), (640, 480, True, 2),
         (1036, 336, False, 1)]
COMPARED = ("pts3d", "depth_z", "camera_poses", "metric_scaling_factor")


def raw_views(w: int, h: int, seed: int, priors: bool) -> dict:
    """Two raw client views of (w, h) as the npz of a request: uint8 images
    (smooth patterns and noise, as write_images), and with `priors`
    intrinsics whose principal point lies off the centre (the crop moves
    it) and a smooth z-depth in metres."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(w, h)
    imgs = []
    for i in range(2):
        base = np.stack([np.sin(6 * xx + seed + i), np.cos(5 * yy - i),
                         np.sin(4 * (xx + yy) + seed)], -1)
        img = 127.5 * (1 + 0.8 * base) + rng.normal(0, 8, base.shape)
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
    arrays = {"images": np.stack(imgs)}
    if priors:
        f = 0.9 * w
        k = np.array([[f, 0, 0.45 * w], [0, f, 0.55 * h], [0, 0, 1]],
                     np.float32)
        arrays["intrinsics"] = np.stack([k, k])
        arrays["depth_z"] = np.stack([
            (2.0 + np.sin(3 * xx + i) + 0.5 * yy).astype(np.float32)
            for i in range(2)])
    return arrays


def npz_body(arrays: dict) -> bytes:
    import io

    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def http_call(url: str, body: bytes | None = None):
    """(status, body bytes, seconds) of a GET (body None) or a POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body,
                                 method="GET" if body is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            status, data = r.status, r.read()
    except urllib.error.HTTPError as e:
        with e:
            status, data = e.code, e.read()
    return status, data, time.perf_counter() - t0


def scene_errors(got, ref, torch) -> dict:
    """Relative error of a served scene (per-view numpy dicts) against a
    solo infer (per-view (1, ...) tensors): rel-L2 over the views for each
    of COMPARED."""
    return {key: rel_l2(torch.stack([torch.as_tensor(g[key]) for g in got]),
                        torch.stack([r[key][0].cpu() for r in ref]))
            for key in COMPARED}


def batched_call(torch, fa, fp, serve, pipe, scenes):
    """9b: SERVE_BATCH scenes queued before the engine starts make exactly
    one batched call (48 forward launches, nothing else), each scene
    within ERR_LIMIT of its solo batch-1 infer. apply_mask=False on both,
    as phase 3 compares: the masks' threshold on near-zero random logits
    flips pixels under any bf16-level change. Returns (results, failure
    or None)."""
    solo = [pipe.infer(s, apply_mask=False) for s in scenes]
    torch.cuda.synchronize()
    engine = serve.BatchingEngine(pipe, max_batch=SERVE_BATCH)
    fa.reset_launch_counts()
    futures = [engine.submit(s, apply_mask=False) for s in scenes]
    engine.start()
    try:
        outs = [f.result(timeout=HTTP_TIMEOUT) for f in futures]
    finally:
        engine.stop()
    stats = engine.stats_dict()
    res = {"stats": stats, "scene_rel_err": [
        scene_errors(o, r, torch) for o, r in zip(outs, solo)]}
    bad = expect_launches(fa, {"fwd": FORWARD_LAUNCHES}, "batched call")
    res["kernel_counts"] = launches_of(fa)
    if stats["batched_calls"] != 1:
        bad = f"{stats['batched_calls']} batched calls, expected 1"
    worst = max(v for e in res["scene_rel_err"] for v in e.values())
    if not bad and not worst <= ERR_LIMIT:
        bad = f"a scene of the batch against its solo infer: {res}"
    return res, bad or untouched_baseline(fp)


def served_checkpoint(torch, serve, save_params, model, folder):
    """9c's server as a user starts it: `model` written with save_params
    into `folder`, then the CLI's composition (serve.build_server prints
    the load seconds). The served model must hold the saved tensors
    bitwise, on the card. Returns (readings, engine, server, failure or
    None); the caller stops the engine and the server."""
    path = os.path.join(folder, "params.pt")
    t0 = time.perf_counter()
    save_params(path, model)
    save_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine, server = serve.build_server(
        ["--checkpoint", path, "--port", "0", "--max-batch", str(SERVE_BATCH)])
    res = {"checkpoint_gib": os.path.getsize(path) / 2**30, "save_s": save_s,
           "build_server_s": time.perf_counter() - t0,
           "loaded_gib": (torch.cuda.memory_allocated() - before) / 2**30,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    served = engine.pipeline.model
    got, want = served.state_dict(), model.state_dict()
    res["bitwise_equal"] = list(got) == list(want) and all(
        torch.equal(got[key], want[key]) for key in want)
    res["device"] = next(served.parameters()).device.type
    if not res["bitwise_equal"] or res["device"] != "cuda":
        return res, engine, server, f"the served model: {res}"
    return res, engine, server, None


def http_burst(torch, fa, serve, pipe, engine, server):
    """9c: over the running `server` and its `engine`: /healthz, a
    concurrent burst (BURST), a malformed body (400) and one more request;
    every response 200, of the bucket's shapes, finite and within ERR_LIMIT
    of `pipe`'s solo infer of the same preprocessed scene; /v1/stats
    errors 0; forward launches 48 x the batched calls of the window.
    Returns (results, the window's kernel counts, failure or None)."""
    import io
    import threading

    import numpy as np

    base = f"http://127.0.0.1:{server.port}"
    health = http_call(base + "/healthz")[0]
    if health != 200:
        return {"healthz": health}, {}, f"/healthz read {health}"
    requests, seed = [], 0
    for w, h, priors, n in BURST:
        for _ in range(n):
            seed += 1
            requests.append(raw_views(w, h, seed, priors))
    bodies = [npz_body(a) for a in requests]
    url = base + "/v1/infer?apply_mask=0"
    answers = [None] * len(bodies)

    def post(i):
        answers[i] = http_call(url, bodies[i])

    fa.reset_launch_counts()
    calls0 = engine.stats_dict()["batched_calls"]
    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(HTTP_TIMEOUT)
    burst_s = time.perf_counter() - t0
    malformed = http_call(url, b"not an npz")[0]
    after = http_call(url, bodies[0])
    stats = json.loads(http_call(base + "/v1/stats")[1])
    calls = stats["batched_calls"] - calls0
    counts = launches_of(fa)
    lat = sorted(a[2] * 1e3 for a in answers if a is not None)
    res = {"requests": len(bodies), "burst_s": burst_s,
           "requests_per_s": len(bodies) / burst_s,
           "latency_ms_p50": statistics.median(lat) if lat else None,
           "latency_ms_max": max(lat) if lat else None,
           "batched_calls": calls, "stats": stats,
           "response_bytes_mean": statistics.mean(
               len(a[1]) for a in answers if a is not None),
           "malformed_status": malformed, "after_status": after[0],
           "kernel_counts": counts}
    if any(a is None or a[0] != 200 for a in answers) or after[0] != 200:
        return res, counts, ("a request failed: " + str(
            [None if a is None else (a[0], a[1][:200]) for a in answers]))
    if malformed != 400 or stats["errors"] != 0:
        return res, counts, (f"malformed body {malformed} (400 "
                             f"expected), /v1/stats errors "
                             f"{stats['errors']}")
    bad = expect_launches(fa, {"fwd": FORWARD_LAUNCHES * calls},
                          f"{calls} batched calls")
    if bad:
        return res, counts, bad
    # the solo infer of each scene as the server preprocessed it
    errs = []
    for arrays, (_, data, _) in zip(requests, answers):
        got = dict(np.load(io.BytesIO(data)))
        views = serve._views_from_npz(arrays, 518)
        h, w = views[0]["img"].shape[1:3]
        if got["pts3d"].shape != (2, h, w, 3) or not all(
                np.isfinite(v).all() for v in got.values()):
            return res, counts, (f"response of shape "
                                 f"{got['pts3d'].shape} or not finite")
        ref = pipe.infer(views, apply_mask=False)
        errs.append(scene_errors(
            [{k: v[j] for k, v in got.items()} for j in range(2)],
            ref, torch) | {"bucket": [w, h]})
    res["scene_rel_err"] = errs
    worst = max(v for e in errs for k, v in e.items() if k != "bucket")
    if not worst <= ERR_LIMIT:
        return res, counts, (f"a served scene against its solo infer: "
                             f"{errs}")
    return res, counts, None


def engine_reading(torch, fa, engine, scenes, calls, **flags):
    """9d through the running engine: `scenes` submitted together, timed
    from the first submit to the last result (the merge, the hand-off to
    the worker, the forward, the host copies and the split); the median of
    `calls` after one warm-up, then a torch.profiler trace of one more.
    Forward launches exactly 48 per batched call. Returns (res, failure or
    None)."""
    def call():
        futures = [engine.submit(scene, **flags) for scene in scenes]
        return [f.result(timeout=HTTP_TIMEOUT) for f in futures]

    call()
    torch.cuda.reset_peak_memory_stats()
    calls0 = engine.stats_dict()["batched_calls"]
    fa.reset_launch_counts()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = launches_of(fa)
    batched = engine.stats_dict()["batched_calls"] - calls0
    wall = statistics.median(times)
    res = {"views": len(scenes[0]), "scenes": len(scenes), "calls": calls,
           "batched_calls": batched, "wall_ms": wall, "wall_ms_all": times,
           "views_per_s": len(scenes) * len(scenes[0]) / wall * 1e3,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "kernel_counts": counts,
           "plain_launches": fa.flash_attention.plain_launches}
    bad = expect_launches(fa, {"fwd": FORWARD_LAUNCHES * batched},
                          f"{batched} batched calls")
    if not bad:
        res["profile"] = profile_calls(torch, call, wall, calls=1)
    return res, bad


def serving_engine(torch, fa, fp, F, load_images):
    """Phase 9 (9a-9d). Returns (kernel rows, the kernel counts of its
    runs, failure or None)."""
    import gc

    from mapanything_tpu_torch import serve
    from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
    from mapanything_tpu_torch.train import save_params
    from mapanything_tpu_torch.utils.inference import InferencePipeline
    from mapanything_tpu_torch.utils.weights import random_normal_

    # 9a: the forward at the serving shapes
    rows = kernel_vs_plain(torch, fa, fp, F, SERVING_SHAPES, seed=900,
                           baseline=False)
    for name, row in rows:
        row["at"] = name
        if not max(row["max_abs_err"], row["rel_l2"]) <= ERR_LIMIT:
            return rows, [], f"kernel disagrees with plain at {name}: {row}"

    model = MapAnything(MapAnythingConfig())
    random_normal_(model)
    model.eval()
    pipe = InferencePipeline(model)
    counts, engine, server = [], None, None
    try:
        with tempfile.TemporaryDirectory() as folder:
            paths = write_images(folder, 2 * SERVE_BATCH)
            scenes = [load_images(paths[2 * i:2 * i + 2])
                      for i in range(SERVE_BATCH)]
        # 9b: one deterministic batched call
        res, bad = batched_call(torch, fa, fp, serve, pipe, scenes)
        print(f"phase 9b, {SERVE_BATCH} queued 2-view scenes: "
              f"{json.dumps(res)}", flush=True)
        if bad:
            return rows, counts, f"9b: {bad}"
        counts.append(res["kernel_counts"])
        # 9c: the CLI's server over a checkpoint of this model, and HTTP
        with tempfile.TemporaryDirectory() as folder:
            res, engine, server, bad = served_checkpoint(
                torch, serve, save_params, model, folder)
        print(f"phase 9c, served checkpoint: {json.dumps(res)}", flush=True)
        if bad:
            return rows, counts, f"9c: {bad}"
        res, window, bad = http_burst(torch, fa, serve, pipe, engine, server)
        print(f"phase 9c, HTTP burst: {json.dumps(res)}", flush=True)
        if bad:
            return rows, counts, f"9c: {bad}"
        counts.append(window)
        # 9d: readings on the served model alone, masks on
        pipe = model = None
        gc.collect()
        torch.cuda.empty_cache()
        flags = dict(apply_mask=True, mask_edges=True)
        readings = {}
        r, bad = engine_reading(torch, fa, engine, scenes, SERVE_CALLS,
                                **flags)
        readings["engine_batch4"] = r
        if bad:
            return rows, counts, f"9d engine_batch4: {bad}"
        counts.append(r["kernel_counts"])
        for name, views in (("pipeline_batch4", serve.merge_scenes(scenes)),
                            ("pipeline_batch1", scenes[0])):
            r, _, bad = timed_infer(torch, fa, engine.pipeline, views,
                                    SERVE_CALLS, **flags)
            if bad:
                return rows, counts, f"9d {name}: {bad}"
            counts.append(r["kernel_counts"])
            readings[name] = r
        for name, r in readings.items():
            prof = r.get("profile", {})
            print(f"phase 9d, {name} x 2 views at 518^2: wall "
                  f"{r['wall_ms']:.2f} ms ({r['views_per_s']:.2f} views/s), "
                  f"device {prof.get('device_ms', float('nan')):.2f} ms, busy "
                  f"{prof.get('busy_share', float('nan')):.3f}, peak "
                  f"{r['peak_memory_gib']:.2f} GiB", flush=True)
        print(f"phase 9d: {json.dumps(readings)}", flush=True)
    finally:
        if server is not None:
            server.stop()
        if engine is not None:
            engine.stop()
    return rows, counts, untouched_baseline(fp)


def timing(row):
    return {key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "mma_ms",
                                      "host_us") if key in row}


def kernels_summary(fp, attn, train_rows, ring_rows, merge, probe_rows,
                    phase_counts) -> list:
    """The kernels' JSON rows: each kernel at its main-path shape with its
    launches in phases 3-9 (phase_counts: the kernel counts each of those
    runs read, reset just before it), the baselines and the probes."""
    launches = {kname: sum(counts[key] for counts in phase_counts)
                for kname, key in COUNTER.items()}
    g2 = dict(attn)["global_2view"]
    kernels = [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": NEW_FWD,
        "replaces": "mapanything_tpu/ops/flash_attention.py:147",
        "also_replaces": "mapanything_tpu/ops/flash_attention.py:94",
        "launches": launches["flash_attn_fwd"],
        "max_abs_err": max(row["max_abs_err"] for _, row in attn),
        **timing(g2),
        "ms_at": "global_2view",
        "library_call": "F.scaled_dot_product_attention, flash backend",
        "per_shape": {name: row for name, row in attn},
    }]
    alone = "none: no one call computes it alone; see flash_attn_bwd_pair"
    library_call = {
        "flash_attn_fwd_lse": "aten._scaled_dot_product_flash_attention",
        "flash_attn_bwd_dkv": alone, "flash_attn_bwd_dq": alone,
        "flash_attn_fwd_stats": ("aten._scaled_dot_product_flash_attention "
                                 "(nearest: normalised output and lse)"),
        "flash_attn_bwd_pt_do": None,
        "flash_attn_bwd_dkv_f32": alone, "flash_attn_bwd_dq_f32": alone,
    }
    for kname, (source, replaces) in (TRAINING_KERNELS | RING_KERNELS).items():
        rows = (train_rows | ring_rows)[kname]
        at = {"flash_attn_fwd_stats": "ring_8view"}.get(
            kname, "ring_4view" if kname in RING_KERNELS else "global_4view")
        main = next(row for row in rows if row["at"] == at)
        entry = {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[kname],
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
    # the mma.sync baselines (off the main path: 0 launches there), timed in
    # phases 2-2c beside the new kernels at the same shapes
    for new in [row for row in kernels if row["source"] in MMA_SOURCE]:
        per = {at: row for at, row in new["per_shape"].items()
               if "mma_ms" in row}
        at = new["ms_at"]
        kernels.append({
            "name": new["name"] + "_mma", "route": "cuda",
            "source": MMA_SOURCE[new["source"]],
            "replaces": new["replaces"], "launches": 0,
            "max_abs_err": max(row["mma_max_abs_err"] for row in per.values()),
            "ms": per[at]["mma_ms"],
            "plain_ms": new["plain_ms"], "bound_ms": new["bound_ms"],
            "bound_by": new["bound_by"], "library_ms": new["library_ms"],
            "ms_at": at, "note": "the baseline, off the main path",
            "ms_per_shape": {key: row["mma_ms"] for key, row in per.items()},
        })
    # the backward as one call: each bf16 backward call of phases 4 and 6
    # launched one dK/dV and one dQ
    pair = {row["at"]: row for row in train_rows[PAIR]}
    kernels.append({
        "name": PAIR, "route": "cuda", "source": NEW_BWD,
        "replaces": TRAINING_KERNELS["flash_attn_bwd_dkv"][1],
        "also_replaces": TRAINING_KERNELS["flash_attn_bwd_dq"][1],
        "launches": launches["flash_attn_bwd_dq"],
        "max_abs_err": max(val for row in pair.values()
                           for key, val in row.items()
                           if key.endswith("_max_abs_err")),
        **timing(pair["global_4view"]), "ms_at": "global_4view",
        "library_call": ("aten._scaled_dot_product_flash_attention_backward "
                         "(dQ, dK and dV together)"),
        "note": ("delta + dK/dV + dQ in one call, as the backward runs "
                 "them; launches: backward calls; bound: the backward's "
                 "5 products"),
        "per_shape": pair,
    })
    for case, row in probe_rows.items():
        kernels.append({
            "name": f"flash_attn_fwd_probe[{case}]", "route": "cuda",
            "source": "mapanything_tpu_torch/csrc/flash_attn_fwd_probes.cu",
            "replaces": probe_replaces(fp, case), "launches": 0,
            "max_abs_err": row["max_abs_err"], **timing(row),
            "ms_at": row["at"], "max_abs_rel": row["max_abs_rel"],
            "rel_l2": row["rel_l2"], "tflops": row["tflops"],
        })
    return kernels


def main() -> int:
    # deterministic cuBLAS where phase 8 asks for deterministic algorithms;
    # read when the first cuBLAS handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
        from mapanything_tpu_torch.perf import flash_probes as fp
        from mapanything_tpu_torch.train import seq_parallel as SP
        from mapanything_tpu_torch.train import step as T
        from mapanything_tpu_torch.train.grad_check import (
            compare,
            compare_sharded,
        )
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
    t0 = t_start = time.perf_counter()
    try:
        built = _build.build_all()
    except RuntimeError as exc:
        return fail(str(exc))
    print(f"built {len(built)} libraries in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, (path, log, secs) in built.items():
        print(f"  {os.path.relpath(path, HERE)}: {secs:.2f} s", flush=True)
        kernel = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1][:80]
            elif "registers" in line or (
                    "spill" in line and " 0 bytes spill stores" not in line):
                print(f"    ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
    # the forward runs on wgmma (HGMMA) and TMA (UTMALDG): its SASS says so;
    # so do the backward's dK/dV and dQ, in both output types, and P^T dO
    for lib, kernel, count in (("flash_attn_fwd", "flash_fwd_sm90_kernel", 3),
                               ("flash_attn_bwd", "flash_bwd_dkv_sm90_kernel",
                                2),
                               ("flash_attn_bwd", "flash_bwd_dq_sm90_kernel",
                                2),
                               ("flash_attn_bwd",
                                "flash_bwd_pt_do_sm90_kernel", 1)):
        sass = {key: val for key, val in
                _build.sass_counts(built[lib][0]).items() if kernel in key}
        for key, counts in sass.items():
            print(f"    SASS {key[:80]}: {counts}", flush=True)
        if len(sass) != count or not all(c["HGMMA"] and c["UTMALDG"]
                                         for c in sass.values()):
            return fail(f"the {count} instances of {kernel} lack HGMMA or "
                        f"UTMALDG in their SASS: {sass}")
    bwd_lib = _build.load_library("flash_attn_bwd")
    smem = {"flash_attn_fwd": _build.load_library(
        "flash_attn_fwd").flash_attn_fwd_smem_bytes(),
            "flash_attn_bwd": bwd_lib.flash_attn_bwd_smem_bytes()}
    probe_lib = _build.load_library(fp.LIBRARY)
    for name, spec in fp.VARIANTS.items():
        smem[f"probe {name}"] = probe_lib.flash_attn_fwd_probe_smem_bytes(
            spec[0])
    print(f"  dynamic shared memory per block (bytes): {json.dumps(smem)}",
          flush=True)

    # phase 2: the serving forward kernel
    attn = kernel_vs_plain(torch, fa, fp, F)
    for name, row in attn:
        if not all(row[key] <= ERR_LIMIT for key in (
                "max_abs_err", "rel_l2", "mma_max_abs_err", "mma_rel_l2")):
            return fail(f"kernel disagrees with plain at {name}: {row}")

    # phase 2b: the training kernels
    train_rows = training_kernels_vs_plain(torch, fa, fp, F)
    for kname, rows in train_rows.items():
        for row in rows:
            bad = {key: val for key, val in row.items()
                   if key.endswith(("_max_abs_rel", "_rel_l2"))
                   and not val <= ERR_LIMIT}
            if bad:
                return fail(f"{kname} disagrees with plain at {row['at']}: "
                            f"{bad}")

    # phase 2c: the ring's kernels
    ring_rows, merge, bad = ring_kernels_vs_plain(torch, fa, ring, fp, F)
    if bad:
        return fail(bad)
    ring_rows["flash_attn_bwd_pt_do"] = pt_do_vs_plain(torch, ring, fp, F)
    for kname, rows in ring_rows.items():
        for row in rows + ([merge] if kname == "flash_attn_fwd_stats"
                           else []):
            bad = {key: val for key, val in row.items()
                   if key.endswith(("_max_abs_rel", "_rel_l2"))
                   and not val <= ERR_LIMIT}
            if bad:
                return fail(f"{kname} disagrees with plain at {row['at']}: "
                            f"{bad}")

    # phase 2d: the probes, each once against its plain version
    probe_rows = probes_vs_plain(torch, fa, fp, F)
    for case, row in probe_rows.items():
        if not (row["max_abs_rel"] <= ERR_LIMIT
                and row["rel_l2"] <= ERR_LIMIT):
            return fail(f"probe {case} disagrees with its plain version: "
                        f"{row}")

    # phases 3-9 run the main path: no probe and no baseline launch
    fp.reset_probe_counts()

    # phase 3: serving at full width
    t0 = time.perf_counter()
    model = MapAnything(MapAnythingConfig())
    random_normal_(model)
    model.eval()
    pipe = InferencePipeline(model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.1f} M parameters, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    serving = dict.fromkeys(fa.KERNELS, 0)
    with tempfile.TemporaryDirectory() as folder:
        for num_views in (1, 2):
            res, bad = run_slice(torch, fa, model, pipe, load_images, folder,
                                 num_views)
            print(f"slice {num_views}-view: {json.dumps(res)}", flush=True)
            if bad:
                return fail(f"{num_views}-view slice: {bad}")
            serving = {key: serving[key] + res["kernel_counts"][key]
                       for key in serving}
    print(f"peak device memory (serving) "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    bad = untouched_baseline(fp)
    if bad:
        return fail(f"serving: {bad}")
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
    bad = untouched_baseline(fp)
    if bad:
        return fail(f"training: {bad}")
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
        bad = untouched_baseline(fp)
        if bad:
            return fail(f"ring: {bad}")

        # phase 6: the view-sharded train step at full width, same group
        torch.cuda.empty_cache()
        model = MapAnything(MapAnythingConfig(), generator=torch.Generator(
            device="cuda").manual_seed(1))
        vs_train, bad = run_view_sharded_training(
            torch, fa, T, SP, compare_sharded, model, make_synthetic_batch,
            images_only_config(), group, train["first_step_loss"])
        print(f"view-sharded train 1x4v@518: {json.dumps(vs_train)}",
              flush=True)
        if bad:
            return fail(f"view-sharded train step: {bad}")
        prof = vs_train["profile"]
        if "device_ms" in prof:
            print(f"view-sharded step: wall {vs_train['step_ms']:.2f} ms, "
                  f"device {prof['device_ms']:.2f} ms, busy "
                  f"{prof['busy_share']:.3f}, peak "
                  f"{vs_train['peak_memory_gib']:.2f} GiB, P^T dO "
                  f"{vs_train['pt_do_device_ms_per_step']:.3f} ms per step",
                  flush=True)
        bad = untouched_baseline(fp)
        if bad:
            return fail(f"view-sharded training: {bad}")
        del model
    finally:
        torch.distributed.destroy_process_group()

    # phase 7: the rest of the serving API at full width, phase 3's weights
    t7 = time.perf_counter()
    torch.cuda.empty_cache()
    model = MapAnything(MapAnythingConfig())
    random_normal_(model)
    model.eval()
    phase7_counts, b2_rows, bad = serving_api(torch, fa, F, fp, model,
                                              load_images)
    if bad:
        return fail(bad)
    del model
    torch.cuda.empty_cache()
    print(f"phase 7 (configs 3-5) took {time.perf_counter() - t7:.1f} s",
          flush=True)
    attn = attn + b2_rows  # the flash_attn_fwd row's shapes

    # phase 8: training with geometric priors, at full width and depth
    t8 = time.perf_counter()
    phase8_counts, bad = training_with_priors(torch, fa, fp, F, load_images)
    if bad:
        return fail(bad)
    print(f"phase 8 (training with priors) took "
          f"{time.perf_counter() - t8:.1f} s", flush=True)

    # phase 9: serving through serve.py at full width
    t9 = time.perf_counter()
    torch.cuda.empty_cache()
    serve_rows, phase9_counts, bad = serving_engine(torch, fa, fp, F,
                                                    load_images)
    if bad:
        return fail(f"phase 9: {bad}")
    print(f"phase 9 (serving engine and HTTP) took "
          f"{time.perf_counter() - t9:.1f} s", flush=True)
    attn = attn + serve_rows

    phase_counts = [serving,
                    {key: train[f"{key}_launches"] for key in fa.KERNELS},
                    ring_res["kernel_counts"], block_res["kernel_counts"],
                    vs_train["launches"]] + (phase7_counts + phase8_counts
                                             + phase9_counts)
    kernels = kernels_summary(fp, attn, train_rows, ring_rows, merge,
                              probe_rows, phase_counts)
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
