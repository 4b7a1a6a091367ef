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
     leaves these unmeasured and fails nothing. Every trace is read from
     kineto's raw events (perf/timing.py::read_trace; the profiler's own
     FunctionEvent tree took ~5 s a trace, 218 s of a whole run, NVIDIA
     H100 80GB HBM3, 700.00 W): one more traced 2-view call read both ways
     must give the same device ops and the same device and host self µs
     by name (1e-6 relative), with each reading's seconds.
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
     2 warm-up steps (the eager warm-up and the CUDA graph's capture),
     then 10 timed steps, replays of the graph. Checks no plain launch
     and, per step, exactly 48 forward-with-lse, 48 dK/dV and 48 dQ
     launches from the host where the step was not a replay and none where
     it was, a finite loss and grad_norm at every step, and that the
     parameters changed; prints the median step time, the peak device
     memory and the train MFU (utils/flops.py::train_step_flops over the
     step time and the H100 SXM bf16 dense peak). Traces 2 more steps with
     torch.profiler, and one more, a replay, whose device trace must hold
     exactly 48 of each of the three training kernels by name. Last,
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
     chunked program then "auto", the same readings from 1 timed call
     each (a call takes ~2.7 s); demo_colmap's export
     of the chunked call's outputs into a temporary directory, read back
     with utils/colmap_io.py: 100 cameras, 100 images, points, unit
     quaternions whose rotations are the predicted poses' (1e-4). After
     each, B2 at the many-view global shape ((1, 43904, 16, 64) / 43809
     and (1, 136960, 16, 64) / 136901) against its plain version on the
     first and the last 192 real rows (limit 1e-2, as phase 2), its device
     time, bound, flash SDPA's time and host µs (graphs of 3 calls, 3 host
     calls: B2_REPS). 0 probe and baseline launches.
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
     8c, train/loop.py::train at full width, the trunk cut to
     TRAINER_TRUNK_DEPTH = 4 layers (checkpoint bytes set its time), on 1 x
     2-view batches, 2 epochs of 2 batches and a validation loader, in a
     temporary directory (free disk printed first; too little fails the phase):
     uninterrupted, and killed at (epoch 1, iter 1) then resumed from
     checkpoint-last, both under deterministic algorithms: the same step
     counts, the parameters within rel-L2 1e-3; each checkpoint's GiB and save
     and load seconds (5 writes, 1 load).
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
 10. Training from a WAI tree at full width through the training CLI:
     10a, the forward with lse (out and lse), dK/dV, dQ and the pair row
     against their plain versions (phase 2b's method and limits, no
     baseline) at the shapes the loader's 2 x 4-view batches give them
     (LOADER_SHAPES: 518x392 encoder (8, 1152) / 1037, frame (8, 1036),
     global (2, 4224) / 4145; 518x336 (8, 896) / 889, (8, 888), (2, 3584)
     / 3553), with device ms, bound, flash SDPA's with-lse forward or
     FA2's backward, and host µs; and the lse-free forward against its
     plain version (9a's method and limits) at the validation batches'
     shapes (VALIDATION_SHAPES: the three 518x392 rows, the global one on
     B2), with device ms, bound, flash SDPA's time and host µs.
     10b, a tree of 2 scenes x 8 seeded 640x480 frames written by the
     port's write_scene (depth in EXR for one scene, npy for the other, a
     banded covisibility); the first batches of two train loaders built
     alike bitwise equal on the host; on the CLI's initial weights (the
     released config, its own init from seed 0), that batch's images-only
     loss with flash against math attention (limit 1e-2 relative).
     10c, `train.__main__.main([...])` in this process: 8 samples of 4
     views in the buckets 518x392 and 518x336 (the sampler's seed, epoch
     + 788, draws both in its 4 batches of 2), 2 validation batches,
     `aug_training`, one epoch, checkpoints in a temporary directory.
     Gates: finite losses; exactly 48 forward-with-lse, 48 dK/dV and 48 dQ
     launches a step and 48 lse-free forwards a validation batch, nothing
     else, 0 plain, probe and baseline launches; both buckets stepped;
     checkpoint-last, read back with load_train_state, bitwise the final
     state. Readings (not gated): the step interval in the loop, 3 more
     steps alone (median wall), device ms and busy share over 2 traced
     steps, peak GiB, the loader's host ms per batch and the training
     thread's wait for each batch, each checkpoint's save seconds.
     10d, profile_dataloading.main over the same tree and mix, 4 loader
     threads, one epoch, each batch copied to the card: exactly 4 batches
     and 32 images; images/s and the block timers.

 11. The demo path at full width, from a checkpoint in the reference's
     layout: the lse-free forward against its plain version at the demos'
     global shape, (1, 8320) / 8289 real keys (B2; 9a's method and limits),
     with device ms, bound, flash SDPA's time and host µs. 11a, phase 3's
     weights written as a two-shard HF snapshot in the reference's layout
     (tests/torch_reference_layout.py) and loaded with from_pretrained onto
     the card: bitwise phase 3's, the inferred config the released one;
     write and load seconds, GiB on disk, peak host RSS. 11b,
     demo_images_only.main on 8 seeded 640x480 images (bucket 518x392):
     the PLY and the GLB read back, the points bitwise the masked pts3d of
     the loaded model's own infer call, one frustum a view, exactly 48
     forward launches. 11c, demo_colmap.main --ba at the default flags:
     sparse/ and sparse_ba/ read back (8 cameras and images, finite
     points, orthonormal rotations), points.glb, rms_after <= rms_before,
     exactly 48 + 24 forward launches (infer and the ranking's encoder
     pass); each stage's wall. 11d, the tracker on 8 rendered views of a
     textured plane at 518x392 (tests/torch_demo_scenes.py), 1024 points
     from view 0 against the exact correspondences (mean endpoint error
     <= 1 px), and bundle adjustment of 8 frames x 1024 points (0.1 px
     noise, perturbed poses) on the card: rms_after < 0.25 px and <
     rms_before / 8, the refined poses, intrinsics and points within 1e-3
     of the CPU's. 11e, demo_app.main on the snapshot and the 8 images
     with --sky_masks and --measure: exactly 48 forward launches (24 B1 at
     the encoder's (8, 1152) / 1037, 12 B1 at the frame layer's (8, 1036),
     12 B2 at the global layer's (1, 8320) / 8289); every file (scene.glb,
     8 depth and 8 normal PNGs, measure.json, 8 sky masks of 0/255); the
     GLB's scene mesh as many vertices and faces as utils/mesh.py::
     image_mesh of the app's own predictions, one marker a view; the
     app's normal maps recomputed on the card within 1e-5 of the CPU's;
     each stage's wall (load, model, infer, normals, glb, pngs, measure,
     sky). 11f, convert_torch_checkpoint.main --report on the snapshot,
     the port's file loaded with from_pretrained onto the card bitwise
     phase 3's weights with the released config; the report's group
     count, the convert and load seconds. 0 plain, probe and baseline
     launches.
 12. The evaluation path at full width (the benchmark CLIs, the adapter
     seam, ModularDUSt3R): 12a, the lse-free forward against its plain
     version (phase 2's limits, max-abs over the plain's max-abs) at the
     shapes only this path gives it (EVAL_SHAPES: ModularDUSt3R-L at
     512x384, 768 tokens, no class token, 16 heads in the encoder and 12
     in the decoder, the cross-attention's k and v the strided halves of
     one kv tensor, per pair and at batch 10; MapAnything at the dense
     N-view batches of 10 x 2 and 10 x 4 views at 518x392, the 4-view
     global layer on B2), with device ms, bound, flash SDPA's time and
     host µs. Then a WAI tree (phase 10's) and phase 3's weights as a
     save_params file. 12b, benchmark_dense_n_view.main in this process
     (--views 2 4 --batch_sizes 10 10 --num_sets 10 at 518x392, both
     --task images_only and all_priors): exactly 48 forward launches a
     batch, nothing else; the summary and per-set JSON read back; the
     card's _normalize_for_metrics against the CPU's in fp32 from the same
     prediction tensors (1e-4 of each output's largest magnitude); flash
     against math attention on a 10 x 2-view batch (pts3d rel-L2 1e-2);
     the ground-truth oracle (tests/torch_eval_oracles.py) through
     run_dense_n_view_benchmark: abs-rel errors <= 1e-5, inlier ratios
     and AUC@5 1, ATE <= 1e-4. 12c, ModularDUSt3R(encoder_size="large")
     with its seeded init through ModularDUSt3RAdapter and the unmodified
     run_dense_n_view_benchmark on 10 two-view sets at 512x384: exactly
     144 forward launches, finite factored outputs of the expected shapes,
     view 1's quaternion the identity; at the model's own init, flash
     and bf16 math each against an fp32 math forward of the same weights
     at the encoder's first, middle and last block, dec_norm (the
     decoder before the head) and pts3d: flash's rel-L2 at most 1.1x
     bf16 math's at each (bf16's own floor there is ~1.3e-2, above 1e-2);
     and flash against math on pts3d (rel-L2 1e-2) with every parameter
     redrawn N(0, 0.02) on the card (the weak gate of phases 5, 7 and
     8d);
     rigid_points_registration of 8 x 1024 weighted points under a
     known rotation, translation and scale on the card within 1e-4 of the
     CPU and of the truth. 12d, benchmark_calibration.main (single views at
     518x392, batches of 10): 48 launches a batch, a finite mean error; the
     oracle's error 0 (<= 1e-4 deg) and, with every ray turned by 1 deg,
     1 deg within 1e-3. 12e, benchmark_rmvd.main --selftest with the
     checkpoint (image+intrinsics+pose, 2 samples of 2 views at 518^2),
     then its adaptor on 2 samples of 1 key and 7 sources at 518x392 (the
     global layer (1, 8320) / 8289): 48 launches a call, finite metrics,
     input_adapter's rays and poses on the card within 1e-5 of the CPU's.
     Each stage's wall (checkpoint load, forwards, metrics, JSON, the rest),
     peak GiB, and the device ms of one (10, 4)-view forward and one
     adapter call (torch.profiler). 0 plain, probe and baseline launches.
 13. The model variants at full width and depth (encoder L, trunk 1024 x
     24 x 16, DPT 256; bf16 with fp32 parameters), one model at a time:
     13a, the lse-free forward against its plain version (phase 2's
     limits) at the shapes only the variants give it (VARIANT_SHAPES: the
     RoPE'd frame layer, its q and k new tensors beside the fused tensor's
     strided v; the entropy-scaled 2-view global layer; a one-row q, the
     extra token's self- and cross-attention; the cross trunk's gathered
     contexts at 2 and 4 views; RADIO-L's ragged 769 tokens at 512x384),
     with device ms, bound, flash SDPA's time and host µs. 13b, the
     released model at 8 views as the yardstick, then the global trunk
     (info_sharing_type="global") at 2 and 8 views at 518^2; 13c, the
     ablations preset (no scale token, RoPE 100) at 2 views, its metric
     scale exactly 1; 13d, the cross trunk at 2 and 4 views; 13e,
     MapAnything with RADIO-L and with CroCo-L at 512x384, 2 views; 13f,
     the four other scene-representation families (+confidence+mask) at 1
     view. Each through InferencePipeline.infer: exactly 48 forward
     launches a call (168 for the cross trunk: 24 encoder blocks and, per
     layer, self- and cross-attention for the reference view, the batch
     of the others and the token), no other kernel, no plain, probe or
     baseline launch; finite outputs of the family's key set; at the
     model's own init (13b-13e) flash at most 1.1x as far as bf16 math
     from an fp32 math twin at the trunk's taps, its output, pts3d, rays,
     the raw depth channel and depth over its metric scale, and depth at
     most max(1.1x math's, 1e-2) (the scale is one number a scene);
     with every parameter redrawn N(0, 0.02) flash against math within
     1e-2 rel-L2 on pts3d, depth and rays; wall, device ms, busy share and
     peak GiB. 13g, a one-shard snapshot in the reference's layout of a
     RADIO-L model (tests/torch_reference_layout.py) read back through
     from_pretrained bitwise, with the same config.
 14. The offline data-processing path (tests/torch_offline_scenes.py
     builds its inputs): the forward against its plain version at the
     self-labelling shapes (8 frames at 518x392). 14a, a raw ScanNet++ v2
     scene (OPENCV_FISHEYE DSLR frames of 1752x1168 with anonymisation
     masks, a closed room mesh of 52272 triangles whose depth has a closed
     form) through convert_dataset.main with --undistort and
     --render-depth, no --device: the tree read back through the port's
     reader, every rendered frame within 1e-4 of the closed form where
     hit (and hit but for 1e-3 of the pixels), a window of frame 0 ray-cast
     on the CPU within 1e-5 of the card's; each stage's wall, the render's
     ms per frame and (pixel, triangle) pairs per second. 14b,
     compute_pairwise_covisibility on the card over 256 closed-form
     depths at 1752x1168 (224 inside): the diagonal 1, the frame facing
     away 0, a 32-frame subset within 4 pixels' share of the CPU's, the
     depth-consistency confidence of 32 noisy frames at 360 differing from
     the CPU's on at most 1e-2 of the pixels; ms and peak GiB; the
     rendered scene's covisibility stored for the loader. 14c,
     run_pseudo_depth_stage with MapAnythingAdapter over phase 3's
     weights on an 8-frame 518x392 scene, one call: 48 forward launches,
     no plain, probe or baseline launch, the stored depth, mask and
     confidence bitwise the adapter's outputs; the forward's wall, device
     ms and busy share; run_depth_consistency_stage on the labels and on
     the closed-form depth, each on the card within 1e-2 of the pixels of
     the CPU's. 14d, one loader batch (2 x 2 views
     at 518x336) of the converted scene through the `scannetpp` spec:
     finite, of the expected shapes.

 15. Multi-GPU training (parallel/mesh.py, the mesh step of train/step.py) at
     full width (15a's trunk cut, 15c at full depth): the released
     MapAnythingConfig() in bf16 with fp32 parameters, the model's own seeded
     init, a global batch of 2 x 4 views at 518^2, images_only and
     aug_training. 15a, on one card: two processes share it over a gloo group
     (NCCL refuses two ranks on one device; gloo stages the CUDA tensors
     through the host) and run parallel/mesh_check.py at DP 2 and then at TP 2
     (`--tp 1,2`), the trunk cut to MESH_TRUNK_DEPTH = 4 layers (`--trunk_depth
     4`; the encoder whole): rank 0's one-rank step on the whole batch (once a
     task) against each mesh step from the same weights, loss and grad_norm
     within 1e-2, the gradients of every parameter (gathered for TP) within
     2e-2 rel-L2 as one vector (phase 4's gradient limit) and within 5e-2 each,
     the updated parameters within 2e-2 as one vector, the worst single
     parameter of each printed with its name; each rank's kernel launches (28
     forward-with-lse, dK/dV and dQ per rank-step, no plain launch) and, for
     images_only, its wall, device ms and peak GiB over MESH_TIMED_STEPS more
     steps. 15b, the training kernels against their plain versions (phase 2b's
     method and limits, no baseline) at the tensor-parallel head counts, H = 8
     (TP 2) and H = 4 (TP 4), q, k and v strided views of a local fused qkv
     (token stride 3 * 1024 / tp): the encoder (2, 1408) / 1370, frame (2,
     1369) and 4-view global (1, 5504) / 5477 shapes, and 15a's TP 2 ones (8,
     1408) / 1370, (8, 1369) and (2, 5504) / 5477. 15c, only where the machine
     has two or more cards: mesh_check under NCCL at DP 2 and TP 2, with four
     cards DP 2 x TP 2 (at full depth) and ring_check's view-sharded train step
     at p = 2 and 4, one card per rank; with one card it prints "phase 15c:
     skipped, 1 card".

 16. Training the model variants and the criteria outside the released
     recipe at full width (encoders L, trunk 1024 x 16, DPT 256), the
     trunk cut to VARIANT_TRUNK_DEPTH = 4 layers (cut_trunk; bf16 with
     fp32 parameters, the model's own seeded init, make_synthetic_batch
     on the card), one model at a time. 16c first:
     the forward with lse, dK/dV, dQ and the pair against their plain
     versions (phase 2b's method and limits, over q's real rows for the
     outputs, the lse and dQ and the keys' for dK and dV) at
     VARIANT_SHAPES, where q and k differ in length (the cross trunk's
     gathered contexts, the extra token's one-row q), q and k are new
     tensors beside a strided v (RoPE), q is scaled (entropy) or the
     tokens are ragged (RADIO-L), each with device ms, bound, library ms
     and host µs; and dO as an expanded zero and as the slice of a wider
     row through the Function's backward. 16a, the released recipe's
     make_train_step (images_only, OptimConfig(warmup_steps=2,
     total_steps=100)) on the global trunk, the cross trunk (2 and 4
     views), the ablations preset, RADIO-L and CroCo-L at 512x384 and the
     campointmap+pose and pointmap+raydirs+depth+pose families: on the
     fresh model at 1 view, train/grad_check.py::compare with phase 4's
     limits (the loss auto against math within 1e-2 relative, the pulled-
     back gradient over all parameters and over the qkv weights within
     2e-2 rel-L2, each beside its noise floor; where a floor exceeds 2e-2,
     flash at most 1.1x as far as bf16 math from an fp32 twin); then 1
     warm-up and 3 timed steps, each with exactly one forward with lse,
     one dK/dV and one dQ launch per attention (28; 48 for the cross
     trunk) and nothing else, a finite loss and grad_norm, parameters that
     changed; the median step wall, device ms and busy share of a traced
     step, peak GiB. 16b, the composed step (forward, criterion, backward,
     AdamW) with 16a's checks: ConfLoss(Regr3D) on pointmap, ConfLoss(
     PointsPlusScaleRegr3D) on raymap+depth (each + 0.3 x the mask loss),
     ConfAndExcludeTopNPercentPixelLoss(DisentangledFactoredGeometryScale
     Regr3DPlusNormalGMLoss) on pointmap+raydirs+depth+pose, and
     FactoredGeometryScaleRegr3D(FactoredLLoss()) on the released model.

 17. The external-model adapters (models/adapters.py) over their interface
     fakes (tests/torch_adapter_fakes.py; no foreign checkpoint or pip
     package is in the repository). 17a, each of the nine (VGGT, Pi3 and
     MoGe over torch stand-ins; PosedDepth, DUSt3R with an aligner that
     fits a scale by Adam under enable_grad, MASt3R, MUSt3R, Pow3R and
     AnyCalib over host callables) on the card and on the CPU, same
     make_synthetic_batch inputs at 518x392 (the harnesses' size), fp32, under inference mode:
     every key within 1e-5 rel-L2 of the CPU's (masks equal), on the card
     and finite; the GT-exact fakes (PosedDepth, MASt3R, MUSt3R, Pow3R
     with its 0.5 scale error to undo, AnyCalib) within the JAX tests'
     tolerances of the ground truth; the device-to-host copies and host
     reads inside a call, counted at the ATen dispatcher
     (perf/timing.py::host_transfers): none for the module adapters, some
     for the callables (which take host arrays). 17b, the
     unmodified harnesses on the card: the dense N-view benchmark over
     DUSt3R, MASt3R, MUSt3R (pointmaps_abs_rel < 1e-2), VGGT, Pi3 and MoGe
     (finite); the calibration benchmark over AnyCalib (< 1e-2 degrees);
     RMVD over MoGe. 17c, VGGT's stand-in at VGGT-1B's attention width (a
     14x14 patch conv, 2 x (a frame and a global nn/layers.py::Block), dim
     1024, 16 heads of 64, bf16) on 2 views at 518^2: the forward kernel
     against its plain version at its two shapes (2, 1369, 16, 64) and
     (1, 2738, 16, 64); one adapter call with exactly 4 forward launches,
     0 plain, probe and baseline; flash against math within 1e-2 rel-L2;
     no device-to-host copy or host read; wall, device ms and busy share.
     17d, convert_dataset.main on a raw 4-frame ScanNet++ v2 scene at
     518x392 with --undistort and --pseudo-depth FILE, a MoGe stand-in
     pickled whole, on the card: the stored depth and mask bitwise the
     adapter's outputs; the stage's wall.

The last two lines are the kernels' JSON summary (each kernel's launches:
the counts phases 3-17 read, summed) and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import types

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
MANY_VIEWS = {32: 3, 100: 1}  # views: timed calls per program
CONF_PERCENTILE = 10.0
FUSION_LIMIT = 1e-4  # the card's fused features against the CPU's, fp32
SAMPLE_ROWS = 192  # B2 at the many-view shapes: first and last real rows
# B2 at those shapes takes 15-150 ms a call and flash SDPA 26-250 ms: a
# graph of 3 calls after 1 warm-up times them, and 3 calls the host's µs
B2_REPS = {"reps": 3, "warmup": 1}
PATCHES = 37 * 37  # per view at 518^2


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def kernel_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms per call of a kernel or a library call: a CUDA graph of
    `reps` (20) back-to-back calls, replayed between two CUDA events
    (perf/timing.py::device_ms). No host work of the wrapper enters it."""
    from mapanything_tpu_torch.perf.timing import device_ms

    return device_ms(fn, reps=reps, warmup=warmup)


def plain_ms(fn) -> float:
    """Device ms per call of a plain version: events around 5 calls issued
    back to back (perf/timing.py::events_ms; each call allocates its score
    matrix, which a graph's pool would keep for every call)."""
    from mapanything_tpu_torch.perf.timing import events_ms

    return events_ms(fn)


def host_us(fn, reps: int = 20) -> float:
    """A wrapper's host µs per call (perf/timing.py::host_us). Phase 2
    holds the forward's own wrapper (ops/flash_attention.py::_fwd_cuda)
    beside the baseline's, which does the same work."""
    from mapanything_tpu_torch.perf.timing import host_us as measure

    return measure(fn, reps=reps)


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


def library_fwd_ms(torch, qh, kh, vh, **reps) -> float:
    """F.scaled_dot_product_attention with the flash backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return kernel_ms(lambda: sdpa(qh, kh, vh), **reps)


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
            if key.endswith(("_rel", "_rel_l2", "_over_products"))}
    mma = (f" mma.sync {row['mma_ms']:.4f} ms" if "mma_ms" in row else "")
    lib = row["library_ms"]
    print(f"{kname} {case} {tuple(shape)}: {errs} kernel {row['ms']:.4f} ms"
          + (f" ({row['tflops']:.2f} TFLOP/s)" if "tflops" in row else "")
          + f"{mma} plain {row['plain_ms']:.4f} ms bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}) library "
          f"{'none' if lib is None else f'{lib:.4f} ms'} host "
          f"{row['host_us']:.1f} us", flush=True)


def training_kernels_vs_plain(torch, fa, fp, F, shapes=TRAIN_SHAPES,
                              seed=100, baseline=True):
    """Phase 2b (and 10a at the loader's shapes): {kernel name or PAIR:
    [row per (name, shape, n_valid) of `shapes`]}. The backward kernels are
    fed the plain forward's lse and delta; the pair row times delta, dK/dV
    and dQ as the backward runs them, in one call, against FA2's backward,
    which computes the same function. With `baseline`, each kernel's
    mma.sync baseline too."""
    rows = {name: [] for name in [*TRAINING_KERNELS, PAIR]}
    for i, (name, shape, n_valid) in enumerate(shapes):
        q, k, v = attention_inputs(torch, shape, n_valid, seed=seed + i)
        real = shape[1] if n_valid is None else n_valid
        gen = torch.Generator(device="cuda").manual_seed(seed + 100 + i)
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
        mma_fwd = mma_dk = mma_dv = mma_dq = None
        if baseline:
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
        mma = {}
        if baseline:
            mma = {
                "flash_attn_fwd_lse": (
                    real_rows(out=(mma_fwd[0], ref_out),
                              lse=(lse_rows(mma_fwd[1]), lse_rows(ref_lse))),
                    lambda: fp.flash_attention_fwd_lse_mma(q, k, v,
                                                           n_valid)),
                "flash_attn_bwd_dkv": (
                    real_rows(dk=(mma_dk, ref_dk), dv=(mma_dv, ref_dv)),
                    lambda: fp.flash_attention_dkv_mma(*bwd_args)),
                "flash_attn_bwd_dq": (
                    real_rows(dq=(mma_dq, ref_dq)),
                    lambda: fp.flash_attention_dq_mma(*bwd_args)),
            }
        cases = [
            ("flash_attn_fwd_lse",
             real_rows(out=(out, ref_out),
                       lse=(lse_rows(lse), lse_rows(ref_lse))),
             lambda: fa.flash_attention_fwd_lse(q, k, v, n_valid),
             lambda: fa.flash_attention_fwd_lse_plain(q, k, v, n_valid),
             mma.get("flash_attn_fwd_lse"),
             "fwd_lse", library_fwd_lse_ms(torch, *lib)),
            ("flash_attn_bwd_dkv",
             real_rows(dk=(dk, ref_dk), dv=(dv, ref_dv)),
             lambda: fa.flash_attention_dkv(*bwd_args),
             lambda: fa.flash_attention_dkv_plain(*bwd_args),
             mma.get("flash_attn_bwd_dkv"), "dkv", None),
            ("flash_attn_bwd_dq", real_rows(dq=(dq, ref_dq)),
             lambda: fa.flash_attention_dq(*bwd_args),
             lambda: fa.flash_attention_dq_plain(*bwd_args),
             mma.get("flash_attn_bwd_dq"), "dq", None),
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
             mma, cases, bwd_args, pair_args, lib)
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


def write_images(folder: str, n: int, w: int = 518,
                 h: int = 518) -> list[str]:
    import numpy as np
    import PIL.Image

    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:h, 0:w] / float(max(w, h))
    paths = []
    for i in range(n):
        base = np.stack([np.sin(6 * xx + i), np.cos(5 * yy - i),
                         np.sin(4 * (xx + yy))], -1)
        img = 127.5 * (1 + 0.8 * base) + rng.normal(0, 8, base.shape)
        path = os.path.join(folder, f"view{i}.png")
        PIL.Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)
        paths.append(path)
    return paths


# utils/weights.py::random_normal_'s weights of the released config (seed
# 0), kept on the host after their first draw: numpy draws 653 M normals in
# ~14 s, and phases 3, 5, 7, 8d and 9 each run a model with these weights
_RANDOM_WEIGHTS: dict = {}


def random_weights_model():
    """MapAnything(MapAnythingConfig()) on the card, in eval mode, with
    random_normal_'s weights (numpy normals x 0.02, seed 0): phase 3's
    model. The weights are drawn once and loaded from the host after."""
    from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
    from mapanything_tpu_torch.utils.weights import random_normal_

    model = MapAnything(MapAnythingConfig())
    if _RANDOM_WEIGHTS:
        model.load_state_dict(_RANDOM_WEIGHTS)
    else:
        random_normal_(model)
        _RANDOM_WEIGHTS.update({key: val.detach().cpu() for key, val
                                in model.state_dict().items()})
    return model.eval()


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


# what this script's own traces cost: their count, their seconds in all
# and the seconds spent reading them (printed at the end)
TRACES = {"traces": 0, "s": 0.0, "read_s": 0.0}
READER_LIMIT = 1e-6  # read_trace against the profiler's own events


def profile_calls(torch, call, wall_ms, calls: int = 3, match=None) -> dict:
    """Device time per `call()` from torch.profiler, and its share of
    `wall_ms`, the median wall time of the untraced calls
    (perf/timing.py::profile_calls)."""
    from mapanything_tpu_torch.perf.timing import profile_calls as profile

    t0 = time.perf_counter()
    res = profile(call, wall_ms, calls, match)
    TRACES["traces"] += 1
    TRACES["s"] += time.perf_counter() - t0
    TRACES["read_s"] += res.get("read_s", 0.0)
    return res


def trace_reader_check(torch, call) -> tuple:
    """perf/timing.py::read_trace (kineto's raw events, how every trace here
    is read) against the profiler's own FunctionEvents on one traced
    `call()`: the same device ops, device µs by name and host self µs by
    name (READER_LIMIT relative), and the seconds each reading took.
    Returns (readings, failure or None)."""
    from torch.profiler import ProfilerActivity, profile

    from mapanything_tpu_torch.perf.timing import read_trace, read_trace_events

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = read_trace(prof)
    t1 = time.perf_counter()
    ref = read_trace_events(prof)
    t2 = time.perf_counter()

    def worst(got, want):
        if got.keys() != want.keys():
            return math.inf
        return max((abs(got[k] - want[k]) / max(abs(want[k]), 1e-3)
                    for k in want), default=0.0)

    res = {"raw_read_s": t1 - t0, "events_read_s": t2 - t1,
           "device_ops": [raw[2], ref[2]], "host_ops": len(ref[1]),
           "device_worst_rel": worst(raw[0], ref[0]),
           "host_worst_rel": worst(raw[1], ref[1])}
    if (raw[2] != ref[2] or not res["device_worst_rel"] <= READER_LIMIT
            or not res["host_worst_rel"] <= READER_LIMIT):
        return res, f"read_trace against the profiler's events: {res}"
    return res, None


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
        counted = step_counts(step)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = dict(fa.flash_attention.kernel_counts)
        plain = fa.flash_attention.plain_launches
        want = dict.fromkeys(fa.KERNELS, 0) | host_launches(
            step, counted, TRAIN_LAUNCHES)
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
    res["replay_kernels"], bad = replay_launches(
        torch, step, lambda: step(state, batch), TRAIN_LAUNCHES)
    res["train_step"] = step_counts(step)
    return res, bad


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
           "ms": kernel_ms(lambda: fa.flash_attention(q, k, v, n_valid),
                           **B2_REPS),
           "plain_ms": plain_ms(
               lambda: fa.flash_attention_plain(q_rows, k, v, n_valid)),
           "plain_ms_of": f"the {2 * SAMPLE_ROWS} sampled rows only",
           "host_us": host_us(
               lambda: fa._fwd_cuda(q, k, v, n_valid, with_lse=False),
               reps=B2_REPS["reps"])}
    flops = fa.attention_flops(shape[0], shape[1], n_valid, shape[2],
                               shape[3])
    row["tflops"] = flops / row["ms"] / 1e9
    row.update(bound(F, "fwd", shape, n_valid))
    row["library_ms"] = library_fwd_ms(torch, *sdpa_layout(q, k, v, n_valid),
                                       **B2_REPS)
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
# 8c's trunk: its time is the checkpoints' bytes, ~0.6 of them at 4 of 24
# layers
TRAINER_TRUNK_DEPTH = 4


PROFILER_WORKERS = 4


def profiler_run(root, spec):
    """10d: profile_dataloading.main over phase 10's tree and dataset mix,
    PROFILER_WORKERS loader threads, one epoch, each batch copied to the
    card. Returns (readings, failure or None)."""
    from mapanything_tpu_torch import profile_dataloading

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = profile_dataloading.main([
            "--wai_root", root, "--dataset_spec", spec, "--epochs", "1",
            "--max_imgs_per_device", str(WAI_IMGS), "--num_workers",
            str(PROFILER_WORKERS)])
    print(buf.getvalue(), end="", flush=True)
    res = {"wall_s": time.perf_counter() - t0, "batches": got["batches"],
           "images": got["images"], "images_per_s": got["images_per_s"],
           "seconds": got["seconds"], "timers": got["timers"]}
    print(f"phase 10d, the data-loading profiler: {json.dumps(res)}",
          flush=True)
    want = WAI_SAMPLES * WAI_VIEWS
    if got["batches"] != [want // WAI_IMGS] or got["images"] != want:
        return res, (f"10d: the profiler counted {got['batches']} batches "
                     f"and {got['images']} images, expected "
                     f"[{want // WAI_IMGS}] and {want}")
    return res, None


def seeded_model(torch, MapAnything, MapAnythingConfig, **flags):
    """Phase 4's model: the released config, its own init from seed 1."""
    return MapAnything(MapAnythingConfig(**flags), generator=torch.Generator(
        device="cuda").manual_seed(1))


def launches_of(fa) -> dict:
    return dict(fa.flash_attention.kernel_counts)


# the names of the training kernels in a device trace
REPLAY_KERNELS = {"fwd_lse": "flash_fwd_sm90", "dkv": "flash_bwd_dkv_sm90",
                  "dq": "flash_bwd_dq_sm90"}


def step_counts(step) -> dict:
    """make_train_step's counter of captures, replays and eager steps, of
    `step` or of its `train_step` (VariantStep's); {} for a step without
    one."""
    return dict(getattr(getattr(step, "train_step", step), "counts", None)
                or {})


def host_launches(step, before: dict, want: dict) -> dict:
    """The attention launches a train step made from the host since its
    counter read `before`: `want` where it ran eagerly or was captured
    (the capture counts the launches it records), none where it replayed
    its CUDA graph. A replay's launches show in its device trace alone
    (replay_launches)."""
    replays = step_counts(step).get("replays", 0)
    return {} if replays > before.get("replays", 0) else want


def replay_launches(torch, step, call, want: dict) -> tuple:
    """The training kernels that one `call()`, a replay of the train step's
    CUDA graph, runs on the card, counted by name in its device trace
    (perf/timing.py::trace_kernel_counts), against `want`. Returns (the
    counts, failure or None); a call that does not replay fails."""
    from torch.profiler import ProfilerActivity, profile

    from mapanything_tpu_torch.perf.timing import trace_kernel_counts

    counted = step_counts(step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    if host_launches(step, counted, want):
        return {}, "the traced train step did not replay its graph"
    found = trace_kernel_counts(prof, REPLAY_KERNELS.values())
    counts = {key: found[name] for key, name in REPLAY_KERNELS.items()}
    if counts != want:
        return counts, (f"a replayed train step ran {counts} training "
                        f"kernels on the card, expected {want}")
    return counts, None


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
        counted = step_counts(step)
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        bad = expect_launches(fa,
                              host_launches(step, counted, TRAIN_LAUNCHES),
                              f"aug_training step {i}")
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
        counted = step_counts(step)
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        bad = expect_launches(fa,
                              host_launches(step, counted, CKPT_LAUNCHES),
                              f"{STAGE2_VIEWS}-view step")
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
                        InferencePipeline):
    """Phase 8d, at p = 1: config 3 through the view-sharded pipeline
    against the unsharded call, then the view-sharded aug_training step
    against the unsharded one with the same generator seed, and its launch
    counts. Returns (results, launches, failure or None)."""
    model = random_weights_model()
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
    from mapanything_tpu_torch.parallel.mesh_check import cut_trunk
    from mapanything_tpu_torch.train import loop as L
    from mapanything_tpu_torch.train import seq_parallel as SP
    from mapanything_tpu_torch.train import step as T
    from mapanything_tpu_torch.train.grad_check import (
        compare,
        compare_sharded,
    )
    from mapanything_tpu_torch.utils.inference import InferencePipeline

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
    res, launches, bad = trainer_check(
        torch, fa, T, L,
        lambda: make_model(**cut_trunk(TRAINER_TRUNK_DEPTH)),
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
            make_synthetic_batch, aug, group, views, InferencePipeline)
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
    from mapanything_tpu_torch.train import save_params
    from mapanything_tpu_torch.utils.inference import InferencePipeline

    # 9a: the forward at the serving shapes
    rows = kernel_vs_plain(torch, fa, fp, F, SERVING_SHAPES, seed=900,
                           baseline=False)
    for name, row in rows:
        row["at"] = name
        if not max(row["max_abs_err"], row["rel_l2"]) <= ERR_LIMIT:
            return rows, [], f"kernel disagrees with plain at {name}: {row}"

    model = random_weights_model()
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


# phase 10: training from a WAI tree at full width, through the training CLI
# (python -m mapanything_tpu_torch.train). The training kernels at the
# shapes the loader's batches give them: 2 samples x 4 views a step
# (--max_imgs_per_device 8), one aspect-ratio bucket a batch; the encoder
# adds a class token and the global layer the scale token, both padded to
# 128 keys
LOADER_SHAPES = [
    # 518x392 (37 x 28 = 1036 patches)
    ("encoder_518x392_b2x4", (8, 1152, 16, 64), 1037),
    ("frame_518x392_b2x4", (8, 1036, 16, 64), None),
    ("global_518x392_b2x4", (2, 4224, 16, 64), 4145),
    # 518x336 (37 x 24 = 888 patches)
    ("encoder_518x336_b2x4", (8, 896, 16, 64), 889),
    ("frame_518x336_b2x4", (8, 888, 16, 64), None),
    ("global_518x336_b2x4", (2, 3584, 16, 64), 3553),
]
# the CLI validates in the first bucket, 2 samples of 4 views a batch,
# through the lse-free forward (B1 at the encoder and frame layers, B2 at
# the global layer)
VALIDATION_SHAPES = LOADER_SHAPES[:3]
WAI_BUCKETS = [(518, 392), (518, 336)]
WAI_SCENES = (("scene_exr", "exr"), ("scene_npy", "npy"))  # depth format
WAI_FRAMES, WAI_SIZE = 8, (640, 480)
WAI_VIEWS, WAI_IMGS = 4, 8  # views a sample, images a batch (2 samples)
WAI_SAMPLES = 8  # 4 steps; the sampler (seed epoch + 788) draws both buckets
VAL_SAMPLES = 4  # 2 validation batches of 2
CLI_SEED = 0  # the model's init and the masks' generator
TIMED_STEPS, PROFILED_STEPS = 3, 2


def write_wai_tree(folder: str) -> str:
    """WAI_SCENES of WAI_FRAMES seeded 640x480 frames through the port's
    write_scene: smooth images with noise, a smooth positive depth, a
    camera moving along x, a banded covisibility (the walk chooses among
    the two neighbours on each side)."""
    import numpy as np

    from mapanything_tpu_torch.data.wai import write_scene

    w, h = WAI_SIZE
    rng = np.random.default_rng(10)
    yy, xx = np.mgrid[0:h, 0:w] / max(w, h)
    dist = np.abs(np.arange(WAI_FRAMES)[:, None]
                  - np.arange(WAI_FRAMES)[None, :])
    covis = np.clip(1.0 - dist / 3.0, 0.0, 1.0).astype(np.float32)
    intrinsics = dict(fx=0.9 * w, fy=0.9 * w, cx=w / 2, cy=h / 2, w=w, h=h)
    root = os.path.join(folder, "wai")
    for s, (scene, fmt) in enumerate(WAI_SCENES):
        frames = []
        for i in range(WAI_FRAMES):
            base = np.stack([np.sin(6 * xx + i + s), np.cos(5 * yy - i),
                             np.sin(4 * (xx + yy) + s)], -1)
            img = 127.5 * (1 + 0.8 * base) + rng.normal(0, 8, base.shape)
            pose = np.eye(4)
            pose[:3, 3] = [0.1 * i, 0.0, 0.02 * s]
            frames.append({
                "frame_name": f"frame_{i:03d}",
                "image": np.clip(img, 0, 255).astype(np.uint8),
                "depth": (2.0 + np.sin(3 * xx + i) + 0.5 * yy
                          + rng.uniform(0, 0.05, (h, w))).astype(np.float32),
                "transform_matrix": pose})
        write_scene(os.path.join(root, scene), frames, intrinsics, covis,
                    depth_format=fmt)
    return root


def wai_spec(samples: int, buckets, seed: int) -> str:
    return (f"{samples} @ WAIDataset(ROOT=wai_root, spec='eth3d', "
            f"num_views={WAI_VIEWS}, covisibility_thres=0.25, "
            f"resolution={list(buckets)}, seed={seed})")


class TimedLoader:
    """The CLI's train loader, timed: the seconds the training thread
    waits for each batch, and the host seconds each batch took to load in
    its worker thread."""

    def __init__(self, inner):
        self.inner, self.wait_s, self.load_s = inner, [], []
        load = inner._load_batch

        def timed_load(idxs):
            t0 = time.perf_counter()
            out = load(idxs)
            self.load_s.append(time.perf_counter() - t0)
            return out

        inner._load_batch = timed_load

    def set_epoch(self, epoch):
        self.inner.set_epoch(epoch)

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        it = iter(self.inner)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.wait_s.append(time.perf_counter() - t0)
                yield batch
        finally:
            it.close()


def first_loader_batch(DL, mix, spec, root):
    """The first batch of a train loader built as the CLI builds it."""
    loader = DL.get_train_data_loader(mix(spec, wai_root=root),
                                      max_num_of_imgs_per_gpu=WAI_IMGS)
    loader.set_epoch(0)
    it = iter(loader)
    try:
        return next(it)
    finally:
        it.close()


def batches_equal(a, b) -> bool:
    import numpy as np

    return all(sorted(a[g]) == sorted(b[g]) and all(
        a[g][k].dtype == b[g][k].dtype and np.array_equal(a[g][k], b[g][k])
        for k in a[g]) for g in ("views", "gt"))


def cli_flash_vs_math(torch, CLI, L, batch) -> dict:
    """The loss of the loader's first batch, images only, on the CLI's
    initial weights, with flash and with math attention (no gradient)."""
    from mapanything_tpu_torch.models import images_only_config
    from mapanything_tpu_torch.train.losses import overall_loss

    model = CLI.build_model(False, None, CLI_SEED)
    dbatch = L.to_device(batch, "cuda")
    losses = {}
    with torch.no_grad():
        for impl in ("auto", "math"):
            model.set_attn_impl(impl)
            preds = model(dbatch["views"], images_only_config())
            losses[impl] = float(overall_loss(dbatch["gt"], preds)[0])
            del preds
    model.set_attn_impl("auto")
    del model, dbatch
    torch.cuda.empty_cache()
    return {"loss_flash": losses["auto"], "loss_math": losses["math"],
            "loss_rel_diff": abs(losses["auto"] - losses["math"])
            / max(abs(losses["math"]), 1e-30)}


def cli_training(torch, fa, fp, F):
    """Phase 10. Returns (the training kernels' rows, the forward's rows,
    the kernel counts of its runs, failure or None)."""
    import gc

    import numpy as np

    from mapanything_tpu_torch.data import loader as DL
    from mapanything_tpu_torch.models import aug_training_config
    from mapanything_tpu_torch.train import __main__ as CLI
    from mapanything_tpu_torch.train import loop as L
    from mapanything_tpu_torch.train import step as T

    # 10a: the training kernels at the loader's shapes
    t0 = time.perf_counter()
    rows = training_kernels_vs_plain(torch, fa, fp, F, LOADER_SHAPES,
                                     seed=1000, baseline=False)
    for kname, krows in rows.items():
        for row in krows:
            bad = {key: val for key, val in row.items()
                   if key.endswith(("_max_abs_rel", "_rel_l2"))
                   and not val <= ERR_LIMIT}
            if bad:
                return rows, [], [], (f"{kname} disagrees with plain at "
                                      f"{row['at']}: {bad}")
    # the lse-free forward at the validation batches' shapes (9a's method)
    fwd_rows = kernel_vs_plain(torch, fa, fp, F, VALIDATION_SHAPES,
                               seed=1100, baseline=False)
    for name, row in fwd_rows:
        row["at"] = name
        if not max(row["max_abs_err"], row["rel_l2"]) <= ERR_LIMIT:
            return rows, fwd_rows, [], (f"flash_attn_fwd disagrees with "
                                        f"plain at {name}: {row}")
    print(f"phase 10a, training kernels at the loader's shapes and the "
          f"forward at the validation's ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    counts = []
    with tempfile.TemporaryDirectory() as folder:
        t0 = time.perf_counter()
        root = write_wai_tree(folder)
        spec = wai_spec(WAI_SAMPLES, WAI_BUCKETS, seed=7)
        val_spec = wai_spec(VAL_SAMPLES, WAI_BUCKETS[:1], seed=9)
        res = {"tree_s": time.perf_counter() - t0, "sampler_seed": 0 + 788,
               "dataset_spec": spec, "val_dataset_spec": val_spec}
        # 10b: the loader is deterministic; the flash-vs-math gate on the
        # CLI's initial weights
        t0 = time.perf_counter()
        first = first_loader_batch(DL, L.build_dataset_mix, spec, root)
        again = first_loader_batch(DL, L.build_dataset_mix, spec, root)
        res["two_loaders_s"] = time.perf_counter() - t0
        if not batches_equal(first, again):
            return (rows, fwd_rows, counts,
                    "two loaders' first batches differ")
        res["first_batch"] = {g: {k: list(v.shape) for k, v in d.items()}
                              for g, d in first.items()}
        res["flash_vs_math"] = cli_flash_vs_math(torch, CLI, L, first)
        print(f"phase 10b: {json.dumps(res)}", flush=True)
        if not res["flash_vs_math"]["loss_rel_diff"] <= ERR_LIMIT:
            return rows, fwd_rows, counts, (
                f"the first batch's loss, flash against math: "
                f"{res['flash_vs_math']}")
        del first, again
        gc.collect()

        # 10c: the CLI, in this process, with its loader, steps,
        # validation and checkpoint saves instrumented
        steps, val, saves, loaders, made = [], [], [], [], []
        make_step, test_epoch = L.make_train_step, L.test_one_epoch
        save, get_loader = L.save_train_state, DL.get_train_data_loader

        def counted_step(*args, **kw):
            step = make_step(*args, **kw)
            made.append(step)

            def run(state, batch, generator=None):
                fa.reset_launch_counts()
                counted = step_counts(step)
                t_start = time.perf_counter()
                state, metrics = step(state, batch, generator)
                steps.append({"t": t_start, "loss": metrics["loss"],
                              "shape": list(batch["views"]["img"].shape),
                              "counts": launches_of(fa),
                              "want": host_launches(step, counted,
                                                    TRAIN_LAUNCHES),
                              "plain": fa.flash_attention.plain_launches})
                return state, metrics
            run.counts = step.counts
            return run

        def counted_eval(model, loader, *args, **kw):
            fa.reset_launch_counts()
            out = test_epoch(model, loader, *args, **kw)
            val.append({"batches": len(loader), "counts": launches_of(fa),
                        "plain": fa.flash_attention.plain_launches})
            return out

        def timed_save(path, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(path, *args, **kw)
            saves.append({"file": os.path.basename(path),
                          "seconds": time.perf_counter() - t0,
                          "gib": os.path.getsize(path) / 2**30})

        def timed_loader(*args, **kw):
            loaders.append(TimedLoader(get_loader(*args, **kw)))
            return loaders[-1]

        out_dir = os.path.join(folder, "run")
        argv = ["--wai_root", root, "--dataset_spec", spec,
                "--val_dataset_spec", val_spec,
                "--max_imgs_per_device", str(WAI_IMGS), "--epochs", "1",
                "--task", "aug_training", "--warmup_steps", "2",
                "--total_steps", "100", "--print_freq", "1",
                "--seed", str(CLI_SEED), "--output_dir", out_dir]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        L.make_train_step, L.test_one_epoch = counted_step, counted_eval
        L.save_train_state, DL.get_train_data_loader = timed_save, timed_loader
        t0 = time.perf_counter()
        try:
            state = CLI.main(argv)
        finally:
            L.make_train_step, L.test_one_epoch = make_step, test_epoch
            L.save_train_state, DL.get_train_data_loader = save, get_loader
        res = {"cli_s": time.perf_counter() - t0, "argv": argv[4:],
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
        losses = [float(s["loss"]) for s in steps]
        heights = sorted({s["shape"][2] for s in steps})
        walls = [(b["t"] - a["t"]) * 1e3 for a, b in zip(steps, steps[1:])]
        loader = loaders[0]
        res.update({
            "steps": len(steps), "losses": losses,
            "batch_shapes": [s["shape"] for s in steps],
            "replayed": [not s["want"] for s in steps],
            "train_step": step_counts(made[0]) if made else {},
            "step_interval_ms": walls,
            "step_interval_ms_median": (statistics.median(walls)
                                        if walls else None),
            "loader_wait_ms": [w * 1e3 for w in loader.wait_s],
            "loader_host_ms_per_batch": [s * 1e3 for s in loader.load_s],
            "checkpoint_saves": saves,
            "validation": val,
        })
        bad = None
        for i, s in enumerate(steps):
            full = dict.fromkeys(fa.KERNELS, 0) | s["want"]
            if s["counts"] != full or s["plain"] != 0:
                bad = (f"CLI step {i}: kernel launches {s['counts']} and "
                       f"{s['plain']} plain, expected {full} and 0")
                break
            counts.append(s["counts"])
        for v in val:
            full = dict.fromkeys(fa.KERNELS, 0) | {
                "fwd": FORWARD_LAUNCHES * v["batches"]}
            if not bad and (v["counts"] != full or v["plain"] != 0):
                bad = (f"CLI validation: kernel launches {v['counts']} and "
                       f"{v['plain']} plain, expected {full} and 0")
            counts.append(v["counts"])
        if not bad and len(steps) != WAI_SAMPLES * WAI_VIEWS // WAI_IMGS:
            bad = f"{len(steps)} CLI steps"
        elif not bad and (len(val) != 1
                          or val[0]["batches"] != VAL_SAMPLES // 2):
            bad = f"CLI validation runs {val}"
        elif not bad and not all(math.isfinite(x) for x in losses):
            bad = f"CLI losses {losses}"
        elif not bad and heights != sorted(h for _, h in WAI_BUCKETS):
            bad = f"the CLI's steps ran buckets of heights {heights} alone"
        bad = bad or untouched_baseline(fp)
        if bad:
            print(f"phase 10c: {json.dumps(res)}", flush=True)
            return rows, fwd_rows, counts, bad

        # 10c: checkpoint-last against the final state, bitwise
        t0 = time.perf_counter()
        fresh = T.create_train_state(CLI.build_model(False, None, 1),
                                     T.OptimConfig())
        fresh, _, epoch = L.load_train_state(
            os.path.join(out_dir, "checkpoint-last"), fresh)
        res["checkpoint_load_s"] = time.perf_counter() - t0
        same = (epoch == 1 and fresh.step == state.step
                and fresh.optimizer.count == state.optimizer.count
                and all(torch.equal(a, b) for a, b in zip(
                    fresh.model.state_dict().values(),
                    state.model.state_dict().values()))
                and all(torch.equal(a, b) for a, b in zip(
                    fresh.optimizer.mu + fresh.optimizer.nu,
                    state.optimizer.mu + state.optimizer.nu)))
        res["checkpoint_last_equal"] = same
        del fresh
        torch.cuda.empty_cache()
        if not same:
            print(f"phase 10c: {json.dumps(res)}", flush=True)
            return (rows, fwd_rows, counts,
                    "checkpoint-last differs from the final state")

        # readings: TIMED_STEPS more steps on a loader batch, each ending
        # in a synchronise (the step alone, no loader), then
        # PROFILED_STEPS traced
        batch = L.to_device(first_loader_batch(
            DL, L.build_dataset_mix, spec, root), "cuda")
        step = T.make_train_step(state.model, aug_training_config())
        gen = torch.Generator(device="cuda").manual_seed(CLI_SEED)
        alone = []
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            step(state, batch, gen)
            torch.cuda.synchronize()
            alone.append((time.perf_counter() - t0) * 1e3)
        res["step_ms_alone"] = alone
        wall = statistics.median(alone)
        res["profile"] = profile_calls(torch, lambda: step(state, batch, gen),
                                       wall, calls=PROFILED_STEPS)
        res["profile_batch"] = list(batch["views"]["img"].shape)
        del state, step, batch
        gc.collect()
        torch.cuda.empty_cache()
        _, bad = profiler_run(root, spec)
        if bad:
            return rows, fwd_rows, counts, bad
    prof = res["profile"]
    waits = res["loader_wait_ms"][1:]  # the first waits for the cold start
    print(f"phase 10c, the CLI at full width: {res['steps']} steps, losses "
          f"{[round(x, 4) for x in res['losses']]}, buckets {heights}; step "
          f"interval in the loop {res['step_interval_ms_median']:.2f} ms "
          f"median; the step alone "
          f"{statistics.median(res['step_ms_alone']):.2f} ms median, device "
          f"{prof.get('device_ms', float('nan')):.2f} ms, busy "
          f"{prof.get('busy_share', float('nan')):.3f}, peak "
          f"{res['peak_memory_gib']:.2f} GiB; loader host "
          f"{statistics.median(res['loader_host_ms_per_batch']):.1f} ms a "
          f"batch, wait after the first {max(waits) if waits else 0:.2f} ms "
          f"at most; checkpoint saves "
          f"{[round(s['seconds'], 2) for s in saves]} s", flush=True)
    print(f"phase 10c: {json.dumps(res)}", flush=True)
    return rows, fwd_rows, counts, untouched_baseline(fp)


# phase 11: the demo path at full width. 8 views of 640x480 go to the
# 518x392 bucket (37 x 28 = 1036 patches a view): the global layer holds
# 8 x 1036 + the scale token = 8289 real keys, padded to 8320 (B2)
DEMO_VIEWS = 8
DEMO_SHAPE = ("global_518x392_8view", (1, 8320, 16, 64), 8289)
RANKING_LAUNCHES = 24  # the encoder's 24 blocks over the 8 frames at once
DEMO_SIZE = (518, 392)
TRACK_FOCAL = 480.0
TRACK_GRID = 32  # 32 x 32 = 1024 query points
EPE_LIMIT = 1.0  # px, as the JAX package's test of the same construction
BA_RMS_LIMIT = 0.25  # px, as tests/test_ba.py
CARD_VS_CPU = 1e-3


def tests_on_path():
    """tests/ on sys.path: its JAX-free helpers build phase 11's inputs
    (torch_reference_layout.py, torch_demo_scenes.py)."""
    tests = os.path.join(HERE, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)


class PeakRSS:
    """The process's peak resident set over a `with` block, sampled from
    /proc/self/statm every 5 ms (GiB)."""

    def __enter__(self):
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.peak = self.start = self.read()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.sample, daemon=True)
        self.thread.start()
        return self

    def read(self) -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page / 2**30

    def sample(self):
        while not self.stop.wait(0.005):
            self.peak = max(self.peak, self.read())

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self.read())


def read_glb(path: str):
    """(the JSON chunk, accessor 0's positions (N, 3)) of a GLB file, its
    magic, version and length checked."""
    import numpy as np

    with open(path, "rb") as f:
        raw = f.read()
    magic, version, total = struct.unpack("<4sII", raw[:12])
    n, kind = struct.unpack("<I4s", raw[12:20])
    if (magic, version, total, kind) != (b"glTF", 2, len(raw), b"JSON"):
        raise ValueError(f"{path}: not a GLB ({magic}, {version}, {total})")
    gltf = json.loads(raw[20:20 + n])
    binary = raw[20 + n + 8:]
    view = gltf["bufferViews"][0]
    pos = np.frombuffer(binary[view["byteOffset"]:view["byteOffset"]
                               + view["byteLength"]], np.float32)
    return gltf, pos.reshape(-1, 3)


def run_demo(main, argv):
    """A demo's main(argv) in this process; its printed lines are echoed
    and returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    print(text, end="", flush=True)
    if rc != 0:
        raise RuntimeError(f"demo exited with {rc}")
    return text


def reference_snapshot(torch, folder):
    """11a: phase 3's weights as a two-shard HF snapshot in the reference's
    layout, loaded with from_pretrained. Returns (readings, the loaded
    model, its path, failure or None)."""
    tests_on_path()
    from torch_reference_layout import reference_state_dict, write_snapshot

    from mapanything_tpu_torch.models import MapAnythingConfig
    from mapanything_tpu_torch.models.pretrained import from_pretrained

    if not _RANDOM_WEIGHTS:  # phase 11 alone: draw phase 3's weights
        random_weights_model()
        torch.cuda.empty_cache()
    weights = _RANDOM_WEIGHTS
    snap = os.path.join(folder, "snapshot")
    t0 = time.perf_counter()
    write_snapshot(snap, reference_state_dict(
        weights, MapAnythingConfig().trunk_indices), shards=2)
    res = {"write_s": time.perf_counter() - t0,
           "files": sorted(os.listdir(snap)),
           "disk_gib": sum(os.path.getsize(os.path.join(snap, f))
                           for f in os.listdir(snap)) / 2**30}
    with PeakRSS() as rss:
        t0 = time.perf_counter()
        model = from_pretrained(snap)
        torch.cuda.synchronize()
        res["load_s"] = time.perf_counter() - t0
    res.update(rss_before_gib=rss.start, peak_rss_gib=rss.peak,
               host_weights_gib=sum(v.numel() * v.element_size()
                                    for v in weights.values()) / 2**30)
    got = model.state_dict()
    res["bitwise_equal"] = list(got) == list(weights) and all(
        torch.equal(got[key].cpu(), weights[key]) for key in weights)
    res["config_is_released"] = model.cfg == MapAnythingConfig()
    res["device"] = next(model.parameters()).device.type
    print(f"phase 11a, reference-layout snapshot: {json.dumps(res)}",
          flush=True)
    if not (res["bitwise_equal"] and res["config_is_released"]
            and res["device"] == "cuda"):
        return res, model, snap, f"11a: {res}"
    return res, model, snap, None


def images_only_demo(torch, fa, model, snap, images, folder):
    """11b: demo_images_only.main on the snapshot; the PLY and the GLB read
    back, the points bitwise the masked pts3d of `model`'s own infer call.
    Returns (readings, launches, failure or None)."""
    import numpy as np

    from mapanything_tpu_torch import demo_images_only
    from mapanything_tpu_torch.data.image import load_images
    from mapanything_tpu_torch.demo_colmap import masked_points
    from mapanything_tpu_torch.utils.inference import InferencePipeline

    ply = os.path.join(folder, "reconstruction.ply")
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    run_demo(demo_images_only.main, ["--image_folder", images, "--output",
                                     ply, "--checkpoint", snap])
    res = {"wall_s": time.perf_counter() - t0}
    counts = launches_of(fa)
    bad = expect_launches(fa, {"fwd": FORWARD_LAUNCHES}, "11b")
    gltf, pos = read_glb(os.path.splitext(ply)[0] + ".glb")
    with open(ply) as f:
        header = [next(f) for _ in range(10)]
    preds = InferencePipeline(model).infer(load_images(images),
                                           memory_efficient_inference=False)
    want, _ = masked_points(preds)
    res.update(points=len(pos), ply_vertices=int(header[2].split()[-1]),
               glb_point_count=gltf["accessors"][0]["count"],
               frustum_vertices=gltf["accessors"][2]["count"],
               points_bitwise_infer=bool(np.array_equal(pos, want)))
    print(f"phase 11b, images-only demo: {json.dumps(res)}", flush=True)
    if bad:
        return res, counts, bad
    if not (res["points_bitwise_infer"] and 0 < len(pos)
            == res["ply_vertices"] == res["glb_point_count"]
            and res["frustum_vertices"] == DEMO_VIEWS * 16):
        return res, counts, f"11b: {res}"
    return res, counts, None


def colmap_demo(torch, fa, snap, images, folder):
    """11c: demo_colmap.main --ba on the snapshot at the default flags; both
    sparse models and points.glb read back. Returns (readings, launches,
    failure or None)."""
    import re

    import numpy as np

    from mapanything_tpu_torch import demo_colmap
    from mapanything_tpu_torch.utils import colmap_io

    out = os.path.join(folder, "colmap")
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    text = run_demo(demo_colmap.main, ["--image_folder", images,
                                       "--output_dir", out, "--checkpoint",
                                       snap, "--ba"])
    res = {"wall_s": time.perf_counter() - t0}
    counts = launches_of(fa)
    bad = expect_launches(fa, {"fwd": FORWARD_LAUNCHES + RANKING_LAUNCHES},
                          "11c")
    ba = re.search(r"BA: rms (\S+) px -> (\S+) px over (\d+) observations "
                   r"of (\d+) tracks", text)
    res.update(rms_before=float(ba.group(1)), rms_after=float(ba.group(2)),
               observations=int(ba.group(3)), tracks=int(ba.group(4)),
               stage_walls_s=json.loads(text.split("stage walls (s): ")[1]
                                        .splitlines()[0]))
    for sub in ("sparse", "sparse_ba"):
        path = os.path.join(out, sub)
        cams = colmap_io.read_cameras_bin(os.path.join(path, "cameras.bin"))
        imgs = colmap_io.read_images_bin(os.path.join(path, "images.bin"))
        pts, _ = colmap_io.read_points3d_bin(
            os.path.join(path, "points3D.bin"))
        rots = [colmap_io.quaternion_wxyz_to_matrix_np(im["qvec"])
                for im in imgs]
        res[sub] = {"cameras": len(cams), "images": len(imgs),
                    "points": len(pts),
                    "points_finite": bool(np.isfinite(pts).all()),
                    "rotation_orthonormal_err": max(
                        float(np.abs(r @ r.T - np.eye(3)).max())
                        for r in rots)}
    gltf, pos = read_glb(os.path.join(out, "points.glb"))
    res["glb_points"] = len(pos)
    print(f"phase 11c, COLMAP demo with --ba: {json.dumps(res)}", flush=True)
    if bad:
        return res, counts, bad
    models_ok = all(
        res[sub]["cameras"] == res[sub]["images"] == DEMO_VIEWS
        and res[sub]["points"] > 0 and res[sub]["points_finite"]
        and res[sub]["rotation_orthonormal_err"] <= 1e-4
        for sub in ("sparse", "sparse_ba"))
    if not (models_ok and res["glb_points"] == res["sparse"]["points"]
            and gltf["accessors"][0]["count"] == len(pos)
            and res["rms_after"] <= res["rms_before"]
            and res["sparse_ba"]["points"] == res["tracks"]):
        return res, counts, f"11c: {res}"
    return res, counts, None


# 11e: the app's forward launches by (q shape, real keys): the encoder's 24
# blocks and the trunk's 12 frame layers on B1, its 12 global layers on B2
APP_LAUNCHES = {((8, 1152, 16, 64), 1037): 24, ((8, 1036, 16, 64), 1036): 12,
                ((1, 8320, 16, 64), 8289): 12}
APP_MEASURE = "100,100,400,300"  # x1,y1,x2,y2 in the 518x392 frame
NORMALS_CARD_VS_CPU = 1e-5
# the pixels held to it: the four unit quad normals sum to at least this
# (4 on a smooth surface), so fp32 rounding moves the normal < 2e-6
NORMALS_DEFINED = 0.5


def quad_normal_sum(torch, world, masks):
    """|the sum of the four unit quad normals| at each pixel of (V, H, W, 3)
    pointmaps, in fp64 on the host: geometry/edges.py::points_to_normals
    normalises this sum, so its normal is defined where it is away from
    0."""
    h, w = world.shape[1:3]
    pts = torch.nn.functional.pad(world.double().permute(0, 3, 1, 2),
                                  (1, 1, 1, 1)).permute(0, 2, 3, 1)
    mp = torch.nn.functional.pad(masks.double(), (1, 1, 1, 1)) > 0.5
    centre, m_c = pts[:, 1:h + 1, 1:w + 1], mp[:, 1:h + 1, 1:w + 1]

    def side(di, dj):
        return (pts[:, di:di + h, dj:dj + w] - centre,
                mp[:, di:di + h, dj:dj + w])

    (up, m_u), (left, m_l) = side(0, 1), side(1, 0)
    (down, m_d), (right, m_r) = side(2, 1), side(1, 2)
    total = torch.zeros_like(centre)
    for a, b, m in ((up, left, m_u & m_l), (left, down, m_l & m_d),
                    (down, right, m_d & m_r), (right, up, m_r & m_u)):
        cross = torch.linalg.cross(a, b)
        unit = cross / (cross.norm(dim=-1, keepdim=True) + 1e-12)
        total = total + unit * (m & m_c)[..., None]
    return total.norm(dim=-1)


def demo_app_run(torch, fa, snap, images, folder):
    """11e: demo_app.main on the snapshot with --sky_masks and --measure;
    the forward's launches by shape, the files read back, the GLB's scene
    mesh against utils/mesh.py::image_mesh of the app's own predictions,
    the app's normal maps recomputed on the card and on the CPU. Returns
    (readings, launches, failure or None)."""
    import collections
    import re
    from unittest import mock

    import numpy as np
    from PIL import Image

    from mapanything_tpu_torch import demo_app
    from mapanything_tpu_torch.geometry import points_to_normals
    from mapanything_tpu_torch.utils import demo_core as dc
    from mapanything_tpu_torch.utils import mesh as PM

    out = os.path.join(folder, "app")
    shapes, kept = [], {}
    fwd, run_model = fa._fwd_cuda, dc.run_model

    def recording_fwd(q, k, v, n_valid, with_lse):
        shapes.append((tuple(q.shape),
                       k.shape[1] if n_valid is None else int(n_valid)))
        return fwd(q, k, v, n_valid, with_lse)

    def keeping_run_model(*args, **kw):
        kept["out"] = run_model(*args, **kw)
        return kept["out"]

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(fa, "_fwd_cuda", recording_fwd), \
            mock.patch.object(dc, "run_model", keeping_run_model):
        text = run_demo(demo_app.main, [
            "--image_folder", images, "--out_dir", out, "--checkpoint", snap,
            "--sky_masks", "--measure", APP_MEASURE])
    res = {"wall_s": time.perf_counter() - t0,
           "stage_walls_s": {m.group(1): float(m.group(2)) for m in
                             re.finditer(r"^wall (\w+): (\S+) s$", text,
                                         re.M)}}
    counts = launches_of(fa)
    bad = expect_launches(fa, {"fwd": FORWARD_LAUNCHES}, "11e")
    per_shape = collections.Counter(shapes)
    res["launches_by_shape"] = {f"{list(q)}/{n}": c
                                for (q, n), c in per_shape.items()}
    if not bad and dict(per_shape) != APP_LAUNCHES:
        bad = f"11e: forward launches by shape {res['launches_by_shape']}"

    preds, processed = kept["out"]
    gltf, _ = read_glb(os.path.join(out, "scene.glb"))
    prim = gltf["meshes"][0]["primitives"][0]
    res["glb"] = {"vertices": gltf["accessors"][prim["attributes"][
        "POSITION"]]["count"], "faces": gltf["accessors"][prim["indices"]][
        "count"] // 3, "meshes": len(gltf["meshes"])}
    t0 = time.perf_counter()
    verts = faces = 0
    for world, mask in zip(preds["world_points"], preds["final_mask"]):
        f, v = PM.image_mesh(world, mask=mask, tri=True, diagonal_attr=0)
        verts, faces = verts + len(v), faces + len(f)
    res["image_mesh"] = {"vertices": verts, "faces": faces,
                         "seconds": time.perf_counter() - t0}

    world = torch.from_numpy(preds["world_points"])
    masks = torch.from_numpy(np.stack([processed[i]["mask"]
                                       for i in sorted(processed)]))
    card, card_mask = points_to_normals(world.cuda(), masks.cuda())
    cpu, cpu_mask = points_to_normals(world, masks)
    app = np.stack([processed[i]["normal"] for i in sorted(processed)])
    diff = (card.cpu() - cpu).abs().amax(-1)
    # held to the limit where the normal is well defined: the four unit
    # quad normals sum (fp64) to at least NORMALS_DEFINED. Where they
    # cancel, a 1-ulp difference turns the unit normal of a tiny sum in any
    # direction (torch's fp32 sqrt on the CPU is vectorised and not
    # correctly rounded: 0.6% of uniform inputs differ by an ulp)
    defined = quad_normal_sum(torch, world, masks) >= NORMALS_DEFINED
    res["normals"] = {
        "card_vs_cpu_defined": float(diff[defined].max()),
        "defined_share": float(defined[cpu_mask].float().mean()),
        "card_vs_cpu_max": float(diff.max()),
        "over_limit_pixels": int((diff > NORMALS_CARD_VS_CPU).sum()),
        "masks_equal": bool(torch.equal(card_mask.cpu(), cpu_mask)),
        "app_vs_card": float(np.abs(app - card.cpu().numpy()).max()),
        "valid_share": float(cpu_mask.float().mean())}

    names = set(os.listdir(out))
    want = {"scene.glb", "measure.json", "sky"} | {
        f"{kind}_{i:03d}.png" for kind in ("depth", "normal")
        for i in range(DEMO_VIEWS)}
    sky = [np.asarray(Image.open(os.path.join(out, "sky", name)))
           for name in sorted(os.listdir(os.path.join(out, "sky")))]
    with open(os.path.join(out, "measure.json")) as f:
        measured = json.load(f)
    res.update(files_ok=names == want, sky_masks=len(sky),
               sky_share=float(np.mean([(m == 0).mean() for m in sky])),
               measure_valid=measured["valid"],
               measure_distance=measured.get("distance"))
    print(f"phase 11e, the demo app: {json.dumps(res)}", flush=True)
    if bad:
        return res, counts, bad
    if not (res["files_ok"] and len(sky) == DEMO_VIEWS and all(
            m.shape == DEMO_SIZE[::-1] and set(np.unique(m)) <= {0, 255}
            for m in sky)):
        return res, counts, f"11e: the app's files {sorted(names)}"
    if not (res["glb"]["vertices"] == verts and res["glb"]["faces"] == faces
            and verts > 0 and res["glb"]["meshes"] == 1 + DEMO_VIEWS):
        return res, counts, (f"11e: the GLB's scene mesh {res['glb']} "
                             f"against image_mesh's {res['image_mesh']}")
    normals = res["normals"]
    if not (normals["card_vs_cpu_defined"] <= NORMALS_CARD_VS_CPU
            and normals["masks_equal"] and normals["app_vs_card"] == 0.0):
        return res, counts, f"11e: normals card against CPU {res['normals']}"
    return res, counts, None


def converter_run(torch, snap, folder):
    """11f: convert_torch_checkpoint.main --report on the snapshot, the
    port's file loaded with from_pretrained onto the card and held bitwise
    to phase 3's weights (11a's snapshot model). Returns (readings, failure
    or None)."""
    import re

    from mapanything_tpu_torch import convert_torch_checkpoint
    from mapanything_tpu_torch.models import MapAnythingConfig
    from mapanything_tpu_torch.models.pretrained import from_pretrained

    out = os.path.join(folder, "converted.pt")
    t0 = time.perf_counter()
    text = run_demo(convert_torch_checkpoint.main,
                    ["--input", snap, "--output", out, "--report"])
    res = {"convert_s": time.perf_counter() - t0,
           "report_groups": len(re.findall(r"^  \S+: \d+$", text, re.M)),
           "file_gib": os.path.getsize(out) / 2**30}
    t0 = time.perf_counter()
    model = from_pretrained(out)
    torch.cuda.synchronize()
    res["load_s"] = time.perf_counter() - t0
    got = model.state_dict()
    res["bitwise_equal"] = list(got) == list(_RANDOM_WEIGHTS) and all(
        torch.equal(got[key].cpu(), val)
        for key, val in _RANDOM_WEIGHTS.items())
    res["config_is_released"] = model.cfg == MapAnythingConfig()
    res["device"] = next(model.parameters()).device.type
    del model, got
    os.remove(out)
    print(f"phase 11f, the checkpoint converter: {json.dumps(res)}",
          flush=True)
    if not (res["bitwise_equal"] and res["config_is_released"]
            and res["device"] == "cuda" and res["report_groups"] > 0):
        return res, f"11f: {res}"
    return res, None


def known_geometry(torch):
    """11d: the tracker on 8 rendered views of a textured plane at 518x392
    against the exact correspondences, and bundle adjustment of 8 frames x
    1024 points on the card against the CPU. Returns (readings, failure or
    None)."""
    import numpy as np

    tests_on_path()
    from torch_demo_scenes import (
        ba_problem,
        grid_points,
        plane_correspondences,
        plane_views,
    )

    from mapanything_tpu_torch.utils import ba as BA
    from mapanything_tpu_torch.utils.tracking import track_points

    w, h = DEMO_SIZE
    views, homs = plane_views(0, DEMO_VIEWS, h, w, TRACK_FOCAL)
    query = grid_points(h, w, TRACK_GRID, 40)
    truth = plane_correspondences(homs, query.astype(np.float64))
    images, q = torch.from_numpy(views).cuda(), torch.from_numpy(query).cuda()
    track_points(images, q)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracks, vis = track_points(images, q)
    torch.cuda.synchronize()
    epe = np.linalg.norm(tracks.cpu().numpy() - truth, axis=-1)
    res = {"points": len(query), "frames": DEMO_VIEWS,
           "track_ms": (time.perf_counter() - t0) * 1e3,
           "mean_epe_px": float(epe.mean()), "max_epe_px": float(epe.max()),
           "mean_vis": float(vis.mean())}

    arrays, _ = ba_problem(0, n_f=DEMO_VIEWS, n_p=len(query),
                           intrinsics=(TRACK_FOCAL, TRACK_FOCAL, w / 2, h / 2))
    cpu = BA.BAProblem(*(torch.from_numpy(np.array(a)) for a in arrays))
    card = BA.BAProblem(*(t.cuda() for t in cpu))
    BA.bundle_adjust(card, iters=2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = BA.bundle_adjust(card, iters=20)
    res.update(rms_before=float(out["rms_before"]),
               rms_after=float(out["rms_after"]),
               ba_ms=(time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    ref = BA.bundle_adjust(cpu, iters=20)
    res["ba_cpu_ms"] = (time.perf_counter() - t0) * 1e3
    res["card_vs_cpu"] = {}
    for key in ("cam_quats", "cam_trans", "intrinsics", "points"):
        want = ref[key].double().numpy()
        res["card_vs_cpu"][key] = float(
            np.abs(out[key].double().cpu().numpy() - want).max()
            / max(1.0, np.abs(want).max()))
    print(f"phase 11d, tracking and BA on known geometry: {json.dumps(res)}",
          flush=True)
    if not res["mean_epe_px"] <= EPE_LIMIT:
        return res, f"11d: mean endpoint error {res['mean_epe_px']} px"
    if not (res["rms_after"] < BA_RMS_LIMIT
            and res["rms_after"] < res["rms_before"] / 8):
        return res, f"11d: BA rms {res['rms_before']} -> {res['rms_after']}"
    if not max(res["card_vs_cpu"].values()) <= CARD_VS_CPU:
        return res, f"11d: card against the CPU {res['card_vs_cpu']}"
    return res, None


def demo_path(torch, fa, fp, F):
    """Phase 11 (the forward at the demo's global shape, 11a-11f). Returns
    (kernel rows, the kernel counts of the demos' runs, failure or None)."""
    rows = kernel_vs_plain(torch, fa, fp, F, [DEMO_SHAPE], seed=1100,
                           baseline=False)
    for name, row in rows:
        row["at"] = name
        if not max(row["max_abs_err"], row["rel_l2"]) <= ERR_LIMIT:
            return rows, [], f"kernel disagrees with plain at {name}: {row}"
    counts = []
    with tempfile.TemporaryDirectory() as folder:
        res, model, snap, bad = reference_snapshot(torch, folder)
        if bad:
            return rows, counts, bad
        images = os.path.join(folder, "images")
        os.makedirs(images)
        write_images(images, DEMO_VIEWS, 640, 480)
        res, launched, bad = images_only_demo(torch, fa, model, snap, images,
                                              folder)
        counts.append(launched)
        if bad:
            return rows, counts, bad
        del model
        torch.cuda.empty_cache()
        res, launched, bad = colmap_demo(torch, fa, snap, images, folder)
        counts.append(launched)
        if bad:
            return rows, counts, bad
        torch.cuda.empty_cache()
        res, launched, bad = demo_app_run(torch, fa, snap, images, folder)
        counts.append(launched)
        if bad:
            return rows, counts, bad
        torch.cuda.empty_cache()
        res, bad = converter_run(torch, snap, folder)
        if bad:
            return rows, counts, bad
    torch.cuda.empty_cache()
    res, bad = known_geometry(torch)
    if bad:
        return rows, counts, bad
    return rows, counts, untouched_baseline(fp)


# phase 12: the evaluation path at full width. The forward at the shapes
# it runs that no earlier phase held: ModularDUSt3R-L at 512x384 (768
# tokens a view = 32 x 24 patches of 16, no class token; 16 heads in the
# ViT-L encoder, 12 in the ViT-B decoder; the cross-attention's k and v the
# strided halves of one (B, M, 2, H, D) tensor), per pair and at the
# benchmark's batch of 10 pairs; MapAnything at the dense N-view batches of
# 10 sets of 2 and 4 views at 518x392 (37 x 28 = 1036 patches a view)
EVAL_SHAPES = [
    # (name, (B, N, H, D), n_valid, layout: "qkv" fused, "cross" q + kv)
    ("dust3r_encoder_pair", (2, 768, 16, 64), None, "qkv"),
    ("dust3r_decoder_self_pair", (1, 768, 12, 64), None, "qkv"),
    ("dust3r_decoder_cross_pair", (1, 768, 12, 64), None, "cross"),
    ("dust3r_encoder_b10", (20, 768, 16, 64), None, "qkv"),
    ("dust3r_decoder_self_b10", (10, 768, 12, 64), None, "qkv"),
    ("dust3r_decoder_cross_b10", (10, 768, 12, 64), None, "cross"),
    ("encoder_518x392_b10x2", (20, 1152, 16, 64), 1037, "qkv"),
    ("frame_518x392_b10x2", (20, 1036, 16, 64), None, "qkv"),
    ("global_518x392_b10x2", (10, 2176, 16, 64), 2073, "qkv"),
    ("encoder_518x392_b10x4", (40, 1152, 16, 64), 1037, "qkv"),
    ("frame_518x392_b10x4", (40, 1036, 16, 64), None, "qkv"),
    ("global_518x392_b10x4", (10, 4224, 16, 64), 4145, "qkv"),
]
PLAIN_SCORE_BYTES = 3 * 2**30  # the plain version's score matrix, a slice
EVAL_SIZE = (518, 392)
EVAL_VIEWS, EVAL_BATCH, EVAL_SETS = (2, 4), 10, 10
DUST3R_SIZE = (512, 384)
# per ModularDUSt3RAdapter call: the pair and the swapped pair, each 24
# encoder blocks and 12 decoder layers x 2 branches x (self + cross)
DUST3R_LAUNCHES = 2 * (24 + 12 * 2 * 2)
# at ModularDUSt3R-L's own init bf16 math itself lies ~1.3e-2 (rel-L2) from
# an fp32 forward; flash may lie at most 1.1x as far at every tapped output
DUST3R_FLOOR_RATIO = 1.1
RMVD_SOURCES = 7  # rmvd's max_source_views: 1 key + 7 sources
CPU_METRICS_LIMIT = 1e-4  # the card's _normalize_for_metrics against fp32 CPU
REGISTRATION_LIMIT = 1e-4


def eval_attention_inputs(torch, shape, n_valid, layout, seed):
    """bf16 q, k, v: the fused-qkv views of nn/layers.py::Attention, or
    nn/croco.py::CrossAttention's q of its own with k and v the strided
    halves of one (B, N, 2, H, D) tensor."""
    if layout == "qkv":
        return attention_inputs(torch, shape, n_valid, seed)
    b, n, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, n, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    kv = torch.randn((b, n, 2, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    return (q, *kv.unbind(2))


def eval_kernel_rows(torch, fa, F):
    """12a: the forward kernel against its plain version at EVAL_SHAPES
    (phase 2's limits: max-abs over the plain's max-abs and rel-L2 over
    the real rows, 1e-2 each), with device ms, bound, flash SDPA's time
    and host µs. The plain version runs a batch slice at a time where its
    fp32 score matrix would pass PLAIN_SCORE_BYTES (its time is that of
    the whole loop). Returns ([(name, row)], failure or None)."""
    rows = []
    for i, (name, shape, n_valid, layout) in enumerate(EVAL_SHAPES):
        b, n, h, d = shape
        q, k, v = eval_attention_inputs(torch, shape, n_valid, layout,
                                        1200 + i)
        real = n if n_valid is None else n_valid
        step = max(1, min(b, PLAIN_SCORE_BYTES // (h * n * real * 4)))

        def plain():
            return torch.cat([fa.flash_attention_plain(
                q[j:j + step], k[j:j + step], v[j:j + step], n_valid)
                for j in range(0, b, step)])

        out = fa.flash_attention(q, k, v, n_valid=n_valid)
        ref = plain()
        torch.cuda.synchronize()
        o, r = out[:, :real].float(), ref[:, :real].float()
        row = {
            "shape": list(shape), "n_valid": n_valid, "layout": layout,
            "strides": [list(x.stride()[:3]) for x in (q, k, v)],
            "max_abs_err": float((o - r).abs().max()),
            "max_abs_rel": max_abs_rel(o, r), "rel_l2": rel_l2(o, r),
            "ms": kernel_ms(lambda: fa.flash_attention(q, k, v, n_valid)),
            "plain_ms": plain_ms(plain), "plain_batch_slice": step,
            "host_us": host_us(
                lambda: fa._fwd_cuda(q, k, v, n_valid, with_lse=False)),
        }
        flops = fa.attention_flops(b, n, real, h, d)
        row["tflops"] = flops / row["ms"] / 1e9
        row.update(bound(F, "fwd", shape, real))
        row["library_ms"] = library_fwd_ms(torch, *sdpa_layout(q, k, v, real))
        row["at"] = name
        print(f"12a attention {name} {tuple(shape)} n_valid={n_valid} "
              f"{layout}: max_abs_rel={row['max_abs_rel']:.3e} "
              f"rel_l2={row['rel_l2']:.3e} kernel {row['ms']:.4f} ms "
              f"({row['tflops']:.2f} TFLOP/s) plain {row['plain_ms']:.4f} ms "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) library "
              f"{row['library_ms']:.4f} ms; host {row['host_us']:.1f} us",
              flush=True)
        rows.append((name, row))
        del q, k, v, out, ref, o, r
        torch.cuda.empty_cache()
        if not max(row["max_abs_rel"], row["rel_l2"]) <= ERR_LIMIT:
            return rows, f"kernel disagrees with plain at {name}: {row}"
    return rows, None


class StageClock:
    """The walls of the benchmark CLIs' stages, read by wrapping, for the
    length of a `with` block, the functions each stage calls: the
    checkpoint load (train/checkpoints.py::load_params,
    models/pretrained.py::from_pretrained), every model forward
    (MapAnything and ModularDUSt3RAdapter, a synchronise on each side; the
    kernel launches of each call are kept), the metrics
    (compute_metrics_for_batch, ray_angular_error_deg) and the JSON
    writes; "rest" is the data loading and the set-up. `seen` holds the
    (gt, preds) of each compute_metrics_for_batch call."""

    def __init__(self, torch, fa):
        self.torch, self.fa = torch, fa
        self.walls = {}
        self.forwards = []
        self.seen = []

    def timed(self, stage, fn, sync=False, forward=False, keep=False):
        torch, fa = self.torch, self.fa

        def run(*args, **kw):
            if sync:
                torch.cuda.synchronize()
            before = launches_of(fa)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            self.walls[stage] = (self.walls.get(stage, 0.0)
                                 + time.perf_counter() - t0)
            if forward:
                after = launches_of(fa)
                self.forwards.append({key: after[key] - before[key]
                                      for key in after
                                      if after[key] != before[key]})
            if keep:
                self.seen.append(args[:2])
            return out

        return run

    def __enter__(self):
        from unittest import mock

        from mapanything_tpu_torch.benchmarks import calibration as BC
        from mapanything_tpu_torch.benchmarks import dense_n_view as BD
        from mapanything_tpu_torch.models import MapAnything
        from mapanything_tpu_torch.models import pretrained as PR
        from mapanything_tpu_torch.models.adapters import (
            ModularDUSt3RAdapter,
        )
        from mapanything_tpu_torch.train import checkpoints as CK

        self.stack = contextlib.ExitStack()
        for owner, name, stage, kw in (
                (CK, "load_params", "load", {"sync": True}),
                (PR, "from_pretrained", "load", {"sync": True}),
                (MapAnything, "forward", "forward",
                 {"sync": True, "forward": True}),
                (ModularDUSt3RAdapter, "forward", "forward",
                 {"sync": True, "forward": True}),
                (BD, "compute_metrics_for_batch", "metrics", {"keep": True}),
                (BC, "ray_angular_error_deg", "metrics", {"sync": True}),
                (BD, "write_json", "json", {}),
                (BC, "write_json", "json", {})):
            self.stack.enter_context(mock.patch.object(
                owner, name, self.timed(stage, getattr(owner, name), **kw)))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stack.close()
        total = time.perf_counter() - self.t0
        self.walls["rest"] = total - sum(self.walls.values())
        self.walls["total"] = total


def eval_loader(root: str, views: int, size, batch: int, sets: int,
                norm: str = "dinov2"):
    """A test loader as the benchmark CLIs build theirs."""
    from mapanything_tpu_torch.data.loader import get_test_data_loader
    from mapanything_tpu_torch.data.wai_datasets import WAIDataset

    ds = WAIDataset(ROOT=root, spec="eth3d", split="test", num_views=views,
                    covisibility_thres=0.25, resolution=tuple(size),
                    data_norm_type=norm, seed=0)
    return get_test_data_loader(sets @ ds, batch_size=batch, num_workers=2)


def first_batch(loader):
    loader.set_epoch(0)
    it = iter(loader)
    try:
        return next(it)
    finally:
        it.close()


def card_vs_cpu_metrics(torch, gt, preds) -> dict:
    """_normalize_for_metrics on the card against the same function on the
    CPU in fp32, from the same tensors: max |card - cpu| over max |cpu|
    per output (a bool output: 0 if equal, else 1)."""
    from mapanything_tpu_torch.benchmarks.dense_n_view import (
        _normalize_for_metrics,
    )

    def cpu(d):
        return {k: v.cpu() if v.dtype == torch.bool else v.float().cpu()
                for k, v in d.items()}

    with torch.inference_mode():
        card = _normalize_for_metrics(gt, preds)
        ref = _normalize_for_metrics(cpu(gt), cpu(preds))
    errs = {}
    for key, r in ref.items():
        g = card[key].cpu()
        errs[key] = (float(not torch.equal(g, r)) if r.dtype == torch.bool
                     else max_abs_rel(g, r))
    return errs


def gt_oracle_dense(torch, BD, batches) -> tuple:
    """The ground-truth oracle (tests/torch_eval_oracles.py) through
    run_dense_n_view_benchmark on the card, over {views: host batch}: each
    error at its floor."""
    tests_on_path()
    from torch_eval_oracles import (
        GroundTruthOracle,
        ListLoader,
        RecordingLoader,
    )

    res = {}
    for views, batch in batches.items():
        loader = RecordingLoader(ListLoader([batch]))
        res[views] = BD.run_dense_n_view_benchmark(
            GroundTruthOracle(loader, "cuda"), loader, None)
    bad = [f"{views} views: {s}" for views, s in res.items() if not (
        s["num_sets"] == EVAL_SETS
        and s["pointmaps_abs_rel"] <= 1e-5 and s["depth_abs_rel"] <= 1e-5
        and s["pointmaps_inlier_thres_103"] == 1.0
        and s["depth_inlier_thres_103"] == 1.0
        and s["pose_ate_rmse"] <= 1e-4 and s["pose_auc_5"] == 1.0
        and s["scale_abs_rel"] <= 1e-5)]
    return res, (f"12b GT oracle: {bad}" if bad else None)


def dense_cli(torch, fa, fp, ckpt, root, folder):
    """12b: benchmark_dense_n_view.main, both tasks, over the tree with
    phase 3's weights; the card's metrics against the CPU's, flash against
    math, the GT oracle. Returns (readings, launch counts, failure)."""
    import numpy as np

    from mapanything_tpu_torch import benchmark_dense_n_view as CLI
    from mapanything_tpu_torch.benchmarks import dense_n_view as BD
    from mapanything_tpu_torch.models import images_only_config
    from mapanything_tpu_torch.utils.device import to_device

    res, counts, seen = {}, [], None
    for task in ("images_only", "all_priors"):
        out = os.path.join(folder, f"dense_{task}")
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with StageClock(torch, fa) as clock:
            summaries = CLI.main([
                "--wai_root", root, "--checkpoint", ckpt, "--resolution",
                *map(str, EVAL_SIZE), "--views", *map(str, EVAL_VIEWS),
                "--batch_sizes", *[str(EVAL_BATCH)] * len(EVAL_VIEWS),
                "--num_sets", str(EVAL_SETS), "--task", task,
                "--output_dir", out])
        counts.append(launches_of(fa))
        r = {"walls_s": clock.walls, "forward_launches": clock.forwards,
             "plain_launches": fa.flash_attention.plain_launches,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "summary": {str(k): v for k, v in summaries.items()}}
        with open(os.path.join(out, "summary.json")) as f:
            back = json.load(f)
        per_set = {}
        for views in EVAL_VIEWS:
            with open(os.path.join(out, f"eth3d_{views}views.json")) as f:
                per_set[views] = json.load(f)
        r["json_read_back"] = (
            back == json.loads(json.dumps(r["summary"]))
            and all(len(per_set[v]["per_set"]) == EVAL_SETS
                    and per_set[v]["summary"] == back[str(v)]
                    for v in EVAL_VIEWS))
        res[task] = r
        print(f"12b dense N-view CLI, {task}: {json.dumps(r)}", flush=True)
        want = [{"fwd": FORWARD_LAUNCHES}] * len(EVAL_VIEWS)
        bad = expect_launches(fa, {"fwd": FORWARD_LAUNCHES * len(EVAL_VIEWS)},
                              f"12b {task}") or untouched_baseline(fp)
        if bad or clock.forwards != want:
            return res, counts, bad or (f"12b {task}: forward launches "
                                        f"{clock.forwards}, expected {want}")
        if not r["json_read_back"] or not all(
                s["num_sets"] == EVAL_SETS
                and np.isfinite(s["pointmaps_abs_rel"])
                for s in summaries.values()):
            return res, counts, f"12b {task}: {r}"
        seen = seen or clock.seen[-1]  # images only, the 4-view batch
    errs = card_vs_cpu_metrics(torch, *seen)
    res["card_vs_cpu_normalize"] = errs
    print(f"12b _normalize_for_metrics card vs CPU: {json.dumps(errs)}",
          flush=True)
    del seen
    if not max(errs.values()) <= CPU_METRICS_LIMIT:
        return res, counts, f"12b card vs CPU metrics: {errs}"

    # flash against math on one batch of 10 x 2 views, phase 3's weights;
    # the (10, 4)-view forward traced; the batches as the CLI loaded them
    batches = {views: first_batch(eval_loader(root, views, EVAL_SIZE,
                                              EVAL_BATCH, EVAL_SETS))
               for views in EVAL_VIEWS}
    model = random_weights_model()
    geom = images_only_config()
    views2 = to_device(batches[EVAL_VIEWS[0]], "cuda")["views"]
    views4 = to_device(batches[EVAL_VIEWS[-1]], "cuda")["views"]
    with torch.inference_mode():
        flash = model(views2, geom)["pts3d"]
        model.set_attn_impl("math")
        math_out = model(views2, geom)["pts3d"]
        model.set_attn_impl("auto")
        model(views4, geom)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(views4, geom)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        res["forward_b10x4"] = {"wall_ms": wall, **profile_calls(
            torch, lambda: model(views4, geom), wall, calls=2)}
    res["pts3d_rel_l2_vs_math"] = rel_l2(flash, math_out)
    print(f"12b flash vs math (10 x 2 views): pts3d rel-L2 "
          f"{res['pts3d_rel_l2_vs_math']:.3e}; the (10 x 4) forward: "
          f"{json.dumps(res['forward_b10x4'])}", flush=True)
    del model, flash, math_out, views2, views4
    torch.cuda.empty_cache()
    if not res["pts3d_rel_l2_vs_math"] <= ERR_LIMIT:
        return res, counts, (f"12b flash vs math: "
                             f"{res['pts3d_rel_l2_vs_math']}")
    res["gt_oracle"], bad = gt_oracle_dense(torch, BD, batches)
    print(f"12b GT oracle: {json.dumps(res['gt_oracle'])}", flush=True)
    return res, counts, bad


def registration_check(torch) -> tuple:
    """12c: rigid_points_registration on the card against the CPU, 8 x 1024
    weighted points under a known rotation, translation and scale."""
    import numpy as np

    from mapanything_tpu_torch.geometry import (
        quaternion_to_rotation_matrix,
        rigid_points_registration,
    )

    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    r_true = quaternion_to_rotation_matrix(q / q.norm(dim=-1, keepdim=True))
    t_true = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    s_true = torch.from_numpy(rng.uniform(0.5, 2.0, 8).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(8, 1024, 3)).astype(np.float32))
    rotated = (r_true[:, None] * a[..., None, :]).sum(-1)
    w = torch.from_numpy(rng.uniform(0.1, 1.0, (8, 1024)).astype(np.float32))
    res = {}
    for with_scale in (False, True):
        scale = s_true if with_scale else torch.ones(8)
        target = scale[:, None, None] * rotated + t_true[:, None]
        cpu = rigid_points_registration(a, target, w, with_scale)
        card = rigid_points_registration(a.cuda(), target.cuda(), w.cuda(),
                                         with_scale)
        r = {"card_vs_cpu": max(float((g.cpu() - c).abs().max())
                                for g, c in zip(card, cpu)),
             "rotation_err": float((card[0].cpu() - r_true).abs().max()),
             "translation_err": float((card[1].cpu() - t_true).abs().max())}
        if with_scale:
            r["scale_err"] = float((card[2].cpu() - s_true).abs().max())
        res["with_scale" if with_scale else "rigid"] = r
    bad = [key for key, r in res.items()
           if not max(r.values()) <= REGISTRATION_LIMIT]
    return res, (f"12c registration: {res}" if bad else None)


def dust3r_outputs(torch, model, adapter, imgs, impl) -> dict:
    """One adapter call with every attention on `impl`, in fp32 over both
    forwards: the encoder's first block, its middle block and its output,
    dec_norm's output (the decoder before the linear head and its expm1),
    and pts3d."""
    blocks = model.encoder.blocks
    taps = {"encoder_block_1": blocks[0],
            f"encoder_block_{len(blocks) // 2}": blocks[len(blocks) // 2 - 1],
            "encoder": model.encoder, "dec_norm": model.dec_norm}
    seen = {name: [] for name in taps}
    hooks = [mod.register_forward_hook(
        lambda mod, args, out, name=name: seen[name].append(out.float()))
        for name, mod in taps.items()]
    model.set_attn_impl(impl)
    try:
        with torch.inference_mode():
            pts3d = adapter(imgs)["pts3d"].float()
    finally:
        model.set_attn_impl("auto")
        for hook in hooks:
            hook.remove()
    out = {name: torch.cat([x.flatten() for x in xs])
           for name, xs in seen.items()}
    out["pts3d"] = pts3d
    return out


def dust3r_own_init(torch, model, adapter, imgs) -> dict:
    """12c at ModularDUSt3R-L's own init (weights N(0, 0.02), LayerNorms 1,
    biases 0), per output of dust3r_outputs: rel-L2 of flash against math
    in bf16, and of each against a math forward of the same weights in
    fp32, with "flash_over_math": flash's distance to fp32 over bf16
    math's, held to DUST3R_FLOOR_RATIO."""
    import dataclasses

    from mapanything_tpu_torch.models import ModularDUSt3R
    from mapanything_tpu_torch.models.adapters import ModularDUSt3RAdapter

    runs = {impl: dust3r_outputs(torch, model, adapter, imgs, impl)
            for impl in ("auto", "math")}
    twin = ModularDUSt3R(dataclasses.replace(model.cfg,
                                             dtype=torch.float32)).eval()
    twin.load_state_dict(model.state_dict())
    runs["fp32"] = dust3r_outputs(torch, twin, ModularDUSt3RAdapter(twin),
                                  imgs, "math")
    del twin
    torch.cuda.empty_cache()
    res = {}
    for key in runs["fp32"]:
        flash, math_bf16, fp32 = (runs[impl][key]
                                  for impl in ("auto", "math", "fp32"))
        res[key] = {"flash_vs_math": rel_l2(flash, math_bf16),
                    "flash_vs_fp32": rel_l2(flash, fp32),
                    "math_vs_fp32": rel_l2(math_bf16, fp32)}
        res[key]["flash_over_math"] = (res[key]["flash_vs_fp32"]
                                       / res[key]["math_vs_fp32"])
    return res


def dust3r_path(torch, fa, fp, root):
    """12c: ModularDUSt3R-L through ModularDUSt3RAdapter and the unmodified
    run_dense_n_view_benchmark. Returns (readings, counts, failure)."""
    import numpy as np

    from mapanything_tpu_torch.benchmarks import dense_n_view as BD
    from mapanything_tpu_torch.models import (
        ModularDUSt3R,
        ModularDUSt3RConfig,
    )
    from mapanything_tpu_torch.models.adapters import (
        FACTORED_PRED_KEYS,
        ModularDUSt3RAdapter,
    )

    t0 = time.perf_counter()
    model = ModularDUSt3R(ModularDUSt3RConfig(encoder_size="large"),
                          generator=torch.Generator(device="cuda")
                          .manual_seed(13)).eval()
    torch.cuda.synchronize()
    res = {"build_s": time.perf_counter() - t0,
           "parameters_m": sum(p.numel() for p in model.parameters()) / 1e6}
    adapter = ModularDUSt3RAdapter(model)
    loader = eval_loader(root, 2, DUST3R_SIZE, EVAL_BATCH, EVAL_BATCH,
                         norm="croco")
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with StageClock(torch, fa) as clock:
        summary = BD.run_dense_n_view_benchmark(adapter, loader, None)
    counts = launches_of(fa)
    res.update(walls_s=clock.walls, forward_launches=clock.forwards,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               summary=summary)
    bad = expect_launches(fa, {"fwd": DUST3R_LAUNCHES}, "12c") \
        or untouched_baseline(fp)
    preds = clock.seen[-1][1]
    b, (w, h) = EVAL_BATCH, DUST3R_SIZE
    shapes = {"pts3d": (b, 2, h, w, 3), "pts3d_cam": (b, 2, h, w, 3),
              "ray_directions": (b, 2, h, w, 3),
              "depth_along_ray": (b, 2, h, w, 1), "cam_quats": (b, 2, 4),
              "cam_trans": (b, 2, 3), "metric_scaling_factor": (b,),
              "conf": (b, 2, h, w), "non_ambiguous_mask": (b, 2, h, w),
              "non_ambiguous_mask_logits": (b, 2, h, w)}
    res["outputs_ok"] = set(preds) == set(FACTORED_PRED_KEYS) and all(
        tuple(preds[k].shape) == s and (
            preds[k].dtype == torch.bool
            or bool(torch.isfinite(preds[k]).all()))
        for k, s in shapes.items())
    res["view1_quat_identity"] = bool(torch.equal(
        preds["cam_quats"][:, 0].cpu(),
        torch.tensor([[0.0, 0.0, 0.0, 1.0]] * b)))
    res["pts3d_abs_max"] = float(preds["pts3d"].abs().max())
    del preds
    imgs = {"img": torch.from_numpy(first_batch(loader)["views"]["img"])
            .cuda()}

    with torch.inference_mode():
        adapter(imgs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adapter(imgs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        res["adapter_call"] = {"wall_ms": wall, **profile_calls(
            torch, lambda: adapter(imgs), wall, calls=2)}
    res["own_init"] = dust3r_own_init(torch, model, adapter, imgs)
    with torch.inference_mode():
        # every parameter redrawn N(0, 0.02) on the card (phase 3's kind):
        # ROADMAP's weak gate, held beside the own-init fp32-twin gate
        gen = torch.Generator(device="cuda").manual_seed(13)
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
        res["pts3d_rel_l2_vs_math"] = rel_l2(*(
            dust3r_outputs(torch, model, adapter, imgs, impl)["pts3d"]
            for impl in ("auto", "math")))
    res["registration"], reg_bad = registration_check(torch)
    print(f"12c ModularDUSt3R-L: {json.dumps(res)}", flush=True)
    del model, adapter, imgs
    torch.cuda.empty_cache()
    if bad:
        return res, counts, bad
    if clock.forwards != [{"fwd": DUST3R_LAUNCHES}]:
        return res, counts, f"12c: forward launches {clock.forwards}"
    if not (res["outputs_ok"] and res["view1_quat_identity"]
            and summary["num_sets"] == EVAL_BATCH
            and np.isfinite(summary["pointmaps_abs_rel"])):
        return res, counts, f"12c outputs: {res}"
    ratios = {key: r["flash_over_math"] for key, r in res["own_init"].items()}
    if not (all(r <= DUST3R_FLOOR_RATIO for r in ratios.values())
            and res["pts3d_rel_l2_vs_math"] <= ERR_LIMIT):
        return res, counts, (
            f"12c: flash's distance to fp32 over bf16 math's at own init "
            f"{ratios}; pts3d flash vs math at N(0, 0.02) "
            f"{res['pts3d_rel_l2_vs_math']}")
    return res, counts, reg_bad


def calibration_cli(torch, fa, fp, ckpt, root, folder):
    """12d: benchmark_calibration.main with phase 3's weights, then the GT
    oracle at 0 and at a 1-degree turn of every ray."""
    import numpy as np

    from mapanything_tpu_torch import benchmark_calibration as CLI
    from mapanything_tpu_torch.benchmarks import calibration as BC

    tests_on_path()
    from torch_eval_oracles import (
        GroundTruthOracle,
        ListLoader,
        RecordingLoader,
    )

    out = os.path.join(folder, "calibration")
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with StageClock(torch, fa) as clock:
        summary = CLI.main(["--wai_root", root, "--checkpoint", ckpt,
                            "--resolution", *map(str, EVAL_SIZE),
                            "--batch_size", str(EVAL_BATCH),
                            "--output_dir", out])
    counts = launches_of(fa)
    res = {"walls_s": clock.walls, "forward_launches": clock.forwards,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "summary": summary}
    with open(os.path.join(out, "eth3d_calibration.json")) as f:
        back = json.load(f)
    res["json_read_back"] = (back["summary"] == summary
                             and len(back["per_image"])
                             == summary["num_images"])
    batches = len(clock.forwards)
    bad = expect_launches(fa, {"fwd": FORWARD_LAUNCHES * batches}, "12d") \
        or untouched_baseline(fp)
    batch = first_batch(eval_loader(root, 2, EVAL_SIZE, EVAL_BATCH,
                                    EVAL_BATCH))
    for degrees in (0.0, 1.0):
        loader = RecordingLoader(ListLoader([batch]))
        res[f"oracle_{degrees:g}deg"] = BC.run_calibration_benchmark(
            GroundTruthOracle(loader, "cuda", ray_rotation_deg=degrees),
            loader, None)
    print(f"12d calibration CLI: {json.dumps(res)}", flush=True)
    if bad:
        return res, counts, bad
    if clock.forwards != [{"fwd": FORWARD_LAUNCHES}] * batches or not (
            batches and res["json_read_back"]
            and np.isfinite(summary["ray_angular_error_deg_mean"])):
        return res, counts, f"12d: {res}"
    zero = res["oracle_0deg"]["ray_angular_error_deg_mean"]
    one = res["oracle_1deg"]["ray_angular_error_deg_mean"]
    if not (zero <= 1e-4 and abs(one - 1.0) <= 1e-3):
        return res, counts, f"12d oracle: 0 -> {zero}, 1 -> {one}"
    return res, counts, None


def rmvd_samples(count: int, w: int, h: int, views: int):
    """RMVD samples of 1 key and views - 1 sources, as rmvd's mvd
    evaluation hands them over: uint8 (1, 3, H, W) images, K, key_T_i
    poses (a camera moving along x), the key view's depth; the key view
    is not view 0 in the second sample."""
    import numpy as np

    rng = np.random.default_rng(14)
    yy, xx = np.mgrid[0:h, 0:w] / float(max(w, h))
    k = np.array([[[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]]],
                 np.float32)
    samples = []
    for s in range(count):
        key = 3 * s % views
        images, poses = [], []
        for i in range(views):
            base = np.stack([np.sin(6 * xx + i + s), np.cos(5 * yy - i),
                             np.sin(4 * (xx + yy))], 0)
            img = 127.5 * (1 + 0.8 * base) + rng.normal(0, 8, base.shape)
            images.append(np.clip(img, 0, 255).astype(np.uint8)[None])
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = -0.1 * (i - key)  # key_T_i
            poses.append(pose[None])
        samples.append({"images": images, "keyview_idx": key,
                        "poses": poses, "intrinsics": [k] * views,
                        "gt_depth": (2.0 + np.sin(3 * xx) + 0.5 * yy)
                        .astype(np.float32)})
    return samples


def rmvd_cli(torch, fa, fp, ckpt):
    """12e: benchmark_rmvd.main --selftest with phase 3's weights, then the
    same adaptor on samples of 1 key and RMVD_SOURCES sources at 518x392;
    input_adapter on the card against the CPU."""
    import argparse

    import numpy as np

    from mapanything_tpu_torch import benchmark_rmvd as CLI
    from mapanything_tpu_torch.benchmarks.rmvd import (
        RMVDAdaptor,
        evaluate_mvs_depth,
    )

    res, counts = {}, []
    cond = "image+intrinsics+pose"
    fa.reset_launch_counts()
    buf = io.StringIO()
    with StageClock(torch, fa) as clock, contextlib.redirect_stdout(buf):
        rc = CLI.main(["--selftest", "--checkpoint", ckpt, "--conditioning",
                       cond, "--selftest-res", str(EVAL_SIZE[0])])
    counts.append(launches_of(fa))
    res["selftest"] = {"rc": rc, "walls_s": clock.walls,
                       "metrics": json.loads(buf.getvalue().splitlines()[-1]),
                       "forward_launches": clock.forwards}
    bad = expect_launches(fa, {"fwd": FORWARD_LAUNCHES * 2}, "12e selftest")
    if bad or rc != 0 or clock.forwards != [{"fwd": FORWARD_LAUNCHES}] * 2:
        print(f"12e RMVD: {json.dumps(res)}", flush=True)
        return res, counts, bad or f"12e selftest: {res}"

    adaptor = CLI.build_adaptor(argparse.Namespace(
        checkpoint=ckpt, conditioning=cond, views="multi_view", name="smoke",
        device=None))
    w, h = EVAL_SIZE
    samples = rmvd_samples(2, w, h, 1 + RMVD_SOURCES)
    s = samples[1]
    args = (s["images"], s["keyview_idx"], s["poses"], s["intrinsics"])
    card = adaptor.input_adapter(*args)
    # the same adaptor code on the CPU: a stand-in without parameters
    # names its device (benchmarks/dense_n_view.py::model_device)
    cpu = RMVDAdaptor(types.SimpleNamespace(device="cpu"),
                      inference_conditioning=cond).input_adapter(*args)
    res["input_adapter_card_vs_cpu"] = {
        key: float((card[key].cpu().float() - cpu[key].float()).abs().max())
        for key in cpu}
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with StageClock(torch, fa) as clock:
        metrics = evaluate_mvs_depth(adaptor, samples)
    counts.append(launches_of(fa))
    res["key_plus_sources"] = {
        "views": 1 + RMVD_SOURCES, "size": [w, h], "metrics": metrics,
        "walls_s": clock.walls, "forward_launches": clock.forwards,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"12e RMVD: {json.dumps(res)}", flush=True)
    del adaptor, card, cpu
    torch.cuda.empty_cache()
    bad = expect_launches(fa, {"fwd": FORWARD_LAUNCHES * len(samples)},
                          "12e") or untouched_baseline(fp)
    if bad:
        return res, counts, bad
    if not (max(res["input_adapter_card_vs_cpu"].values()) <= 1e-5
            and metrics["num_samples"] == len(samples)
            and np.isfinite(metrics["depth_abs_rel"])
            and clock.forwards == [{"fwd": FORWARD_LAUNCHES}] * len(samples)):
        return res, counts, f"12e: {res}"
    return res, counts, None


def evaluation_path(torch, fa, fp, F):
    """Phase 12. Returns (kernel rows, the kernel counts of its runs,
    failure or None)."""
    from mapanything_tpu_torch.train.checkpoints import save_params

    t0 = time.perf_counter()
    rows, bad = eval_kernel_rows(torch, fa, F)
    walls = {"12a_s": time.perf_counter() - t0}
    counts = []
    if bad:
        return rows, counts, bad
    with tempfile.TemporaryDirectory() as folder:
        t0 = time.perf_counter()
        root = write_wai_tree(folder)
        ckpt = os.path.join(folder, "params.pt")
        save_params(ckpt, random_weights_model())
        torch.cuda.empty_cache()
        walls["setup_s"] = time.perf_counter() - t0
        for stage, run in (
                ("12b", lambda: dense_cli(torch, fa, fp, ckpt, root, folder)),
                ("12c", lambda: dust3r_path(torch, fa, fp, root)),
                ("12d", lambda: calibration_cli(torch, fa, fp, ckpt, root,
                                                folder)),
                ("12e", lambda: rmvd_cli(torch, fa, fp, ckpt))):
            t0 = time.perf_counter()
            _, launched, bad = run()
            walls[f"{stage}_s"] = time.perf_counter() - t0
            counts += launched if isinstance(launched, list) else [launched]
            torch.cuda.empty_cache()
            if bad:
                return rows, counts, f"phase {stage}: {bad}"
    print(f"phase 12 walls: {json.dumps(walls)}", flush=True)
    return rows, counts, None


# phase 13: the model variants at full width and depth. The forward at the
# shapes only they give it: (name, q (B, Nq, H, D), keys, n_valid, layout)
# with layout "qkv" (the fused-qkv views of nn/layers.py::Attention),
# "rope" (the frame layer's q and k rotated by nn/rope.py::apply_rope, new
# tensors, v still the fused tensor's strided view), "entropy" (the global
# layer's q times log(n_valid)/log(P), the rest fused) or "cross" (q of its
# own, k and v the strided halves of one gathered (B, M, 2, H, D) kv
# tensor: nn/croco.py::CrossAttention with a context_index)
VARIANT_SHAPES = [
    ("rope_frame_518", (2, 1369, 16, 64), 1369, None, "rope"),
    ("entropy_global_2view_518", (1, 2816, 16, 64), 2816, 2739, "entropy"),
    ("one_row_self", (1, 1, 16, 64), 1, None, "qkv"),
    ("one_row_cross_2view_518", (1, 1, 16, 64), 2739, None, "cross"),
    ("one_row_cross_4view_518", (1, 1, 16, 64), 5477, None, "cross"),
    ("cross_2view_518", (1, 1369, 16, 64), 1370, None, "cross"),
    ("cross_ref_4view_518", (1, 1369, 16, 64), 4108, None, "cross"),
    ("cross_rest_4view_518", (3, 1369, 16, 64), 4108, None, "cross"),
    ("radio_l_512x384", (2, 769, 16, 64), 769, None, "qkv"),
]
VARIANT_SEED = 13
# per forward: 24 encoder blocks and 24 trunk layers, one launch each; the
# cross trunk launches self- and cross-attention for the reference view,
# the batch of the other views and the token in each of its 24 layers
CROSS_LAUNCHES = 24 + 24 * 6
# at a model's own init flash may lie at most this much farther than bf16
# math from an fp32 math twin, at every tap (phase 12c's gate)
FLOOR_RATIO = 1.1
# the readings held to FLOOR_RATIO (by prefix): every one that no single
# number of a scene (the metric scale, a view's pose) dominates
RATIO_GATED = ("trunk_tap_", "trunk_final", "pts3d", "ray_directions",
               "depth_over_scale", "depth_raw")
# the dense head's raw depth channel of each family that has one
DEPTH_CHANNEL = {"raydirs+depth+pose": 3, "raymap+depth": 6,
                 "pointmap+raydirs+depth+pose": 6}
FAMILIES = ("pointmap", "raymap+depth", "campointmap+pose",
            "pointmap+raydirs+depth+pose")
# the forward's keys of each family, +confidence+mask (the JAX package's
# recombination, models/mapanything.py:587-664)
_FACTORED = {"pts3d", "pts3d_cam", "ray_directions", "depth_along_ray",
             "cam_trans", "cam_quats"}
FAMILY_KEYS = {
    "raydirs+depth+pose": _FACTORED,
    "pointmap": {"pts3d"},
    "raymap+depth": {"pts3d", "ray_origins", "ray_directions",
                     "depth_along_ray"},
    "campointmap+pose": _FACTORED,
    "pointmap+raydirs+depth+pose": _FACTORED,
}
FAMILY_KEYS = {fam: keys | {"metric_scaling_factor", "conf",
                            "non_ambiguous_mask", "non_ambiguous_mask_logits"}
               for fam, keys in FAMILY_KEYS.items()}


def variant_inputs(torch, shape, keys, n_valid, layout, seed):
    """bf16 q, k, v in one of VARIANT_SHAPES' layouts."""
    from mapanything_tpu_torch.nn.rope import apply_rope, rope_tables

    b, n, h, d = shape
    if layout == "cross":
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q = torch.randn((b, n, h, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        kv = torch.randn((b, keys, 2, h, d), generator=gen,
                         device="cuda").to(torch.bfloat16)
        return (q, *kv.unbind(2))
    q, k, v = attention_inputs(torch, shape, n_valid, seed)
    if layout == "rope":
        cos, sin = rope_tables(37, 37, d, 100.0, "cuda")
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    elif layout == "entropy":
        q = q * (math.log(n_valid) / math.log(PATCHES))
    return q, k, v


def variant_kernel_rows(torch, fa, F):
    """13a: the forward against its plain version at VARIANT_SHAPES (phase
    2's limits, max-abs over the plain's max-abs and rel-L2 over the real
    rows), with device ms, bound, flash SDPA's time and host µs. Returns
    ([(name, row)], failure or None)."""
    rows = []
    for i, (name, shape, keys, n_valid, layout) in enumerate(VARIANT_SHAPES):
        b, n, h, d = shape
        q, k, v = variant_inputs(torch, shape, keys, n_valid, layout,
                                 1300 + i)
        real_q = n if n_valid is None else n_valid
        real_k = keys if n_valid is None else n_valid
        out = fa.flash_attention(q, k, v, n_valid=n_valid)
        ref = fa.flash_attention_plain(q, k, v, n_valid)
        torch.cuda.synchronize()
        o, r = out[:, :real_q].float(), ref[:, :real_q].float()
        row = {
            "shape": list(shape), "keys": keys, "n_valid": n_valid,
            "layout": layout,
            "strides": [list(x.stride()[:3]) for x in (q, k, v)],
            "max_abs_err": float((o - r).abs().max()),
            "max_abs_rel": max_abs_rel(o, r), "rel_l2": rel_l2(o, r),
            "ms": kernel_ms(lambda: fa.flash_attention(q, k, v, n_valid)),
            "plain_ms": plain_ms(
                lambda: fa.flash_attention_plain(q, k, v, n_valid)),
            "host_us": host_us(
                lambda: fa._fwd_cuda(q, k, v, n_valid, with_lse=False)),
        }
        row["tflops"] = (fa.attention_flops(b, n, real_k, h, d) / row["ms"]
                         / 1e9)
        row.update(bound(F, "fwd", shape, real_k))
        row["library_ms"] = library_fwd_ms(
            torch, q.transpose(1, 2).contiguous(),
            k[:, :real_k].transpose(1, 2).contiguous(),
            v[:, :real_k].transpose(1, 2).contiguous())
        row["at"] = name
        print(f"13a attention {name} {tuple(shape)} keys={keys} "
              f"n_valid={n_valid} {layout}: max_abs_rel="
              f"{row['max_abs_rel']:.3e} rel_l2={row['rel_l2']:.3e} kernel "
              f"{row['ms']:.4f} ms ({row['tflops']:.2f} TFLOP/s) plain "
              f"{row['plain_ms']:.4f} ms bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}) library {row['library_ms']:.4f} ms; "
              f"host {row['host_us']:.1f} us", flush=True)
        rows.append((name, row))
        del q, k, v, out, ref, o, r
        torch.cuda.empty_cache()
        if not max(row["max_abs_rel"], row["rel_l2"]) <= ERR_LIMIT:
            return rows, f"kernel disagrees with plain at {name}: {row}"
    return rows, None


def redraw_normal_(torch, model, seed: int) -> None:
    """Every parameter N(0, 0.02) from a generator on the card, RADIO's
    input conditioner kept (the weak gate's weights, drawn in
    milliseconds)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            consts = getattr(mod, "init_constants", {})
            for name, p in mod.named_parameters(recurse=False):
                if name not in consts:
                    p.normal_(0.0, 0.02, generator=gen)


def variant_outputs(torch, model, pipe, views, impl, norm) -> dict:
    """One infer call with every attention on `impl`, in fp32: the trunk's
    taps, its final output and extra-token output, the dense head's raw
    depth channel, and the infer outputs (unmasked), with depth also over
    its metric scale and less its per-view mean."""
    from mapanything_tpu_torch.models.mapanything import scene_rep_family

    seen, raw = {}, []
    channel = DEPTH_CHANNEL.get(scene_rep_family(model.cfg.scene_rep_type))

    def trunk_hook(mod, args, out):
        final, taps, tok = out
        for i, tap in zip(mod.indices, taps):
            seen[f"trunk_tap_{i}"] = tap.float()
        seen["trunk_final"] = final.float()
        if tok is not None and tok.numel():
            seen["trunk_token"] = tok.float()

    def head_hook(mod, args, out):
        raw.append(out[..., channel].float())

    handles = [model.info_sharing.register_forward_hook(trunk_hook)]
    if channel is not None:
        handles.append(model.dense_head.register_forward_hook(head_hook))
    model.set_attn_impl(impl)
    try:
        out = pipe.infer(views, apply_mask=False, data_norm_type=norm)
    finally:
        model.set_attn_impl("auto")
        for handle in handles:
            handle.remove()
    for key in ("pts3d", "depth_along_ray", "ray_directions",
                "metric_scaling_factor"):
        if key in out[0]:
            seen[key] = torch.cat([o[key].float() for o in out])
    if raw:
        seen["depth_raw"] = torch.cat(raw)
    if "depth_along_ray" in seen:
        depth = seen["depth_along_ray"]
        scale = seen["metric_scaling_factor"].reshape(-1, 1, 1, 1)
        seen["depth_over_scale"] = depth / scale
        seen["depth_less_mean"] = depth - depth.mean(dim=(1, 2, 3),
                                                     keepdim=True)
    return seen


def own_init_gate(torch, model, views, norm) -> tuple:
    """At the model's own init: flash and bf16 math each against a math
    forward of an fp32 twin of the same weights, at every reading of
    `variant_outputs`. Flash's rel-L2 at most FLOOR_RATIO x math's at
    RATIO_GATED; depth's at most max(FLOOR_RATIO x math's, ERR_LIMIT):
    depth is the metric scale times exp(raw), and the scale is one number
    a scene, so there flash's and math's distances are two single rounding
    draws whose ratio spreads. The extra token, the scale and depth less
    its mean are read, not gated."""
    import dataclasses

    from mapanything_tpu_torch.models import MapAnything
    from mapanything_tpu_torch.utils.inference import InferencePipeline

    pipe = InferencePipeline(model)
    runs = {impl: variant_outputs(torch, model, pipe, views, impl, norm)
            for impl in ("auto", "math")}
    twin = MapAnything(dataclasses.replace(model.cfg, dtype=torch.float32)
                       ).eval()
    twin.load_state_dict(model.state_dict())
    runs["fp32"] = variant_outputs(torch, twin, InferencePipeline(twin),
                                   views, "math", norm)
    del twin
    torch.cuda.empty_cache()
    res = {}
    for key in runs["fp32"]:
        flash, math_bf16, fp32 = (runs[impl][key]
                                  for impl in ("auto", "math", "fp32"))
        r = {"flash_vs_math": rel_l2(flash, math_bf16),
             "flash_vs_fp32": rel_l2(flash, fp32),
             "math_vs_fp32": rel_l2(math_bf16, fp32)}
        r["flash_over_math"] = (  # 0 / 0: a scale of exactly 1
            r["flash_vs_fp32"] / r["math_vs_fp32"] if r["math_vs_fp32"]
            else 0.0 if not r["flash_vs_fp32"] else math.inf)
        res[key] = r
    bad = {key: r for key, r in res.items() if (
        key.startswith(RATIO_GATED)
        and not r["flash_over_math"] <= FLOOR_RATIO) or (
        key == "depth_along_ray" and not r["flash_vs_fp32"]
        <= max(FLOOR_RATIO * r["math_vs_fp32"], ERR_LIMIT))}
    return res, (f"own init: flash farther than {FLOOR_RATIO} x bf16 math "
                 f"from fp32: {bad}" if bad else None)


def variant_views(torch, load_images, folder, n, size, norm):
    """n seeded views at `size`, loaded as a user loads them (the 518 or
    512 resolution set, the encoder's normalisation)."""
    w, h = size
    sub = os.path.join(folder, f"{n}_{w}x{h}")
    os.makedirs(sub, exist_ok=True)
    return load_images(write_images(sub, n, w, h), norm_type=norm,
                       resolution_set=518 if w in (518, 392) else 512)


def variant_run(torch, fa, fp, name, cfg, views_by_n, launches, norm,
                twin: bool):
    """One variant model: at its own init the fp32-twin gate (with
    `twin`); then at N(0, 0.02) weights, for each view count, one infer
    call with exactly `launches` forward launches and nothing else, finite
    outputs of the expected shapes and keys, flash against math (rel-L2
    <= 1e-2 on pts3d, depth and rays), its wall, device ms, busy share and
    peak GiB. Returns (readings, [counts], failure or None)."""
    from mapanything_tpu_torch.models import MapAnything
    from mapanything_tpu_torch.models.mapanything import scene_rep_family
    from mapanything_tpu_torch.utils.inference import InferencePipeline

    t0 = time.perf_counter()
    model = MapAnything(cfg, generator=torch.Generator(
        device="cuda").manual_seed(VARIANT_SEED)).eval()
    pipe = InferencePipeline(model)
    res = {"build_s": time.perf_counter() - t0,
           "parameters_m": sum(p.numel() for p in model.parameters()) / 1e6}
    counts = []
    first = next(iter(views_by_n))
    if twin:
        res["own_init"], bad = own_init_gate(torch, model,
                                             views_by_n[first], norm)
        print(f"13 {name} own init vs fp32 twin ({first} views): "
              f"{json.dumps(res['own_init'])}", flush=True)
        if bad:
            return res, counts, f"{name}: {bad}"
    redraw_normal_(torch, model, VARIANT_SEED + 1)
    family = scene_rep_family(cfg.scene_rep_type)
    for n, views in views_by_n.items():
        r = {}
        h, w = views[0]["img"].shape[1:3]
        pipe.infer(views, data_norm_type=norm)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        out = pipe.infer(views, data_norm_type=norm)
        torch.cuda.synchronize()
        r["wall_ms"] = (time.perf_counter() - t0) * 1e3
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        counts.append(launches_of(fa))
        bad = (expect_launches(fa, {"fwd": launches}, f"{name} {n} views")
               or untouched_baseline(fp))
        if bad:
            return res, counts, bad
        from mapanything_tpu_torch.utils.inference import stack_views
        with torch.inference_mode():
            raw = model(stack_views(views, "cuda"))
        r["keys"] = sorted(raw)
        if not cfg.use_scale_token and not all(
                bool((view["metric_scaling_factor"] == 1).all())
                for view in out):
            return res, counts, f"{name}: metric scale not 1 without a token"
        if set(raw) != FAMILY_KEYS[family]:
            return res, counts, (f"{name}: keys {sorted(raw)}, expected "
                                 f"{sorted(FAMILY_KEYS[family])}")
        for i, view in enumerate(out):
            for key, t in view.items():
                if t.dtype != torch.bool and not torch.isfinite(t).all():
                    return res, counts, f"{name}: view {i} {key} not finite"
            if tuple(view["pts3d"].shape) != (1, h, w, 3):
                return res, counts, (f"{name}: pts3d "
                                     f"{tuple(view['pts3d'].shape)}")
        flash = variant_outputs(torch, model, pipe, views, "auto", norm)
        maths = variant_outputs(torch, model, pipe, views, "math", norm)
        for key in ("pts3d", "depth_along_ray", "ray_directions"):
            if key in flash:
                r[f"{key}_rel_l2_vs_math"] = rel_l2(flash[key], maths[key])
        del flash, maths
        r["profile"] = profile_calls(
            torch, lambda: pipe.infer(views, data_norm_type=norm),
            r["wall_ms"], calls=2)
        res[f"{n}_views"] = r
        print(f"13 {name} {n} views: {json.dumps(r)}", flush=True)
        worst = max(val for key, val in r.items()
                    if key.endswith("_rel_l2_vs_math"))
        if not worst <= ERR_LIMIT:
            return res, counts, f"{name} {n} views flash vs math: {r}"
    del model, pipe
    torch.cuda.empty_cache()
    return res, counts, None


def radio_checkpoint(torch, folder, cfg) -> tuple:
    """13g: a one-shard snapshot in the reference's layout of a RADIO-L
    MapAnything (tests/torch_reference_layout.py) read back through
    from_pretrained, bitwise. Returns (readings, failure or None)."""
    tests_on_path()
    from torch_reference_layout import reference_state_dict, write_snapshot

    from mapanything_tpu_torch.models import MapAnything
    from mapanything_tpu_torch.models.pretrained import from_pretrained

    model = MapAnything(cfg, generator=torch.Generator(
        device="cuda").manual_seed(VARIANT_SEED))
    redraw_normal_(torch, model, VARIANT_SEED + 1)
    state = {key: val.detach().cpu() for key, val in
             model.state_dict().items()}
    del model
    snap = os.path.join(folder, "radio_snapshot")
    t0 = time.perf_counter()
    write_snapshot(snap, reference_state_dict(state, cfg.trunk_indices))
    res = {"write_s": time.perf_counter() - t0,
           "gib": os.path.getsize(os.path.join(snap, "model.safetensors"))
           / 2**30}
    overrides = {key: getattr(cfg, key) for key in (
        "encoder_type", "encoder_size", "patch_size", "data_norm_type")}
    t0 = time.perf_counter()
    loaded = from_pretrained(snap, config_overrides=overrides)
    torch.cuda.synchronize()
    res["load_s"] = time.perf_counter() - t0
    got = loaded.state_dict()
    res["bitwise"] = (set(got) == set(state) and all(
        torch.equal(got[key].cpu(), val) for key, val in state.items()))
    res["config_equal"] = loaded.cfg == cfg
    del loaded, got, state
    torch.cuda.empty_cache()
    print(f"13g RADIO-L reference-layout snapshot: {json.dumps(res)}",
          flush=True)
    if not (res["bitwise"] and res["config_equal"]):
        return res, f"13g: {res}"
    return res, None


def variants_path(torch, fa, fp, F, load_images):
    """Phase 13. Returns (kernel rows, the kernel counts of its runs,
    failure or None)."""
    from mapanything_tpu_torch.models import (
        MapAnythingConfig,
        dense_dim_for,
        mapanything_ablations_config,
    )

    walls = {}
    t0 = time.perf_counter()
    rows, bad = variant_kernel_rows(torch, fa, F)
    walls["13a_s"] = time.perf_counter() - t0
    counts = []
    if bad:
        return rows, counts, bad
    fam = {f: f + "+confidence+mask" for f in FAMILIES}
    runs = [  # (stage, name, config, views, size, norm, launches, twin)
        ("13b", "released", MapAnythingConfig(), (8,), (518, 518), "dinov2",
         FORWARD_LAUNCHES, False),  # the yardstick of the global trunk
        ("13b", "global", MapAnythingConfig(info_sharing_type="global"),
         (2, 8), (518, 518), "dinov2", FORWARD_LAUNCHES, True),
        ("13c", "ablations", mapanything_ablations_config(), (2,),
         (518, 518), "dinov2", FORWARD_LAUNCHES, True),
        ("13d", "cross", MapAnythingConfig(info_sharing_type="cross"),
         (2, 4), (518, 518), "dinov2", CROSS_LAUNCHES, True),
        ("13e", "radio_l", MapAnythingConfig(
            encoder_type="radio", patch_size=16, data_norm_type="radio"),
         (2,), (512, 384), "radio", FORWARD_LAUNCHES, True),
        ("13e", "croco_l", MapAnythingConfig(
            encoder_type="croco", patch_size=16, data_norm_type="croco"),
         (2,), (512, 384), "croco", FORWARD_LAUNCHES, True),
    ] + [("13f", f, MapAnythingConfig(scene_rep_type=srt,
                                      dense_output_dim=dense_dim_for(srt)),
          (1,), (518, 518), "dinov2", FORWARD_LAUNCHES, False)
         for f, srt in fam.items()]
    with tempfile.TemporaryDirectory() as folder:
        for stage, name, cfg, views, size, norm, launches, twin in runs:
            t0 = time.perf_counter()
            views_by_n = {n: variant_views(torch, load_images, folder, n,
                                           size, norm) for n in views}
            _, launched, bad = variant_run(torch, fa, fp, name, cfg,
                                           views_by_n, launches, norm, twin)
            walls[f"{stage}_{name}_s"] = time.perf_counter() - t0
            counts += launched
            torch.cuda.empty_cache()
            if bad:
                return rows, counts, f"phase {stage}: {bad}"
        t0 = time.perf_counter()
        _, bad = radio_checkpoint(torch, folder, runs[4][2])
        walls["13g_s"] = time.perf_counter() - t0
        if bad:
            return rows, counts, bad
    print(f"phase 13 walls: {json.dumps(walls)}", flush=True)
    return rows, counts, None


# phase 14: the offline data-processing path at the sizes its users run. A
# raw ScanNet++ v2 DSLR scene (OPENCV_FISHEYE frames of 1752 x 1168, their
# anonymisation masks, a closed room mesh of 12 x 66^2 = 52272 triangles
# with a closed-form depth) through convert_dataset's conversion,
# undistortion and mesh render; covisibility of 256 frames of that size;
# MapAnything self-labelling an 8-frame 518 x 392 scene and the
# consistency filter; the converted scene through the loader
SNPP_SIZE = (1752, 1168)  # ScanNet++ v2's DSLR frames, (w, h)
OFFLINE_FRAMES = 4  # cut: a scan's hundreds of frames; 4 fit the budget
OFFLINE_YAW = math.radians(15.0)  # a sweep: neighbours overlap
ROOM_CELLS = 66
COVIS_FRAMES, COVIS_SUBSET = 256, 32
LABEL_FRAMES, LABEL_SIZE = 8, (518, 392)
CPU_WINDOW = (32, 64)  # rows, columns of 14a's card-vs-CPU render
OFFLINE_SHAPES = [  # the self-labelling forward: 8 frames at 518 x 392
    ("encoder_518x392_8frames", (8, 1152, 16, 64), 1037),
    ("frame_518x392_8frames", (8, 1036, 16, 64), None),
    ("global_518x392_8frames", (1, 8320, 16, 64), 8289),
]


@contextlib.contextmanager
def stage_walls(torch, walls: dict, targets):
    """For the length of the block, each (owner, name, stage) function adds
    its wall (a synchronise on each side) to walls[stage] and one to
    walls[stage + "_calls"]."""
    from unittest import mock

    def timed(stage, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            walls[stage] = walls.get(stage, 0.0) + time.perf_counter() - t0
            walls[stage + "_calls"] = walls.get(stage + "_calls", 0) + 1
            return out

        return run

    with contextlib.ExitStack() as stack:
        for owner, name, stage in targets:
            stack.enter_context(mock.patch.object(
                owner, name, timed(stage, getattr(owner, name))))
        yield walls


def room_depth_card(torch, K, poses, hw):
    """tests/torch_offline_scenes.py::room_depth on the card, float64, for
    (F, 4, 4) poses and one K: (F, H, W) float32 on the host."""
    from torch_offline_scenes import ROOM

    h, w = hw
    dev = "cuda"
    K = torch.as_tensor(K, dtype=torch.float64, device=dev)
    half = torch.tensor(ROOM, dtype=torch.float64, device=dev) / 2
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                            torch.arange(w, dtype=torch.float64, device=dev),
                            indexing="ij")
    cam = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                       torch.ones_like(xs)], -1)
    out = []
    for pose in poses:
        c2w = torch.as_tensor(pose, dtype=torch.float64, device=dev)
        dirs = cam @ c2w[:3, :3].T
        best = torch.full((h, w), math.inf, dtype=torch.float64, device=dev)
        for axis in range(3):
            for sign in (-1.0, 1.0):
                t = (sign * half[axis] - c2w[axis, 3]) / dirs[..., axis]
                best = torch.where((t > 0) & (t < best), t, best)
        out.append(best.float().cpu())
    return torch.stack(out).numpy()


def offline_conversion(torch, folder):
    """14a: convert_dataset.main on a raw ScanNet++ v2 scene with
    --undistort and --render-depth, no --device (the card). Gates: the
    tree reads back through the port's reader; every frame's rendered
    depth within ANALYTIC_RTOL of the room's closed form where hit, and
    hit on all but HIT_SHARE of the pixels; a CPU_WINDOW window of frame
    0 rendered on the CPU within RENDER_RTOL of the card's. Returns
    (readings, the scene root, failure or None)."""
    tests_on_path()
    import numpy as np
    from torch_offline_scenes import (
        ANALYTIC_RTOL,
        HIT_SHARE,
        RENDER_RTOL,
        room_cameras,
        room_mesh,
        write_scannetpp_raw,
    )

    from mapanything_tpu_torch import convert_dataset as CLI
    from mapanything_tpu_torch.data import converters as CV
    from mapanything_tpu_torch.data import rendering as RD
    from mapanything_tpu_torch.data.wai import load_frame, load_scene_meta

    w, h = SNPP_SIZE
    raw, out = os.path.join(folder, "raw"), os.path.join(folder, "wai")
    walls = {}
    t0 = time.perf_counter()
    mesh = room_mesh(cells=ROOM_CELLS)
    poses = room_cameras(OFFLINE_FRAMES, step=OFFLINE_YAW)
    write_scannetpp_raw(raw, "scene0", poses, w, h, mesh=mesh)
    walls["raw_write_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with stage_walls(torch, walls, [
            (CV, "convert_scannetppv2_scene", "convert_s"),
            (CV, "undistort_scene", "undistort_s"),
            (CV, "render_scene_depth_stage", "render_stage_s"),
            (RD, "render_mesh_depth", "render_frame_s")]):
        roots = CLI.main(["scannetppv2", raw, out, "--undistort",
                          "--render-depth"])
    walls["cli_s"] = time.perf_counter() - t0
    walls["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    root = str(roots[0])
    n_tri = len(mesh[1])
    res = {"frames": OFFLINE_FRAMES, "size": [w, h], "triangles": n_tri,
           **walls}
    res["render_ms_per_frame"] = (1e3 * walls["render_frame_s"]
                                  / walls["render_frame_s_calls"])
    res["render_pairs_per_s"] = (w * h * n_tri * walls["render_frame_s_calls"]
                                 / walls["render_frame_s"])

    meta = load_scene_meta(os.path.join(root, "scene_meta.json"))
    errs, misses = [], []
    frames = []
    for i in range(len(meta["frames"])):
        fr = load_frame(root, i, ["image", "anon_mask", "rendered_depth"],
                        scene_meta=meta)
        frames.append(fr)
        exact = room_depth_card(torch, fr["intrinsics"],
                                fr["extrinsics"][None], (h, w))[0]
        d = fr["rendered_depth"]
        hit = d > 0
        misses.append(float(1 - hit.mean()))
        errs.append(float((np.abs(d[hit] - exact[hit]) / exact[hit]).max()))
    res.update(camera_model=meta["camera_model"],
               image_shape=list(frames[0]["image"].shape),
               analytic_max_rel=max(errs), miss_share=max(misses))

    y0, x0 = h // 2 - CPU_WINDOW[0] // 2, w // 2 - CPU_WINDOW[1] // 2
    K = frames[0]["intrinsics"].astype(np.float64)
    K[0, 2] -= x0
    K[1, 2] -= y0
    verts, faces = CV.read_ply(os.path.join(root, "mesh_aligned.ply"))
    t0 = time.perf_counter()
    cpu = RD.render_mesh_depth(verts, faces, K, frames[0]["extrinsics"],
                               CPU_WINDOW, device="cpu")
    res["cpu_window_s"] = time.perf_counter() - t0
    card = frames[0]["rendered_depth"][y0:y0 + CPU_WINDOW[0],
                                       x0:x0 + CPU_WINDOW[1]]
    both = (card > 0) & (cpu > 0)
    res["card_vs_cpu_max_rel"] = float(
        (np.abs(card[both] - cpu[both]) / cpu[both]).max())
    res["card_vs_cpu_hit_differ"] = float(((card > 0) != (cpu > 0)).mean())
    print(f"phase 14a, conversion: {json.dumps(res)}", flush=True)
    if not (len(meta["frames"]) == OFFLINE_FRAMES
            and res["camera_model"] == "PINHOLE"
            and res["image_shape"] == [h, w, 3]
            and res["analytic_max_rel"] <= ANALYTIC_RTOL
            and res["miss_share"] <= HIT_SHARE
            and res["card_vs_cpu_max_rel"] <= RENDER_RTOL
            and res["card_vs_cpu_hit_differ"] <= HIT_SHARE):
        return res, root, f"14a: {res}"
    return res, root, None


def offline_covisibility(torch, root):
    """14b: compute_pairwise_covisibility on the card over COVIS_FRAMES
    closed-form depths at SNPP_SIZE (downsampled to 224 inside). Gates: the
    diagonal 1, the frame facing away 0, a COVIS_SUBSET-frame subset within
    COVIS_PIXELS / (h w) of the CPU's; the depth-consistency confidence of
    those frames (depth scaled by seeded noise of +-5%) within CONF_SHARE
    of the CPU's. Then the rendered scene's covisibility goes where the
    loader reads it. Returns (readings, failure or None)."""
    import numpy as np
    from torch_offline_scenes import CONF_SHARE, COVIS_PIXELS, room_cameras

    from mapanything_tpu_torch.data import covisibility as CO
    from mapanything_tpu_torch.data.wai import (
        load_frame,
        load_scene_meta,
        store_data,
    )

    w, h = SNPP_SIZE
    meta = load_scene_meta(os.path.join(root, "scene_meta.json"))
    K = load_frame(root, 0, [], scene_meta=meta)["intrinsics"]
    poses = room_cameras(COVIS_FRAMES).astype(np.float32)
    Ks = np.tile(K.astype(np.float32), (COVIS_FRAMES, 1, 1))
    t0 = time.perf_counter()
    depths = room_depth_card(torch, K, poses, (h, w))
    res = {"frames": COVIS_FRAMES, "size": [w, h],
           "depth_write_s": time.perf_counter() - t0}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    covis = CO.compute_pairwise_covisibility(depths, Ks, poses)
    res["covis_ms"] = 1e3 * (time.perf_counter() - t0)
    res["covis_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["resident_before_gib"] = before / 2**30
    dh, dw = CO._downsample(depths[:1], Ks[:1], 224)[0].shape[1:]
    half = COVIS_FRAMES // 2
    res["diag_max_err"] = float(np.abs(np.diag(covis) - 1).max())
    res["facing_away_max"] = float(max(
        covis[k, (k + half) % COVIS_FRAMES] for k in range(COVIS_FRAMES)))
    res["mean_covis"] = float(covis.mean())
    sub = np.arange(0, COVIS_FRAMES, COVIS_FRAMES // COVIS_SUBSET)
    t0 = time.perf_counter()
    cpu = CO.compute_pairwise_covisibility(depths[sub], Ks[sub], poses[sub],
                                           device="cpu")
    res["covis_cpu_subset_s"] = time.perf_counter() - t0
    res["subset_max_abs"] = float(np.abs(covis[np.ix_(sub, sub)]
                                         - cpu).max())
    res["subset_limit"] = COVIS_PIXELS / (dh * dw)

    noisy = depths[sub] * np.random.default_rng(14).uniform(
        0.95, 1.05, size=depths[sub].shape).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    conf = CO.compute_depth_consistency_confidence(noisy, Ks[sub],
                                                   poses[sub])
    res["conf_ms"] = 1e3 * (time.perf_counter() - t0)
    res["conf_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    conf_cpu = CO.compute_depth_consistency_confidence(
        noisy, Ks[sub], poses[sub], device="cpu")
    res["conf_cpu_s"] = time.perf_counter() - t0
    res["conf_shape"] = list(conf.shape)
    res["conf_differ_share"] = float((np.abs(conf - conf_cpu) > 1e-6).mean())
    res["conf_mean"] = float(conf.mean())
    del depths, noisy

    # the rendered scene's own covisibility, where data/wai.py reads it
    recs = [load_frame(root, i, ["rendered_depth"], scene_meta=meta)
            for i in range(len(meta["frames"]))]
    scene_covis = CO.compute_pairwise_covisibility(
        np.stack([r["rendered_depth"] for r in recs]),
        np.stack([r["intrinsics"] for r in recs]),
        np.stack([r["extrinsics"] for r in recs]))
    store_data(os.path.join(root, "covisibility", "v0", "covis.npy"),
               scene_covis, "mmap")
    res["scene_covis"] = scene_covis.round(4).tolist()
    print(f"phase 14b, covisibility: {json.dumps(res)}", flush=True)
    if not (res["diag_max_err"] <= 1e-6 and res["facing_away_max"] == 0.0
            and res["subset_max_abs"] <= res["subset_limit"]
            and res["conf_differ_share"] <= CONF_SHARE
            and 0.0 < res["conf_mean"] < 1.0):
        return res, f"14b: {res}"
    return res, None


class RecordingAdapter(types.SimpleNamespace):
    """Forwards to an adapter and keeps what each call returned."""

    def __call__(self, views, **kw):
        out = self.adapter(views, **kw)
        self.calls.append(out)
        return out

    def parameters(self):
        return self.adapter.parameters()


def offline_labelling(torch, fa, fp, folder):
    """14c: run_pseudo_depth_stage with MapAnythingAdapter over phase 3's
    weights on an 8-frame 518 x 392 WAI scene of the room, one call, then
    run_depth_consistency_stage on the card and on the CPU, over the labels
    and over the scene's closed-form depth. Gates: the stored depth, mask
    and confidence are the adapter's own outputs (bitwise: EXR holds fp32);
    FORWARD_LAUNCHES forward launches, 0 plain, probe and baseline; each
    card confidence within CONF_SHARE of the CPU's, the closed form's
    mostly consistent. Returns (readings, the stage's launches, failure or
    None)."""
    import shutil

    import numpy as np
    from torch_offline_scenes import CONF_SHARE, room_cameras, room_depth

    from mapanything_tpu_torch.data import pseudo_depth as PD
    from mapanything_tpu_torch.data.wai import (
        load_frame,
        load_scene_meta,
        write_scene,
    )
    from mapanything_tpu_torch.models.adapters import MapAnythingAdapter

    w, h = LABEL_SIZE
    K = np.array([[400.0, 0, w / 2], [0, 400.0, h / 2], [0, 0, 1]])
    poses = room_cameras(LABEL_FRAMES, step=OFFLINE_YAW)
    rng = np.random.default_rng(14)
    frames = [{"frame_name": f"frame{i}",
               "image": rng.integers(0, 255, (h, w, 3), np.uint8),
               "depth": room_depth(K, poses[i], (h, w)).astype(np.float32),
               "transform_matrix": poses[i]} for i in range(LABEL_FRAMES)]
    scene = write_scene(os.path.join(folder, "label", "card", "s"), frames,
                        dict(fx=400.0, fy=400.0, cx=w / 2, cy=h / 2, w=w,
                             h=h))
    t0 = time.perf_counter()
    model = random_weights_model()
    res = {"model_s": time.perf_counter() - t0}
    adapter = RecordingAdapter(adapter=MapAnythingAdapter(model), calls=[])
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    PD.run_pseudo_depth_stage(scene, adapter, model_name="mapanything",
                              batch_frames=LABEL_FRAMES)
    torch.cuda.synchronize()
    res["label_stage_s"] = time.perf_counter() - t0
    launched = launches_of(fa)
    bad = expect_launches(fa, {"fwd": FORWARD_LAUNCHES}, "14c")
    res.update(launches=launched, calls=len(adapter.calls))
    if bad or len(adapter.calls) != 1:
        return res, launched, bad or f"14c: {res}"

    preds = adapter.calls[0]
    z = preds["pts3d_cam"][0, ..., 2].float().cpu().numpy()
    z = np.where(np.isfinite(z) & (z > 0), z, 0.0)
    mask = preds["non_ambiguous_mask"][0].cpu().numpy()
    conf = preds["conf"][0].float().cpu().numpy()
    meta = load_scene_meta(os.path.join(scene, "scene_meta.json"))
    keys = ["pred_depth/mapanything", "pred_mask/mapanything",
            "depth_confidence/mapanything"]
    same = []
    for i in range(LABEL_FRAMES):
        got = load_frame(scene, i, keys, scene_meta=meta)
        same.append(np.array_equal(got[keys[0]], z[i])
                    and np.array_equal(got[keys[1]], mask[i])
                    and np.array_equal(got[keys[2]], conf[i]))
    res["stored_equal_outputs"] = all(same)
    res["valid_depth_share"] = float((z > 0).mean())

    img = torch.from_numpy(PD._normalize_images(
        np.stack([f["image"] for f in frames])[None].astype(np.float32)
        / 255.0, "dinov2")).cuda()

    def forward():
        with torch.inference_mode():
            adapter.adapter({"img": img})

    forward()
    walls_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls_ms.append(1e3 * (time.perf_counter() - t0))
    prof = profile_calls(torch, forward, statistics.median(walls_ms), 2,
                         match={"flash": "flash_fwd"})
    res["forward"] = {key: prof[key] for key in (
        "wall_ms", "device_ms", "busy_share", "device_ops", "matched_ms",
        "not_measured") if key in prof}
    res["forward_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, adapter, preds
    torch.cuda.empty_cache()

    cpu_scene = shutil.copytree(scene, os.path.join(folder, "label", "cpu",
                                                    "s"))
    # the filter on the labels (the pipeline) and on the scene's
    # closed-form depth (whose frames agree where they overlap)
    for modality, name in ((keys[0], "mapanything"), ("depth", "gt")):
        t0 = time.perf_counter()
        PD.run_depth_consistency_stage(scene, modality, model_name=name)
        res[f"consistency_{name}_card_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        PD.run_depth_consistency_stage(cpu_scene, modality, model_name=name,
                                       device="cpu")
        res[f"consistency_{name}_cpu_s"] = time.perf_counter() - t0
        differ, mean = [], []
        key = f"depth_confidence/{name}"
        for i in range(LABEL_FRAMES):
            a = load_frame(scene, i, [key])[key]
            b = load_frame(cpu_scene, i, [key])[key]
            differ.append(float((np.abs(a - b) > 1e-6).mean()))
            mean.append(float(a.mean()))
        res[f"conf_{name}_differ_share"] = max(differ)
        res[f"conf_{name}_mean"] = statistics.mean(mean)
    print(f"phase 14c, pseudo-depth: {json.dumps(res)}", flush=True)
    if not (res["stored_equal_outputs"]
            and res["conf_mapanything_differ_share"] <= CONF_SHARE
            and res["conf_gt_differ_share"] <= CONF_SHARE
            and res["conf_gt_mean"] > 0.5):
        return res, launched, f"14c: {res}"
    return res, launched, None


def offline_loading(root):
    """14d: the converted ScanNet++ scene, with its rendered depth and
    covisibility, through the loader of the port's `scannetpp` spec: one
    batch of 2 x 2 views at 518 x 336, finite, of the expected shapes.
    Returns (readings, failure or None)."""
    import numpy as np

    from mapanything_tpu_torch.data.loader import get_test_data_loader
    from mapanything_tpu_torch.data.wai_datasets import WAIDataset

    t0 = time.perf_counter()
    ds = WAIDataset(ROOT=os.path.dirname(root), spec="scannetpp",
                    num_views=2, covisibility_thres=0.1,
                    resolution=(518, 336), data_norm_type="dinov2", seed=0)
    batch = first_batch(get_test_data_loader(4 @ ds, batch_size=2,
                                             num_workers=2))
    res = {"load_s": time.perf_counter() - t0,
           "shapes": {f"{g}/{k}": list(v.shape)
                      for g in ("views", "gt") for k, v in batch[g].items()}}
    floats = [v for g in ("views", "gt") for v in batch[g].values()
              if v.dtype.kind == "f"]
    res["finite"] = all(bool(np.isfinite(v).all()) for v in floats)
    res["depth_max"] = float(batch["gt"]["depth_along_ray"].max())
    print(f"phase 14d, loader: {json.dumps(res)}", flush=True)
    if not (res["finite"] and res["shapes"]["views/img"] == [2, 2, 336, 518, 3]
            and res["depth_max"] > 0):
        return res, f"14d: {res}"
    return res, None


def offline_path(torch, fa, fp, F):
    """Phase 14. Returns (kernel rows, the kernel counts of its runs,
    failure or None)."""
    rows = kernel_vs_plain(torch, fa, fp, F, OFFLINE_SHAPES, seed=1400,
                           baseline=False)
    for name, row in rows:
        row["at"] = name
        if not max(row["max_abs_err"], row["rel_l2"]) <= ERR_LIMIT:
            return rows, [], f"kernel disagrees with plain at {name}: {row}"
    walls = {}
    counts = []
    with tempfile.TemporaryDirectory() as folder:
        t0 = time.perf_counter()
        _, root, bad = offline_conversion(torch, folder)
        walls["14a_s"] = time.perf_counter() - t0
        if bad:
            return rows, counts, bad
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _, bad = offline_covisibility(torch, root)
        walls["14b_s"] = time.perf_counter() - t0
        if bad:
            return rows, counts, bad
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _, launched, bad = offline_labelling(torch, fa, fp, folder)
        walls["14c_s"] = time.perf_counter() - t0
        counts.append(launched)
        if bad:
            return rows, counts, bad
        t0 = time.perf_counter()
        _, bad = offline_loading(root)
        walls["14d_s"] = time.perf_counter() - t0
        if bad:
            return rows, counts, bad
    print(f"phase 14 walls: {json.dumps(walls)}", flush=True)
    return rows, counts, untouched_baseline(fp)


# phase 15: multi-GPU training, data and tensor parallelism
MESH_TIMED_STEPS = 1  # after the compared step, images_only only
MESH_TIMEOUT = 900
# 15a's trunk: gloo stages every collective through the host, so its steps
# cost about their parameters' and activations' bytes; the released trunk
# cut to 4 of its 24 layers keeps every sharded layer kind (the encoder's
# 24 whole, a frame and a global layer twice) at ~0.4 of the bytes
MESH_TRUNK_DEPTH = 4
# the forward-with-lse, dK/dV and dQ launches per rank-step at any head
# count: the encoder's 24 attentions and one per trunk layer
MESH_STEP_LAUNCHES = dict.fromkeys(("fwd_lse", "dkv", "dq"),
                                   24 + MESH_TRUNK_DEPTH)
# the training kernels at the tensor-parallel head counts: H = 16 / tp,
# q, k and v strided views of a local fused qkv (token stride 3 * H * 64)
TP_SHAPES = [
    (f"{name}_h{h}", (b, n, h, 64), n_valid)
    for h in (8, 4)
    for name, (b, n), n_valid in (
        ("encoder_2view", (2, 1408), 1370), ("frame_2view", (2, 1369), None),
        ("global_4view", (1, 5504), 5477),
        ("encoder_tp_2x4view", (8, 1408), 1370),
        ("frame_tp_2x4view", (8, 1369), None),
        ("global_tp_2x4view", (2, 5504), 5477))]


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def shared_card_mesh_check(args, world: int, folder: str):
    """parallel/mesh_check.py ARGS as `world` processes that share card 0
    over gloo; returns (rank 0's JSON, failure or None). Every process is
    stopped before it returns."""
    port = free_port()
    out = os.path.join(folder, "mesh_check.json")
    procs, logs = [], []
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            log = open(os.path.join(folder, f"rank{rank}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "mapanything_tpu_torch.parallel.mesh_check", *args,
                 "--backend", "gloo", "--steps", str(MESH_TIMED_STEPS),
                 "--trunk_depth", str(MESH_TRUNK_DEPTH), "--out", out],
                cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + MESH_TIMEOUT
        codes = [proc.wait(timeout=max(deadline - time.monotonic(), 1))
                 for proc in procs]
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tails = []
    for rank, log in enumerate(logs):
        log.seek(0)
        tails.append(f"rank {rank}: " + log.read()[-3000:])
        log.close()
    if not os.path.exists(out):
        return None, (f"mesh_check {args} exit codes {codes}; "
                      + " | ".join(tails))
    with open(out) as f:
        res = json.load(f)
    if codes != [0] * world:
        return res, f"mesh_check {args} exit codes {codes}"
    return res, None


def mesh_name(shape) -> str:
    return " x ".join(f"{axis} {n}" for axis, n in (("DP", shape["data"]),
                                                   ("TP", shape["model"]))
                      if n > 1)


def mesh_launches(res) -> tuple:
    """(the kernel counts of every rank's compared mesh step, summed over
    the ranks, meshes and tasks; failure or None): each step 48
    forward-with-lse, dK/dV and dQ launches, no other kernel and no plain
    launch."""
    total, bad = {}, None
    for run in res["meshes"]:
        for task, entry in run["tasks"].items():
            for rank, per in enumerate(entry["ranks"]):
                counts = per["launches"]
                want = dict.fromkeys(counts, 0) | MESH_STEP_LAUNCHES
                if counts != want:
                    bad = bad or (f"{mesh_name(run['mesh'])} {task} rank "
                                  f"{rank}: launches {counts}")
                for key, val in counts.items():
                    if key != "plain":
                        total[key] = total.get(key, 0) + val
    return total, bad


def print_mesh(res) -> None:
    for run in res["meshes"]:
        name = mesh_name(run["mesh"])
        for task, entry in run["tasks"].items():
            ref = entry["reference"]
            cmp = entry["vs_reference"]
            print(f"phase 15 {name} {task}: loss {cmp['loss']:.6f} vs "
                  f"one-rank {ref['loss']:.6f} (rel "
                  f"{cmp['loss_rel_diff']:.2e}), grad_norm rel "
                  f"{cmp['grad_norm_rel_diff']:.2e}, gradients rel-L2 "
                  f"{cmp['grads']['rel_l2']:.2e} (worst "
                  f"{cmp['grads']['worst_rel_l2']:.2e}, "
                  f"{cmp['grads']['worst_name']}), updated parameters "
                  f"{cmp['params']['rel_l2']:.2e} (worst "
                  f"{cmp['params']['worst_rel_l2']:.2e}, "
                  f"{cmp['params']['worst_name']})", flush=True)
            rt = ref["timing"]
            if rt:
                prof = rt.get("profile", {})
                print(f"  one-rank step: wall {rt['step_ms']:.1f} ms, "
                      f"device {prof.get('device_ms', float('nan')):.1f} "
                      f"ms, peak {rt.get('peak_memory_gib', float('nan')):.2f}"
                      " GiB", flush=True)
            for rank, per in enumerate(entry["ranks"]):
                t = per["timing"]
                prof = t.get("profile", {})
                timing = "" if not t else (
                    f"wall {t['step_ms']:.1f} ms, device "
                    f"{prof.get('device_ms', float('nan')):.1f} ms (NCCL "
                    f"{prof.get('nccl_ms', float('nan')):.2f}), peak "
                    f"{t.get('peak_memory_gib', float('nan')):.2f} GiB, ")
                print(f"  rank {rank}: {timing}launches {per['launches']}",
                      flush=True)


def multi_card_runs(torch) -> tuple:
    """15c: the mesh and ring checks under NCCL, one card per rank, where
    the machine has two or more; (results, failure or None)."""
    cards = torch.cuda.device_count()
    runs = [(2, ["mapanything_tpu_torch.parallel.mesh_check", "--tp",
                 "1,2"])]
    if cards >= 4:
        runs += [(4, ["mapanything_tpu_torch.parallel.mesh_check", "--tp",
                      "2"]),
                 (4, ["mapanything_tpu_torch.parallel.ring_check", "--check",
                      "train", "--task", "aug_training"])]
    results = []
    for nproc, cmd in runs:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", str(nproc), "--master_port",
             str(free_port()), "-m", *cmd], cwd=HERE, capture_output=True,
            text=True, timeout=MESH_TIMEOUT)
        lines = [line for line in proc.stdout.splitlines()
                 if line.startswith("{")]
        res = json.loads(lines[-1]) if lines else None
        results.append({"nproc": nproc, "cmd": cmd,
                        "secs": time.perf_counter() - t0, "result": res})
        print(f"phase 15c {nproc} cards {' '.join(cmd[1:])}: "
              f"{json.dumps(res)}", flush=True)
        if res is not None and "meshes" in res:
            print_mesh(res)
        if proc.returncode != 0 or res is None or not res.get("ok"):
            return results, (f"15c {cmd} exit {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return results, None


def multi_gpu_training(torch, fa, fp, F):
    """Phase 15: (training-kernel rows at the TP head counts, [kernel
    counts of the mesh steps], failure or None)."""
    fp.reset_probe_counts()
    torch.cuda.empty_cache()
    counts = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as folder:
        # DP 2, then TP 2, in one pair of processes
        res, bad = shared_card_mesh_check(["--tp", "1,2"], 2, folder)
    if res is not None:
        print(f"phase 15a: {json.dumps(res)}", flush=True)
        print_mesh(res)
    if bad:
        return {}, counts, f"15a: {bad}"
    if not res["ok"]:
        return {}, counts, "15a: a check failed"
    total, bad = mesh_launches(res)
    if bad:
        return {}, counts, f"15a: {bad}"
    counts.append(total)
    print(f"phase 15a took {time.perf_counter() - t0:.1f} s", flush=True)
    rows = training_kernels_vs_plain(torch, fa, fp, F, shapes=TP_SHAPES,
                                     seed=1500, baseline=False)
    for kname, krows in rows.items():
        for row in krows:
            bad = {key: val for key, val in row.items()
                   if key.endswith(("_max_abs_rel", "_rel_l2"))
                   and not val <= ERR_LIMIT}
            if bad:
                return rows, counts, (f"15b {kname} disagrees with plain at "
                                      f"{row['at']}: {bad}")
    bad = untouched_baseline(fp)
    if bad:
        return rows, counts, f"15b: {bad}"
    if torch.cuda.device_count() < 2:
        print("phase 15c: skipped, 1 card", flush=True)
    else:
        _, bad = multi_card_runs(torch)
        if bad:
            return rows, counts, bad
    return rows, counts, None


# phase 16: training the model variants and the criteria outside the
# released recipe at full width, the trunk cut to 4 layers, and the training kernels at the
# shapes only the variants give them (phase 13's VARIANT_SHAPES)
VARIANT_TRAIN_SEED = 16
VARIANT_TIMED_STEPS = 3
VARIANT_TRUNK_DEPTH = 4
# launches a step: the encoder's 24 blocks and each trunk layer's one, or
# the cross trunk's six (self- and cross-attention for the reference view,
# the batch of the other views and the token)
VARIANT_LAUNCHES = 24 + VARIANT_TRUNK_DEPTH
VARIANT_CROSS_LAUNCHES = 24 + 6 * VARIANT_TRUNK_DEPTH
# the predictions of an own-init model at the released width are flat
# enough that a bf16-level change of attention can move the gradient past
# GRAD_LIMIT; where the noise floor itself (math on an image perturbed by
# 1e-3) exceeds it, flash is held to bf16 math's distance from an fp32
# twin instead (FLOOR_RATIO, phase 13's gate)


def variant_training_rows(torch, fa, F):
    """16c: the forward with lse, dK/dV, dQ and the pair (delta + dK/dV +
    dQ) against their plain versions at VARIANT_SHAPES (phase 2b's method
    and limits: max-abs over the plain's max-abs and rel-L2 over the real
    rows, q's for the outputs, the lse and dQ, the keys' for dK and dV),
    each with device ms, bound, the library call's time (flash SDPA's
    forward with lse; FA2's backward for the pair) and host µs. With one
    key, dQ and dK are held against the size of their products instead
    (see below). Returns ({kernel name or PAIR: [row]}, failure or
    None)."""
    rows = {name: [] for name in [*TRAINING_KERNELS, PAIR]}
    for i, (name, shape, keys, n_valid, layout) in enumerate(VARIANT_SHAPES):
        b, n, h, d = shape
        q, k, v = variant_inputs(torch, shape, keys, n_valid, layout,
                                 1600 + i)
        real_q = n if n_valid is None else n_valid
        real_k = keys if n_valid is None else n_valid
        gen = torch.Generator(device="cuda").manual_seed(1700 + i)
        dout = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        dout[:, real_q:] = 0  # the row mask's backward zeroes them
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
        torch.cuda.synchronize()

        def q_rows(got, ref):
            return got[:, :real_q], ref[:, :real_q]

        def k_rows(got, ref):
            return got[:, :real_k], ref[:, :real_k]

        lib = sdpa_layout(q, k, v, real_k)
        cases = [
            ("flash_attn_fwd_lse",
             {"out": q_rows(out, ref_out),
              "lse": q_rows(lse.transpose(1, 2), ref_lse.transpose(1, 2))},
             lambda: fa.flash_attention_fwd_lse(q, k, v, n_valid),
             lambda: fa.flash_attention_fwd_lse_plain(q, k, v, n_valid),
             "fwd_lse", library_fwd_lse_ms(torch, *lib)),
            ("flash_attn_bwd_dkv",
             {"dk": k_rows(dk, ref_dk), "dv": k_rows(dv, ref_dv)},
             lambda: fa.flash_attention_dkv(*bwd_args),
             lambda: fa.flash_attention_dkv_plain(*bwd_args), "dkv", None),
            ("flash_attn_bwd_dq", {"dq": q_rows(dq, ref_dq)},
             lambda: fa.flash_attention_dq(*bwd_args),
             lambda: fa.flash_attention_dq_plain(*bwd_args), "dq", None),
            (PAIR, {"dq": q_rows(pair[0], ref_dq), "dk": k_rows(pair[1],
                                                                ref_dk),
                    "dv": k_rows(pair[2], ref_dv)},
             lambda: fa.flash_attention_bwd(*pair_args),
             lambda: fa.flash_attention_bwd_plain(*pair_args), "bwd",
             library_bwd_ms(torch, *lib, dout)),
        ]
        # with one key the softmax has no derivative in its logit: dS, dQ
        # and dK are zero in exact arithmetic, and the kernel's and the
        # plain version's are both rounding noise of dO.V - delta. Those
        # two are held against the size their products would have
        # without the cancellation, |dO| |V| |Q or K| / sqrt(d)
        degenerate = {}
        if real_k == 1:
            scale = (dout.float().abs().max() * v.float().abs().max()
                     / math.sqrt(d))
            degenerate = {"dq": scale * k.float().abs().max(),
                          "dk": scale * q.float().abs().max()}
        for kname, outputs, kernel_fn, plain_fn, work, library in cases:
            row = {"at": name, "shape": list(shape), "keys": keys,
                   "n_valid": n_valid, "layout": layout,
                   "strides": [list(x.stride()[:3]) for x in (q, k, v)],
                   **errors_of(outputs)}
            for oname in set(degenerate) & set(outputs):
                got, ref = outputs[oname]
                row[f"{oname}_max_abs_over_products"] = float(
                    (got.float() - ref.float()).abs().max()
                    / degenerate[oname])
                del row[f"{oname}_max_abs_rel"], row[f"{oname}_rel_l2"]
            row["ms"] = kernel_ms(kernel_fn)
            row["plain_ms"] = plain_ms(plain_fn)
            row["host_us"] = host_us(kernel_fn)
            flops, _ = F.attention_kernel_work(work, b, n, real_k, h, d)
            row["tflops"] = flops / row["ms"] / 1e9
            row.update(bound(F, work, shape, real_k))
            row["library_ms"] = library
            rows[kname].append(row)
            print_row(f"16c {kname}", f"{name} keys={keys} {layout}", shape,
                      row)
            bad = {key: val for key, val in row.items()
                   if key.endswith(("_max_abs_rel", "_rel_l2",
                                    "_over_products"))
                   and not val <= ERR_LIMIT}
            if bad:
                return rows, f"16c {kname} disagrees with plain at {name}: " \
                             f"{bad}"
        del (q, k, v, dout, out, lse, ref_out, ref_lse, delta, dk, dv, dq,
             ref_dk, ref_dv, ref_dq, pair, cases, bwd_args, pair_args, lib)
        torch.cuda.empty_cache()
    return rows, None


def layout_repairs(torch, fa):
    """16c: layouts of dO that autograd can hand the backward, an expanded
    (stride 0) zero and the slice of a wider row. The backward copies the
    first to a contiguous tensor, the kernels read the second in place;
    either way one dK/dV and one dQ launch and the plain backward's
    gradients. Returns (readings, failure or None)."""
    res = {}
    for name, make_dout in (
            ("expanded_zero", lambda o: torch.zeros(
                (), dtype=o.dtype, device=o.device).expand(o.shape)),
            ("row_slice", lambda o: torch.randn(
                o.shape[:-1] + (2 * o.shape[-1],), device=o.device).to(
                    o.dtype)[..., :o.shape[-1]])):
        q, k, v = attention_inputs(torch, (1, 1369, 16, 64), None, 1650)
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        out = fa.flash_attention(q, k, v)
        dout = make_dout(out)
        fa.reset_launch_counts()
        grads = torch.autograd.grad(out, (q, k, v), dout)
        counts = launches_of(fa)
        with torch.no_grad():
            ref = fa.flash_attention_bwd_plain(
                q, k, v, out, fa.flash_attention_fwd_lse_plain(q, k, v)[1],
                dout)
        torch.cuda.synchronize()
        err = max(float((g.float() - r.float()).abs().max()
                        / r.float().abs().max().clamp_min(1e-30))
                  if r.abs().max() > 0 else float(g.abs().max())
                  for g, r in zip(grads, ref))
        res[name] = {"strides": list(dout.stride()), "launches": counts,
                     "max_abs_rel": err}
        if counts["dkv"] != 1 or counts["dq"] != 1 or not err <= ERR_LIMIT:
            return res, f"16c dO layout {name}: {res[name]}"
    print(f"16c dO layouts: {json.dumps(res)}", flush=True)
    return res, None


def variant_criteria(PC):
    """16b: {name: (the scene representation it trains, its criterion)}.
    The disentangled loss's sets: depth 0, ray directions 1, pose quats 2,
    pose trans 3 (pixel sets), scale 4, normal 5, gradient matching 6."""
    robust = PC.RobustRegressionLoss(alpha=0.5, scaling_c=0.05)
    mask = 0.3 * PC.NonAmbiguousMaskLoss(PC.BCELoss())
    return {
        "regr3d": ("pointmap+confidence+mask", PC.ConfLoss(
            PC.Regr3D(robust, norm_mode="?avg_dis"), alpha=0.2) + mask),
        "points_plus_scale": ("raymap+depth+confidence+mask", PC.ConfLoss(
            PC.PointsPlusScaleRegr3D(robust), alpha=0.2) + mask),
        "disentangled": (
            "pointmap+raydirs+depth+pose+confidence+mask",
            PC.ConfAndExcludeTopNPercentPixelLoss(
                PC.DisentangledFactoredGeometryScaleRegr3DPlusNormalGMLoss(
                    robust, normal_loss_weight=3.0, gm_loss_weight=3.0),
                conf_alpha=0.2, top_n_percent=5, conf_loss_set_indices=[0],
                exclude_loss_set_indices=[1, 2, 3]) + mask),
        "factored_l": ("raydirs+depth+pose+confidence+mask",
                       PC.FactoredGeometryScaleRegr3D(PC.FactoredLLoss(),
                                                      norm_mode="avg_dis")),
    }


def twin_gradient_gate(torch, model, batch, loss_fn) -> dict:
    """The gradient pulled back from one cotangent (an fp32 twin's math
    path's d loss / d predictions) through flash and through bf16 math,
    each against the twin's own: flash's rel-L2 at most FLOOR_RATIO x bf16
    math's (phase 13's gate for the forward, on the gradient)."""
    import dataclasses

    from mapanything_tpu_torch.models import MapAnything, images_only_config
    from mapanything_tpu_torch.train.grad_check import (_flat_grad,
                                                        _float_outputs,
                                                        _rel_l2)

    geom = images_only_config()
    views = {"img": batch["views"]["img"]}
    twin = MapAnything(dataclasses.replace(model.cfg, dtype=torch.float32),
                       device=next(model.parameters()).device)
    twin.load_state_dict(model.state_dict())
    twin.set_attn_impl("math")
    preds = twin(views, geom)
    outs = _float_outputs(preds)
    loss, _ = loss_fn(batch["gt"], preds)
    cot = [torch.zeros_like(o) if c is None else c for c, o in zip(
        torch.autograd.grad(loss, outs, retain_graph=True,
                            allow_unused=True), outs)]
    ref = _flat_grad(outs, list(twin.parameters()), cot, retain_graph=False)
    del twin, preds, outs, loss
    grads = {}
    for impl in ("auto", "math"):
        model.set_attn_impl(impl)
        try:
            outs = _float_outputs(model(views, geom))
            grads[impl] = _flat_grad(outs, list(model.parameters()), [
                c.to(o.dtype) for c, o in zip(cot, outs)],
                retain_graph=False)
        finally:
            model.set_attn_impl("auto")
        del outs
    res = {"flash_vs_fp32": _rel_l2(grads["auto"], ref),
           "math_vs_fp32": _rel_l2(grads["math"], ref)}
    res["flash_over_math"] = (  # 0 / 0: the twin's own dtype
        res["flash_vs_fp32"] / res["math_vs_fp32"] if res["math_vs_fp32"]
        else 0.0 if not res["flash_vs_fp32"] else math.inf)
    del grads, ref, cot
    torch.cuda.empty_cache()
    return res


def gradient_gate(torch, compare, model, batch, loss_fn) -> tuple:
    """16a/16b's check on the fresh model: train/grad_check.py::compare
    (loss_fn read as a whole) with phase 4's limits, the loss auto against
    math within ERR_LIMIT relative and the pulled-back gradient, over all
    parameters and over the qkv weights, within GRAD_LIMIT rel-L2, each
    beside its noise floor; where a floor itself exceeds GRAD_LIMIT, the
    fp32-twin gate (twin_gradient_gate). Returns (readings, failure or
    None)."""
    res = compare(model, batch, loss_fn=loss_fn)
    res = {key: val for key, val in res.items() if key != "terms"}
    if not res["loss_rel_diff"] <= ERR_LIMIT:
        return res, f"loss flash vs math {res['loss_rel_diff']:.3e}"
    floors = ("grad_noise_floor_rel_l2", "qkv_grad_noise_floor_rel_l2")
    if all(res[key] <= GRAD_LIMIT for key in floors):
        res["gate"] = "grad_check"
        for key in ("grad_rel_l2", "qkv_grad_rel_l2"):
            if not res[key] <= GRAD_LIMIT:
                return res, f"{key} {res[key]:.3e}"
        return res, None
    res["gate"] = "fp32 twin"
    res["twin"] = twin_gradient_gate(torch, model, batch, loss_fn)
    if not res["twin"]["flash_over_math"] <= FLOOR_RATIO:
        return res, f"flash over bf16 math from the fp32 twin: {res['twin']}"
    return res, None


def timed_variant_steps(torch, fa, step, batch, launches, what) -> tuple:
    """1 warm-up and VARIANT_TIMED_STEPS timed steps of `step(batch)` ->
    (loss, grad_norm): exactly `launches` forward-with-lse, dK/dV and dQ
    launches each and nothing else, finite loss and grad_norm, parameters
    that changed; the median step wall, the device ms and busy share of a
    traced step, the peak GiB. Returns (readings, [counts], failure or
    None)."""
    res, counts = {}, []
    want = {"fwd_lse": launches, "dkv": launches, "dq": launches}
    torch.cuda.reset_peak_memory_stats()
    step(batch)  # warm-up
    torch.cuda.synchronize()
    watched = step.params[::97]
    before = [p.detach().clone() for p in watched]
    times, losses, norms = [], [], []
    for i in range(VARIANT_TIMED_STEPS):
        fa.reset_launch_counts()
        counted = step_counts(step)
        t0 = time.perf_counter()
        loss, norm = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts.append(launches_of(fa))
        bad = expect_launches(fa, host_launches(step, counted, want),
                              f"{what} step {i}")
        if bad:
            return res, counts, bad
        losses.append(float(loss))
        norms.append(float(norm))
        if not (math.isfinite(losses[-1]) and math.isfinite(norms[-1])):
            return res, counts, (f"{what} step {i}: loss {losses[-1]} "
                                 f"grad_norm {norms[-1]}")
    changed = sum(not torch.equal(a, p.detach())
                  for a, p in zip(before, watched))
    del before
    if changed == 0:
        return res, counts, f"{what}: no watched parameter changed"
    res.update({"step_ms": statistics.median(times), "step_ms_all": times,
                "loss": losses, "grad_norm": norms,
                "watched_params_changed": f"{changed}/{len(watched)}",
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    res["profile"] = profile_calls(torch, lambda: step(batch),
                                   res["step_ms"], calls=1)
    return res, counts, None


class VariantStep:
    """One training step of a model: the released recipe's make_train_step,
    or, with a criterion, the composed step (forward, criterion, backward,
    the port's AdamW), both with OptimConfig(warmup_steps=2,
    total_steps=100). Calling it returns (loss, grad_norm)."""

    def __init__(self, T, model, geom, criterion=None):
        cfg = T.OptimConfig(warmup_steps=2, total_steps=100)
        self.state = T.create_train_state(model, cfg)
        self.params = self.state.optimizer.params
        self.T, self.model, self.geom = T, model, geom
        self.criterion = criterion
        self.train_step = (T.make_train_step(model, geom)
                           if criterion is None else None)

    def __call__(self, batch):
        if self.criterion is None:
            self.state, m = self.train_step(self.state, batch)
            return m["loss"], m["grad_norm"]

        def loss_fn(b, generator=None):
            return self.criterion(b["gt"], self.model(b["views"], self.geom))

        loss, _, grads = self.T.loss_and_grads(loss_fn, self.params, batch)
        norm = self.state.optimizer.norm(grads)
        self.state.apply_gradients(grads, norm)
        for p in self.params:
            p.grad = None
        return loss, norm


def variant_training(torch, fa, fp, F):
    """Phase 16. Returns (16c's rows, the kernel counts of its runs,
    failure or None)."""
    from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
    from mapanything_tpu_torch.models import (
        MapAnything,
        MapAnythingConfig,
        dense_dim_for,
        images_only_config,
        mapanything_ablations_config,
    )
    from mapanything_tpu_torch.parallel.mesh_check import cut_trunk
    from mapanything_tpu_torch.train import criteria as PC
    from mapanything_tpu_torch.train import step as T
    from mapanything_tpu_torch.train.grad_check import compare
    from mapanything_tpu_torch.train.losses import overall_loss

    walls, counts = {}, []
    t0 = time.perf_counter()
    rows, bad = variant_training_rows(torch, fa, F)
    if not bad:
        _, bad = layout_repairs(torch, fa)
    walls["16c_s"] = time.perf_counter() - t0
    if bad:
        return rows, counts, bad
    geom = images_only_config()
    cut = cut_trunk(VARIANT_TRUNK_DEPTH)
    pose = {f: f + "+confidence+mask" for f in (
        "campointmap+pose", "pointmap+raydirs+depth+pose")}
    # (stage, name, config, view counts, (w, h), launches a step,
    # criterion or None for the released recipe's step)
    runs = [
        ("16a", "global", MapAnythingConfig(info_sharing_type="global", **cut),
         (2,), (518, 518), VARIANT_LAUNCHES, None),
        ("16a", "cross", MapAnythingConfig(info_sharing_type="cross", **cut),
         (2, 4), (518, 518), VARIANT_CROSS_LAUNCHES, None),
        ("16a", "ablations", mapanything_ablations_config(**cut), (2,),
         (518, 518), VARIANT_LAUNCHES, None),
        ("16a", "radio_l", MapAnythingConfig(
            encoder_type="radio", patch_size=16, data_norm_type="radio",
            **cut), (2,), (512, 384), VARIANT_LAUNCHES, None),
        ("16a", "croco_l", MapAnythingConfig(
            encoder_type="croco", patch_size=16, data_norm_type="croco",
            **cut), (2,), (512, 384), VARIANT_LAUNCHES, None),
    ] + [("16a", fam, MapAnythingConfig(
        scene_rep_type=srt, dense_output_dim=dense_dim_for(srt), **cut),
          (2,), (518, 518), VARIANT_LAUNCHES, None)
         for fam, srt in pose.items()] + [
        ("16b", name, MapAnythingConfig(
            scene_rep_type=srt, dense_output_dim=dense_dim_for(srt), **cut),
         (2,), (518, 518), VARIANT_LAUNCHES, crit)
        for name, (srt, crit) in variant_criteria(PC).items()]
    for stage, name, cfg, views, (w, h), launches, crit in runs:
        # what earlier phases left in reference cycles goes first: the
        # cross trunk's check needs most of the card
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        model = MapAnything(cfg, generator=torch.Generator(
            device="cuda").manual_seed(VARIANT_TRAIN_SEED))
        res = {"build_s": time.perf_counter() - t0,
               "resident_before_gib": resident}
        # at 1 view, as phase 4: compare holds three graphs at once, and
        # the math path's saved fp32 scores of two 2-view graphs exceed
        # the card's 80 GB (the global trunk ran out of memory there)
        check = make_synthetic_batch(1, 1, h, w, seed=1)
        res["gate"], bad = gradient_gate(
            torch, compare, model, check,
            overall_loss if crit is None else crit)
        print(f"{stage} {name} flash vs math, own init (1 view; "
              f"{res['resident_before_gib']:.2f} GiB resident before the "
              f"model): {json.dumps(res['gate'])}", flush=True)
        if bad:
            return rows, counts, f"phase {stage} {name}: {bad}"
        del check
        torch.cuda.empty_cache()
        step = VariantStep(T, model, geom, crit)
        for n in views:
            batch = make_synthetic_batch(1, n, h, w, seed=0)
            r, launched, bad = timed_variant_steps(
                torch, fa, step, batch, launches, f"{stage} {name} {n}v")
            counts += launched
            res[f"{n}_views"] = r
            print(f"{stage} {name} {n} views at {w}x{h}: {json.dumps(r)}",
                  flush=True)
            if bad:
                return rows, counts, f"phase {stage}: {bad}"
            bad = untouched_baseline(fp)
            if bad:
                return rows, counts, f"phase {stage} {name}: {bad}"
            del batch
        del model, step
        torch.cuda.empty_cache()
        walls[f"{stage}_{name}_s"] = time.perf_counter() - t0
    print(f"phase 16 walls: {json.dumps(walls)}", flush=True)
    return rows, counts, None


# phase 17: the external-model adapters (models/adapters.py) over their
# interface fakes (tests/torch_adapter_fakes.py: no VGGT, Pi3, MoGe,
# DUSt3R, MASt3R, MUSt3R, Pow3R or AnyCalib checkpoint or package is in the
# repository): each on the card against its own CPU run, through the
# unmodified harnesses, VGGT's stand-in at VGGT-1B's attention width, and
# the MoGe labelling stage through convert_dataset
ADAPTER_SIZE = (518, 392)  # (w, h) of 17a-17b: the harnesses' images
ADAPTER_LIMIT = 1e-5  # rel-L2 of each key, card against CPU, fp32
GT_DENSE_LIMIT = 1e-2  # pointmaps_abs_rel of the GT-exact fakes
GT_RAY_LIMIT_DEG = 1e-2
VGGT_WIDTH = dict(dim=1024, heads=16, pairs=2)  # VGGT-1B's attention width
VGGT_LAUNCHES = 2 * VGGT_WIDTH["pairs"]  # a frame and a global one a pair
VGGT_SHAPES = [  # 2 views at 518^2: 37 x 37 patches a frame, no extra token
    ("vggt_frame_518", (2, 1369, 16, 64), None),
    ("vggt_global_2view_518", (1, 2738, 16, 64), None),
]
PSEUDO_FRAMES, PSEUDO_SIZE = 4, (518, 392)
MODULE_ADAPTERS = ("vggt", "pi3", "moge")  # no host copy inside their call


def adapter_cases(FK, PA, GeometricInputConfig):
    """(name, views, build(device, batch)) of the nine adapters, each over
    its fake, on `device`, for that device's batch."""
    w, h = ADAPTER_SIZE

    def vggt():
        fake = FK.VGGTStandIn()
        fake.set_attn_impl("math")  # fp32: the flash kernel takes bf16 only
        return fake

    return [
        ("vggt", 2, lambda dev, b: PA.VGGTAdapter(vggt().to(dev))),
        ("pi3", 2, lambda dev, b: PA.Pi3Adapter(FK.Pi3StandIn().to(dev))),
        ("moge", 2, lambda dev, b: PA.MoGeAdapter(FK.MoGeStandIn().to(dev))),
        ("posed_depth", 3, lambda dev, b: PA.PosedDepthAdapter(
            FK.posed_depth_scene_fn(b), device=dev)),
        ("dust3r", 2, lambda dev, b: PA.DUSt3RAdapter(
            FK.aligning_scene_fn(b), device=dev)),
        ("mast3r", 2, lambda dev, b: PA.MASt3RAdapter(
            FK.posed_depth_scene_fn(b), device=dev)),
        ("must3r", 3, lambda dev, b: PA.MUSt3RAdapter(
            FK.must3r_scene_fn(b), device=dev)),
        ("pow3r", 2, lambda dev, b: PA.Pow3RAdapter(
            FK.pow3r_pair_fn(b)[0], geom_cfg=GeometricInputConfig(),
            device=dev)),
        ("anycalib", 2, lambda dev, b: PA.AnyCalibAdapter(
            FK.anycalib_calib_fn(h, w), device=dev)),
    ]


def gt_errors(torch, FK, name, preds, batch) -> dict:
    """The GT-exact fakes against the synthetic ground truth with the JAX
    tests' tolerances (tests/test_adapters.py): {what: max |got - want|
    over (atol + rtol |want|)}, at most 1 where within them."""
    import numpy as np

    gt = {k: v.double().cpu() for k, v in batch["gt"].items()}
    got = {k: v.double().cpu() for k, v in preds.items()}

    def err(a, b, rtol, atol):
        b = torch.as_tensor(b, dtype=torch.float64)
        return float(((a - b).abs() / (atol + rtol * b.abs())).max())

    if name in ("posed_depth", "mast3r"):
        return {"pts3d": err(got["pts3d"], gt["pts3d"], 2e-3, 2e-3),
                "cam_trans": err(got["cam_trans"], gt["camera_pose_trans"],
                                 0.0, 1e-4)}
    if name == "must3r":
        return {"depth_along_ray": err(got["depth_along_ray"],
                                       gt["depth_along_ray"], 1e-4, 1e-5)}
    if name == "pow3r":  # view 2's own points were given at 0.5 x scale
        _, w2c0, c2w = FK.pow3r_pair_fn(batch)
        w2c0 = w2c0.astype(np.float64)
        want = (np.einsum("bij,bhwj->bhwi", w2c0[:, :3, :3],
                          gt["pts3d"][:, 1].numpy())
                + w2c0[:, None, None, :3, 3])
        return {"pts3d_view2": err(got["pts3d"][:, 1], want, 5e-3, 5e-3),
                "cam_trans_view2": err(got["cam_trans"][:, 1],
                                       (w2c0 @ c2w[:, 1])[:, :3, 3], 0.0,
                                       1e-3)}
    if name == "anycalib":
        return {"rays": err(got["ray_directions"],
                            gt["ray_directions_cam"][:, :1], 1e-4, 1e-5)}
    return {}


def adapters_card_vs_cpu(torch, FK, PA, GeometricInputConfig):
    """17a: each adapter over its fake on the card and on the CPU, on the
    same inputs, under inference mode (as the harnesses call them): every
    key within ADAPTER_LIMIT rel-L2 (masks equal), on the card and finite;
    the GT-exact fakes within the JAX tests' tolerances; no device-to-host
    copy or host read inside a module adapter's call, some in each
    callable's (they take host arrays: 0 there would mean the counter sees
    nothing), perf/timing.py::host_transfers. Returns (readings, failure
    or None)."""
    from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
    from mapanything_tpu_torch.perf.timing import host_transfers

    w, h = ADAPTER_SIZE
    res = {}
    cases = adapter_cases(FK, PA, GeometricInputConfig)
    for i, (name, views, build) in enumerate(cases):
        t0 = time.perf_counter()
        card_b, cpu_b = (make_synthetic_batch(1, views, h, w, seed=170 + i,
                                              device=dev)
                         for dev in ("cuda", "cpu"))
        card_a, cpu_a = build("cuda", card_b), build("cpu", cpu_b)
        with torch.inference_mode():
            card = card_a(card_b["views"])
            cpu = cpu_a(cpu_b["views"])
            copies = host_transfers(lambda: card_a(card_b["views"]))
        r = {"copies": copies,
             "on_card": all(t.is_cuda for t in card.values()),
             "finite": all(bool(torch.isfinite(t).all())
                           for t in card.values() if t.is_floating_point()),
             "rel_l2": {key: (float(not torch.equal(val.cpu(), cpu[key]))
                              if val.dtype == torch.bool
                              else rel_l2(val.cpu(), cpu[key]))
                        for key, val in card.items()},
             "gt": gt_errors(torch, FK, name, card, card_b),
             "s": time.perf_counter() - t0}
        res[name] = r
        print(f"17a {name}: {json.dumps(r)}", flush=True)
        if not (r["on_card"] and r["finite"]
                and max(r["rel_l2"].values()) <= ADAPTER_LIMIT
                and all(e <= 1.0 for e in r["gt"].values())):
            return res, f"17a {name}: {r}"
        moved = copies["copies"] + copies["reads"]
        if (moved == 0) != (name in MODULE_ADAPTERS):
            return res, f"17a {name}: device-to-host transfers {copies}"
    return res, None


def adapter_harnesses(torch, FK, PA, GeometricInputConfig, folder):
    """17b: the unmodified harnesses on the card: the dense N-view benchmark
    over DUSt3R (the Adam-fitting aligner), MASt3R, MUSt3R, VGGT, Pi3 and
    MoGe, the calibration benchmark over AnyCalib, RMVD over MoGe. The
    GT-exact fakes score pointmaps_abs_rel < GT_DENSE_LIMIT and a ray error
    < GT_RAY_LIMIT_DEG; the others are finite. Returns (readings, failure
    or None)."""
    tests_on_path()
    from torch_eval_oracles import ListLoader

    from mapanything_tpu_torch.benchmarks.calibration import (
        run_calibration_benchmark,
    )
    from mapanything_tpu_torch.benchmarks.dense_n_view import (
        run_dense_n_view_benchmark,
    )
    from mapanything_tpu_torch.benchmarks.rmvd import (
        RMVDAdaptor,
        evaluate_mvs_depth,
    )
    from mapanything_tpu_torch.data.image import rgb
    from mapanything_tpu_torch.data.synthetic import make_synthetic_batch

    w, h = ADAPTER_SIZE
    batch = make_synthetic_batch(2, 2, h, w, seed=171, device="cuda")
    loader = ListLoader([{g: {k: v.cpu().numpy() for k, v in batch[g].items()}
                          for g in ("views", "gt")}])
    cases = {name: build for name, _, build in adapter_cases(
        FK, PA, GeometricInputConfig)}
    res, bad = {}, []
    for name in ("dust3r", "mast3r", "must3r", "vggt", "pi3", "moge"):
        t0 = time.perf_counter()
        s = run_dense_n_view_benchmark(
            cases[name]("cuda", batch), loader, None,
            output_json=os.path.join(folder, f"{name}.json"))
        res[f"dense_{name}"] = {"pointmaps_abs_rel": s["pointmaps_abs_rel"],
                                "num_sets": s["num_sets"],
                                "s": time.perf_counter() - t0}
        if not (s["num_sets"] == 2 and (
                math.isfinite(s["pointmaps_abs_rel"])
                if name in MODULE_ADAPTERS
                else s["pointmaps_abs_rel"] < GT_DENSE_LIMIT)):
            bad.append(f"dense {name}: {s}")
    t0 = time.perf_counter()
    s = run_calibration_benchmark(cases["anycalib"]("cuda", batch), loader,
                                  None, output_json=os.path.join(
                                      folder, "anycalib.json"))
    res["calibration_anycalib"] = {
        "ray_angular_error_deg_mean": s["ray_angular_error_deg_mean"],
        "num_images": s["num_images"], "s": time.perf_counter() - t0}
    if not (s["num_images"] == 2
            and s["ray_angular_error_deg_mean"] < GT_RAY_LIMIT_DEG):
        bad.append(f"calibration anycalib: {s}")
    t0 = time.perf_counter()
    rmvd = RMVDAdaptor(cases["moge"]("cuda", batch),
                       inference_conditioning="image",
                       evaluate_single_view=True)
    imgs01 = rgb(batch["views"]["img"][0].cpu().numpy())
    sample = {"images": [im.transpose(2, 0, 1)[None] for im in imgs01],
              "keyview_idx": 0,
              "gt_depth": batch["gt"]["pts3d_cam"][0, 0, ..., 2].cpu().numpy()}
    m = evaluate_mvs_depth(rmvd, [sample])
    res["rmvd_moge"] = {**m, "s": time.perf_counter() - t0}
    if not (m["num_samples"] == 1 and math.isfinite(m["depth_abs_rel"])):
        bad.append(f"rmvd moge: {m}")
    print(f"17b harnesses: {json.dumps(res)}", flush=True)
    return res, (f"17b: {bad}" if bad else None)


def vggt_stand_in(torch, fa, fp, F):
    """17c: VGGT's stand-in at VGGT-1B's attention width (tests/
    torch_adapter_fakes.py::VGGTStandIn: a 14 x 14 patch conv and 2 x (a
    frame Block, a global Block) of dim 1024, 16 heads of 64, bf16) through
    VGGTAdapter on 2 views at 518^2, under inference mode. The forward
    kernel against its plain version at its two shapes first (rows for the
    kernels' line); then one call: exactly VGGT_LAUNCHES forward launches,
    0 plain, probe and baseline; finite outputs of the contract's shapes;
    flash against math within ERR_LIMIT rel-L2 (pts3d, depth along the
    ray); no device-to-host copy or host read; its wall, device ms and
    busy share.
    Returns (kernel rows, the call's launches, readings, failure or
    None)."""
    tests_on_path()
    import torch_adapter_fakes as FK

    from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
    from mapanything_tpu_torch.models.adapters import VGGTAdapter
    from mapanything_tpu_torch.perf.timing import host_transfers

    rows = kernel_vs_plain(torch, fa, fp, F, VGGT_SHAPES, seed=1700,
                           baseline=False)
    for name, row in rows:
        row["at"] = name
        if not max(row["max_abs_err"], row["rel_l2"]) <= ERR_LIMIT:
            return rows, {}, {}, f"17c: kernel disagrees at {name}: {row}"
    t0 = time.perf_counter()
    fake = FK.VGGTStandIn(**VGGT_WIDTH, dtype=torch.bfloat16)
    adapter = VGGTAdapter(fake.cuda())
    res = {"build_s": time.perf_counter() - t0,
           "parameters_m": sum(p.numel() for p in fake.parameters()) / 1e6}
    views = make_synthetic_batch(1, 2, 518, 518, seed=172,
                                 device="cuda")["views"]

    def call():
        with torch.inference_mode():
            return adapter(views)

    fa.reset_launch_counts()
    preds = call()
    torch.cuda.synchronize()
    launched = launches_of(fa)
    bad = (expect_launches(fa, {"fwd": VGGT_LAUNCHES}, "17c")
           or untouched_baseline(fp))
    res["launches"] = launched
    shapes = {k: list(v.shape) for k, v in preds.items()}
    res["finite"] = all(bool(torch.isfinite(v).all()) for v in preds.values()
                        if v.is_floating_point())
    fake.set_attn_impl("math")
    ref = call()
    fake.set_attn_impl("auto")
    res["flash_vs_math"] = {k: rel_l2(preds[k].cpu(), ref[k].cpu())
                            for k in ("pts3d", "depth_along_ray")}
    res["copies"] = host_transfers(call)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    prof = profile_calls(torch, call, statistics.median(walls), 2,
                         match={"flash": "flash_fwd"})
    res["call"] = {key: prof[key] for key in (
        "wall_ms", "device_ms", "busy_share", "device_ops", "matched_ms",
        "not_measured") if key in prof}
    res["walls_ms"] = walls
    print(f"17c VGGT stand-in, 2 views at 518^2: {json.dumps(res)}",
          flush=True)
    if not bad and not (
            res["finite"] and shapes["pts3d"] == [1, 2, 518, 518, 3]
            and shapes["cam_quats"] == [1, 2, 4]
            and max(res["flash_vs_math"].values()) <= ERR_LIMIT
            and res["copies"] == {"copies": 0, "reads": 0}):
        bad = f"17c: {res} shapes {shapes}"
    del adapter, fake, preds, ref
    torch.cuda.empty_cache()
    return rows, launched, res, bad


def moge_labelling(torch, folder):
    """17d: convert_dataset.main on a raw 4-frame ScanNet++ v2 scene at
    518 x 392 (tests/torch_offline_scenes.py::write_scannetpp_raw) with
    --undistort (the labeller reads the undistorted images) and
    --pseudo-depth FILE, FILE a MoGe stand-in pickled whole (tests/
    torch_adapter_fakes.py::MoGeStandIn), no --device (the card). Gates:
    every frame's stored depth and mask bitwise what MoGeAdapter returned
    on the card (EXR holds fp32); the stage's wall. Returns (readings,
    failure or None)."""
    from unittest import mock

    import numpy as np

    tests_on_path()
    import torch_adapter_fakes as FK
    from torch_offline_scenes import room_cameras, write_scannetpp_raw

    from mapanything_tpu_torch import convert_dataset as CLI
    from mapanything_tpu_torch.data import pseudo_depth as PD
    from mapanything_tpu_torch.data.wai import load_frame, load_scene_meta
    from mapanything_tpu_torch.models.adapters import MoGeAdapter

    w, h = PSEUDO_SIZE
    raw = os.path.join(folder, "raw")
    write_scannetpp_raw(raw, "scene0",
                        room_cameras(PSEUDO_FRAMES, step=OFFLINE_YAW), w, h)
    ckpt = os.path.join(folder, "moge.pt")
    torch.save(FK.MoGeStandIn(), ckpt)
    outputs, walls = [], {}
    forward = MoGeAdapter.forward

    def recording(self, views, *args, **kw):
        out = forward(self, views, *args, **kw)
        outputs.append(out)
        return out

    t0 = time.perf_counter()
    with mock.patch.object(MoGeAdapter, "forward", recording), \
            stage_walls(torch, walls, [
                (PD, "run_pseudo_depth_stage", "pseudo_depth_stage_s")]):
        roots = CLI.main(["scannetppv2", raw, os.path.join(folder, "wai"),
                          "--undistort", "--pseudo-depth", ckpt])
    res = {"cli_s": time.perf_counter() - t0, **walls,
           "adapter_calls": len(outputs),
           "on_card": all(t.is_cuda for out in outputs for t in out.values())}
    z = np.concatenate([o["pts3d_cam"][0, ..., 2].cpu().numpy()
                        for o in outputs])
    z = np.where(np.isfinite(z) & (z > 0), z, 0.0)
    mask = np.concatenate([o["non_ambiguous_mask"][0].cpu().numpy()
                           for o in outputs])
    root = roots[0]
    meta = load_scene_meta(os.path.join(root, "scene_meta.json"))
    keys = ["pred_depth/moge2", "pred_mask/moge2"]
    same = []
    for i in range(len(meta["frames"])):
        got = load_frame(root, i, keys, scene_meta=meta)
        same.append(np.array_equal(got[keys[0]], z[i])
                    and np.array_equal(got[keys[1]], mask[i]))
    res.update(frames=len(meta["frames"]), stored_equal_outputs=all(same),
               image_shape=list(z.shape[1:]),
               mask_share=float(mask.mean()))
    print(f"17d MoGe labelling through convert_dataset: {json.dumps(res)}",
          flush=True)
    if not (res["frames"] == PSEUDO_FRAMES and res["on_card"]
            and res["stored_equal_outputs"] and res["adapter_calls"] == 1
            and res["image_shape"] == [h, w]):
        return res, f"17d: {res}"
    return res, None


def adapters_path(torch, fa, fp, F):
    """Phase 17. Returns (17c's kernel rows, the kernel counts of its main
    call, failure or None)."""
    tests_on_path()
    import torch_adapter_fakes as FK

    from mapanything_tpu_torch.models import GeometricInputConfig
    from mapanything_tpu_torch.models import adapters as PA

    walls = {}
    t0 = time.perf_counter()
    _, bad = adapters_card_vs_cpu(torch, FK, PA, GeometricInputConfig)
    walls["17a_s"] = time.perf_counter() - t0
    if bad:
        return [], [], bad
    with tempfile.TemporaryDirectory() as folder:
        t0 = time.perf_counter()
        _, bad = adapter_harnesses(torch, FK, PA, GeometricInputConfig,
                                   folder)
        walls["17b_s"] = time.perf_counter() - t0
        if bad:
            return [], [], bad
        t0 = time.perf_counter()
        rows, launched, _, bad = vggt_stand_in(torch, fa, fp, F)
        walls["17c_s"] = time.perf_counter() - t0
        if bad:
            return rows, [launched], bad
        t0 = time.perf_counter()
        _, bad = moge_labelling(torch, folder)
        walls["17d_s"] = time.perf_counter() - t0
    print(f"phase 17 walls: {json.dumps(walls)}", flush=True)
    return rows, [launched], bad


def timing(row):
    return {key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "mma_ms",
                                      "host_us") if key in row}


def kernels_summary(fp, attn, train_rows, ring_rows, merge, probe_rows,
                    phase_counts) -> list:
    """The kernels' JSON rows: each kernel at its main-path shape with its
    launches in phases 3-17 (phase_counts: the kernel counts each of those
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
    print(f"phase 1 (the build) took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # phase 2: the serving forward kernel
    t0 = time.perf_counter()
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

    print(f"phase 2 (the kernels against their plain versions) took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # phases 3-16 run the main path: no probe and no baseline launch
    fp.reset_probe_counts()

    # phase 3: serving at full width
    t0 = t3 = time.perf_counter()
    model = random_weights_model()
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
    with tempfile.TemporaryDirectory() as folder:
        views = load_images(write_images(folder, 2))
    reader, bad = trace_reader_check(torch, lambda: pipe.infer(views))
    print(f"trace reader, one 2-view infer: {json.dumps(reader)}",
          flush=True)
    if bad:
        return fail(bad)
    del views
    bad = untouched_baseline(fp)
    if bad:
        return fail(f"serving: {bad}")
    del model, pipe
    torch.cuda.empty_cache()
    print(f"phase 3 (serving) took {time.perf_counter() - t3:.1f} s",
          flush=True)

    # phase 4: training at full width
    t0 = t4 = time.perf_counter()
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
    print(f"phase 4 (training) took {time.perf_counter() - t4:.1f} s",
          flush=True)

    # phase 5: the ring slice at full width, on a group of this one process
    t5 = time.perf_counter()
    group = init_distributed()
    try:
        t0 = time.perf_counter()
        model = random_weights_model()
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
        print(f"phase 5 (the ring slice) took {time.perf_counter() - t5:.1f}"
              " s", flush=True)

        # phase 6: the view-sharded train step at full width, same group
        t6 = time.perf_counter()
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
        print(f"phase 6 (the view-sharded train step) took "
              f"{time.perf_counter() - t6:.1f} s", flush=True)
    finally:
        torch.distributed.destroy_process_group()

    # phase 7: the rest of the serving API at full width, phase 3's weights
    t7 = time.perf_counter()
    torch.cuda.empty_cache()
    model = random_weights_model()
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

    # phase 10: training from a WAI tree through the training CLI
    t10 = time.perf_counter()
    torch.cuda.empty_cache()
    loader_rows, val_rows, phase10_counts, bad = cli_training(torch, fa, fp,
                                                              F)
    if bad:
        return fail(f"phase 10: {bad}")
    print(f"phase 10 (the training CLI on a WAI tree) took "
          f"{time.perf_counter() - t10:.1f} s", flush=True)
    for kname, rows in loader_rows.items():
        train_rows[kname] += rows
    attn = attn + val_rows

    # phase 11: the demo path: the reference's checkpoint layout, both demos
    t11 = time.perf_counter()
    torch.cuda.empty_cache()
    demo_rows, phase11_counts, bad = demo_path(torch, fa, fp, F)
    if bad:
        return fail(f"phase 11: {bad}")
    print(f"phase 11 (the demos from a reference-layout snapshot) took "
          f"{time.perf_counter() - t11:.1f} s", flush=True)
    attn = attn + demo_rows

    # phase 12: the evaluation path: the benchmark CLIs, ModularDUSt3R-L
    t12 = time.perf_counter()
    torch.cuda.empty_cache()
    eval_rows, phase12_counts, bad = evaluation_path(torch, fa, fp, F)
    if bad:
        return fail(f"phase 12: {bad}")
    print(f"phase 12 (the benchmark CLIs and ModularDUSt3R-L) took "
          f"{time.perf_counter() - t12:.1f} s", flush=True)
    attn = attn + eval_rows

    # phase 13: the model variants at full width and depth
    t13 = time.perf_counter()
    torch.cuda.empty_cache()
    variant_rows, phase13_counts, bad = variants_path(torch, fa, fp, F,
                                                      load_images)
    if bad:
        return fail(f"phase 13: {bad}")
    print(f"phase 13 (the model variants) took "
          f"{time.perf_counter() - t13:.1f} s", flush=True)
    attn = attn + variant_rows

    # phase 14: the offline data-processing path
    t14 = time.perf_counter()
    torch.cuda.empty_cache()
    offline_rows, phase14_counts, bad = offline_path(torch, fa, fp, F)
    if bad:
        return fail(f"phase 14: {bad}")
    print(f"phase 14 (the offline data-processing path) took "
          f"{time.perf_counter() - t14:.1f} s", flush=True)
    attn = attn + offline_rows

    # phase 15: multi-GPU training: data and tensor parallelism
    t15 = time.perf_counter()
    torch.cuda.empty_cache()
    tp_rows, phase15_counts, bad = multi_gpu_training(torch, fa, fp, F)
    if bad:
        return fail(f"phase 15: {bad}")
    print(f"phase 15 (multi-GPU training) took "
          f"{time.perf_counter() - t15:.1f} s", flush=True)
    for kname, rows in tp_rows.items():
        train_rows[kname] += rows

    # phase 16: training the model variants and the other criteria
    t16 = time.perf_counter()
    torch.cuda.empty_cache()
    variant_train_rows, phase16_counts, bad = variant_training(torch, fa, fp,
                                                               F)
    if bad:
        return fail(f"phase 16: {bad}")
    print(f"phase 16 (training the variants and the other criteria) took "
          f"{time.perf_counter() - t16:.1f} s", flush=True)
    for kname, rows in variant_train_rows.items():
        train_rows[kname] += rows

    # phase 17: the external-model adapters over their interface fakes
    t17 = time.perf_counter()
    torch.cuda.empty_cache()
    adapter_rows, phase17_counts, bad = adapters_path(torch, fa, fp, F)
    if bad:
        return fail(f"phase 17: {bad}")
    print(f"phase 17 (the external-model adapters) took "
          f"{time.perf_counter() - t17:.1f} s", flush=True)
    attn = attn + adapter_rows

    phase_counts = [serving,
                    {key: train[f"{key}_launches"] for key in fa.KERNELS},
                    ring_res["kernel_counts"], block_res["kernel_counts"],
                    vs_train["launches"]] + (phase7_counts + phase8_counts
                                             + phase9_counts + phase10_counts
                                             + phase11_counts + phase12_counts
                                             + phase13_counts + phase14_counts
                                             + [dict.fromkeys(fa.KERNELS, 0)
                                                | c for c in phase15_counts]
                                             + phase16_counts
                                             + phase17_counts)
    kernels = kernels_summary(fp, attn, train_rows, ring_rows, merge,
                              probe_rows, phase_counts)
    print(f"torch.profiler in this script's own calls: "
          f"{TRACES['traces']} traces, {TRACES['s']:.1f} s in all, "
          f"{TRACES['read_s']:.1f} s of it reading them", flush=True)
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
