"""Check view-sharded inference and the ring block across processes against
the unsharded computation, one process per card:

    torchrun --nproc_per_node=N -m mapanything_tpu_torch.parallel.ring_check

Every rank builds the same model (the released config; `--size test` for a
tiny one) with the same weights, `--weights normal` (every parameter
N(0, 0.02^2) from a seeded numpy generator, as chip_smoke.py's phases 3
and 5) or `--weights init` (the model's own seeded init, LayerNorm and
LayerScale at 1, as phase 4), and the same synthetic views, then

  1. runs `InferencePipeline(model, view_shard_group=group).infer` and the
     unsharded `infer` of the same views, and compares pts3d and
     depth_along_ray (rel-L2), camera quaternions, translations and the
     metric scale (relative), limit 1e-2 each; beside them, not held to a
     limit, the same differences between the unsharded call with flash and
     with math attention: how far bf16-level changes of attention move
     this model's outputs. Times 5 calls of each after 2 warm-ups and
     counts the kernel launches of the timed sharded calls;
  2. takes the gradient of RingGlobalBlock over its shard of x plus the
     replicated token (loss sum(out_x^2) + sum(out_t^2) / N per rank,
     parameter and token gradients all-reduced) and compares every
     gradient with the plain Block's on the whole [x; tok], rel-L2 2e-2.

With `--check train` it runs the view-sharded train step instead
(train/seq_parallel.py), on the model's own seeded init (as chip_smoke.py's
phase 4) and a synthetic batch of 1 x `--views` views: for each ring size p
of 2 and the world size that divides it, the ranks split into groups of p
consecutive ranks, and on each rank

  3. train/grad_check.py::compare_sharded: the view-sharded loss and
     parameter gradient against the unsharded ones that this rank computes
     on its own card (loss relative, limit 1e-2; the gradient pulled back
     from the unsharded path's d loss / d predictions, rel-L2 limit 2e-2,
     beside its noise floor and the whole loss's gradient, not held to a
     limit); then the unsharded and the view-sharded step, 2 warm-up and
     3 timed steps each: wall ms per step, device ms per step and its
     NCCL share (torch.profiler), peak memory.

With `--task NAME` the views carry geometric priors: for `--check infer`
BASELINE config 3's (intrinsics, camera-to-world poses, the metric flag)
and every `infer` runs the preset NAME (a deterministic one, e.g.
pass_through); for `--check train` the batch's priors under the preset
NAME (e.g. aug_training), each step's masks drawn from a generator seeded
the same on every rank (check 3 then holds the view-sharded masks to the
unsharded ones as well).

Rank 0 prints one JSON line; the exit code is 1 if a check failed. With
`--device cpu` the group is gloo and the plain kernel twins run.
chip_smoke.py's phase 5 runs checks 1-2 on a one-process group, its phase
6 check 3.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data.synthetic import make_synthetic_batch
from ..geometry import pose_quats_trans_to_matrix
from ..models import MapAnything, MapAnythingConfig, images_only_config
from ..models.tasks import task_config
from ..nn.layers import Block, RingGlobalBlock, init_weights_
from ..ops.flash_attention import flash_attention, reset_launch_counts
from ..perf.timing import profile_calls
from ..train.grad_check import compare_sharded
from ..train.seq_parallel import make_view_sharded_train_step
from ..train.step import OptimConfig, create_train_state, make_train_step
from ..utils.inference import InferencePipeline
from ..utils.weights import random_normal_
from .distributed import init_distributed

ERR_LIMIT = 1e-2
GRAD_LIMIT = 2e-2
_TEST_CFG = dict(encoder_size="test", trunk_dim=64, trunk_depth=2,
                 trunk_num_heads=2, trunk_indices=(0, 1), dpt_feature_dim=32,
                 dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device, calls=5):
    for _ in range(2):
        fn()
    times = []
    for _ in range(calls):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def output_differences(got, ref, suffix="") -> dict:
    """pts3d and depth_along_ray rel-L2 (worst view), cameras and scale
    relative, between two `infer` results of the same views."""
    res = {}
    for key in ("pts3d", "depth_along_ray"):
        res[f"{key}_rel_l2{suffix}"] = max(_rel_l2(g[key], r[key])
                                           for g, r in zip(got, ref))
    for key in ("cam_quats", "cam_trans", "metric_scaling_factor"):
        res[f"{key}_rel{suffix}"] = _rel_l2(
            torch.stack([g[key] for g in got]),
            torch.stack([r[key] for r in ref]))
    return res


def _launches() -> dict:
    return {"kernel_counts": dict(flash_attention.kernel_counts),
            "plain_launches": flash_attention.plain_launches}


def config3_views(views, seed: int = 7):
    """BASELINE config 3's priors on `views` (one dict per view): intrinsics
    (focal 0.8-1.2 x the width, centred), a camera-to-world 4x4 from a
    seeded random unit quaternion and normal translation, the metric
    flag."""
    rng = np.random.default_rng(seed)
    out = []
    for view in views:
        h, w = view["img"].shape[1:3]
        f = rng.uniform(0.8, 1.2) * w
        k = np.array([[[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]], np.float32)
        quat = rng.standard_normal(4).astype(np.float32)
        pose = pose_quats_trans_to_matrix(
            torch.from_numpy(quat / np.linalg.norm(quat)),
            torch.from_numpy(rng.standard_normal(3).astype(np.float32)))
        out.append(dict(view, intrinsics=k, camera_poses=pose[None].numpy(),
                        is_metric_scale=True))
    return out


def check_inference(model, group, views, device, calls=5, task=None):
    """Returns (results, the last sharded `infer` output). The launch counts
    and the peak memory are those of the timed sharded calls: 2 warm-ups
    and `calls`, `forwards_counted` in all. Every call runs the preset
    `task` (infer's `task`)."""
    plain = InferencePipeline(model)
    sharded = InferencePipeline(model, view_shard_group=group)
    ref = plain.infer(views, apply_mask=False, task=task)
    res = output_differences(sharded.infer(views, apply_mask=False,
                                           task=task), ref)
    model.set_attn_impl("math")
    try:
        res.update(output_differences(plain.infer(views, apply_mask=False,
                                                  task=task),
                                       ref, "_math_vs_flash"))
    finally:
        model.set_attn_impl("auto")
    del ref
    res["unsharded_infer_ms"], res["unsharded_infer_ms_all"] = _timed(
        lambda: plain.infer(views, task=task), device, calls)
    last = [None]

    def call():
        last[0] = sharded.infer(views, task=task)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res["infer_ms"], res["infer_ms_all"] = _timed(call, device, calls)
    res.update(_launches(), forwards_counted=calls + 2)
    if device.type == "cuda":
        res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res, last[0]


def check_block_gradient(dim, heads, n, group, device, dtype) -> dict:
    """The launch counts are those of the ring block's forward and
    backward."""
    p, rank = dist.get_world_size(group), dist.get_rank(group)
    blk = Block(dim, heads, dtype=dtype, device=device)
    init_weights_(blk, torch.Generator(device=device).manual_seed(3))
    gen = torch.Generator(device=device).manual_seed(4)
    x0 = torch.randn((1, n, dim), generator=gen, device=device).to(dtype)
    t0 = torch.randn((1, 1, dim), generator=gen, device=device).to(dtype)

    def grads(loss_fn, x, tok):
        blk.zero_grad(set_to_none=True)
        x, tok = x.clone().requires_grad_(), tok.clone().requires_grad_()
        loss_fn(x, tok).backward()
        return x.grad, tok.grad, {name: prm.grad
                                  for name, prm in blk.named_parameters()}

    def ring_loss(x, tok):
        out_x, out_t = RingGlobalBlock(blk)(x, tok, group)
        return ((out_x.float() ** 2).sum()
                + (out_t.float() ** 2).sum() / p)

    def block_loss(x, tok):
        return (blk(torch.cat([x, tok], dim=1)).float() ** 2).sum()

    shard = slice(rank * n // p, (rank + 1) * n // p)
    reset_launch_counts()
    dx, dtok, dparams = grads(ring_loss, x0[:, shard], t0)
    launches = _launches()
    for g in [dtok, *dparams.values()]:
        dist.all_reduce(g, group=group)
    rx, rtok, rparams = grads(block_loss, x0, t0)
    errs = {"x": _rel_l2(dx, rx[:, shard]), "tok": _rel_l2(dtok, rtok)}
    errs.update({name: _rel_l2(dparams[name], rparams[name])
                 for name in rparams})
    return {"x": [1, n, dim], "grad_rel_l2": errs,
            "worst_grad_rel_l2": max(errs.values()), **launches}


def _timed_steps(step, model, batch, device, steps, seed=0) -> dict:
    """2 warm-up and `steps` timed calls of step(state, batch, generator)
    from a fresh TrainState, one generator seeded `seed` for all of them:
    wall ms per step, the launch counts of the last step (from the host:
    none where the unsharded step replays its CUDA graph), the losses, the
    peak memory and a profile of one more step."""
    state = create_train_state(model, OptimConfig(warmup_steps=2,
                                                  total_steps=100))
    generator = torch.Generator(device=device).manual_seed(seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses = []

    def call():
        nonlocal state
        reset_launch_counts()
        state, metrics = step(state, batch, generator)
        losses.append(float(metrics["loss"]))

    res = {}
    res["step_ms"], res["step_ms_all"] = _timed(call, device, steps)
    res.update(_launches(), loss=losses,
               finite=bool(np.isfinite(losses).all()))
    if device.type == "cuda":
        res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res["profile"] = profile_calls(call, res["step_ms"], calls=1,
                                       match={"pt_do": "pt_do_sm90"})
    return res


def check_train_step(model, batch, group, device, steps: int = 3,
                     geom_cfg=None) -> dict:
    """Check 3 on this rank: compare_sharded, then the unsharded and the
    view-sharded step timed (_timed_steps), the unsharded first. The
    weights move in the timed steps. `geom_cfg`: the priors' config
    (images only when None)."""
    res = {"ranks": dist.get_world_size(group),
           "views": batch["views"]["img"].shape[1],
           "vs_unsharded": compare_sharded(model, batch, group,
                                           geom_cfg=geom_cfg)}
    geom = geom_cfg or images_only_config()
    res["unsharded"] = _timed_steps(make_train_step(model, geom), model,
                                    batch, device, steps)
    res.update(_timed_steps(
        make_view_sharded_train_step(model, geom, group=group), model, batch,
        device, steps))
    return res


def _build_model(cfg, weights, device):
    if weights == "init":
        return MapAnything(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(1))
    return random_normal_(MapAnything(cfg, device=device))


def _main_train(args, group, device, cfg, hw, res) -> bool:
    """Check 3 at each ring size; every rank's results in res["train"]."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    ok = True
    res["train"] = {}
    for p in sorted({size for size in (2, world)
                     if size > 1 and world % size == 0}):
        # every rank makes every group, in the same order
        subs = [dist.new_group(list(range(lo, lo + p)))
                for lo in range(0, world, p)]
        model = _build_model(cfg, args.weights, device)
        batch = make_synthetic_batch(1, args.views, hw, hw, seed=0,
                                     device=device)
        mine = check_train_step(
            model, batch, subs[rank // p], device,
            geom_cfg=task_config(args.task) if args.task else None)
        del model, batch
        if device.type == "cuda":
            torch.cuda.empty_cache()
        per_rank = [None] * world
        dist.all_gather_object(per_rank, mine, group=group)
        res["train"][f"p{p}"] = per_rank
        for r in per_rank:
            cmp = r["vs_unsharded"]
            ok &= (r["finite"] and cmp["loss_rel_diff"] <= ERR_LIMIT
                   and cmp["grad_rel_l2"] <= GRAD_LIMIT)
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--views", type=int, default=8)
    parser.add_argument("--size", choices=("released", "test"),
                        default="released")
    parser.add_argument("--weights", choices=("normal", "init"),
                        default=None,
                        help="normal (the default of --check infer) or init "
                        "(of --check train)")
    parser.add_argument("--device", default=None,
                        help="cuda (default, NCCL) or cpu (gloo)")
    parser.add_argument("--check", choices=("infer", "train"),
                        default="infer",
                        help="infer: checks 1-2; train: check 3")
    parser.add_argument("--task", default=None,
                        help="a preset of models/tasks.py: infer with "
                        "config 3's priors, or train with the batch's")
    args = parser.parse_args(argv)
    if args.weights is None:
        args.weights = "init" if args.check == "train" else "normal"
    group = init_distributed(args.device)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    try:
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        test = args.size == "test"
        cfg = (MapAnythingConfig(dtype=torch.float32, **_TEST_CFG) if test
               else MapAnythingConfig())
        hw = 56 if test else 518
        if args.check == "train":
            res = {"check": "train", "ranks": dist.get_world_size(group),
                   "backend": dist.get_backend(group), "views": args.views,
                   "size": args.size, "weights": args.weights,
                   "task": args.task,
                   "device": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu")}
            ok = _main_train(args, group, device, cfg, hw, res)
            res["ok"] = ok
            if dist.get_rank(group) == 0:
                print(json.dumps(res), flush=True)
            return 0 if ok else 1
        model = _build_model(cfg, args.weights, device).eval()
        rng = np.random.default_rng(0)
        views = [{"img": (0.5 * rng.standard_normal((1, hw, hw, 3))).astype(
            np.float32), "data_norm_type": ["dinov2"]}
            for _ in range(args.views)]
        if args.task:
            views = config3_views(views)
        res = {"ranks": dist.get_world_size(group), "backend":
               dist.get_backend(group), "views": args.views, "size": args.size,
               "weights": args.weights, "task": args.task,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu")}
        res["inference"], _ = check_inference(model, group, views, device,
                                              task=args.task)
        del model
        patches = (hw // 14) ** 2
        dim, heads = (64, 2) if test else (1024, 16)
        res["block_gradient"] = check_block_gradient(
            dim, heads, args.views * patches, group, device, cfg.dtype)
        ok = (all(val <= ERR_LIMIT for key, val in res["inference"].items()
                  if key.endswith(("_rel_l2", "_rel")))
              and res["block_gradient"]["worst_grad_rel_l2"] <= GRAD_LIMIT)
        res["ok"] = ok
        if dist.get_rank(group) == 0:
            print(json.dumps(res), flush=True)
        return 0 if ok else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
