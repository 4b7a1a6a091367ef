"""Check data and tensor parallelism across processes against one
process's step; the counterpart of __graft_entry__.py::dryrun_multichip:

    torchrun --nproc_per_node=N -m mapanything_tpu_torch.parallel.mesh_check \\
        [--tp 1,2]

For each T of `--tp` the N ranks form make_mesh(N / T, T)
(parallel/mesh.py). Every rank builds the released model (`--size test`
for a tiny one; `--trunk_depth D` cuts the released trunk to D layers,
its DPT taps at layers D / 2 - 1 and 3 D / 4 - 1 as the released 11 and
17 of 24) with the model's own seeded init, and the same synthetic
global batch of BATCH x VIEWS views (518^2; 56^2 at `--size test`). For
each of TASKS (its priors' config, models/tasks.py; the stochastic
`aug_training` draws its masks from a generator seeded alike everywhere):

  1. rank 0 alone takes the one-rank step on the whole batch (the
     reference, once for every mesh): its loss, grad_norm, gradients
     before the clip and updated parameters, kept on the host; then
     (first task) its wall, device and peak memory over `--steps` more
     steps;
  2. on each mesh every rank takes the mesh step (train/step.py) from
     the same weights on its rows: loss and grad_norm (relative, limit
     1e-2); every parameter's gradient before the clip, gathered over the
     model group: rel-L2 of all of them as one vector (limit 2e-2, the
     limit chip_smoke.py's phase 4 holds the gradient to) and of each
     parameter alone (limit 5e-2: a missing or doubled reduction moves a
     parameter's gradient by a large fraction, however small the
     parameter; in bf16 a parameter deep in the network reads more than
     the whole, the encoder's patch embedding 2.0e-2-2.2e-2 at TP 2 on
     the card, PERF.md); the updated parameters, gathered, as one vector
     (limit 2e-2), the worst single one printed with its name, not held:
     Adam's first step moves every element by about lr whatever its
     gradient's size, so an updated parameter initialised at 0, a bias,
     is all update and follows its gradient's rounding;
  3. each rank's kernel launches of the compared step and (first task)
     its wall over `--steps` more steps, device ms (torch.profiler) and
     its collectives' share (`nccl_ms`; gloo's run on the host and show in
     the wall only) and peak memory.

Rank 0 prints one JSON line (and writes it to `--out`); the exit code is 1
if a check failed. `--backend gloo` lets several processes share one card
(NCCL refuses two ranks on one device): chip_smoke.py's phase 15a runs it
so; across cards it runs under NCCL (phase 15c). With `--device cpu` the
group is gloo and the plain kernel twins run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch
import torch.distributed as dist

from ..data.synthetic import make_synthetic_batch
from ..models import MapAnything, MapAnythingConfig
from ..models.tasks import task_config
from ..ops.flash_attention import flash_attention, reset_launch_counts
from ..perf.timing import profile_calls
from ..train.losses import overall_loss
from ..train.step import (
    OptimConfig,
    create_train_state,
    global_norm,
    make_train_step,
)
from .distributed import init_distributed
from .mesh import gather_full, make_mesh, shard_batch, shard_params
from .ring_check import _TEST_CFG, _rel_l2, _sync

BATCH, VIEWS = 2, 4  # the global batch
TASKS = ("images_only", "aug_training")
ERR_LIMIT = 1e-2
GRAD_LIMIT = 2e-2  # all gradients as one vector
GRAD_EACH_LIMIT = 5e-2  # each parameter's gradient alone
PARAM_LIMIT = 2e-2  # the updated parameters as one vector
# the first step moves the weights: warmup 0, so it runs at the peak lr
OPTIM = OptimConfig(warmup_steps=0, total_steps=100)
SEED = 1  # the model's init, as chip_smoke.py's training phases
MASK_SEED = 8


def cut_trunk(depth) -> dict:
    """The config fields of a released trunk cut to `depth` layers ({} for
    None): the DPT taps where the released ones sit, half and three quarters
    of the way up."""
    if depth is None:
        return {}
    if depth < 4 or depth % 4:
        raise ValueError(f"--trunk_depth {depth}: a multiple of 4 from 4 on")
    return {"trunk_depth": depth,
            "trunk_indices": (depth // 2 - 1, 3 * depth // 4 - 1)}


def _generator(geom, device):
    if geom.deterministic() and geom.sparse_depth_prob == 0:
        return None
    return torch.Generator(device=device).manual_seed(MASK_SEED)


def _recording(state):
    """Wrap the optimizer's step to keep a copy of its first gradients
    (before the clip) in `state.grads`."""
    apply, state.grads = state.optimizer.step, None

    def step(grads, norm=None):
        if state.grads is None:
            state.grads = [g.detach().clone() for g in grads]
        return apply(grads, norm)

    state.optimizer.step = step


def _timed(step, state, batch, geom, device, steps) -> dict:
    """`steps` steps after the one already taken: median wall ms, the
    kernel launches of the last step (from the host: none where the step
    replays its CUDA graph), a profile of one more, peak memory; {} for
    none."""
    if not steps:
        return {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    walls, counts = [], {}

    def call():
        nonlocal state, counts
        reset_launch_counts()
        state, _ = step(state, batch, _generator(geom, device))
        counts = dict(flash_attention.kernel_counts,
                      plain=flash_attention.plain_launches)

    for _ in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        call()
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    res = {"step_ms": statistics.median(walls), "step_ms_all": walls,
           "launches": counts}
    if device.type == "cuda":
        res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res["profile"] = profile_calls(call, res["step_ms"], calls=1)
    return res


def _model(cfg, device):
    return MapAnything(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(SEED))


def reference(cfg, batch, geom, device, steps) -> dict:
    """Check 1 (rank 0): the one-rank step on the whole batch; tensors on
    the host."""
    model = _model(cfg, device)
    state = create_train_state(model, OPTIM)
    params = state.optimizer.params
    # the loss alone: a detail kept alive would hold the autograd graph,
    # and with it the accumulators the timed step's capture needs
    loss = overall_loss(batch["gt"], model(batch["views"], geom,
                                           _generator(geom, device)))[0]
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    norm = global_norm(grads)
    res = {"loss": float(loss.detach()), "grad_norm": float(norm),
           "grads": [g.detach().to("cpu", copy=True) for g in grads]}
    del loss
    state.apply_gradients(grads, norm)
    for p in params:
        p.grad = None
    res["params"] = [p.detach().to("cpu", copy=True) for p in params]
    res["timing"] = _timed(make_train_step(model, geom), state, batch, geom,
                           device, steps)
    return res


def _compare(model, names, local, ref, is_main) -> dict:
    """Per-parameter rel-L2 of the gathered `local` tensors (this rank's
    parts) against the reference's (on rank 0): the worst, its name, and
    the rel-L2 of all of them as one vector."""
    worst, worst_name, num, den = 0.0, None, 0.0, 0.0
    for i, name in enumerate(names):
        full = gather_full(model, name, local[i])
        if not is_main:
            continue
        want = ref[i].to(full.device)
        err = _rel_l2(full, want)
        num += float((full.double() - want.double()).norm()) ** 2
        den += float(want.double().norm()) ** 2
        if err > worst:
            worst, worst_name = err, name
    if not is_main:
        return {}
    return {"worst_rel_l2": worst, "worst_name": worst_name,
            "rel_l2": (num / max(den, 1e-60)) ** 0.5}


def mesh_step(cfg, global_batch, geom, mesh, device, ref, steps) -> dict:
    """Checks 2-3 on this rank (the timing where `steps`); the comparisons
    on rank 0."""
    is_main = dist.get_rank(mesh.group) == 0
    model = shard_params(_model(cfg, device), mesh)
    state = create_train_state(model, OPTIM)
    names, params = state.optimizer.names, state.optimizer.params
    batch = shard_batch(global_batch, mesh)
    _recording(state)
    step = make_train_step(model, geom, mesh=mesh)
    reset_launch_counts()
    state, metrics = step(state, batch, _generator(geom, device))
    res = {"launches": dict(flash_attention.kernel_counts,
                            plain=flash_attention.plain_launches)}
    loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
    res["grads"] = _compare(model, names, state.grads, ref["grads"],
                            is_main)
    res["params"] = _compare(model, names, [p.detach() for p in params],
                             ref["params"], is_main)
    state.grads = None
    if is_main:
        res.update(loss=loss, grad_norm=norm,
                   loss_rel_diff=abs(loss - ref["loss"]) / abs(ref["loss"]),
                   grad_norm_rel_diff=(abs(norm - ref["grad_norm"])
                                       / ref["grad_norm"]))
    res["timing"] = _timed(step, state, batch, geom, device, steps)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tp", default="1",
                        help="the model axis of each mesh, comma-separated")
    parser.add_argument("--size", choices=("released", "test"),
                        default="released")
    parser.add_argument("--trunk_depth", type=int, default=None,
                        help="cut the released trunk to this many layers")
    parser.add_argument("--steps", type=int, default=3,
                        help="timed steps after the compared one")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu (gloo)")
    parser.add_argument("--backend", default=None,
                        help="gloo: ranks that share one card")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    group = init_distributed(args.device, args.backend)
    device = (torch.device("cpu") if args.device == "cpu" else
              torch.device("cuda", torch.cuda.current_device()))
    try:
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        world = dist.get_world_size(group)
        tps = [int(tp) for tp in args.tp.split(",")]
        if any(world % tp for tp in tps):
            raise ValueError(f"--tp {args.tp} does not divide the world of "
                             f"{world}")
        # every rank makes every mesh's subgroups, in the same order
        meshes = [make_mesh(world // tp, tp, group=group) for tp in tps]
        test = args.size == "test"
        cfg = (MapAnythingConfig(dtype=torch.float32, **_TEST_CFG) if test
               else MapAnythingConfig(**cut_trunk(args.trunk_depth)))
        hw = 56 if test else 518
        batch = make_synthetic_batch(BATCH, VIEWS, hw, hw, seed=0,
                                     device=device)
        is_main = dist.get_rank(group) == 0
        res = {"backend": dist.get_backend(group), "ranks": world,
               "batch": BATCH, "views": VIEWS, "res": hw,
               "size": args.size, "trunk_depth": cfg.trunk_depth,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
               "meshes": [{"mesh": mesh.shape, "tasks": {}}
                          for mesh in meshes]}
        ok = True
        for i, task in enumerate(TASKS):
            geom = task_config(task)
            steps = args.steps if i == 0 else 0
            ref = {"grads": None, "params": None}
            if is_main:
                ref = reference(cfg, batch, geom, device, steps)
                if device.type == "cuda":
                    torch.cuda.empty_cache()
            dist.barrier(group=group)
            for mesh, out in zip(meshes, res["meshes"]):
                mine = mesh_step(cfg, batch, geom, mesh, device, ref, steps)
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                per_rank = [None] * world
                dist.all_gather_object(
                    per_rank, {"timing": mine.pop("timing"),
                               "launches": mine.pop("launches")},
                    group=group)
                if not is_main:
                    continue
                entry = {"reference": {k: ref[k] for k in (
                    "loss", "grad_norm", "timing")},
                         "vs_reference": mine, "ranks": per_rank}
                entry["ok"] = (
                    mine["loss_rel_diff"] <= ERR_LIMIT
                    and mine["grad_norm_rel_diff"] <= ERR_LIMIT
                    and mine["grads"]["rel_l2"] <= GRAD_LIMIT
                    and mine["grads"]["worst_rel_l2"] <= GRAD_EACH_LIMIT
                    and mine["params"]["rel_l2"] <= PARAM_LIMIT)
                ok &= entry["ok"]
                out["tasks"][task] = entry
            del ref
        res["ok"] = ok
        flag = [ok]
        dist.broadcast_object_list(flag, src=0, group=group)
        if is_main:
            line = json.dumps(res)
            print(line, flush=True)
            if args.out:
                with open(args.out, "w") as f:
                    f.write(line + "\n")
        return 0 if flag[0] else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
