"""The training loop: epochs, evaluation, best and last checkpoints, resume
and the loss-explosion tripwire; counterpart of mapanything_tpu/train/
loop.py (SmoothedValue, MetricLogger, TrainLoopConfig, train,
train_one_epoch, test_one_epoch, _dump_explosion).

An epoch is one pass over the train loader. Before it, every `eval_freq`
epochs, each test loader is evaluated images-only and the median of their
median losses decides `checkpoint-best`; after it `checkpoint-last` is
written every `save_freq` epochs (train/checkpoints.py). With `resume`,
`train` continues from `checkpoint-last`.

Each epoch draws its steps' prior masks from one torch.Generator seeded
from (seed, epoch + 1) (`epoch_generator`, JAX's fold_in), not threaded
across epochs: a run killed in an epoch and resumed from `checkpoint-last`
replays that epoch as the uninterrupted run did, bit for bit on the CPU.

The tripwire checks every iteration's loss one step late: the loss and the
gradient norm of step i are copied to pinned host memory behind an event
as step i is issued, and read after step i + 1 is issued, waiting on that
event only. A non-finite loss, or one above `loss_explosion_thresh`, dumps
that step's batch and the (one step later) state and exits.

Loaders yield batches {"views": {...}, "gt": {...}} of numpy arrays or
tensors and have `set_epoch`, `__len__` and `__iter__`; batches move to
the model's device.

With a mesh (parallel/mesh.py; JAX's `train(mesh=)`), the parameters are
sharded before the optimizer is made and each rank's loader yields its
data rank's rows in lockstep with the other data ranks
(data/loader.py::get_train_data_loader(data_shard=)). The steps are
make_train_step's mesh steps; every rank evaluates the whole validation
set, the best-checkpoint decision is taken from the mean of every rank's
value so that all agree, checkpoints are written by one rank
(train/checkpoints.py) between barriers, and rank 0 alone prints and
writes the log.

`build_dataset_mix` evaluates the dataset-mix DSL of
the training CLI (train/__main__.py) over the WAI datasets of
data/wai_datasets.py, whose loaders (data/loader.py) feed `train`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from collections import defaultdict, deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models import (
    GeometricInputConfig,
    MapAnything,
    aug_training_config,
    images_only_config,
)
from ..parallel.distributed import all_reduce_mean
from ..parallel.mesh import shard_params
from ..utils.device import resolve_device, to_device
from .checkpoints import load_train_state, save_train_state
from .losses import OverallLossConfig, overall_loss
from .step import OptimConfig, create_train_state, make_train_step


class SmoothedValue:
    """Windowed and global average of a series (the reference's
    train_tools.py:34)."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


class MetricLogger:
    """Iteration logger with an ETA (the reference's train_tools.py:98)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for key, val in kwargs.items():
            if val is not None:
                self.meters[key].update(float(val))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}"
                                   for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = "",
                  printing: bool = True):
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        n = len(iterable) if hasattr(iterable, "__len__") else None
        end = time.time()
        for i, obj in enumerate(iterable):
            yield i, obj
            iter_time.update(time.time() - end)
            end = time.time()
            if printing and i % print_freq == 0:
                eta = ""
                if n:
                    secs = iter_time.avg * (n - i)
                    eta = f"eta: {int(secs // 60)}:{int(secs % 60):02d}"
                print(f"{header} [{i}{f'/{n}' if n else ''}] {eta} {self} "
                      f"time/it: {iter_time}")
        if printing:
            print(f"{header} done in {time.time() - start:.1f}s")


@dataclasses.dataclass
class TrainLoopConfig:
    output_dir: str = "./out"
    epochs: int = 10
    print_freq: int = 10
    save_freq: int = 1  # write checkpoint-last every N epochs
    keep_freq: int = 0  # also keep checkpoint-{epoch} every N epochs
    eval_freq: int = 1
    loss_explosion_thresh: float = 1000.0
    seed: int = 0
    resume: bool = True


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of epoch `epoch`'s steps on `device`, seeded from
    (seed, epoch + 1) alone."""
    words = np.random.SeedSequence([seed, epoch + 1]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        (int(words[0]) << 32) | int(words[1]))


class _HostCopy:
    """A tensor's value on the host, copied without waiting: into pinned
    memory behind an event from the card, a plain copy on the CPU."""

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _model_device(model: MapAnything, device) -> torch.device:
    device = resolve_device(device)
    have = next(model.parameters()).device
    if have.type != device.type:
        raise ValueError(f"the model lives on {have}, the loop was asked "
                         f"for {device}")
    return have


def _barrier(mesh) -> None:
    if mesh is not None:
        torch.distributed.barrier(group=mesh.group)


def train(model: MapAnything, train_loader, loop_cfg: TrainLoopConfig,
          optim_cfg: OptimConfig,
          geom_cfg: GeometricInputConfig = aug_training_config(),
          loss_cfg: OverallLossConfig = OverallLossConfig(),
          test_loaders: Optional[Dict[str, Any]] = None, device=None,
          mesh=None):
    """Run the loop of the module docstring on `model` (trained in place)
    and return the final TrainState.

    Args:
        device: where the model lives: the card when None (raises without
            one), "cpu" when asked; the model must already be there.
        mesh: a parallel/mesh.py::Mesh that every rank of it passes, each
            with its data rank's loader.
    """
    device = _model_device(model, device)
    main = mesh is None or torch.distributed.get_rank(mesh.group) == 0
    os.makedirs(loop_cfg.output_dir, exist_ok=True)
    log_path = os.path.join(loop_cfg.output_dir, "log.txt")
    if mesh is not None and getattr(model, "mesh", None) is None:
        shard_params(model, mesh)
    state = create_train_state(model, optim_cfg)

    best_so_far = None
    last_path = os.path.join(loop_cfg.output_dir, "checkpoint-last")
    start_epoch = 0
    if loop_cfg.resume and os.path.exists(last_path):
        state, best_so_far, ckpt_epoch = load_train_state(last_path, state)
        start_epoch = (ckpt_epoch if ckpt_epoch is not None
                       else state.step // max(1, len(train_loader)))
        if main:
            print(f"resumed from {last_path} at step {state.step} (epoch "
                  f"{start_epoch})")

    def save(path, epoch):
        _barrier(mesh)
        save_train_state(path, state, best_so_far, epoch=epoch)
        _barrier(mesh)

    train_step = make_train_step(model, geom_cfg, loss_cfg, mesh)
    for epoch in range(start_epoch, loop_cfg.epochs):
        if test_loaders and epoch % loop_cfg.eval_freq == 0:
            quiet = {} if main else {"printing": False}
            stats = [test_one_epoch(model, loader, loss_cfg, epoch, name,
                                    device, **quiet)
                     for name, loader in test_loaders.items()]
            median_val = float(np.median([s["loss_med"] for s in stats]))
            if mesh is not None:  # one decision, taken alike on every rank
                median_val = all_reduce_mean(median_val, mesh.group)
            if best_so_far is None or median_val < best_so_far:
                best_so_far = median_val
                save(os.path.join(loop_cfg.output_dir, "checkpoint-best"),
                     epoch)
                if main:
                    print(f"epoch {epoch}: new best val loss "
                          f"{best_so_far:.4f}")

        state, _ = train_one_epoch(
            model, state, train_step, train_loader, epoch, loop_cfg,
            epoch_generator(loop_cfg.seed, epoch, device), log_path, device,
            main)

        if (epoch + 1) % loop_cfg.save_freq == 0:
            save(last_path, epoch + 1)
        if loop_cfg.keep_freq and (epoch + 1) % loop_cfg.keep_freq == 0:
            save(os.path.join(loop_cfg.output_dir, f"checkpoint-{epoch}"),
                 epoch + 1)
    return state


def train_one_epoch(model, state, train_step, loader, epoch: int,
                    loop_cfg: TrainLoopConfig, generator, log_path: str,
                    device=None, main: bool = True):
    """One pass over `loader` with train_step(state, batch, generator);
    returns (state, generator). The tripwire of the module docstring runs
    on every iteration. Only the `main` rank prints and writes the log."""
    device = resolve_device(device)
    logger = MetricLogger()
    loader.set_epoch(epoch)
    n_steps = 0
    pending = None  # (host copy of [loss, grad_norm], batch, iter, views)

    def check(fetched, batch_i, idx, n_views_i):
        loss_i, norm_i = (float(x) for x in fetched.numpy())
        if not np.isfinite(loss_i) or loss_i > loop_cfg.loss_explosion_thresh:
            _dump_explosion(loop_cfg.output_dir, batch_i, state, loss_i,
                            epoch, idx)
        if idx % loop_cfg.print_freq == 0:
            logger.update(loss=loss_i, grad_norm=norm_i, n_views=n_views_i)

    for i, batch in logger.log_every(loader, loop_cfg.print_freq,
                                     header=f"Epoch [{epoch}]",
                                     printing=main):
        dbatch = to_device(batch, device)
        n_views = dbatch["views"]["img"].shape[1]
        state, metrics = train_step(state, dbatch, generator)
        fetched = _HostCopy(torch.stack([metrics["loss"].float(),
                                         metrics["grad_norm"].float()]))
        if pending is not None:
            check(*pending)
        pending = (fetched, batch, i, n_views)
        n_steps += 1
    if pending is not None:
        check(*pending)

    if not main:
        return state, generator
    # make_train_step's counter of graph captures, replays and eager steps
    counts = getattr(train_step, "counts", None)
    if counts is not None:
        print(f"Epoch [{epoch}] train step: {counts['captures']} captures, "
              f"{counts['replays']} replays, {counts['eager']} eager "
              "(since the step was made)")
    with open(log_path, "a") as f:
        f.write(json.dumps({
            "epoch": epoch,
            "train_loss_med": logger.meters["loss"].median,
            "train_loss_avg": logger.meters["loss"].global_avg,
            "steps": n_steps,
            **({} if counts is None else {"train_step": dict(counts)}),
        }) + "\n")
    return state, generator


def test_one_epoch(model, loader,
                   loss_cfg: OverallLossConfig = OverallLossConfig(),
                   epoch: int = 0, name: str = "val",
                   device=None, printing: bool = True) -> Dict[str, float]:
    """Validation on frozen samples (the loader at epoch 0), images only
    with every prior off, as the JAX loop; returns the median and mean
    loss."""
    device = resolve_device(device)
    loader.set_epoch(0)
    losses = []
    with torch.no_grad():
        for batch in loader:
            dbatch = to_device(batch, device)
            preds = model(dbatch["views"], images_only_config())
            losses.append(overall_loss(dbatch["gt"], preds, loss_cfg)[0])
    losses = [float(x) for x in losses]
    stats = {
        "loss_med": float(np.median(losses)) if losses else float("nan"),
        "loss_avg": float(np.mean(losses)) if losses else float("nan"),
    }
    if printing:
        print(f"[eval {name}] epoch {epoch}: median {stats['loss_med']:.4f} "
              f"avg {stats['loss_avg']:.4f} over {len(losses)} batches")
    return stats


def build_dataset_mix(spec: str, **context):
    """Evaluate a dataset-mix expression such as
    "100 @ WAIDataset(spec='eth3d', ...) + 50 @ WAIDataset(...)": the DSL
    of the reference's eval(dataset_str), over an explicit namespace of the
    dataset constructors and `context` alone (no builtins)."""
    from ..data.wai_datasets import WAIDataset, make_wai_dataset

    namespace = {"WAIDataset": WAIDataset, "make_wai_dataset": make_wai_dataset}
    namespace.update(context)
    return eval(spec, {"__builtins__": {}}, namespace)  # noqa: S307


def _dump_explosion(output_dir: str, batch, state, loss: float, epoch: int,
                    it: int):
    """Dump the batch of the exploded step and a checkpoint, then exit
    non-zero (the reference's training.py:480-509). The tripwire reads step
    i after step i + 1 was issued, so the checkpoint is one update past
    the dumped batch: replay from checkpoint-last for clean weights."""
    dump_dir = os.path.join(output_dir, "explosion_dump")
    os.makedirs(dump_dir, exist_ok=True)
    flat = {}
    for grp, tree in batch.items():
        for key, val in tree.items():
            flat[f"{grp}.{key}"] = (val.detach().cpu().numpy()
                                    if isinstance(val, torch.Tensor)
                                    else np.asarray(val))
    rank = (f"_rank{torch.distributed.get_rank()}"
            if torch.distributed.is_initialized() else "")
    np.savez(os.path.join(dump_dir, f"batch_e{epoch}_i{it}{rank}.npz"),
             **flat)
    save_train_state(os.path.join(dump_dir, "checkpoint-post-explosion"),
                     state)
    print(f"LOSS EXPLOSION ({loss}) at epoch {epoch} iter {it}; batch and "
          f"post-explosion checkpoint dumped to {dump_dir} (replay from "
          "checkpoint-last for clean weights)", file=sys.stderr)
    sys.exit(1)


__all__ = [
    "MetricLogger",
    "SmoothedValue",
    "TrainLoopConfig",
    "build_dataset_mix",
    "epoch_generator",
    "test_one_epoch",
    "to_device",
    "train",
    "train_one_epoch",
]
