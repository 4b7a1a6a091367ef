"""Process-group bootstrap and cross-process reductions; counterpart of
mapanything_tpu/parallel/distributed.py.

Under torchrun (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` set) :func:`init_distributed` joins the job's group; with
none of them set it makes a group of this one process over an in-memory
store, so that a single-card run drives the same code as a multi-card one.
The backend follows the device: NCCL for CUDA, gloo for the CPU. A failed
NCCL init raises; nothing falls back to gloo. :func:`spawn_cpu_ranks` runs a
function on several CPU processes over gloo, the way the tests rehearse the
multi-card paths on one host.
"""

from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


def init_distributed(device=None, backend=None) -> dist.ProcessGroup:
    """Initialise the default process group once and return it.

    Args:
        device: "cuda" (the default; NCCL) or "cpu" (gloo). Under torchrun
            each process takes the card of its ``LOCAL_RANK``.
        backend: "gloo" on the card: processes that share one card (NCCL
            refuses two ranks on one device); gloo stages CUDA tensors
            through the host. The device's backend when None.
    """
    device = resolve_device(device)
    if dist.is_initialized():
        return dist.group.WORLD
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.group.WORLD


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every process of the default group (no-op alone)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _cpu_rank(rank, fn, world_size, init_file, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=120))
    try:
        fn(dist.group.WORLD, *args)
    finally:
        dist.destroy_process_group()


def spawn_cpu_ranks(fn, world_size: int, *args, timeout: float = 300.0):
    """Run `fn(group, *args)` in `world_size` fresh CPU processes joined by
    one gloo group: the multi-card paths rehearsed on one host. `fn` must
    be importable by name (a module-level function); the children import
    its module and torch, nothing of the caller's state. Raises if a
    process fails or `timeout` seconds pass."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _cpu_rank, args=(fn, world_size, os.path.join(tmp, "store"),
                             args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world_size} CPU ranks ran past {timeout} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join()


def all_reduce_mean(x: float, group=None) -> float:
    """Mean of a host scalar across the processes of `group` (the default
    group when None): the same value on every rank, for logging and for
    decisions every rank must take alike."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return float(x)
    device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([float(x)], dtype=torch.float64, device=device)
    dist.all_reduce(t, group=group)
    return float(t) / dist.get_world_size(group)


# gradients are summed over the ranks in flat buckets of this many elements
# (one all_reduce each)
GRAD_BUCKET = 1 << 26


def all_reduce_grads(grads, group) -> None:
    """Sum every rank's gradients in place, in flat buckets of about
    GRAD_BUCKET elements per dtype (one all_reduce each)."""
    bucket, size = [], 0

    def flush():
        if not bucket:
            return
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        torch._foreach_copy_(bucket, [
            piece.view_as(g) for piece, g in zip(
                flat.split([g.numel() for g in bucket]), bucket)])
        bucket.clear()

    for g in grads:
        if bucket and (size + g.numel() > GRAD_BUCKET
                       or g.dtype != bucket[0].dtype):
            flush()
            size = 0
        bucket.append(g)
        size += g.numel()
    flush()
