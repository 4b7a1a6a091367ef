"""Checkpoints of the training state as torch files; counterpart of
mapanything_tpu/train/checkpoints.py (orbax there), with its API:

  * `save_train_state(path, state, best_so_far, epoch)` writes one file
    with the model's state dict, every AdamW tensor (the moments m and v,
    and with accumulation the running mean and its micro-step counter),
    the optimizer's step count, the train step, the number of completed
    epochs and the best validation loss;
  * `load_train_state(path, state)` restores all of it into `state` and
    returns (state, best_so_far or None, epoch or None);
  * `save_params` / `load_params` hold the model's parameters alone.

A file is written under a temporary name and moved into place with
`os.replace`, so a run killed while saving leaves the previous checkpoint
whole. Files load with `weights_only=True`, onto the model's device.

A model on a mesh (parallel/mesh.py) saves in the released, unsharded
layout: the ranks of data rank 0 gather the split parameters and their
moments over their model group, and its model rank 0 writes; every rank
of the mesh calls the save. A load reads the whole file and keeps each
rank's parts, so a tensor-parallel run's file loads into a one-card model
and back into a sharded one.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from ..parallel.mesh import gather_full, local_part, unshard_params


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _write(path: str, obj) -> None:
    path = _abs(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _gathers(model: nn.Module) -> bool:
    """Whether this rank joins the gathers of a save: every rank without a
    mesh, the ranks of data rank 0 with one."""
    mesh = getattr(model, "mesh", None)
    return mesh is None or mesh.data_rank == 0


def _writes(model: nn.Module) -> bool:
    mesh = getattr(model, "mesh", None)
    return mesh is None or (mesh.data_rank == 0 and mesh.model_rank == 0)


def _local_state(model: nn.Module, state):
    """A full state dict cut to this rank's parts."""
    return {key: local_part(model, key, val) for key, val in state.items()}


def save_params(path: str, model: nn.Module) -> None:
    """Write the model's state dict (unsharded)."""
    if _gathers(model):
        state = unshard_params(model)
        if _writes(model):
            _write(path, state)


def load_params(path: str, model: nn.Module) -> nn.Module:
    """Load a state dict written by save_params into `model` (strict)."""
    state = torch.load(_abs(path), map_location=_device_of(model),
                       weights_only=True)
    model.load_state_dict(_local_state(model, state))
    return model


def save_train_state(path: str, state, best_so_far: Optional[float] = None,
                     epoch: Optional[int] = None) -> None:
    """Write the whole training state (module docstring). `epoch` counts
    the COMPLETED epochs, so a resume starts at it."""
    opt, model = state.optimizer, state.model
    if not _gathers(model):
        return

    def full(tensors):
        return (None if tensors is None else
                [gather_full(model, n, t) for n, t in zip(opt.names,
                                                          tensors)])

    ckpt = {
        "model": unshard_params(model),
        "optimizer": {"names": list(opt.names), "mu": full(opt.mu),
                      "nu": full(opt.nu), "count": opt.count,
                      "mini_step": opt.mini_step, "acc": full(opt.acc)},
        "step": state.step,
        "best_so_far": None if best_so_far is None else float(best_so_far),
        "epoch": None if epoch is None else int(epoch),
    }
    if _writes(model):
        _write(path, ckpt)


def load_train_state(path: str, state):
    """Restore a file of save_train_state into `state` (its model and
    optimizer, in place); returns (state, best_so_far, epoch), each None
    where the file holds none. The optimizer must be the same (parameter
    names and accumulation)."""
    opt = state.optimizer
    ckpt = torch.load(_abs(path), map_location=_device_of(state.model),
                      weights_only=True)
    saved = ckpt["optimizer"]
    if saved["names"] != list(opt.names):
        raise ValueError(f"{path}: the optimizer's parameters differ from "
                         f"the model's")
    if (saved["acc"] is None) != (opt.acc is None):
        raise ValueError(f"{path}: saved with another accum_steps")
    model = state.model
    model.load_state_dict(_local_state(model, ckpt["model"]))

    def local(tensors):
        return [local_part(model, n, t) for n, t in zip(opt.names, tensors)]

    with torch.no_grad():
        torch._foreach_copy_(opt.mu, local(saved["mu"]))
        torch._foreach_copy_(opt.nu, local(saved["nu"]))
        if opt.acc is not None:
            torch._foreach_copy_(opt.acc, local(saved["acc"]))
    opt.count, opt.mini_step = saved["count"], saved["mini_step"]
    state.step = ckpt["step"]
    return state, ckpt["best_so_far"], ckpt["epoch"]


__all__ = ["load_params", "load_train_state", "save_params",
           "save_train_state"]
