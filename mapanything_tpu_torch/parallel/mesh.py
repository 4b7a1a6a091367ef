"""Data and tensor parallelism over torch.distributed; counterpart of
mapanything_tpu/parallel/mesh.py.

The JAX package lays its devices out as a ("data", "model") mesh and lets
XLA GSPMD insert the collectives. Here the mesh is a layout of the ranks of
a process group, `np.arange(world).reshape(n_data, n_model)` as JAX's
`make_mesh` reshapes its devices, and the collectives are written out:

  * "data": each rank of a data group holds its share of the batch's rows
    (`shard_batch`); the loss reduces over the group
    (train/criteria.py::Reduction) and the parameter gradients are summed
    over it (train/step.py);
  * "model": the ranks of a model group hold the same rows and split the
    encoder's and the trunk's `Attention` and `Mlp` layers between them by
    JAX's rules (`PARAM_RULES`): the fused qkv and fc1 on their output
    features, attn/proj and mlp/fc2 on their input features, the rest
    replicated. The fused qkv splits head-parallel: each rank takes its
    heads of each of q, k and v, since a contiguous slice of the (3 * dim)
    rows would give one rank all of q and half of k. The layers then sum
    their partial products over the group (nn/layers.py).

A parameter that JAX's regex shards but that is not one of such a pair (an
`fc1` of a head or of a prior encoder) is replicated here: GSPMD reshards
it wherever it is used, a hand-written split could not
(`param_split`, ROADMAP's pinned divergences).

`unshard_params` is the inverse of `shard_params`, for checkpoints in the
released (unsharded) layout.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..nn.layers import Attention, Mlp

# JAX's partition rules (mapanything_tpu/parallel/mesh.py:48-58): a regex on
# the "/"-joined flax path and the kernel's (in, out) axes over "model";
# first match wins, the rest replicated
PARAM_RULES: List[Tuple[str, tuple]] = [
    (r".*(qkv|fc1)/kernel$", (None, "model")),
    (r".*attn/proj/kernel$", ("model", None)),
    (r".*mlp/fc2/kernel$", ("model", None)),
    (r".*(qkv|fc1)/bias$", ("model",)),
]

_LIST_SCOPE = re.compile(r"^(blocks|layers|ref_layers)$")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) layout of a group's ranks: its
    data group (the ranks that share its model rank, over which the batch
    is split) and its model group (the ranks that share its rows, over
    which the layers are split); None where the axis has one rank."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: object = None
    model_group: object = None
    group: object = None  # every rank of the mesh

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              group=None) -> Mesh:
    """The ("data", "model") layout of `group`'s ranks (the default group
    when None): rank i of the group sits at (i // n_model, i % n_model).
    Every rank of `group` calls it; each creates its own two subgroups."""
    group = dist.group.WORLD if group is None else group
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the "
                         f"group's {world} ranks")
    ranks = np.asarray(dist.get_process_group_ranks(group)).reshape(
        n_data, n_model)
    d, m = divmod(rank, n_model)

    def subgroup(members):
        if len(members) == 1:
            return None
        return dist.new_group([int(r) for r in members],
                              use_local_synchronization=True)

    # the same creation order on every rank: data group, then model group
    return Mesh(n_data, n_model, d, m, subgroup(ranks[:, m]),
                subgroup(ranks[d]), group)


def jax_path(name: str) -> str:
    """The flax path of a port parameter (utils/weights.py::_torch_key
    inverted for Dense layers): "encoder.blocks.0.attn.qkv.weight" ->
    "encoder/blocks_0/attn/qkv/kernel"."""
    parts = name.split(".")
    out = []
    for part in parts[:-1]:
        if part.isdigit() and out and _LIST_SCOPE.match(out[-1]):
            out[-1] = f"{out[-1]}_{part}"
        else:
            out.append(part)
    out.append({"weight": "kernel"}.get(parts[-1], parts[-1]))
    return "/".join(out)


def jax_rule(path: str) -> Optional[tuple]:
    """The spec of the first of PARAM_RULES that matches a flax path."""
    for pattern, spec in PARAM_RULES:
        if re.match(pattern, path):
            return spec
    return None


@dataclasses.dataclass(frozen=True)
class Split:
    """A parameter split over the model axis along torch dimension `dim`;
    `chunks` 3 for a fused qkv (each of q, k and v split alike, so a rank
    holds whole heads), else 1."""

    dim: int
    chunks: int = 1


def param_split(model: nn.Module, n_model: int) -> Dict[str, Split]:
    """{parameter name: Split} of every parameter sharded over `n_model`
    ranks: those that PARAM_RULES shard and that belong to an `Attention`
    (whole heads, num_heads divisible by n_model) or an `Mlp` (hidden
    features divisible by n_model). A kernel's (in, out) axes are torch's
    weight dims (1, 0)."""
    if n_model == 1:
        return {}
    splits = {}
    for mname, mod in model.named_modules():
        if isinstance(mod, Attention):
            if mod.num_heads % n_model:
                continue
            layers = {"qkv": 3, "proj": 1}
        elif isinstance(mod, Mlp):
            if mod.fc1.out_features % n_model:
                continue
            layers = {"fc1": 1, "fc2": 1}
        else:
            continue
        for lname, chunks in layers.items():
            for pname, p in getattr(mod, lname).named_parameters():
                name = f"{mname}.{lname}.{pname}" if mname else (
                    f"{lname}.{pname}")
                spec = jax_rule(jax_path(name))
                if spec is None or "model" not in spec:
                    continue
                axis = spec.index("model")
                dim = (1 - axis) if p.dim() == 2 else 0
                splits[name] = Split(dim, chunks)
    return splits


def shard(x: torch.Tensor, split: Split, rank: int, n: int) -> torch.Tensor:
    """Rank `rank`'s part of a full tensor."""
    return torch.cat([c.chunk(n, split.dim)[rank]
                      for c in x.chunk(split.chunks, split.dim)],
                     split.dim)


def unshard(parts, split: Split) -> torch.Tensor:
    """The full tensor from every rank's part, in rank order."""
    per = [p.chunk(split.chunks, split.dim) for p in parts]
    return torch.cat([torch.cat([pieces[c] for pieces in per], split.dim)
                      for c in range(split.chunks)], split.dim)


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's part of every parameter `param_split` shards (in
    place, the Parameter objects kept) and set the model group on those
    layers. Call it before the optimizer is made. The model records its
    splits and mesh as `model.tp_split` and `model.mesh`."""
    splits = param_split(model, mesh.n_model)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, split in splits.items():
            p = params[name]
            p.data = shard(p.data, split, mesh.model_rank,
                           mesh.n_model).clone()
    owners = {name.rsplit(".", 2)[0] for name in splits}
    for mname, mod in model.named_modules():
        if mname in owners:
            mod.tp_group = mesh.model_group
    model.tp_split = splits
    model.mesh = mesh
    return model


def gather_full(model: nn.Module, name: str, local: torch.Tensor
                ) -> torch.Tensor:
    """The full tensor of parameter `name` (or of a tensor shaped like its
    part, a gradient or a moment) from every model-group rank's part: one
    all_gather; the local tensor itself where the parameter is not
    split."""
    split = getattr(model, "tp_split", {}).get(name)
    if split is None:
        return local
    group = model.mesh.model_group
    parts = [torch.empty_like(local) for _ in range(model.mesh.n_model)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return unshard(parts, split)


def local_part(model: nn.Module, name: str, full: torch.Tensor
               ) -> torch.Tensor:
    """This rank's part of a full tensor of parameter `name`."""
    split = getattr(model, "tp_split", {}).get(name)
    if split is None:
        return full
    return shard(full, split, model.mesh.model_rank, model.mesh.n_model)


def unshard_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict in the released (unsharded) layout, on every
    rank of the model group (every rank joins the gathers)."""
    params = dict(model.named_parameters())
    return {key: gather_full(model, key, val) if key in params else val
            for key, val in model.state_dict().items()}


def shard_batch(batch, mesh: Mesh):
    """This data rank's rows of a batch: rows [d B / n, (d + 1) B / n) of
    every tensor of {"views": ..., "gt": ...} (or of a flat dict), the
    leading axis being the batch's."""
    def rows(t):
        b = t.shape[0]
        if b % mesh.n_data:
            raise ValueError(f"batch of {b} rows over {mesh.n_data} data "
                             "ranks")
        n = b // mesh.n_data
        return t[mesh.data_rank * n:(mesh.data_rank + 1) * n]

    return {key: shard_batch(val, mesh) if isinstance(val, dict) else
            rows(val) for key, val in batch.items()}


__all__ = [
    "Mesh",
    "PARAM_RULES",
    "Split",
    "gather_full",
    "jax_path",
    "jax_rule",
    "local_part",
    "make_mesh",
    "param_split",
    "shard",
    "shard_batch",
    "shard_params",
    "unshard",
    "unshard_params",
]
