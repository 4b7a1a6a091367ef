"""View-sharded (sequence-parallel) training: the loss and the train step;
counterpart of mapanything_tpu/train/seq_parallel.py.

The VIEW axis of a batch is sharded over the ranks of a torch.distributed
process group. Each rank runs its V/p views through the model with the
trunk's global layers on the ring (``MapAnything.forward(views,
seq_group=group)``, ops/ring_attention.py), so activation and gradient
memory per card are O(V/p).

The released criterion reduces per-view means and sums them over the
views, so nearly every term is view-local and the total is a sum over
ranks of local view sums. Three quantities cross views:

  * the GT reference pose, that of global view 0, gathered from rank 0;
  * the joint avg-dis normalisation factors: masked distance sums reduced
    over the ranks;
  * the pairwise relative-pose arm (off in the released recipe): the
    per-view pose vectors are gathered and the term computed on every
    rank alike.

Each rank's loss is its SHARE of the total: its local view sums plus the
replicated terms (the metric-scale set, the pairwise arm) at 1/p, so that
the shares add up to the total. Every collective on a differentiated
quantity sums the cotangents over the ranks in its backward
(``ops/ring_attention.py::all_gather`` and ``::all_reduce``, the JAX
package's ``all_gather_grad_correct`` and ``psum_grad_correct``), so
backpropagating each rank's share and summing the parameter gradients over
the ranks gives the gradient of the total.

Parity with the unsharded ``overall_loss`` and ``make_train_step`` is held
in tests/test_torch_seq_parallel.py on CPU ranks over gloo, and on the
card by chip_smoke.py and parallel/ring_check.py.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..models import GeometricInputConfig, MapAnything
from ..parallel.distributed import all_reduce_grads
from .criteria import Reduction
from .losses import OverallLossConfig, overall_loss
from .step import TrainState, check_released_scene_rep, global_norm

def _view_details(red: Reduction, group) -> Dict[str, torch.Tensor]:
    """The terms the criterion recorded through `red` (this rank's views)
    as one entry per term of the total, the same on every rank:
    ``{term}_viewsum_local`` sums a term's per-view means over every rank's
    views (``pts3d_conf``, the excluded sets by their type, the plainly
    reduced sets, ``normal``, ``gradient_matching`` and ``mask_bce``,
    unweighted); the replicated terms are as every rank computed them
    (``scale_loss`` and, with the pairwise arm, ``pose_quats_sum`` and
    ``pose_trans_sum``)."""
    out = {}
    for name, (val, replicated) in red.recorded.items():
        if replicated:
            out["scale_loss" if name == "scale" else f"{name}_sum"] = val
        else:
            dist.all_reduce(val, group=group)
            out[f"{name}_viewsum_local"] = val
    return out


def view_sharded_overall_loss(
        gt: Dict[str, torch.Tensor], preds: Dict[str, torch.Tensor],
        cfg: OverallLossConfig = OverallLossConfig(), group=None):
    """train/losses.py::overall_loss with `gt` and `preds` holding this
    rank's views only ((B, V_local, ...); the per-sample entries and
    metric_scaling_factor replicated): the released criterion through its
    view-group reductions (criteria.Reduction(view_group=group)).

    Returns (total, details): `total` (no gradient) and the details are the
    same on every rank; ``details["_share"]`` is this rank's share of the
    total, the scalar to backpropagate. The details aggregate per term of
    the total (:func:`_view_details`).
    """
    red = Reduction(view_group=group, record=True)
    total, details = overall_loss(gt, preds, cfg, red)
    out = _view_details(red, group)
    out["total"] = total
    out["_share"] = details["_share"]
    return total, out


def shard_views(batch: Dict, group) -> tuple:
    """(local views, local GT) of this rank: its V/p consecutive views of
    every entry with a view axis (axis 1 of the entries with two or more
    dimensions: the images, the priors and their flags), the per-sample
    entries as they are."""
    p, rank = dist.get_world_size(group), dist.get_rank(group)
    v = batch["views"]["img"].shape[1]
    if v % p:
        raise ValueError(f"view count {v} must be a multiple of the group "
                         f"size {p}")
    lo, hi = rank * (v // p), (rank + 1) * (v // p)

    def local(entries):
        return {key: t[:, lo:hi] if t.dim() >= 2 else t
                for key, t in entries.items()}

    return local(batch["views"]), local(batch["gt"])


def make_view_sharded_train_step(
        model: MapAnything, geom_cfg: GeometricInputConfig,
        loss_cfg: OverallLossConfig = OverallLossConfig(),
        group=None) -> Callable:
    """Build train_step(state, batch, generator=None) -> (state, metrics)
    with the VIEW axis sharded over the ranks of `group`: make_train_step's
    semantics.

    Every rank holds the same model and optimizer state (a TrainState of
    train/step.py, its AdamW), the whole batch and a generator in the same
    state; it runs its V/p views (V a multiple of the group size) with
    their priors, backpropagates its share of the loss, sums the parameter
    gradients over the ranks and applies the same AdamW step, so the
    parameters stay identical. A stochastic `geom_cfg` draws the masks of
    all V views on every rank and keeps its own (draw_prior_masks), so the
    step computes what make_train_step computes with the same generator.
    metrics, the same on every rank: "loss", the details of
    :func:`view_sharded_overall_loss` and "grad_norm", the global norm
    before clipping. Runs where the model lives: the card, or the CPU with
    a gloo group.
    """

    # the JAX package's view-sharded step computes the released criterion
    # only (mapanything_tpu/train/seq_parallel.py:78-98), so it takes the
    # same scene representations as make_train_step, on the alternating
    # trunk (MapAnything.forward refuses a seq_group on any other)
    check_released_scene_rep(
        model, "the view-sharded step (the released criterion only, as the "
        "JAX package's)")
    if getattr(model, "tp_split", None):
        raise ValueError("a tensor-parallel model cannot train view-sharded: "
                         "tensor parallelism and the ring both use the "
                         "model axis")

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None):
        params = state.optimizer.params
        views, gt = shard_views(batch, group)
        for prm in params:
            prm.grad = None
        preds = model(views, geom_cfg, generator, seq_group=group)
        total, details = view_sharded_overall_loss(gt, preds, loss_cfg,
                                                   group)
        details.pop("_share").backward()
        grads = [torch.zeros_like(prm) if prm.grad is None else prm.grad
                 for prm in params]
        all_reduce_grads(grads, group)
        norm = global_norm(grads)
        metrics = {"loss": total, **details, "grad_norm": norm}
        state.apply_gradients(grads, norm)
        for prm in params:
            prm.grad = None  # free the gradients before the next forward
        return state, metrics

    return train_step


__all__ = [
    "make_view_sharded_train_step",
    "shard_views",
    "view_sharded_overall_loss",
]
