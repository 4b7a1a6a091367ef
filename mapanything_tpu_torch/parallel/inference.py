"""Sequence-parallel (view-sharded) full-model inference; counterpart of
mapanything_tpu/parallel/inference.py.

The VIEW axis is sharded over the ranks of a process group. The encoder,
the frame layers and the heads are per view and run on each rank's views
unchanged; the trunk's global layers run ring attention and the scale token
stays replicated. Per-rank memory is O(V/p), so the view ceiling grows with
the number of cards. In images-only inference nothing else crosses views.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist


def view_sharded_forward(model, views: Dict[str, torch.Tensor], group,
                         memory_efficient: bool = False, chunking=None
                         ) -> Dict[str, torch.Tensor]:
    """`model(views)` with the views sharded over the ranks of `group`.

    Images only: the JAX function's `geom_cfg` waits for the priors on this
    path (ROADMAP queue A item 14); views with priors raise
    NotImplementedError in `MapAnything.forward`.

    Args:
        model: a MapAnything, the same weights on every rank.
        views: the stacked (B, V, ...) views, the same on every rank; V must
            be a multiple of the group size (pad with duplicate views and
            slice the outputs if it is not).
        group: the torch.distributed process group of the ring.
        memory_efficient, chunking: as `MapAnything.forward`: chunk each
            rank's MLPs and dense head.

    Returns:
        The same dict as `model(views)`, on every rank: each rank runs its
        V/p views and every per-view output is all-gathered along V.
    """
    p = dist.get_world_size(group)
    v = views["img"].shape[1]
    if v % p:
        raise ValueError(
            f"view count {v} must be a multiple of the group size {p}; pad "
            f"with duplicate views and slice the outputs")
    lo = dist.get_rank(group) * (v // p)
    local = {key: t[:, lo:lo + v // p] if t.dim() >= 2 and t.shape[1] == v
             else t for key, t in views.items()}
    out = model(local, seq_group=group, memory_efficient=memory_efficient,
                chunking=chunking)
    return {key: _gather_views(t, group) if t.dim() >= 2 else t
            for key, t in out.items()}


def _gather_views(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's (B, V/p, ...) -> (B, V, ...), in rank order."""
    send = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts, dim=1).to(t.dtype)
