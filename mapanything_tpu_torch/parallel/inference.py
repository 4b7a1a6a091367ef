"""Sequence-parallel (view-sharded) full-model inference; counterpart of
mapanything_tpu/parallel/inference.py.

The VIEW axis is sharded over the ranks of a process group. The encoder,
the frame layers and the heads are per view and run on each rank's views
unchanged; the trunk's global layers run ring attention and the scale token
stays replicated. Per-rank memory is O(V/p), so the view ceiling grows with
the number of cards. With geometric priors two more things cross views,
inside the model: the pose of global view 0 (gathered from rank 0) and the
mean translation norm (reduced over the ranks).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist


def view_sharded_forward(model, views: Dict[str, torch.Tensor], group,
                         geom_cfg=None,
                         generator: Optional[torch.Generator] = None,
                         memory_efficient: bool = False, chunking=None
                         ) -> Dict[str, torch.Tensor]:
    """`model(views, geom_cfg, generator)` with the views sharded over the
    ranks of `group`.

    Args:
        model: a MapAnything, the same weights on every rank.
        views: the stacked (B, V, ...) views, the same on every rank, with
            any priors and their `*_valid` flags; V must be a multiple of
            the group size (pad with duplicate views and slice the outputs
            if it is not).
        group: the torch.distributed process group of the ring.
        geom_cfg: a deterministic GeometricInputConfig (probabilities in
            {0, 1}; images only when None). A stochastic training mix
            raises ValueError, as in the JAX package.
        generator: the sparse presets' pixel draw, in the same state on
            every rank (each draws all V views' pixels and keeps its own).
        memory_efficient, chunking: as `MapAnything.forward`: chunk each
            rank's MLPs and dense head.

    Returns:
        The same dict as `model(views)`, on every rank: each rank runs its
        V/p views and every per-view output is all-gathered along V.
    """
    from ..models.mapanything import images_only_config

    geom_cfg = geom_cfg or images_only_config()
    if not geom_cfg.deterministic():
        raise ValueError(
            "view_sharded_forward takes a deterministic geom_cfg (0/1 "
            "probabilities); got a stochastic training mix")
    p = dist.get_world_size(group)
    v = views["img"].shape[1]
    if v % p:
        raise ValueError(
            f"view count {v} must be a multiple of the group size {p}; pad "
            f"with duplicate views and slice the outputs")
    lo = dist.get_rank(group) * (v // p)
    local = {key: t[:, lo:lo + v // p] if t.dim() >= 2 and t.shape[1] == v
             else t for key, t in views.items()}
    out = model(local, geom_cfg, generator, memory_efficient,
                seq_group=group, chunking=chunking)
    return {key: _gather_views(t, group) if t.dim() >= 2 else t
            for key, t in out.items()}


def _gather_views(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's (B, V/p, ...) -> (B, V, ...), in rank order."""
    send = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts, dim=1).to(t.dtype)
