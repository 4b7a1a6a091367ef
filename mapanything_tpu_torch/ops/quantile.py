"""Per-row quantile threshold by bisection on the value range.

Counterpart of mapanything_tpu/ops/quantile.py::quantile_threshold, with the
same iteration count so both packages return the same threshold: the
smallest t (within range / 2^iters) with count(x <= t) >= ceil(q * N).
"""

from __future__ import annotations

import math

import torch


def quantile_threshold(x: torch.Tensor, q: float, dim: int = -1,
                       iters: int = 30) -> torch.Tensor:
    x = x.movedim(dim, -1)
    k = max(int(math.ceil(q * x.shape[-1])), 1)
    lo = x.amin(dim=-1)
    hi = x.amax(dim=-1)
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        ge = (x <= mid[..., None]).sum(dim=-1) >= k
        lo = torch.where(ge, lo, mid)
        hi = torch.where(ge, mid, hi)
    return hi
