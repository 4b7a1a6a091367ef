"""The card's idle time under the program's spans.

The program marks its layer boundaries with torch.profiler ranges
(mapanything_tpu_torch/perf/timing.py::SPANS). They are host events of
the traced stretch, on the clock of its device operations, so the idle
time that falls inside a layer's spans is an intersection of intervals:
no clock is aligned and no gap is put to one host operation. The names
are given here as the metric files give them, never read from the
program.
"""

from __future__ import annotations

from .trace import Trace


def _matches(name: str, names) -> bool:
    """`name` is one of `names`, or starts with one that ends in "."."""
    return any(name == n or (n.endswith(".") and name.startswith(n))
               for n in names)


def _union(intervals) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_ms_under(trace: Trace, names) -> float | None:
    """Ms a traced call in which the card is idle while a host event named
    in `names` is open ("model." stands for every name that starts so).
    The events' intervals are joined first, on every thread (a backward
    launches from autograd's thread while the calling thread waits in its
    span), so nested spans count once. None where no such span falls in
    the traced window."""
    w0, w1 = trace.window_ns
    under = _union((max(s, w0), min(e, w1)) for name, s, e, _ in trace.host
                   if e > w0 and s < w1 and _matches(name, names))
    if not under:
        return None
    busy = trace.busy_intervals()
    covered = sum(e - s for s, e in under)
    # the busy time inside the spans, both lists sorted and disjoint
    i = 0
    for s, e in under:
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            covered -= min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
    return covered / 1e6 / trace.calls
