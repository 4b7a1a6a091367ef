"""Device and host time of one GPU call.

:func:`device_ms` is the card's time per call: CUDA events around one
replay of a CUDA graph that holds `reps` back-to-back calls, captured
after warm-up, over `reps`. No host work (argument checks, allocation,
ctypes marshalling) enters it: the graph replays the launches alone.
:func:`host_us` is the caller's time per call on the host clock: `reps`
calls without a synchronise between them, then one synchronise outside
the clock. Python-side launch counters count the captured calls once, at
capture; counter checks belong to uncaptured calls. :func:`events_ms`
times calls that allocate gigabytes each (plain versions) by events around
a run of calls instead. :func:`profile_calls` reads a call's device time,
device ops and busy share from torch.profiler.

:class:`Timer`, :class:`BlockTimeManager` and :func:`block_timer` are the
host-side block timers of mapanything_tpu/utils/timing.py (the reference's
utils/timing.py): named wall-clock spans that accumulate their total and
count, summed in a manager (`default_manager` unless one is given).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms per call of `fn` (which launches work on the current
    stream), from a CUDA graph of `reps` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()  # the first replay uploads the graph
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def events_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Device ms per call from CUDA events around `reps` calls issued back
    to back (no synchronise between them), for calls that allocate too
    much to replay from a graph's private pool (the plain versions' score
    matrices) and whose device time dwarfs the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 20) -> float:
    """Host µs per call of `fn`: `reps` calls back to back on the host
    clock; the device work is synchronised after the clock stops."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def profile_calls(call, wall_ms: float, calls: int = 3, match=None) -> dict:
    """Device time per `call()` from torch.profiler (the sum of the device
    events of `calls` calls over `calls`), the device ops per call, the ten
    device ops that take the most time, the ten host ops that take the
    most host time of their own (self CPU ms per call), and the busy share:
    device time over `wall_ms`, the median wall time of the untraced calls.
    With
    `match` ({key: substring}), also the device ms per call of the kernels
    whose names hold each substring. NCCL's kernels count in the device
    time; across cards they include the wait for the other ranks
    (`nccl_ms` says how much). A profiler that cannot trace the card
    returns {"not_measured": reason}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
    except RuntimeError as exc:  # a profiler without CUPTI access
        return {"not_measured": str(exc)[:200]}
    by_name: dict[str, float] = {}
    host: dict[str, float] = {}
    n_ops = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("nccl:"):
                continue  # NCCL's annotation, spanning its own kernel
            name = e.name[:90]  # template instances that share a prefix add up
            by_name[name] = (by_name.get(name, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / calls)
            n_ops += 1
        else:
            host[e.name[:60]] = (host.get(e.name[:60], 0.0)
                                 + e.self_cpu_time_total / 1e3 / calls)
    device = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:10]
    res = {"device_ms": device, "device_ops": n_ops / calls,
           "wall_ms": wall_ms, "busy_share": device / wall_ms,
           "nccl_ms": sum(ms for name, ms in by_name.items()
                          if name.startswith("ncclDevKernel")),
           "top_ops_ms": dict(top), "top_host_self_ms": dict(top_host)}
    if match:
        res["matched_ms"] = {key: sum(ms for name, ms in by_name.items()
                                      if sub in name)
                             for key, sub in match.items()}
    return res


class Timer:
    """Accumulating wall-clock timer."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("Timer.stop() before start()")
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.count += 1
        self._t0 = None
        return dt

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)


class BlockTimeManager:
    """Named timers; prints as `name: avg ms(xcount)` per timer."""

    def __init__(self):
        self.timers: Dict[str, Timer] = defaultdict(Timer)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": t.total, "count": t.count, "avg_s": t.avg}
                for name, t in self.timers.items()}

    def __str__(self):
        return "  ".join(f"{k}: {v.avg * 1000:.1f}ms(x{v.count})"
                         for k, v in self.timers.items())


default_manager = BlockTimeManager()


@contextlib.contextmanager
def block_timer(name: str, manager: Optional[BlockTimeManager] = None,
                verbose: bool = False):
    """Time a host-side block into `manager`'s timer `name` (the default
    manager when None). Work queued on a device is not waited for."""
    mgr = manager or default_manager
    t = mgr.timers[name].start()
    try:
        yield t
    finally:
        dt = mgr.timers[name].stop()
        if verbose:
            print(f"[{name}] {dt * 1000:.2f} ms")


__all__ = ["BlockTimeManager", "Timer", "block_timer", "default_manager",
           "device_ms", "events_ms", "host_us", "profile_calls"]
