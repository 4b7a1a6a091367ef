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
a run of calls instead.
"""

from __future__ import annotations

import time

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


__all__ = ["device_ms", "events_ms", "host_us"]
