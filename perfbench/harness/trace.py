"""The traced stretch: torch.profiler over a few calls, read from kineto's
raw events.

The reading of the raw events is copied from
mapanything_tpu_torch/perf/timing.py::read_trace and frozen here (the
profiler's own `events()` builds a FunctionEvent tree, seconds a trace).
Unlike that function, it keeps each device operation's interval: the busy
time is the union of the intervals over the traced window, so operations
that overlap count once, and the window is the benchmark's own span
around the calls, on the trace's clock.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

WINDOW = "perfbench.window"
CALL = "perfbench.call"


@dataclasses.dataclass
class Trace:
    calls: int
    window_ns: tuple  # (start, end) of the benchmark's window span
    device: list  # [(name, start_ns, end_ns)] of every device operation
    host: list  # [(name, start_ns, end_ns, thread)] of the host operations

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals inside the window,
        sorted and disjoint."""
        w0, w1 = self.window_ns
        spans = sorted((max(s, w0), min(e, w1)) for _, s, e in self.device
                       if e > w0 and s < w1)
        merged: list = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_seconds(self, substring: str) -> float:
        """Summed device time of the operations whose name holds it."""
        return sum(e - s for name, s, e in self.device
                   if substring in name) / 1e9

    def top_device_ops(self, n: int = 10) -> list:
        by_name: dict = {}
        for name, s, e in self.device:
            key = name[:90]
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e9
        return sorted(([k, v] for k, v in by_name.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_by_host_op(self, n: int = 10) -> list:
        """The device's idle time in the window, each gap put to what the
        host was doing where it starts: of the innermost host operation
        open on each thread, the one that started last (the autograd
        engine's thread runs a backward's launches while the calling
        thread waits), summed by that operation's name."""
        w0, w1 = self.window_ns
        gaps, t = [], w0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < w1:
            gaps.append((t, w1))
        # one sweep a thread: host operations on one thread nest, so the
        # open ones form a stack whose top is the innermost
        threads: dict = {}
        for name, s, e, tid in self.host:
            threads.setdefault(tid, []).append((name, s, e))
        sweeps = [[sorted(evs, key=lambda ev: (ev[1], -ev[2])), 0, []]
                  for evs in threads.values()]
        by_name: dict = {}
        for g0, g1 in gaps:
            best = None
            for sweep in sweeps:
                evs, i, stack = sweep
                while i < len(evs) and evs[i][1] <= g0:
                    while stack and stack[-1][2] <= evs[i][1]:
                        stack.pop()
                    stack.append(evs[i])
                    i += 1
                sweep[1] = i
                while stack and stack[-1][2] <= g0:
                    stack.pop()
                if stack and (best is None or stack[-1][1] > best[1]):
                    best = stack[-1]
            key = best[0][:60] if best else "(no host op)"
            by_name[key] = by_name.get(key, 0.0) + (g1 - g0) / 1e9
        return sorted(([k, v] for k, v in by_name.items()),
                      key=lambda kv: -kv[1])[:n]


def _is_annotation(e) -> bool:
    probe = getattr(e, "is_user_annotation", None)
    return bool(probe()) if probe is not None else False


def traced(call, n_calls: int) -> Trace | None:
    """Run `call(i)` for i < n_calls under torch.profiler and read the
    trace. None where the profiler cannot trace the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                for i in range(n_calls):
                    with record_function(CALL):
                        call(i)
                torch.cuda.synchronize()
    except RuntimeError as exc:  # a profiler without CUPTI access
        print(f"perfbench: the profiler could not trace: {exc}",
              file=sys.stderr)
        return None
    device, host, window = [], [], None
    names: dict = {}  # demangled, as the profiler names them
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        if e.device_type() == DeviceType.CUDA:
            if (_is_annotation(e) or name.startswith(("perfbench.", "nccl:",
                                                      "gloo:"))):
                continue  # a span on the device's timeline, not an operation
            if name not in names:
                names[name] = (torch._C._demangle(name) if len(name) > 1
                               else name)
            device.append((names[name], e.start_ns(), e.end_ns()))
        elif not e.is_async():
            if name == WINDOW:
                window = (e.start_ns(), e.end_ns())
            host.append((name, e.start_ns(), e.end_ns(), e.start_thread_id()))
    if window is None:
        return None
    return Trace(n_calls, window, device, host)
