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
device ops and busy share from torch.profiler (:func:`read_trace`);
:func:`trace_kernel_counts` counts a trace's kernels by name, a graph's
replayed launches among them.

:func:`host_transfers` counts what a call moves from the card to the host,
at the ATen dispatcher.

:func:`span` marks a layer boundary of the program (the names in
:data:`SPANS`) on torch.profiler's timeline, the clock of the device
operations in the same trace; with no profiler running it costs one flag
read.

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


# The program's spans, one at each layer boundary; tools that read a trace
# find each layer's interval by these names.
SPANS = (
    # utils/inference.py::InferencePipeline.infer
    "infer.prepare",      # validate, preprocess, stack_views (the host stack
                          # and the copy to the device), the geometric
                          # config, the memory policy, the generator
    "infer.forward",      # the model, or view_sharded_forward: the model.*
                          # spans and what lies between them, such as the
                          # view-sharded path's gathers and collectives
    "infer.postprocess",  # postprocess_outputs and unstack_views
    # models/mapanything.py::MapAnything.forward
    "model.encoder",      # the image encoder (ModularDUSt3R's too)
    "model.fuse",         # fuse_geometric_priors, fusion_norm, the scale token
    "model.trunk",        # info_sharing, with its view-PE rows
    "model.dense_head",   # the hooks and the dense head, chunked or not
    "model.pose_scale",   # the scale and pose heads, scene_rep_outputs
    # models/modular_dust3r.py::ModularDUSt3R.forward
    "model.decoder",      # decoder_embed, both branches' blocks, dec_norm
    "model.heads",        # head1, head2 and the pointmap split
    # train/step.py: make_train_step, loss_and_grads, make_loss_fn; the
    # first four are the eager step's
    "train.forward",      # loss_fn: the model and the criterion
    "train.loss",         # overall_loss, inside train.forward
    "train.backward",     # .backward() (its launches run on autograd's
                          # thread), the gradient list, the all-reduce
    "train.optimizer",    # the global norm, the clip, AdamW, the gradients
                          # freed
    "train.graph",        # a replay of the captured step: the batch copied
                          # into the graph's inputs, the optimizer's scalars
                          # written, the replay, the metrics cloned; no
                          # train.forward, .loss, .backward or .optimizer
                          # span opens under it
)

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A torch.profiler range named `name` (one of :data:`SPANS`) while a
    profiler records; else one shared null context, so that a span costs
    one flag read when nothing records (record_function would cost ~10 µs
    even then)."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.autograd.profiler.record_function(name)


# utility ops the profiler's own reading drops (torch.autograd.profiler_util.
# _filter_name)
_FILTERED = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"))


def read_trace(prof) -> tuple:
    """({device op name: summed µs}, {host op name: summed self µs}, device
    ops) of a finished torch.profiler trace, from kineto's raw events: the
    profiler's own reading (`prof.events()`) builds a FunctionEvent for each
    event and their tree, seconds a trace at a train step's ~10k device and
    ~40k host events. The same numbers: device ops by their span, host ops'
    self time as the profiler nests them (each thread's synchronous CPU
    events by start, a child inside its parent's span; runtime calls on
    their launching op's thread). The device-side ranges of record_function
    spans (:func:`span`'s) and of collectives are no device ops: left out."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    device: dict[str, float] = {}
    host: dict[str, float] = {}
    n_ops = 0
    cpu = []  # [thread, start, end, name, correlation, linked]
    names: dict[str, str] = {}  # demangled, as the profiler names them
    for e in results.events():
        name = e.name()
        if name in _FILTERED or getattr(e, "is_hidden_event",
                                        lambda: False)():
            continue
        if name not in names:
            names[name] = torch._C._demangle(name) if len(name) > 1 else name
        name = names[name]
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(("nccl:", "gloo:")):
                continue  # a span's or a collective's range over its work
            key = name[:90]  # template instances that share a prefix add up
            device[key] = (device.get(key, 0.0)
                           + (e.end_ns() - e.start_ns()) / 1e3)
            n_ops += 1
        elif e.is_async() or e.start_thread_id() != e.end_thread_id():
            # outside the nesting: all of its span is its own
            key = name[:60]
            host[key] = host.get(key, 0.0) + (e.end_ns() - e.start_ns()) / 1e3
        else:
            cpu.append([e.start_thread_id(), e.start_ns(), e.end_ns(), name,
                        e.correlation_id(), e.linked_correlation_id()])
    frontend = {ev[4]: ev[0] for ev in cpu if ev[5] == 0}
    for ev in cpu:
        if ev[5] > 0 and ev[5] in frontend:
            ev[0] = frontend[ev[5]]
    cpu.sort(key=lambda ev: (ev[0], ev[1], -ev[2]))
    stack: list = []  # [end, name, self ns]
    thread = None

    def close(item):
        key = item[1][:60]
        host[key] = host.get(key, 0.0) + item[2] / 1e3

    for t, start, end, name, _, _ in cpu:
        if t != thread:
            while stack:
                close(stack.pop())
            thread = t
        while stack and (start >= stack[-1][0] or end > stack[-1][0]):
            close(stack.pop())
        if stack:
            stack[-1][2] -= end - start
        stack.append([end, name, end - start])
    while stack:
        close(stack.pop())
    return device, host, n_ops


def read_trace_events(prof) -> tuple:
    """read_trace's numbers from the profiler's own FunctionEvents (slow;
    the reference the raw reading is held to)."""
    from torch.autograd import DeviceType

    device: dict[str, float] = {}
    host: dict[str, float] = {}
    n_ops = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.is_user_annotation or e.name.startswith(("nccl:", "gloo:")):
                continue
            name = e.name[:90]
            device[name] = device.get(name, 0.0) + e.time_range.elapsed_us()
            n_ops += 1
        else:
            host[e.name[:60]] = (host.get(e.name[:60], 0.0)
                                 + e.self_cpu_time_total)
    return device, host, n_ops


def trace_kernel_counts(prof, names) -> dict:
    """{name: the device ops of a finished torch.profiler trace whose names
    hold `name`}: the launches that a CUDA graph's replay makes, which no
    host-side counter sees."""
    from torch.autograd import DeviceType

    found = dict.fromkeys(names, 0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            for name in names:
                found[name] += name in e.name()
    return found


def profile_calls(call, wall_ms: float, calls: int = 3, match=None) -> dict:
    """Device time per `call()` from torch.profiler (the sum of the device
    events of `calls` calls over `calls`), the device ops per call, the ten
    device ops that take the most time, the ten host ops that take the
    most host time of their own (self CPU ms per call), and the busy share:
    device time over `wall_ms`, the median wall time of the untraced calls;
    `read_s`, the host seconds from the end of the traced calls to the
    result (the profiler's stop and the reading of its trace, read_trace).
    With `match` ({key: substring}), also the device ms per call of the
    kernels whose names hold each substring. NCCL's kernels count in the
    device time; across cards they include the wait for the other ranks
    (`nccl_ms` says how much). A profiler that cannot trace the card
    returns {"not_measured": reason}."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    except RuntimeError as exc:  # a profiler without CUPTI access
        return {"not_measured": str(exc)[:200]}
    device, host, n_ops = read_trace(prof)
    by_name = {name: us / 1e3 / calls for name, us in device.items()}
    host = {name: us / 1e3 / calls for name, us in host.items()}
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:10]
    res = {"device_ms": total, "device_ops": n_ops / calls,
           "wall_ms": wall_ms, "busy_share": total / wall_ms,
           "nccl_ms": sum(ms for name, ms in by_name.items()
                          if name.startswith("ncclDevKernel")),
           "top_ops_ms": dict(top), "top_host_self_ms": dict(top_host)}
    if match:
        res["matched_ms"] = {key: sum(ms for name, ms in by_name.items()
                                      if sub in name)
                             for key, sub in match.items()}
    res["read_s"] = time.perf_counter() - t0
    return res


def host_transfers(call) -> dict:
    """What one `call()` moves from the card to the host, counted at the
    ATen dispatcher (a TorchDispatchMode sees every op that reaches it:
    `.cpu()` arrives as `to` under inference mode, as `_to_copy` outside
    it): "copies", the ops that take a CUDA tensor and return a host
    tensor (`to`, `_to_copy`, `copy_` into host memory), and "reads", the
    ops that hand the host a device value (`_local_scalar_dense`: .item(),
    bool(), float(); `equal`; `nonzero`, whose output size the host waits
    for)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    aten = torch.ops.aten
    reads = (aten._local_scalar_dense, aten.equal, aten.nonzero,
             aten.is_nonzero)
    counts = {"copies": 0, "reads": 0}

    def tensors(tree):
        return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(x.is_cuda for x in tensors((args, kwargs))):
                if func.overloadpacket in reads:
                    counts["reads"] += 1
                elif any(not x.is_cuda for x in tensors(out)):
                    counts["copies"] += 1
            return out

    with Count():
        call()
    return counts


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


__all__ = ["SPANS", "BlockTimeManager", "Timer", "block_timer",
           "default_manager", "device_ms", "events_ms", "host_us",
           "profile_calls", "span", "trace_kernel_counts"]
