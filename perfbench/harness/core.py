"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

Everything a cell is made of is found by name: BENCHMARK.json's workload
names a configuration (perfbench/configs/<config>.json, whose "family"
names perfbench/families/<family>.py and its reference), a traffic mix
(perfbench/traffic/<traffic>.json) and, through its metrics,
perfbench/metrics/<metric>.py; the limits of its check are in
perfbench/limits/<cell>.json. A new cell needs new files and entries,
never an edit.

A run (see `run`):
  1. set-up: the state dict made on the device from the seed
     (harness/weights.py), the program's model loaded from it, the input
     pool made on the host from the seed (harness/traffic.py), and the
     traffic's warm-up calls, which build or load every kernel and touch
     every shape. `setup_s` runs from the process's start to here.
  2. the window: calls back to back, each timed from its start to its
     outputs synchronised, until `seconds` have passed; the window's
     length runs from the first call's start to the last one's end. A few
     calls' outputs, drawn from the seed, are kept for the check.
  3. with --trace 1, a short traced stretch after the window
     (harness/trace.py).
  4. the program freed, the reference run on the kept calls' inputs, with
     a state dict made again from the seed, and every compared number
     judged against its limit (harness/compare.py). Where the family names
     a FLOOR_PRECISION, each number is the program's gap to the float32
     reference over the gap of the reference rounded to that precision:
     the gap in units of the call's own rounding floor.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Optional

import torch

from . import compare, traffic as traffic_mod, weights
from .trace import Trace, traced

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent
BENCHMARK = ROOT / "BENCHMARK.json"
# the least length of a --trace 1 run's traced stretch, in seconds (at
# least 3 calls)
TRACE_SECONDS = 2.0


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    family: ModuleType
    traffic: dict
    end_to_end: list  # BENCHMARK.json's metric entries that this cell reports
    per_layer: list


@dataclasses.dataclass
class Record:
    """What the metric readers read (perfbench/metrics/<name>.py)."""

    setup_s: float
    latencies: list  # seconds, every call of the window
    window_s: float
    views_per_call: int
    flops_per_call: int
    attention_calls: list  # [(b, nq, nk, heads, head_dim, count)] a call
    peak_window_bytes: int
    trace: Optional[Trace] = None


def load_benchmark() -> dict:
    return json.loads(BENCHMARK.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((ROOT / configs[work["config"]]["file"]).read_text())
    family = importlib.import_module(f"perfbench.families.{cfg['family']}")
    return Cell(name, work["chips"], work["config"], cfg, family,
                traffic_mod.load(work["traffic"]),
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def load_reader(metric: str) -> ModuleType:
    path = PERFBENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device: torch.device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t0: float, limits: Optional[dict] = None,
        wrap_call: Optional[Callable] = None,
        control: Optional[str] = None) -> dict:
    """One run; returns the result object (the line's keys, "checks"
    last). `limits` replaces the cell's limits file and `wrap_call`
    wraps the program's call (the tests' faults). With `control` (a
    precision of reference/common.py), the result's "control" holds the
    numbers of the reference at that precision put in the program's
    place, on the same calls' inputs (perfbench/control.py)."""
    device = torch.device(device)
    fam, cfg, tr = cell.family, cell.config, cell.traffic

    # 1. set-up
    spec = fam.spec(cfg)
    sd = weights.make_state_dict(spec, seed, device)
    model = fam.build(cfg, sd, device)
    del sd
    pool = traffic_mod.make_pool(tr, fam.IMAGE_MEAN, fam.IMAGE_STD, seed)
    inputs = [fam.host_inputs(images) for images in pool]
    base_call = fam.make_call(model, tr, seed)
    call = base_call if wrap_call is None else wrap_call(base_call)
    for k in range(tr["warmup"]):
        call(inputs[k % len(inputs)])
        _sync(device)
    setup_s = time.perf_counter() - t0
    setup_peak = _peak(device)

    # 2. the window
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    pick = random.Random(seed)
    samples: list = []  # (call index, outputs), a reservoir drawn by `pick`
    latencies = []
    start = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        out = call(inputs[i % len(inputs)])
        _sync(device)
        end = time.perf_counter()
        latencies.append(end - t)
        if len(samples) < tr["samples"]:
            samples.append((i, out))
        else:
            j = pick.randrange(i + 1)
            if j < tr["samples"]:
                samples[j] = (i, out)
        del out
        i += 1
        if end - start >= seconds:
            break
    window_s = end - start
    window_peak = _peak(device)

    # 3. the traced stretch
    trace_obj = None
    if trace:
        n = max(3, math.ceil(TRACE_SECONDS
                             / sorted(latencies)[len(latencies) // 2]))
        trace_obj = traced(lambda k: call(inputs[k % len(inputs)]), n)

    record = Record(setup_s, latencies, window_s, tr["batch"] * tr["views"],
                    fam.call_flops(cfg, tr), fam.attention_calls(cfg, tr),
                    window_peak, trace_obj)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # 4. the check, with the program freed
    steps = getattr(base_call, "record", None)  # a training step's first
    got = [] if steps is not None else [(k, fam.collect(o))
                                        for k, o in samples]
    del model, call, base_call, samples
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sd = weights.make_state_dict(spec, seed, device)
    t_ref = time.perf_counter()
    if steps is not None:
        readings, control_readings = fam.train_readings(
            steps, sd, cfg, tr, pool, seed, device, control)
    else:
        readings, control_readings = _call_readings(
            fam, got, sd, cfg, pool, device, control)
    _sync(device)
    print(f"perfbench: the check took {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    correct, checks = compare.judge(
        readings, compare.load_limits(cell.name) if limits is None else limits)

    result = {"correct": correct, "attempted": len(latencies), "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": cell.chips,
                         "memory_peak_bytes": max(setup_peak, window_peak)}}
    if trace_obj is not None:
        result["device"].update(busy_s=trace_obj.busy_s(),
                                window_s=trace_obj.window_s)
        result["breakdown"] = {"device_ops": trace_obj.top_device_ops(),
                               "idle_gaps": trace_obj.idle_by_host_op()}
    if control is not None:
        result["control"] = control_readings
    result["checks"] = checks
    return result


def _call_readings(fam, got, sd, cfg, pool, device, control):
    """The compared numbers of the kept calls (each number's worst), and
    the control's on the same inputs."""
    per_call, per_control = [], []
    floor_precision = getattr(fam, "FLOOR_PRECISION", None)
    for k, g in got:
        images = pool[k % len(pool)]
        ref = fam.run_reference(sd, cfg, images, device)
        floor = None
        if floor_precision is not None:
            floor = fam.numbers(fam.run_reference(sd, cfg, images, device,
                                                  floor_precision), ref)
        gaps = fam.numbers(g, ref)
        print(f"perfbench: call {k}: gaps {gaps} floor {floor}",
              file=sys.stderr)
        per_call.append(compare.over_floor(gaps, floor))
        if control is not None:
            per_control.append(compare.over_floor(fam.numbers(
                fam.run_reference(sd, cfg, images, device, control), ref),
                floor))
        del ref
    return (compare.worst(per_call),
            compare.worst(per_control) if per_control else None)
