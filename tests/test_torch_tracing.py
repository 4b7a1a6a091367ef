"""The port's spans (perf/timing.py::span, SPANS): each layer boundary of
`infer`, ModularDUSt3R's forward and the training step records its span
once a call under torch.profiler, the model's spans nest inside the entry
that calls the model, and with no profiler running a span is one shared
null context that never builds a record_function. The span of a graph
replay ("train.graph") opens only on the card
(tests/test_torch_train_cuda.py); here the eager step never records it,
and perfbench's graph_replay_share.train reads it from a hand-made
trace."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.models import (
    MapAnything,
    MapAnythingConfig,
    ModularDUSt3R,
    ModularDUSt3RConfig,
    images_only_config,
)
from mapanything_tpu_torch.perf import timing
from mapanything_tpu_torch.train import step as PS
from mapanything_tpu_torch.utils.inference import InferencePipeline

# the tiny models of tests/test_torch_train.py and tests/test_torch_dust3r.py
SLICE_CFG = dict(encoder_size="test", trunk_dim=128, trunk_depth=4,
                 trunk_num_heads=2, trunk_indices=(1, 2), dpt_feature_dim=32,
                 dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
DUST3R_CFG = dict(encoder_size="test", patch_size=4, decoder_dim=64,
                  decoder_depth=2, decoder_num_heads=2)
H, W = 28, 42
CALLS = 2

MODEL = ("model.encoder", "model.fuse", "model.trunk", "model.dense_head",
         "model.pose_scale")
ROWS = {
    "infer": ("infer.prepare", "infer.forward", "infer.postprocess") + MODEL,
    "dust3r": ("model.encoder", "model.decoder", "model.heads"),
    "train": ("train.forward", "train.loss", "train.backward",
              "train.optimizer") + MODEL,
}
# the span each model span lies in, by entry
PARENT = {"infer": "infer.forward", "train": "train.forward"}
# the spans that open only on the card: a replay of the captured step
CARD_ONLY = ("train.graph",)


def _mapanything():
    torch.manual_seed(0)
    return MapAnything(MapAnythingConfig(dtype=torch.float32, **SLICE_CFG),
                       device="cpu")


def _infer_call():
    pipeline = InferencePipeline(_mapanything())
    rng = np.random.default_rng(0)
    views = [{"img": rng.standard_normal((1, H, W, 3), np.float32),
              "data_norm_type": "dinov2"} for _ in range(2)]
    return lambda: pipeline.infer(views)


def _dust3r_call():
    torch.manual_seed(0)
    model = ModularDUSt3R(ModularDUSt3RConfig(dtype=torch.float32,
                                              **DUST3R_CFG), device="cpu")
    img = torch.randn(1, 2, 16, 16, 3)

    def call():
        with torch.inference_mode():
            return model({"img": img})
    return call


def _train_call():
    model = _mapanything()
    state = PS.create_train_state(model, PS.OptimConfig())
    step = PS.make_train_step(model, images_only_config())
    batch = make_synthetic_batch(1, 2, H, W, seed=0, device="cpu")
    batch = {"views": {"img": batch["views"]["img"]}, "gt": batch["gt"]}
    return lambda: step(state, batch)


CALLERS = {"infer": _infer_call, "dust3r": _dust3r_call,
           "train": _train_call}


def _annotations(prof) -> list:
    """[(name, start_ns, end_ns)] of the trace's host user annotations."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and not e.is_async()]


@pytest.mark.parametrize("entry", sorted(ROWS))
def test_each_layer_records_its_span_once_a_call(entry):
    call = CALLERS[entry]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(CALLS):
            call()
    spans = _annotations(prof)
    names = [name for name, _, _ in spans]
    assert set(names) <= set(timing.SPANS)
    assert {name: names.count(name) for name in ROWS[entry]} == {
        name: CALLS for name in ROWS[entry]}
    assert set(names) == set(ROWS[entry])
    nests = {"train.loss": "train.forward"}
    if entry in PARENT:
        nests.update({name: PARENT[entry] for name in MODEL})
    for child, parent in nests.items():
        outer = [(s, e) for name, s, e in spans if name == parent]
        for name, s, e in spans:
            if name == child:
                assert any(s0 <= s and e <= e0 for s0, e0 in outer), child


def test_every_span_is_some_entry_row():
    assert set(timing.SPANS) == set().union(*ROWS.values(), CARD_ONLY)
    assert len(set(timing.SPANS)) == len(timing.SPANS)


def test_the_cpu_step_is_eager_and_counts_it():
    """Parameters on the CPU keep every step eager: no train.graph span, the
    step's counter all "eager"."""
    model = _mapanything()
    state = PS.create_train_state(model, PS.OptimConfig())
    step = PS.make_train_step(model, images_only_config())
    batch = make_synthetic_batch(1, 2, H, W, seed=0, device="cpu")
    batch = {"views": {"img": batch["views"]["img"]}, "gt": batch["gt"]}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(CALLS):
            step(state, batch)
    names = [name for name, _, _ in _annotations(prof)]
    assert "train.graph" not in names
    assert names.count("train.forward") == CALLS
    assert step.counts == {"captures": 0, "replays": 0, "eager": CALLS}


def _graph_share_reader():
    """perfbench/metrics/graph_replay_share.train.py, loaded by path as the
    benchmark's harness loads it."""
    path = (Path(__file__).resolve().parent.parent / "perfbench" / "metrics"
            / "graph_replay_share.train.py")
    spec = importlib.util.spec_from_file_location("graph_replay_share", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("spans, calls, want", [
    ([(10, 40), (50, 90)], 2, 100.0),   # one replay a call
    ([(10, 40)], 2, 50.0),              # one call eager
    ([(10, 40), (95, 120)], 2, 50.0),   # a replay past the window's end
    ([], 2, None),                      # every step eager: nothing to read
])
def test_graph_replay_share_reads_the_replays_of_the_window(spans, calls,
                                                            want):
    reader = _graph_share_reader()
    assert reader.SPAN == "train.graph" and reader.SPAN in timing.SPANS
    host = [("perfbench.call", 0, 45, 1), ("perfbench.call", 45, 100, 1),
            ("train.forward", 12, 20, 1)]
    host += [("train.graph", s, e, 1) for s, e in spans]
    trace = SimpleNamespace(window_ns=(0, 100), calls=calls, host=host)
    assert reader.read(SimpleNamespace(trace=trace)) == want
    assert reader.read(SimpleNamespace(trace=None)) is None


def test_span_off_is_the_shared_null_context(monkeypatch):
    built = []
    real = torch.autograd.profiler.record_function

    def counting(*args, **kwargs):
        built.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    assert not torch._C._autograd._profiler_enabled()
    first = timing.span("infer.prepare")
    assert first is timing.span("model.trunk")
    with first:
        with first:  # nests, as the model's spans do in the entry's
            pass
    _dust3r_call()()
    assert built == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing.span("model.heads") is not first
    assert built == [("model.heads",)]


class _KinetoEvent:
    """The part of a kineto event that perf/timing.py::read_trace reads."""

    def __init__(self, name, device, start, end, annotation=False, thread=1):
        self._v = (name, device, start, end, annotation, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def is_async(self):
        return False

    def start_thread_id(self):
        return self._v[5]

    end_thread_id = start_thread_id

    def correlation_id(self):
        return 0

    def linked_correlation_id(self):
        return 0


def test_read_trace_leaves_the_spans_device_ranges_out():
    """On the card, each span also has a range on the device's timeline
    over the kernels it launched: neither reader counts it as a device op,
    nor as device time."""
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    kineto = [  # (name, device, start ns, end ns, user annotation)
        ("model.trunk", cpu, 0, 9000, True),
        ("aten::mm", cpu, 1000, 3000, False),
        ("model.trunk", cuda, 2000, 8000, True),
        ("model.encoder", cuda, 2000, 8000, True),
        ("gemm_kernel", cuda, 2000, 5000, False),
        ("flash_kernel", cuda, 5000, 8000, False),
        ("nccl:all_reduce", cuda, 5000, 8000, False),
    ]
    events = [_KinetoEvent(*row) for row in kineto]
    prof = SimpleNamespace(
        profiler=SimpleNamespace(kineto_results=SimpleNamespace(
            events=lambda: events)),
        events=lambda: [SimpleNamespace(
            name=name, device_type=device, is_user_annotation=annotation,
            time_range=SimpleNamespace(elapsed_us=lambda s=s, e=e: (e - s)
                                       / 1e3),
            self_cpu_time_total=0.0)
            for name, device, s, e, annotation in kineto])
    for device, _, n_ops in (timing.read_trace(prof),
                             timing.read_trace_events(prof)):
        assert device == {"gemm_kernel": 3.0, "flash_kernel": 3.0}
        assert n_ops == 2
    host = timing.read_trace(prof)[1]
    assert host == {"model.trunk": 7.0, "aten::mm": 2.0}


def test_trace_kernel_counts_counts_the_device_kernels_by_name():
    """perf/timing.py::trace_kernel_counts, which counts a graph replay's
    training kernels on the card: device kernels whose names hold each
    name, not the spans' device ranges and not host ops of the same
    name."""
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    kineto = [  # (name, device, start ns, end ns, user annotation)
        ("train.graph", cpu, 0, 9000, True),
        ("train.graph", cuda, 100, 8000, True),
        ("flash_fwd_sm90_wrapper", cpu, 100, 200, False),
        ("void flash_fwd_sm90_kernel<Cfg<true>>", cuda, 200, 900, False),
        ("void flash_fwd_sm90_simple_kernel<Cfg<true>>", cuda, 900, 1300,
         False),
        ("void flash_bwd_dkv_sm90_kernel<float>", cuda, 1300, 2000, False),
        ("void flash_bwd_dq_sm90_kernel<float>", cuda, 2000, 2900, False),
        ("gemm_kernel", cuda, 2900, 4000, False),
    ]
    events = [_KinetoEvent(*row) for row in kineto]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    got = timing.trace_kernel_counts(
        prof, ("flash_fwd_sm90", "flash_bwd_dkv_sm90", "flash_bwd_dq_sm90",
               "train.graph"))
    assert got == {"flash_fwd_sm90": 2, "flash_bwd_dkv_sm90": 1,
                   "flash_bwd_dq_sm90": 1, "train.graph": 0}
    with profile(activities=[ProfilerActivity.CPU]) as real:
        torch.ones(3).sum()
    assert timing.trace_kernel_counts(real, ("sum",)) == {"sum": 0}
