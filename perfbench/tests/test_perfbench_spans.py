"""harness/spans.py::idle_ms_under on hand-made traces: the card's idle
time inside the program's spans, exact to the nanosecond."""

from __future__ import annotations

import pytest

from . import tiny  # noqa: F401  (puts the checkout on sys.path)
from perfbench.harness import core
from perfbench.harness.spans import idle_ms_under
from perfbench.harness.trace import Trace

MS = 1_000_000  # ns


def _trace(host, device, window=(0, 100), calls=1):
    """Times in ms; host events on thread 1 unless they name one."""
    return Trace(calls, (window[0] * MS, window[1] * MS),
                 [("k", s * MS, e * MS) for s, e in device],
                 [(ev[0], ev[1] * MS, ev[2] * MS, ev[3] if len(ev) > 3 else 1)
                  for ev in host])


@pytest.mark.parametrize("span, device, want", [
    # the card idle in [20, 30) and [60, 100); the span [25, 70)
    ((25, 70), [(0, 20), (30, 60)], 5 + 10),
    # a gap inside the span
    ((10, 50), [(0, 20), (30, 60)], 10),
    # gaps outside the span only
    ((35, 55), [(0, 20), (30, 60)], 0),
    # a busy interval across both of the span's ends
    ((40, 50), [(30, 60)], 0),
    # the span running past the window, clipped to it
    ((90, 130), [(0, 95)], 5),
])
def test_idle_inside_across_and_outside_a_span(span, device, want):
    trace = _trace([("infer.prepare",) + span], device)
    assert idle_ms_under(trace, ("infer.prepare",)) == want


def test_nested_spans_count_once():
    host = [("infer.forward", 10, 90), ("model.encoder", 10, 40),
            ("model.trunk", 40, 80), ("aten::mm", 15, 16)]
    trace = _trace(host, [(20, 30), (50, 60)])
    # idle in [10, 20), [30, 50), [60, 80) under the model's spans
    assert idle_ms_under(trace, ("model.",)) == 10 + 20 + 20
    assert idle_ms_under(trace, ("infer.forward", "model.")) == 10 + 20 + 30
    assert idle_ms_under(trace, ("model.trunk",)) == 10 + 20


def test_a_span_on_a_second_thread():
    """The backward's launches run on autograd's thread while the calling
    thread waits inside its span: both threads' spans are joined by time."""
    host = [("train.backward", 0, 50, 1), ("train.backward", 40, 70, 2),
            ("aten::mm", 45, 46, 2)]
    trace = _trace(host, [(10, 20)], window=(0, 80), calls=2)
    assert idle_ms_under(trace, ("train.backward",)) == (70 - 10) / 2


def test_none_without_spans():
    host = [("perfbench.call", 0, 100), ("aten::mm", 5, 6),
            ("model.encoder", 120, 130)]  # after the window
    trace = _trace(host, [(0, 10)])
    assert idle_ms_under(trace, ("model.",)) is None
    assert idle_ms_under(trace, ("infer.prepare",)) is None


def test_prefix_only_where_the_name_ends_in_a_dot():
    trace = _trace([("model.encoder", 0, 10), ("modelx", 10, 20)], [])
    assert idle_ms_under(trace, ("model",)) is None
    assert idle_ms_under(trace, ("model.",)) == 10


@pytest.mark.parametrize("metric, names", [
    ("idle_ms_prepare.infer", ("infer.prepare",)),
    ("idle_ms_model.infer", ("model.",)),
    ("idle_ms_post.infer", ("infer.postprocess",)),
    ("idle_ms_forward.train", ("train.forward",)),
    ("idle_ms_backward.train", ("train.backward",)),
    ("idle_ms_optimizer.train", ("train.optimizer",)),
])
def test_the_metric_files_read_their_spans(metric, names):
    reader = core.load_reader(metric)
    assert reader.SPANS == names
    assert "mapanything_tpu_torch" not in (
        core.PERFBENCH / "metrics" / f"{metric}.py").read_text()

    class Run:
        trace = None
    assert reader.read(Run) is None
    name = names[0] + "encoder" if names[0].endswith(".") else names[0]
    Run.trace = _trace([(name, 0, 50)], [(0, 30)], calls=2)
    assert reader.read(Run) == 10
