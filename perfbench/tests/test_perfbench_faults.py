"""A run with the timed path broken underneath comes out not correct,
under each cell's own limits; the same run unbroken comes out correct.
The program computes in float32 here, so that only the fault can fail
it at the tiny size. Inference cells: an answer altered where it is
produced. The training cell: a step that returns its state unchanged, and
a step on half of the batch (its loss the mean over that half)."""

from __future__ import annotations

from unittest import mock

import pytest

from . import tiny
from perfbench.harness import faults

INFER = [n for n in tiny.cells() if not n.endswith("train-2x4v")]
TRAIN = [n for n in tiny.cells() if n.endswith("train-2x4v")]


@pytest.mark.parametrize("name", INFER)
def test_an_altered_answer_is_not_correct(name):
    c = tiny.cell(name, "float32")
    assert tiny.run(c, 21)["correct"]
    assert not tiny.run(c, 21, wrap_call=faults.altered_answer)["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_on_half_the_batch_is_not_correct(name):
    c = tiny.cell(name, "float32")
    assert tiny.run(c, 22)["correct"]
    assert not tiny.run(c, 22, wrap_call=faults.half_batch)["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_its_state_unchanged_is_not_correct(name):
    from mapanything_tpu_torch.train.step import TrainState

    c = tiny.cell(name, "float32")
    with mock.patch.object(TrainState, "apply_gradients",
                           lambda self, grads, norm=None: self):
        assert not tiny.run(c, 23)["correct"]


@pytest.mark.parametrize("name", INFER)
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_the_fp8_control_is_not_correct(name, seed):
    """The control (the reference in float8 e4m3 in the program's place)
    fails the cell's limits."""
    from perfbench.harness import compare

    res = tiny.run(tiny.cell(name), seed, limits={}, control="fp8")
    ok, _ = compare.judge(res["control"], compare.load_limits(name))
    assert not ok


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_the_fp8_control_reads_far_above_the_program(name, seed):
    """The training cell's raw gaps scale with its size (the tiny model's
    median gradient gap sits under the full size's), so at this size the
    control is held to the program's own reading on the seed: three times
    it or more on the median first gradient. On the card, at the cell's
    size, the control fails the cell's limit (PERF.md)."""
    res = tiny.run(tiny.cell(name), seed, limits={}, control="fp8")
    assert res["control"]["grad"] >= 3 * res["checks"]["grad"]["value"]
