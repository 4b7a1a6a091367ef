"""Faults planted under the timed path, for the tests and for the readings
that a training cell's limits are set from (perfbench/control.py --fault):
each wraps the program's call."""

from __future__ import annotations

import torch


def altered_answer(call):
    """The last view's (or pair's) outputs replaced by the first's, where
    the call produces them."""
    def broken(inputs):
        out = call(inputs)
        if isinstance(out, list):  # infer: one dict per view
            return out[:-1] + [out[0]]
        return {k: torch.cat([t[:1], t[:-1]]) for k, t in out.items()}
    return broken


def half_batch(call):
    """A training step on the first half of the batch's rows: its loss and
    gradients the mean over that half."""
    def broken(batch):
        b = batch["gt"]["pts3d"].shape[0] // 2
        return call({part: {k: a[:b] for k, a in d.items()}
                     for part, d in batch.items()})
    return broken


FAULTS = {"altered_answer": altered_answer, "half_batch": half_batch}
