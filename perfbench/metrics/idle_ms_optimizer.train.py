"""idle_ms_optimizer.train: ms a step in which the card is idle while the
training step runs its optimizer (the span "train.optimizer": the global
norm, the clip, AdamW, the gradients freed), in the traced stretch
(harness/spans.py)."""

from perfbench.harness.spans import idle_ms_under

SPANS = ("train.optimizer",)


def read(run):
    if run.trace is None:
        return None
    return idle_ms_under(run.trace, SPANS)
