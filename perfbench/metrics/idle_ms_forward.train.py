"""idle_ms_forward.train: ms a step in which the card is idle while the
training step runs its forward (the span "train.forward": the model and
the criterion), in the traced stretch (harness/spans.py)."""

from perfbench.harness.spans import idle_ms_under

SPANS = ("train.forward",)


def read(run):
    if run.trace is None:
        return None
    return idle_ms_under(run.trace, SPANS)
