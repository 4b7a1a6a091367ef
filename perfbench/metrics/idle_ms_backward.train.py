"""idle_ms_backward.train: ms a step in which the card is idle while the
training step runs its backward (the span "train.backward": autograd's
launches, the gradient list), in the traced stretch (harness/spans.py)."""

from perfbench.harness.spans import idle_ms_under

SPANS = ("train.backward",)


def read(run):
    if run.trace is None:
        return None
    return idle_ms_under(run.trace, SPANS)
