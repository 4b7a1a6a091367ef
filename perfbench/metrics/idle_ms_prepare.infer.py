"""idle_ms_prepare.infer: ms a call in which the card is idle while the
program prepares an `infer` call (the span "infer.prepare": the views
validated and preprocessed, stacked on the host and copied to the card,
the memory policy), in the traced stretch (harness/spans.py)."""

from perfbench.harness.spans import idle_ms_under

SPANS = ("infer.prepare",)


def read(run):
    if run.trace is None:
        return None
    return idle_ms_under(run.trace, SPANS)
