"""idle_ms_post.infer: ms a call in which the card is idle while the
program postprocesses an `infer` call (the span "infer.postprocess": the
derived fields, the masks, the views unstacked), in the traced stretch
(harness/spans.py)."""

from perfbench.harness.spans import idle_ms_under

SPANS = ("infer.postprocess",)


def read(run):
    if run.trace is None:
        return None
    return idle_ms_under(run.trace, SPANS)
