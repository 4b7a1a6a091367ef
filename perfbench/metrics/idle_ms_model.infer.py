"""idle_ms_model.infer: ms a call in which the card is idle while the
program is inside its model (every "model.*" span: the encoder, the
fusion, the trunk or decoder, the heads), in the traced stretch
(harness/spans.py): the host dispatching the forward slower than the
card runs it."""

from perfbench.harness.spans import idle_ms_under

SPANS = ("model.",)


def read(run):
    if run.trace is None:
        return None
    return idle_ms_under(run.trace, SPANS)
