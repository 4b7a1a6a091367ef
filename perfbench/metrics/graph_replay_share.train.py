"""graph_replay_share.train: the share of the traced steps that replayed
the training step's CUDA graph: the spans "train.graph" in the traced
window over the traced calls. Nothing where the trace holds no such span
(a program that runs every step eagerly)."""

SPAN = "train.graph"


def read(run):
    if run.trace is None:
        return None
    w0, w1 = run.trace.window_ns
    replays = sum(1 for name, s, e, _ in run.trace.host
                  if name == SPAN and s >= w0 and e <= w1)
    if not replays:
        return None
    return 100.0 * replays / run.trace.calls
