"""views_per_s: every view the window reconstructed over the window's
seconds (a pair counts two views)."""


def read(run):
    return run.views_per_call * len(run.latencies) / run.window_s
