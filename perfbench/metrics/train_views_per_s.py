"""train_views_per_s: views of every training step completed in the window
(batch x views a step) over the window's seconds."""


def read(run):
    return run.views_per_call * len(run.latencies) / run.window_s
