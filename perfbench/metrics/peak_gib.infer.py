"""peak_gib.infer: the card's allocated memory at its highest in the
untraced window (max_memory_allocated after a reset at its start)."""


def read(run):
    return run.peak_window_bytes / 2**30
