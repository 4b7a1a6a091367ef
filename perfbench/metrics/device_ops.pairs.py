"""device_ops.pairs: device operations (kernels, copies, fills) a call in
the traced stretch; a count that the host dispatches one by one."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return len(run.trace.device) / run.trace.calls
