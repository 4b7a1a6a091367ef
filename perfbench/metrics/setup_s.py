"""setup_s: seconds from the process's start to the window's first call:
imports, the kernels loaded (built by nvcc on a checkout's first run),
weights made on the card from the seed, the input pool, and the
traffic's warm-up calls."""


def read(run):
    return run.setup_s
