"""Multi-process execution: the process group and view-sharded inference."""

from .distributed import (
    all_reduce_mean,
    barrier,
    init_distributed,
    is_main_process,
    spawn_cpu_ranks,
)
from .inference import view_sharded_forward

__all__ = [
    "all_reduce_mean",
    "barrier",
    "init_distributed",
    "is_main_process",
    "spawn_cpu_ranks",
    "view_sharded_forward",
]
