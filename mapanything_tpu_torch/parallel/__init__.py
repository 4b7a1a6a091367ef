"""Multi-process execution: the process group, the (data, model) mesh of
data and tensor parallelism, and view-sharded inference."""

from .distributed import (
    all_reduce_mean,
    barrier,
    init_distributed,
    is_main_process,
    spawn_cpu_ranks,
)
from .inference import view_sharded_forward
from .mesh import (
    Mesh,
    make_mesh,
    shard_batch,
    shard_params,
    unshard_params,
)

__all__ = [
    "Mesh",
    "all_reduce_mean",
    "barrier",
    "init_distributed",
    "is_main_process",
    "make_mesh",
    "shard_batch",
    "shard_params",
    "spawn_cpu_ranks",
    "unshard_params",
    "view_sharded_forward",
]
