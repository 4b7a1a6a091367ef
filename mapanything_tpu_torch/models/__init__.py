"""Models of the PyTorch port."""

from .mapanything import (
    GeometricInputConfig,
    MapAnything,
    MapAnythingConfig,
    MemoryPolicy,
    aug_training_config,
    images_only_config,
    resolve_memory_policy,
)
from .tasks import TASK_NAMES, task_config

__all__ = [
    "GeometricInputConfig",
    "MapAnything",
    "MapAnythingConfig",
    "MemoryPolicy",
    "TASK_NAMES",
    "aug_training_config",
    "images_only_config",
    "resolve_memory_policy",
    "task_config",
]
