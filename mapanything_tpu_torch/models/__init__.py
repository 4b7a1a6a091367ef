"""Models of the PyTorch port."""

from .mapanything import (
    GeometricInputConfig,
    MapAnything,
    MapAnythingConfig,
    images_only_config,
)

__all__ = [
    "GeometricInputConfig",
    "MapAnything",
    "MapAnythingConfig",
    "images_only_config",
]
