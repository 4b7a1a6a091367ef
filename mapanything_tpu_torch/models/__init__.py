"""Models of the PyTorch port, and the registry the reference builds them
by (mapanything_tpu/models/__init__.py:17-30, 81-83)."""

from typing import Any, Dict

from torch import nn

from .adapters import (
    AnyCalibAdapter,
    DUSt3RAdapter,
    MASt3RAdapter,
    MoGeAdapter,
    MUSt3RAdapter,
    Pi3Adapter,
    PosedDepthAdapter,
    Pow3RAdapter,
    VGGTAdapter,
)
from .mapanything import (
    GeometricInputConfig,
    MapAnything,
    MapAnythingConfig,
    MemoryPolicy,
    aug_training_config,
    dense_dim_for,
    images_only_config,
    resolve_memory_policy,
)
from .modular_dust3r import ModularDUSt3R, ModularDUSt3RConfig
from .tasks import TASK_NAMES, task_config

MODEL_CONFIGS: Dict[str, Any] = {
    "mapanything": MapAnythingConfig,
    "modular_dust3r": ModularDUSt3RConfig,
}
_MODELS = {MapAnythingConfig: MapAnything, ModularDUSt3RConfig: ModularDUSt3R}


def model_factory(model_str: str = "mapanything", device=None, generator=None,
                  **overrides) -> nn.Module:
    """Build a model by name with config overrides (reference
    models/__init__.py:128), its parameters on `device` (the card when
    None), seeded from `generator` or left for weights to be loaded. The
    JAX package's factory builds a MapAnything around whatever config the
    name gives; here each name builds its own model."""
    if model_str not in MODEL_CONFIGS:
        raise ValueError(
            f"unknown model {model_str!r}; available: {sorted(MODEL_CONFIGS)}")
    cls = MODEL_CONFIGS[model_str]
    return _MODELS[cls](cls(**overrides), device=device, generator=generator)


def mapanything_ablations_config(**overrides) -> MapAnythingConfig:
    """The reference's MapAnythingAblations preset: no metric-scale token
    and RoPE2D at frequency 100 on the trunk's frame layers (the JAX
    package's mapanything_ablations_config)."""
    return MapAnythingConfig(**{"use_scale_token": False,
                                "trunk_rope_freq": 100.0, **overrides})


__all__ = [
    "AnyCalibAdapter",
    "DUSt3RAdapter",
    "GeometricInputConfig",
    "MODEL_CONFIGS",
    "MapAnything",
    "MapAnythingConfig",
    "MASt3RAdapter",
    "MUSt3RAdapter",
    "MemoryPolicy",
    "ModularDUSt3R",
    "ModularDUSt3RConfig",
    "MoGeAdapter",
    "Pi3Adapter",
    "PosedDepthAdapter",
    "Pow3RAdapter",
    "TASK_NAMES",
    "VGGTAdapter",
    "aug_training_config",
    "dense_dim_for",
    "images_only_config",
    "mapanything_ablations_config",
    "model_factory",
    "resolve_memory_policy",
    "task_config",
]
