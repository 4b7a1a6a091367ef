"""mapanything_tpu_torch: the PyTorch/CUDA port of mapanything_tpu.

Images-only MapAnything inference (DINOv2-L encoder, alternating
frame/global trunk, DPT + pose + scale heads, factored geometry) and its
training step (the released loss, AdamW; train/) on an NVIDIA H100.
Attention runs forward and backward through hand-written CUDA
flash-attention kernels (csrc/flash_attn_fwd.cu, csrc/flash_attn_bwd.cu),
built with nvcc at first use; on CPU tensors every kernel runs its plain
PyTorch version. The JAX package
mapanything_tpu is the reference this port is tested against; this package
imports neither jax nor flax.
"""

from .models import (
    GeometricInputConfig,
    MapAnything,
    MapAnythingConfig,
    images_only_config,
)

__version__ = "0.1.0"

__all__ = [
    "GeometricInputConfig",
    "MapAnything",
    "MapAnythingConfig",
    "images_only_config",
]
