"""Loading a trained model for serving; counterpart of
mapanything_tpu/models/pretrained.py.

`from_pretrained` builds a `MapAnything` from the port's own checkpoint
files: a state dict written by `train/checkpoints.py::save_params`, or the
"model" entry of a `save_train_state` file (the trainer's checkpoint-best
and checkpoint-last). The file is memory-mapped on the host and only the
model's tensors are copied to the device: a full-width train state holds
the AdamW moments too (~7.3 GiB), which serving must not place on the card.

The reference's own checkpoint layout (an HF snapshot directory, or a
*.safetensors / *.pt file of the reference's state dict) needs the key
conversion of ROADMAP A0 and raises NotImplementedError; so does the JAX
package's orbax directory, which needs orbax to read.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from .mapanything import MapAnything, MapAnythingConfig

# key fragments found only in the reference's state dict (DINOv2's patch
# projection, the fusion LayerNorm and the DPT heads under their names)
_REFERENCE_KEYS = ("patch_embed.proj.weight", "fusion_norm_layer.",
                   "dpt_feature_head.", "dpt_regressor_head.")


def _reference_layout(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: a checkpoint in the reference's layout (HF snapshot, "
        "*.safetensors or the reference's state dict) needs its key "
        "conversion, ROADMAP queue A item A0; load the port's own files "
        "(train/checkpoints.py) or a JAX param tree "
        "(utils/weights.py::load_jax_params)")


def _model_state(path: str) -> Dict[str, torch.Tensor]:
    """The model's state dict in a save_params or save_train_state file,
    memory-mapped on the host."""
    if os.path.isdir(path):
        if any(os.path.isfile(os.path.join(path, name)) for name in (
                "model.safetensors", "model.safetensors.index.json",
                "config.json")):
            raise _reference_layout(path)
        raise NotImplementedError(
            f"{path}: a directory is the JAX package's orbax checkpoint; "
            "reading it needs orbax, which this package does not use. Load "
            "its param tree where JAX runs and convert it with "
            "utils/weights.py::from_jax_params")
    if path.endswith(".safetensors"):
        raise _reference_layout(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: not a state dict ({type(ckpt).__name__})")
    for key in ("model", "state_dict"):
        if isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    if any(frag in key for key in ckpt for frag in _REFERENCE_KEYS):
        raise _reference_layout(path)
    return ckpt


def from_pretrained(path: str, dtype: Any = torch.bfloat16,
                    config_overrides: Optional[Dict[str, Any]] = None,
                    device=None) -> MapAnything:
    """A MapAnything holding the weights of a checkpoint of this package.

    Args:
        path: a file of train/checkpoints.py::save_params, or of
            save_train_state (its "model" entry is read, nothing else).
        dtype: the compute dtype (bf16 for serving; parameters stay fp32).
        config_overrides: MapAnythingConfig fields of the architecture the
            file holds (the files store no config; the released one when
            None).
        device: where the model lives; the card when None.

    Returns:
        The model in eval mode. A state dict that does not fit the
        configured architecture raises RuntimeError (strict load).
    """
    state = _model_state(os.path.abspath(os.path.expanduser(path)))
    cfg = MapAnythingConfig(dtype=dtype, **dict(config_overrides or {}))
    model = MapAnything(cfg, device=device)
    model.load_state_dict(state)
    return model.eval()


__all__ = ["from_pretrained"]
