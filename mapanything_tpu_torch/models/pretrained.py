"""Loading a trained model; counterpart of
mapanything_tpu/models/pretrained.py.

`from_pretrained` builds a `MapAnything` from a local checkpoint:

  * in the reference's layout: an HF snapshot directory (model.safetensors,
    or model.safetensors.index.json and its shards), a *.safetensors file,
    or a torch file holding the reference's state dict (directly or under
    "model" / "state_dict"). utils/weights.py::convert_mapanything_checkpoint
    turns it into the JAX package's param tree and from_jax_params takes
    that onto the model; infer_model_config reads the architecture's
    dimensions from the tensor shapes where the caller sets none. The
    encoder's family (DINOv2, CroCo, RADIO) is found by its keys; the
    config's other variant fields (`encoder_type`, `info_sharing_type`,
    `scene_rep_type`, `use_scale_token`, ...) come from
    `config_overrides`, and `fold_layerscale` folds DINOv2's LayerScale
    into its layers as the checkpoint converts;
  * the port's own files: a state dict written by
    train/checkpoints.py::save_params, or the "model" entry of a
    save_train_state file (the trainer's checkpoint-best and
    checkpoint-last).

Files are memory-mapped on the host and only the model's tensors are copied
to the device: a full-width train state holds the AdamW moments too
(~7.3 GiB), which serving must not place on the card. Torch files load with
`weights_only=True`, which unpickles tensors and containers only (the JAX
package passes weights_only=False). The JAX package's orbax directory needs
orbax to read and raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Any, Dict, Optional, Tuple

import torch

from ..utils.weights import (
    convert_mapanything_checkpoint,
    infer_model_config,
    load_jax_params,
    read_safetensors,
)
from .mapanything import MapAnything, MapAnythingConfig

# key fragments found only in the reference's state dict (DINOv2's patch
# projection, the fusion LayerNorm and the DPT heads under their names)
_REFERENCE_KEYS = ("patch_embed.proj.weight", "fusion_norm_layer.",
                   "dpt_feature_head.", "dpt_regressor_head.", "dense_head.0.")


def _snapshot(path: str) -> Dict[str, Any]:
    """The state dict of an HF snapshot directory, memory-mapped."""
    single = os.path.join(path, "model.safetensors")
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.isfile(single):
        return read_safetensors(single)
    if os.path.isfile(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        state: Dict[str, Any] = {}
        for shard in sorted(set(weight_map.values())):
            state.update(read_safetensors(os.path.join(path, shard)))
        return state
    raise NotImplementedError(
        f"{path}: a directory without model.safetensors or its index is the "
        "JAX package's orbax checkpoint; reading it needs orbax, which this "
        "package does not use. Load its param tree where JAX runs and "
        "convert it with utils/weights.py::from_jax_params")


def _torch_file(path: str) -> Dict[str, Any]:
    """The state dict of a torch file, memory-mapped; the "model" or
    "state_dict" entry of a dict that holds one."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)
    except pickle.UnpicklingError as exc:
        raise pickle.UnpicklingError(
            f"{path}: holds objects other than tensors and containers. This "
            "package loads torch files with weights_only=True and unpickles "
            "no code (the JAX package loads them with weights_only=False); "
            "save the state dict alone, or as safetensors") from exc
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: not a state dict ({type(ckpt).__name__})")
    for key in ("model", "state_dict"):
        if isinstance(ckpt.get(key), dict):
            return ckpt[key]
    return ckpt


def _state_dict(path: str) -> Tuple[Dict[str, Any], bool]:
    """(the state dict at `path`, whether it is in the reference's
    layout)."""
    if os.path.isdir(path):
        return _snapshot(path), True
    if path.endswith(".safetensors"):
        return read_safetensors(path), True
    state = _torch_file(path)
    return state, any(frag in key for key in state
                      for frag in _REFERENCE_KEYS)


def _conversion_taps(state: Dict[str, Any], cfg: MapAnythingConfig) -> tuple:
    """The tap indices the conversion takes: the config's layers, or, for a
    trunk of frame/global pairs, the pairs whose global layers they are."""
    if not any(".frame_blocks.0." in key for key in state):
        return tuple(cfg.trunk_indices)
    if any(i % 2 == 0 for i in cfg.trunk_indices):
        raise ValueError(
            f"trunk_indices {tuple(cfg.trunk_indices)}: a checkpoint of "
            "frame/global pairs taps the global (odd) layers only")
    return tuple((i - 1) // 2 for i in cfg.trunk_indices)


def from_pretrained(path: str, dtype: Any = torch.bfloat16,
                    config_overrides: Optional[Dict[str, Any]] = None,
                    device=None, strict: bool = True) -> MapAnything:
    """A MapAnything holding the weights of a local checkpoint.

    Args:
        path: an HF snapshot directory, a *.safetensors file, a torch file
            of the reference's state dict, or a file of this package's
            train/checkpoints.py (save_params or save_train_state).
        dtype: the compute dtype (bf16 for serving; parameters stay fp32).
        config_overrides: MapAnythingConfig fields. For the reference's
            layout, the fields not given are read from the tensor shapes
            where they can be (the trunk, the DPT widths, the pose head);
            the port's own files store no config, so the released one is
            used where none is given.
        device: where the model lives; the card when None.
        strict: raise ValueError if a tensor of the reference's layout has
            no conversion rule.

    Returns:
        The model in eval mode. Weights that do not fit the configured
        architecture raise (KeyError or ValueError for the reference's
        layout, RuntimeError for the port's own files).
    """
    state, reference = _state_dict(os.path.abspath(os.path.expanduser(path)))
    if not reference:
        model = MapAnything(MapAnythingConfig(dtype=dtype,
                                              **dict(config_overrides or {})),
                            device=device)
        model.load_state_dict(state)
        return model.eval()
    return convert_reference(state, dtype, config_overrides, device,
                             strict)[0]


def convert_reference(state: Dict[str, Any], dtype: Any = torch.bfloat16,
                      config_overrides: Optional[Dict[str, Any]] = None,
                      device=None, strict: bool = True
                      ) -> Tuple[MapAnything, Dict[str, Any]]:
    """A MapAnything holding a state dict in the reference's layout
    (from_pretrained's conversion, and convert_torch_checkpoint's).

    The config is `config_overrides` with the fields infer_model_config
    reads from the shapes filled in where they are not given. Returns (the
    model in eval mode, {"unconverted": keys no rule took, "aliases": keys
    skipped as known duplicates, "inferred": infer_model_config(state)}).
    With `strict`, an unconverted key raises ValueError; without, it does
    not reach the model."""
    overrides = dict(config_overrides or {})
    inferred = infer_model_config(state)
    fields = {f.name for f in dataclasses.fields(MapAnythingConfig)}
    for key, val in inferred.items():
        if key in fields:  # it reports non-config facts too (enc_dim)
            overrides.setdefault(key, val)
    cfg = MapAnythingConfig(dtype=dtype, **overrides)
    tree = convert_mapanything_checkpoint(
        state, trunk_indices=_conversion_taps(state, cfg),
        fold_layerscale=cfg.fold_layerscale)
    report = {"unconverted": tree.pop("_unconverted", []),
              "aliases": tree.pop("_aliases", []), "inferred": inferred}
    if report["unconverted"] and strict:
        raise ValueError(
            f"{len(report['unconverted'])} checkpoint tensors have no "
            f"conversion rule, e.g. {report['unconverted'][:5]} (pass "
            "strict=False to ignore)")
    model = MapAnything(cfg, device=device)
    load_jax_params(model, tree)
    return model.eval(), report


__all__ = ["convert_reference", "from_pretrained"]
