"""JAX param tree -> the port's state dict.

The port names its submodules after the JAX package's flax scopes, so a flax
path maps to a state-dict key mechanically: scopes join with ".",
`blocks_{i}` and `layers_{i}` index ModuleLists (`blocks.{i}`, `layers.{i}`),
a Dense or Conv `kernel` becomes `weight`, and a LayerNorm `scale` becomes
`weight`. The layouts are the reverse of the rules in
mapanything_tpu/utils/weights.py (`linear`, `conv`, `conv_transpose`):

  * Dense kernel (in, out)             -> Linear weight (out, in)
  * Conv kernel HWIO                   -> Conv2d weight OIHW
  * ConvTranspose kernel (kh, kw, in, out), spatially flipped
                                       -> ConvTranspose2d weight (in, out, kh, kw)

Every leaf must land on a parameter of the model with the same number of
elements in the converted shape, and every parameter must be covered.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_LIST_SCOPE = re.compile(r"^(blocks|layers)_(\d+)$")


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _torch_key(path: tuple) -> str:
    parts = []
    for p in path[:-1]:
        m = _LIST_SCOPE.match(p)
        parts.extend((m.group(1), m.group(2)) if m else (p,))
    leaf = path[-1]
    parts.append({"kernel": "weight", "scale": "weight"}.get(leaf, leaf))
    return ".".join(parts)


def _to_torch_layout(module: nn.Module, leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return arr
    if isinstance(module, nn.Linear):
        return arr.T
    if isinstance(module, nn.ConvTranspose2d):
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(module, nn.Conv2d):
        return arr.transpose(3, 2, 0, 1)
    raise ValueError(f"no kernel layout rule for {type(module).__name__}")


def from_jax_params(params: Mapping[str, Any],
                    model: nn.Module) -> Dict[str, np.ndarray]:
    """Convert a JAX param tree (numpy leaves) into `model`'s state dict.

    Args:
        params: the flax variables ({"params": {...}}) or the inner tree.
        model: the port's module the tree belongs to; its module types pick
            each kernel's layout and its parameters are the expected keys.

    Returns:
        {state-dict key: numpy array in the torch layout}. The arrays are
        views of the inputs where the layout allows; load them with
        :func:`load_jax_params`.

    Raises:
        KeyError: a leaf has no parameter in the model, or a parameter
            has no leaf.
        ValueError: a converted shape differs from the parameter's.
    """
    if set(params) == {"params"}:
        params = params["params"]
    expected = dict(model.named_parameters())
    modules = dict(model.named_modules())
    out: Dict[str, np.ndarray] = {}
    unconsumed = []
    for path, leaf in _flatten(params):
        key = _torch_key(path)
        if key not in expected:
            unconsumed.append("/".join(path))
            continue
        owner = modules[key.rsplit(".", 1)[0]] if "." in key else model
        arr = _to_torch_layout(owner, path[-1], np.asarray(leaf))
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(
                f"{'/'.join(path)} -> {key}: shape {tuple(arr.shape)} != "
                f"{tuple(expected[key].shape)}")
        out[key] = arr
    missing = sorted(set(expected) - set(out))
    if unconsumed or missing:
        raise KeyError(
            f"JAX params do not match the model: unconsumed leaves "
            f"{unconsumed}, parameters without a leaf {missing}")
    return out


@torch.no_grad()
def load_jax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Copy a JAX param tree into `model`'s parameters (strict)."""
    state = from_jax_params(params, model)
    for key, p in model.named_parameters():
        p.copy_(torch.from_numpy(np.ascontiguousarray(state[key])))
    return model


@torch.no_grad()
def random_normal_(model: nn.Module, seed: int = 0,
                   std: float = 0.02) -> nn.Module:
    """Every parameter ~ N(0, std^2) from a seeded numpy generator: the same
    weights on every device and in every process. (Unlike
    nn/layers.py::init_weights_, LayerNorm scales and biases are random
    too.)"""
    rng = np.random.default_rng(seed)
    for p in model.parameters():
        host = rng.standard_normal(tuple(p.shape), dtype=np.float32)
        p.copy_(torch.from_numpy(host * np.float32(std)))
    return model
