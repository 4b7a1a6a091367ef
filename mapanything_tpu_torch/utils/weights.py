"""JAX param tree -> the port's state dict.

The port names its submodules after the JAX package's flax scopes, so a flax
path maps to a state-dict key mechanically: scopes join with ".",
`blocks_{i}`, `layers_{i}` and `ref_layers_{i}` index ModuleLists
(`blocks.{i}`, `layers.{i}`, `ref_layers.{i}`),
a Dense or Conv `kernel` becomes `weight`, and a LayerNorm `scale` becomes
`weight`. The layouts are the reverse of the rules in
mapanything_tpu/utils/weights.py (`linear`, `conv`, `conv_transpose`):

  * Dense kernel (in, out)             -> Linear weight (out, in)
  * Conv kernel HWIO                   -> Conv2d weight OIHW
  * ConvTranspose kernel (kh, kw, in, out), spatially flipped
                                       -> ConvTranspose2d weight (in, out, kh, kw)

Every leaf must land on a parameter of the model with the same number of
elements in the converted shape, and every parameter must be covered.

The reference's own checkpoints (the released safetensors, or a torch state
dict of the reference model) reach the model in two steps: the conversion
rules below, a numpy-only copy of mapanything_tpu/utils/weights.py's, turn
the reference's state dict into the JAX package's param tree, and
`from_jax_params` takes that tree onto the port's model. The two layout
changes cancel, so the arrays stay views of the file where the layout
allows (models/pretrained.py::from_pretrained).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_LIST_SCOPE = re.compile(r"^(blocks|layers|ref_layers)_(\d+)$")


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
    too.) A module's `init_constants` (RADIO's input conditioner) keep
    their values and draw nothing."""
    rng = np.random.default_rng(seed)
    for mod in model.modules():
        consts = getattr(mod, "init_constants", {})
        for name, p in mod.named_parameters(recurse=False):
            if name in consts:
                p.copy_(torch.as_tensor(consts[name]))
                continue
            host = rng.standard_normal(tuple(p.shape), dtype=np.float32)
            p.copy_(torch.from_numpy(host * np.float32(std)))
    return model


# ---------------------------------------------------------------------------
# safetensors (the format of the reference's released checkpoint)
# ---------------------------------------------------------------------------

# safetensors dtype tag -> numpy dtype of the raw bytes; BF16 has no numpy
# dtype and is read as uint16 and widened to fp32 (its upper 16 bits)
_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "BF16": np.uint16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
    "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}
_SAFETENSORS_TAGS = {np.dtype(dt): tag for tag, dt in
                     _SAFETENSORS_DTYPES.items() if tag != "BF16"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Parse a .safetensors file into {name: numpy array}.

    The format: an 8-byte little-endian header length, a JSON header of
    {name: {dtype, shape, data_offsets}}, then the raw little-endian data.
    The data is memory-mapped copy-on-write, so each array is a writable
    view of the file and nothing is read until it is used (the released
    checkpoint is ~2.4 GiB in fp32). BF16 tensors are widened to fp32, the
    dtype of the model's parameters.
    """
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len).decode("utf-8"))
    start = 8 + header_len
    size = os.path.getsize(path) - start
    data = (np.memmap(path, dtype=np.uint8, mode="c", offset=start)
            if size else np.zeros(0, np.uint8))
    out: Dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        tag = meta["dtype"]
        if tag not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: unsupported safetensors dtype {tag!r}")
        lo, hi = meta["data_offsets"]
        arr = np.require(data[lo:hi].view(_SAFETENSORS_DTYPES[tag]),
                         requirements="A")  # unaligned offsets are copied
        if tag == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.reshape(meta["shape"])
    return out


def _host_bytes(x) -> Tuple[str, np.ndarray]:
    """(safetensors tag, contiguous numpy array of the raw data) of a torch
    tensor or an array; torch's bfloat16 is written as BF16."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return "BF16", x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.ascontiguousarray(x)
    if x.dtype not in _SAFETENSORS_TAGS:
        raise ValueError(f"unsupported dtype {x.dtype}")
    return _SAFETENSORS_TAGS[x.dtype], x


def write_safetensors(path: str, tensors: Mapping[str, Any]) -> None:
    """Write {name: torch tensor or array} as a .safetensors file, in the
    bytes of mapanything_tpu/utils/weights.py::write_safetensors. Host
    tensors are written from views of their memory, one after the other,
    never joined into one buffer."""
    header: Dict[str, Any] = {}
    arrays = []
    offset = 0
    for name, x in tensors.items():
        try:
            tag, arr = _host_bytes(x)
        except ValueError as exc:
            raise ValueError(f"{exc} for {name}") from None
        header[name] = {"dtype": tag, "shape": list(np.shape(x)),
                        "data_offsets": [offset, offset + arr.nbytes]}
        arrays.append(arr)
        offset += arr.nbytes
    hdr = json.dumps(header).encode("utf-8")
    hdr += b" " * (-len(hdr) % 8)  # spec: align the data to 8 bytes
    with open(path, "wb") as f:
        f.write(len(hdr).to_bytes(8, "little"))
        f.write(hdr)
        for arr in arrays:
            f.write(memoryview(arr.reshape(-1)).cast("B"))


# ---------------------------------------------------------------------------
# The reference's state dict -> the JAX package's param tree. A numpy-only
# copy of mapanything_tpu/utils/weights.py's rules (torch layout -> flax):
#   Linear weight (out, in)            -> kernel (in, out)
#   Conv2d weight (out, in, kh, kw)    -> kernel (kh, kw, in, out)
#   ConvTranspose2d (in, out, kh, kw)  -> kernel (kh, kw, in, out), flipped
#   LayerNorm weight / bias            -> scale / bias
# The top-level prefixes are the reference model's attribute names
# (encoder, ray_dirs_encoder, ..., info_sharing, dpt_feature_head,
# dpt_regressor_head, pose_head, scale_head, scale_token); the reference
# registers the two DPT modules a second time as dense_head.{0,1}. A key
# that no rule takes is reported, never dropped silently.
# ---------------------------------------------------------------------------

def _t(x) -> np.ndarray:
    """torch tensor or array -> numpy array (a view where possible; bf16
    tensors widen to fp32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def linear(w, b=None) -> Dict[str, np.ndarray]:
    out = {"kernel": _t(w).T}
    if b is not None:
        out["bias"] = _t(b)
    return out


def conv(w, b=None) -> Dict[str, np.ndarray]:
    out = {"kernel": _t(w).transpose(2, 3, 1, 0)}  # OIHW -> HWIO
    if b is not None:
        out["bias"] = _t(b)
    return out


def conv_transpose(w, b=None) -> Dict[str, np.ndarray]:
    # torch ConvTranspose2d weight is (in, out, kh, kw); flax ConvTranspose
    # kernel is (kh, kw, in, out) and correlates (torch convolves), so the
    # spatial taps are flipped too
    k = _t(w).transpose(2, 3, 0, 1)[::-1, ::-1]
    out = {"kernel": np.ascontiguousarray(k)}
    if b is not None:
        out["bias"] = _t(b)
    return out


def layer_norm(w, b) -> Dict[str, np.ndarray]:
    return {"scale": _t(w), "bias": _t(b)}


def _vit_block(take, b: str) -> Dict[str, Any]:
    """The tree of a timm/DINOv2 pre-norm block whose keys start with `b`
    (norm1, attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2), read through
    `take(key)`."""

    def lin(name):
        return linear(take(b + name + ".weight"), take(b + name + ".bias"))

    return {"norm1": layer_norm(take(b + "norm1.weight"),
                                take(b + "norm1.bias")),
            "attn": {"qkv": lin("attn.qkv"), "proj": lin("attn.proj")},
            "norm2": layer_norm(take(b + "norm2.weight"),
                                take(b + "norm2.bias")),
            "mlp": {"fc1": lin("mlp.fc1"), "fc2": lin("mlp.fc2")}}


def convert_dinov2(sd: Mapping[str, Any], prefix: str = "",
                   fold_layerscale: bool = False) -> Dict[str, Any]:
    """A torch-hub DINOv2 ViT state dict (keys under `prefix`) -> the JAX
    DinoViT tree. With `fold_layerscale` each block's LayerScale gammas are
    multiplied into the layer that feeds them (ls1 into attn.proj, ls2 into
    mlp.fc2, kernel and bias) and the tree holds no ls1/ls2: the tree of a
    DinoViT(fold_layerscale=True)."""

    def take(k):
        return sd[prefix + k]

    params: Dict[str, Any] = {
        "cls_token": _t(take("cls_token"))[0][None],  # (1, 1, C)
        "pos_embed": _t(take("pos_embed"))[0],  # (1, N, C) -> (N, C)
        "patch_embed": conv(take("patch_embed.proj.weight"),
                            take("patch_embed.proj.bias")),
        "norm": layer_norm(take("norm.weight"), take("norm.bias")),
    }
    if prefix + "register_tokens" in sd:
        params["register_tokens"] = _t(take("register_tokens"))

    n_blocks = 0
    while f"{prefix}blocks.{n_blocks}.norm1.weight" in sd:
        n_blocks += 1
    for i in range(n_blocks):
        b = f"blocks.{i}."
        block = _vit_block(take, b)
        if f"{prefix}{b}ls1.gamma" in sd:
            g1, g2 = _t(take(b + "ls1.gamma")), _t(take(b + "ls2.gamma"))
            if fold_layerscale:  # gamma scales the output of proj / fc2
                for layer, g in ((block["attn"]["proj"], g1),
                                 (block["mlp"]["fc2"], g2)):
                    layer["kernel"] = layer["kernel"] * g[None, :]
                    layer["bias"] = layer["bias"] * g
            else:
                block["ls1"] = {"gamma": g1}
                block["ls2"] = {"gamma": g2}
        params[f"blocks_{i}"] = block
    return params


def convert_croco(sd: Mapping[str, Any],
                  prefix: str = "") -> Tuple[Dict[str, Any], int]:
    """A CroCo/DUSt3R torch encoder state dict (keys under `prefix`) -> the
    JAX CroCoViT tree, and the count of tensors it consumed:

      patch_embed.proj.{weight,bias}   the patch-embedding conv
      enc_blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}
      enc_norm.{weight,bias}           the final LayerNorm

    An `enc_pos_embed` buffer is counted as consumed and skipped: CroCoViT
    computes the same sin-cos table (nn/croco.py). The tree loads onto the
    port's CroCoViT through `from_jax_params`.
    """
    used = 0

    def take(k):
        nonlocal used
        used += 1
        return sd[prefix + k]

    params: Dict[str, Any] = {
        "patch_embed": conv(take("patch_embed.proj.weight"),
                            take("patch_embed.proj.bias")),
        "norm": layer_norm(take("enc_norm.weight"), take("enc_norm.bias")),
    }
    if prefix + "enc_pos_embed" in sd:
        take("enc_pos_embed")

    n_blocks = 0
    while f"{prefix}enc_blocks.{n_blocks}.norm1.weight" in sd:
        n_blocks += 1
    for i in range(n_blocks):
        b = f"enc_blocks.{i}."
        params[f"blocks_{i}"] = _vit_block(take, b)
    return params, used


def convert_radio(sd: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A torch-hub RADIO (AM-RADIO RADIOModel) state dict (keys under
    `prefix`) -> the JAX RadioViT tree (JAX utils/weights.py::
    convert_radio):

      input_conditioner.norm_mean / norm_std        (1, 3, 1, 1)
      model.patch_generator.embedder.{weight,bias}  Linear (dim, p*p*3)
      model.patch_generator.pos_embed               (1, N, dim)
      model.patch_generator.cls_token.token         (k, dim): token 0 the
          class token, tokens 1..k-1 the register tokens
      model.blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}
      model.norm.{weight,bias}

    The embedder flattens each patch in (p1, p2, c) order, the HWIO order
    of a conv kernel, so its weight reshapes to the patch conv's."""

    def take(k):
        return sd[prefix + k]

    pos = _t(take("model.patch_generator.pos_embed"))
    ew = _t(take("model.patch_generator.embedder.weight"))  # (dim, p*p*3)
    dim = ew.shape[0]
    p = int(round((ew.shape[1] // 3) ** 0.5))
    patch_embed: Dict[str, np.ndarray] = {
        "kernel": ew.T.reshape(p, p, 3, dim)}
    if prefix + "model.patch_generator.embedder.bias" in sd:
        patch_embed["bias"] = _t(take("model.patch_generator.embedder.bias"))
    tok = _t(take("model.patch_generator.cls_token.token")).reshape(1, -1, dim)
    params: Dict[str, Any] = {
        "norm_mean": _t(take("input_conditioner.norm_mean")).reshape(3),
        "norm_std": _t(take("input_conditioner.norm_std")).reshape(3),
        "pos_embed": pos.reshape(-1, pos.shape[-1]),
        "norm": layer_norm(take("model.norm.weight"), take("model.norm.bias")),
        "patch_embed": patch_embed,
        "cls_token": tok[:, :1],
    }
    if tok.shape[1] > 1:
        params["register_tokens"] = tok[:, 1:]

    n_blocks = 0
    while f"{prefix}model.blocks.{n_blocks}.norm1.weight" in sd:
        n_blocks += 1
    for i in range(n_blocks):
        b = f"model.blocks.{i}."
        params[f"blocks_{i}"] = _vit_block(take, b)
    return params


class _SubDict:
    """View over sd restricted to one prefix, tracking consumed keys."""

    def __init__(self, sd: Mapping[str, Any], prefix: str):
        self.prefix = prefix
        self.d = {k[len(prefix):]: v for k, v in sd.items()
                  if k.startswith(prefix)}
        self.used: set = set()

    def __contains__(self, k):
        return k in self.d

    def take(self, k):
        self.used.add(k)
        return self.d[k]

    def first(self, *names):
        """The first present bare key, or None."""
        return next((n for n in names if n in self.d), None)

    def first_mod(self, *names, probe: str = ".weight"):
        """The first name that is a module base (has `<name><probe>`)."""
        return next((n for n in names if n + probe in self.d), None)


def _linear_from(sub: _SubDict, base: str) -> Dict[str, np.ndarray]:
    b = sub.take(base + ".bias") if base + ".bias" in sub else None
    return linear(sub.take(base + ".weight"), b)


def _conv_from(sub: _SubDict, base: str) -> Dict[str, np.ndarray]:
    b = sub.take(base + ".bias") if base + ".bias" in sub else None
    return conv(sub.take(base + ".weight"), b)


def _convt_from(sub: _SubDict, base: str) -> Dict[str, np.ndarray]:
    b = sub.take(base + ".bias") if base + ".bias" in sub else None
    return conv_transpose(sub.take(base + ".weight"), b)


def _ln_from(sub: _SubDict, base: str) -> Dict[str, np.ndarray]:
    return layer_norm(sub.take(base + ".weight"), sub.take(base + ".bias"))


def convert_dense_rep_encoder(sub: _SubDict) -> Dict[str, Any]:
    """UniCeption dense_rep_encoder (conv patchify) -> DenseRepEncoder."""
    base = sub.first_mod("proj", "patch_embed.proj", "conv")
    return {} if base is None else {"proj": _conv_from(sub, base)}


def convert_global_rep_encoder(sub: _SubDict) -> Dict[str, Any]:
    """UniCeption global_rep_encoder (MLP) -> GlobalRepEncoder."""
    out: Dict[str, Any] = {}
    f1 = sub.first_mod("fc1", "mlp.0", "mlp.fc1", "0")
    f2 = sub.first_mod("fc2", "mlp.2", "mlp.fc2", "2")
    if f1 is not None:
        out["fc1"] = _linear_from(sub, f1)
    if f2 is not None:
        out["fc2"] = _linear_from(sub, f2)
    return out


def _convert_block(sub: _SubDict, base: str) -> Dict[str, Any]:
    """timm/DINOv2-style transformer block -> the trunk's Block tree."""
    blk: Dict[str, Any] = {
        "norm1": _ln_from(sub, base + ".norm1"),
        "attn": {"qkv": _linear_from(sub, base + ".attn.qkv"),
                 "proj": _linear_from(sub, base + ".attn.proj")},
        "norm2": _ln_from(sub, base + ".norm2"),
        "mlp": {"fc1": _linear_from(sub, base + ".mlp.fc1"),
                "fc2": _linear_from(sub, base + ".mlp.fc2")},
    }
    if base + ".ls1.gamma" in sub:
        blk["ls1"] = {"gamma": _t(sub.take(base + ".ls1.gamma"))}
        blk["ls2"] = {"gamma": _t(sub.take(base + ".ls2.gamma"))}
    return blk


def convert_trunk(sub: _SubDict,
                  indices: Tuple[int, ...] = (11, 17)) -> Dict[str, Any]:
    """UniCeption MultiView*AttentionTransformer[IFR] -> the trunk's tree.

    Two block layouts: flat interleaved `blocks.{i}` (frame/global
    alternating; tap i is layer i) -> layers_{i}, and paired
    `frame_blocks.{j}` + `global_blocks.{j}` (VGGT) -> layers_{2j},
    layers_{2j+1}, where tap i counts pairs and is the pair's global layer
    2i+1.
    """
    out: Dict[str, Any] = {}
    if "proj.weight" in sub:
        out["proj"] = _linear_from(sub, "proj")

    n_flat = 0
    while f"blocks.{n_flat}.norm1.weight" in sub:
        n_flat += 1
    if n_flat:
        for i in range(n_flat):
            out[f"layers_{i}"] = _convert_block(sub, f"blocks.{i}")
        tap_layers = list(indices)
    else:
        n_pairs = 0
        while f"frame_blocks.{n_pairs}.norm1.weight" in sub:
            n_pairs += 1
        for j in range(n_pairs):
            out[f"layers_{2 * j}"] = _convert_block(sub, f"frame_blocks.{j}")
            out[f"layers_{2 * j + 1}"] = _convert_block(
                sub, f"global_blocks.{j}")
        tap_layers = [2 * i + 1 for i in indices]

    # reference-view embeddings: one stacked (2, dim) parameter or two (dim,)
    stacked = sub.first("ref_nonref_embed", "view_embed")
    if stacked is not None:
        out["ref_nonref_embed"] = _t(sub.take(stacked)).reshape(2, -1)
    elif "ref_view_embed" in sub and "non_ref_view_embed" in sub:
        out["ref_nonref_embed"] = np.stack([
            _t(sub.take("ref_view_embed")).reshape(-1),
            _t(sub.take("non_ref_view_embed")).reshape(-1)])

    pe = sub.first("view_pe.weight", "view_pe", "view_pos_embed.weight")
    if pe is not None:
        out["view_pe"] = _t(sub.take(pe))

    # the IFR tap norms: a ModuleList in tap order, named here by layer
    for k, layer_idx in enumerate(tap_layers):
        base = sub.first_mod(f"norm_intermediate.{k}",
                             f"intermediate_norms.{k}",
                             f"adaptors.{k}.final_norm")
        if base is not None:
            out[f"norm_intermediate_{layer_idx}"] = _ln_from(sub, base)

    if "norm.weight" in sub:
        out["norm"] = _ln_from(sub, "norm")
    return out


def convert_dpt_feature(sub: _SubDict) -> Dict[str, Any]:
    """DPT feature pyramid (VGGT's scratch naming) -> DPTFeature's tree."""
    out: Dict[str, Any] = {}
    if "norm.weight" in sub:  # the optional input LayerNorm
        out["input_norm"] = _ln_from(sub, "norm")
    for i in range(4):
        base = sub.first_mod(f"projects.{i}", f"project_{i}",
                             f"act_postprocess.{i}.0")
        if base is not None:
            out[f"project_{i}"] = _conv_from(sub, base)
    # resize layers: 0 and 1 transposed convs, 2 identity, 3 a strided conv
    for i, transposed in ((0, True), (1, True), (3, False)):
        base = sub.first_mod(f"resize_layers.{i}", f"resize_{i}")
        if base is not None:
            out[f"resize_{i}"] = (_convt_from(sub, base) if transposed
                                  else _conv_from(sub, base))
    for i in range(4):
        base = sub.first_mod(f"scratch.layer{i + 1}_rn", f"layer_rn_{i}",
                             f"scratch.layer_rn.{i}")
        if base is not None:
            out[f"layer_rn_{i}"] = _conv_from(sub, base)
    for k in range(1, 5):
        base = sub.first_mod(f"scratch.refinenet{k}", f"refinenet{k}",
                             probe=".resConfUnit2.conv1.weight")
        if base is None:
            continue
        ref: Dict[str, Any] = {}
        for unit_t, unit_o in (("resConfUnit1", "res_conv_unit1"),
                               ("resConfUnit2", "res_conv_unit2")):
            if f"{base}.{unit_t}.conv1.weight" in sub:
                ref[unit_o] = {
                    "conv1": _conv_from(sub, f"{base}.{unit_t}.conv1"),
                    "conv2": _conv_from(sub, f"{base}.{unit_t}.conv2"),
                }
        if f"{base}.out_conv.weight" in sub:
            ref["out_conv"] = _conv_from(sub, f"{base}.out_conv")
        out[f"refinenet{k}"] = ref
    return out


def convert_dpt_regressor(sub: _SubDict) -> Dict[str, Any]:
    """DPT regression tail (VGGT's output_conv1/output_conv2 naming) ->
    DPTRegressionProcessor's tree."""
    out: Dict[str, Any] = {}
    for name, cands in (("conv1", ("output_conv1", "conv1", "head.0")),
                        ("conv2", ("output_conv2.0", "conv2", "head.2")),
                        ("conv_out", ("output_conv2.2", "conv_out",
                                      "head.4"))):
        base = sub.first_mod(*cands)
        if base is not None:
            out[name] = _conv_from(sub, base)
    return out


def convert_pose_head(sub: _SubDict) -> Dict[str, Any]:
    """UniCeption PoseHead (proj conv, resconv blocks, MLP) -> PoseHead."""
    out: Dict[str, Any] = {}
    base = sub.first_mod("proj", "input_proj")
    if base is not None:
        out["proj"] = _conv_from(sub, base)
    i = 0
    while True:
        base = sub.first_mod(f"res_conv_blocks.{i}", f"res_conv.{i}",
                             f"resconv_blocks.{i}", f"res_conv_{i}",
                             probe=".conv1.weight")
        if base is None:
            break
        out[f"res_conv_{i}"] = {"conv1": _conv_from(sub, f"{base}.conv1"),
                                "conv2": _conv_from(sub, f"{base}.conv2")}
        i += 1
    f1 = sub.first_mod("fc1", "mlp.0")
    fo = sub.first_mod("fc_out", "fc2", "mlp.2")
    if f1 is not None:
        out["fc1"] = _linear_from(sub, f1)
    if fo is not None:
        out["fc_out"] = _linear_from(sub, fo)
    return out


def convert_mlp_head(sub: _SubDict) -> Dict[str, Any]:
    """UniCeption MLPHead (the scale head) -> MLPHead."""
    out: Dict[str, Any] = {}
    f1 = sub.first_mod("fc1", "mlp.0")
    f2 = sub.first_mod("fc2", "mlp.2")
    if f1 is not None:
        out["fc1"] = _linear_from(sub, f1)
    if f2 is not None:
        out["fc2"] = _linear_from(sub, f2)
    return out


_DENSE_REP_ENCODERS = ("ray_dirs_encoder", "depth_encoder")
_GLOBAL_REP_ENCODERS = ("depth_scale_encoder", "cam_rot_encoder",
                        "cam_trans_encoder", "cam_trans_scale_encoder")


def _reference_keys(sd: Mapping[str, Any]) -> Mapping[str, Any]:
    """sd without a DDP ("module.") or namespace ("model.") prefix that
    every key carries. A checkpoint that holds the DPT heads only under
    dense_head.{0,1} (safetensors keeps one name of each shared tensor)
    has them renamed to dpt_feature_head and dpt_regressor_head."""
    for wrapper in ("module.", "model."):
        if sd and all(k.startswith(wrapper) for k in sd):
            sd = {k[len(wrapper):]: v for k, v in sd.items()}
    if (not any(k.startswith("dpt_feature_head.") for k in sd)
            and any(k.startswith("dense_head.0.") for k in sd)):
        heads = {"dense_head.0.": "dpt_feature_head.",
                 "dense_head.1.": "dpt_regressor_head."}
        sd = {next((new + k[len(old):] for old, new in heads.items()
                    if k.startswith(old)), k): v for k, v in sd.items()}
    return sd


def convert_mapanything_checkpoint(
        sd: Mapping[str, Any], trunk_indices: Tuple[int, ...] = (11, 17),
        fold_layerscale: bool = False) -> Dict[str, Any]:
    """The reference's full state dict -> the JAX MapAnything param tree
    (the inner tree, numpy leaves), with two bookkeeping entries that
    callers pop:

      '_unconverted': keys no rule took (empty for a supported checkpoint);
      '_aliases': keys skipped as known duplicates (dense_head.{0,1}.*, the
          re-registrations of the DPT heads, and DINOv2's mask_token, which
          inference never reads).

    The encoder is found by its family's signature keys, RADIO
    (input_conditioner), CroCo (enc_blocks) and else DINOv2, under any
    prefix. `fold_layerscale` folds a DINOv2 encoder's LayerScale into its
    layers (convert_dinov2), for a MapAnythingConfig(fold_layerscale=True).
    A checkpoint that holds the DPT heads only under dense_head.{0,1} is
    read as if they were under their own names (`_reference_keys`).
    """
    sd = _reference_keys(sd)

    out: Dict[str, Any] = {}
    consumed: set = set()
    aliases = []

    def run(prefix: str, fn, *args, **kw):
        sub = _SubDict(sd, prefix)
        if not sub.d:
            return None
        res = fn(sub, *args, **kw)
        consumed.update(prefix + k for k in sub.used)
        return res

    def find_prefix(pattern: str):
        for k in sd:
            m = re.match(pattern, k)
            if m is not None:
                return m.group(1)
        return None

    # the encoder, by its family's signature keys (disjoint; first wins)
    for pattern, convert in (
            (r"^(encoder\..*?|)input_conditioner\.norm_mean$", convert_radio),
            (r"^(encoder\..*?|)enc_blocks\.0\.norm1\.weight$",
             lambda sd, prefix: convert_croco(sd, prefix)[0]),
            (r"^(encoder\..*?|)patch_embed\.proj\.weight$",
             lambda sd, prefix: convert_dinov2(sd, prefix, fold_layerscale))):
        enc_prefix = find_prefix(pattern)
        if enc_prefix is not None:
            out["encoder"] = convert(sd, enc_prefix)
            for k in sd:
                if k.startswith(enc_prefix):
                    if k.endswith("mask_token"):
                        aliases.append(k)  # frozen, unused at inference
                    else:
                        consumed.add(k)
            break

    for name in _DENSE_REP_ENCODERS:
        res = run(f"{name}.", convert_dense_rep_encoder)
        if res:
            out[name] = res
    for name in _GLOBAL_REP_ENCODERS:
        res = run(f"{name}.", convert_global_rep_encoder)
        if res:
            out[name] = res
    if "fusion_norm_layer.weight" in sd:
        out["fusion_norm"] = layer_norm(sd["fusion_norm_layer.weight"],
                                        sd["fusion_norm_layer.bias"])
        consumed.update(("fusion_norm_layer.weight",
                         "fusion_norm_layer.bias"))
    if "scale_token" in sd:
        out["scale_token"] = _t(sd["scale_token"]).reshape(-1)
        consumed.add("scale_token")

    res = run("info_sharing.", convert_trunk, indices=trunk_indices)
    if res:
        out["info_sharing"] = res

    dense_head: Dict[str, Any] = {}
    res = run("dpt_feature_head.", convert_dpt_feature)
    if res:
        dense_head["dpt_feature"] = res
    res = run("dpt_regressor_head.", convert_dpt_regressor)
    if res:
        dense_head["dpt_regressor"] = res
    if dense_head:
        out["dense_head"] = dense_head
    res = run("pose_head.", convert_pose_head)
    if res:
        out["pose_head"] = res
    res = run("scale_head.", convert_mlp_head)
    if res:
        out["scale_head"] = res

    aliases += [k for k in sd
                if k.startswith("dense_head.") and k not in consumed]
    unconverted = [k for k in sd if k not in consumed and k not in aliases]
    if unconverted:
        out["_unconverted"] = unconverted
    if aliases:
        out["_aliases"] = aliases
    return out


def infer_model_config(sd: Mapping[str, Any],
                       indices: Tuple[int, ...] = (11, 17)) -> Dict[str, Any]:
    """Architecture dimensions read from a checkpoint's tensor shapes: the
    trunk's depth and width (a paired layout counts two layers a pair and
    taps pair i at layer 2i+1), the DPT widths, the output channels and the
    pose head's block count; `enc_dim` too, which is no config field."""
    sd = _reference_keys(sd)

    def shape(k):
        return tuple(np.shape(sd[k]))

    cfg: Dict[str, Any] = {}
    if "scale_token" in sd:
        cfg["enc_dim"] = int(np.prod(shape("scale_token")))

    n_flat = 0
    while f"info_sharing.blocks.{n_flat}.norm1.weight" in sd:
        n_flat += 1
    n_pairs = 0
    while f"info_sharing.frame_blocks.{n_pairs}.norm1.weight" in sd:
        n_pairs += 1
    if n_flat:
        cfg["trunk_depth"] = n_flat
        cfg["trunk_dim"] = shape("info_sharing.blocks.0.norm1.weight")[0]
        cfg["trunk_indices"] = tuple(indices)
    elif n_pairs:
        cfg["trunk_depth"] = 2 * n_pairs
        cfg["trunk_dim"] = shape(
            "info_sharing.frame_blocks.0.norm1.weight")[0]
        cfg["trunk_indices"] = tuple(2 * i + 1 for i in indices)

    if "dpt_feature_head.scratch.layer1_rn.weight" in sd:
        cfg["dpt_feature_dim"] = shape(
            "dpt_feature_head.scratch.layer1_rn.weight")[0]
    if all(f"dpt_feature_head.projects.{i}.weight" in sd for i in range(4)):
        cfg["dpt_out_channels"] = tuple(
            shape(f"dpt_feature_head.projects.{i}.weight")[0]
            for i in range(4))

    def first(*keys):
        return next((k for k in keys if k in sd), None)

    c1 = first("dpt_regressor_head.output_conv1.weight",
               "dpt_regressor_head.conv1.weight")
    c2 = first("dpt_regressor_head.output_conv2.0.weight",
               "dpt_regressor_head.conv2.weight")
    co = first("dpt_regressor_head.output_conv2.2.weight",
               "dpt_regressor_head.conv_out.weight")
    if c1 and c2:
        cfg["dpt_hidden_dims"] = (shape(c1)[0], shape(c2)[0])
    if co:
        cfg["dense_output_dim"] = shape(co)[0]
    if "pose_head.fc_out.weight" in sd:
        cfg["pose_out_dim"] = shape("pose_head.fc_out.weight")[0]
    n_res = 0
    while any(f"pose_head.{fam}.{n_res}.conv1.weight" in sd
              for fam in ("res_conv_blocks", "res_conv", "resconv_blocks")):
        n_res += 1
    if n_res:
        cfg["pose_num_resconv"] = n_res
    return cfg
