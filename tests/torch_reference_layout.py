"""The reference's checkpoint layout, built from a model of the port.

`reference_state_dict` is the inverse of the conversion rules
(mapanything_tpu_torch/utils/weights.py::convert_mapanything_checkpoint
followed by from_jax_params): the port's state dict renamed to the keys of
the reference model (the names the rules read), in the same torch layouts,
so each value is a view of the port's tensor (RADIO's embedder and tokens
are reshaped copies). The encoder is written in its family's layout:
DINOv2 (torch hub, under encoder.model.), CroCo (patch_embed.proj,
enc_blocks, enc_norm) or RADIO (the hub RADIOModel's). `write_snapshot` writes such
a state dict as an HF snapshot directory. The parity tests and chip_smoke.py
phase 11a build their checkpoints with these two; neither imports JAX.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Sequence

import torch

_DPT_FEATURE = [
    (r"^input_norm\.", "norm."),
    (r"^project_(\d)\.", r"projects.\1."),
    (r"^resize_(\d)\.", r"resize_layers.\1."),
    (r"^refinenet(\d)\.res_conv_unit(\d)\.", r"scratch.refinenet\1.resConfUnit\2."),
    (r"^refinenet(\d)\.out_conv\.", r"scratch.refinenet\1.out_conv."),
]
_DPT_REGRESSOR = {"conv1.": "output_conv1.", "conv2.": "output_conv2.0.",
                  "conv_out.": "output_conv2.2."}


def _dpt_feature_key(rest: str) -> str:
    m = re.match(r"^layer_rn_(\d)\.", rest)
    if m:
        return f"scratch.layer{int(m.group(1)) + 1}_rn." + rest[m.end():]
    for pattern, repl in _DPT_FEATURE:
        if re.match(pattern, rest):
            return re.sub(pattern, repl, rest)
    raise KeyError(f"dense_head.dpt_feature.{rest}: no reference name")


def _dpt_regressor_key(rest: str) -> str:
    for ours, ref in _DPT_REGRESSOR.items():
        if rest.startswith(ours):
            return ref + rest[len(ours):]
    raise KeyError(f"dense_head.dpt_regressor.{rest}: no reference name")


def reference_state_dict(state: Dict[str, torch.Tensor],
                         trunk_indices: Sequence[int], paired: bool = False,
                         aliases: bool = True) -> Dict[str, torch.Tensor]:
    """The reference model's state dict holding the port's `state`.

    Args:
        state: the port's MapAnything state dict.
        trunk_indices: the config's tap layers; the reference lists its tap
            norms in tap order.
        paired: the trunk as VGGT's frame_blocks / global_blocks pairs
            instead of the flat blocks.{i}.
        aliases: add the reference's duplicate registrations, the DPT
            heads again under dense_head.{0,1}, and DINOv2's mask_token
            (zeros; inference never reads it).
    """
    taps = {int(i): k for k, i in enumerate(trunk_indices)}
    out: Dict[str, torch.Tensor] = {}
    if "encoder.norm_mean" in state:
        out.update(_radio_encoder(state))
    for key, val in state.items():
        if key.startswith("encoder.") and "encoder.norm_mean" in state:
            continue  # RADIO, above
        if key.startswith("encoder.") and "encoder.cls_token" not in state:
            # CroCo: patch_embed.proj, enc_blocks, enc_norm
            rest = key[len("encoder."):]
            for ours, ref in (("patch_embed.", "patch_embed.proj."),
                              ("blocks.", "enc_blocks."),
                              ("norm.", "enc_norm.")):
                if rest.startswith(ours):
                    out["encoder." + ref + rest[len(ours):]] = val
        elif key.startswith("encoder."):
            rest = key[len("encoder."):]
            if rest.startswith("patch_embed."):
                rest = "patch_embed.proj." + rest[len("patch_embed."):]
            elif rest == "pos_embed":
                val = val[None]  # (N, C) -> (1, N, C)
            out["encoder.model." + rest] = val
        elif key.startswith("fusion_norm."):
            out["fusion_norm_layer." + key[len("fusion_norm."):]] = val
        elif key == "info_sharing.ref_nonref_embed":
            out["info_sharing.ref_view_embed"] = val[0]
            out["info_sharing.non_ref_view_embed"] = val[1]
        elif key.startswith("info_sharing.layers."):
            i, tail = key[len("info_sharing.layers."):].split(".", 1)
            i = int(i)
            block = (f"{('frame', 'global')[i % 2]}_blocks.{i // 2}"
                     if paired else f"blocks.{i}")
            out[f"info_sharing.{block}.{tail}"] = val
        elif key.startswith("info_sharing.norm_intermediate_"):
            layer, tail = key[len("info_sharing.norm_intermediate_"):].split(
                ".", 1)
            out[f"info_sharing.norm_intermediate.{taps[int(layer)]}.{tail}"] \
                = val
        elif key.startswith("dense_head.dpt_feature."):
            out["dpt_feature_head." + _dpt_feature_key(
                key[len("dense_head.dpt_feature."):])] = val
        elif key.startswith("dense_head.dpt_regressor."):
            out["dpt_regressor_head." + _dpt_regressor_key(
                key[len("dense_head.dpt_regressor."):])] = val
        elif key.startswith("pose_head.res_conv_"):
            i, tail = key[len("pose_head.res_conv_"):].split(".", 1)
            out[f"pose_head.res_conv_blocks.{i}.{tail}"] = val
        else:  # the prior encoders, scale_token, the trunk's proj and norm,
            out[key] = val  # pose_head's proj/fc1/fc_out and scale_head
    if aliases:
        for key in [k for k in out if k.startswith(("dpt_feature_head.",
                                                    "dpt_regressor_head."))]:
            head = "0" if key.startswith("dpt_feature_head.") else "1"
            out[f"dense_head.{head}.{key.split('.', 1)[1]}"] = out[key]
        if "encoder.pos_embed" in state and "encoder.norm_mean" not in state:
            dim = state["encoder.cls_token"].shape[-1]
            out["encoder.model.mask_token"] = torch.zeros(1, dim)
    return out


def _radio_encoder(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A port RadioViT's parameters in the torch-hub RADIOModel's layout
    under encoder.model.: the conditioner's (1, 3, 1, 1) buffers, the
    embedder Linear over (p1, p2, c)-flattened patches, the (1, N, C)
    pos-embed, the class and register tokens as one (k, C) token."""
    pre = "encoder.model."
    w = state["encoder.patch_embed.weight"]  # (C, 3, p, p)
    tokens = [state["encoder.cls_token"].reshape(1, -1)]
    if "encoder.register_tokens" in state:
        tokens.append(state["encoder.register_tokens"][0])
    out = {
        pre + "input_conditioner.norm_mean":
            state["encoder.norm_mean"].reshape(1, 3, 1, 1),
        pre + "input_conditioner.norm_std":
            state["encoder.norm_std"].reshape(1, 3, 1, 1),
        pre + "model.patch_generator.embedder.weight":
            w.permute(0, 2, 3, 1).reshape(w.shape[0], -1),
        pre + "model.patch_generator.embedder.bias":
            state["encoder.patch_embed.bias"],
        pre + "model.patch_generator.pos_embed":
            state["encoder.pos_embed"][None],
        pre + "model.patch_generator.cls_token.token": torch.cat(tokens),
    }
    for key, val in state.items():
        for ours in ("encoder.blocks.", "encoder.norm."):
            if key.startswith(ours):
                out[pre + "model." + key[len("encoder."):]] = val
    return out


def write_snapshot(folder: str, state: Dict[str, torch.Tensor],
                   shards: int = 1) -> str:
    """Write `state` as an HF snapshot in `folder`: model.safetensors, or
    `shards` files model-0000i-of-0000n.safetensors of about equal size and
    model.safetensors.index.json mapping each key to its file."""
    from mapanything_tpu_torch.utils.weights import write_safetensors

    os.makedirs(folder, exist_ok=True)
    if shards == 1:
        write_safetensors(os.path.join(folder, "model.safetensors"), state)
        return folder
    sizes = {k: v.numel() * v.element_size() for k, v in state.items()}
    total = sum(sizes.values())
    parts = [dict() for _ in range(shards)]
    done = 0
    for key, val in state.items():
        parts[min(shards - 1, done * shards // total)][key] = val
        done += sizes[key]
    weight_map = {}
    for i, part in enumerate(parts):
        name = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        write_safetensors(os.path.join(folder, name), part)
        weight_map.update(dict.fromkeys(part, name))
    with open(os.path.join(folder, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    return folder
