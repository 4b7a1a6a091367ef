"""The ModularDUSt3R family: the program's two-view DUSt3R made from a
configuration file and a state dict, the calls a window drives, and the
comparison of their outputs with the plain reference.

Entries (a traffic file's "entry"):
  * "forward": `models/modular_dust3r.py::ModularDUSt3R.forward` under
    `torch.inference_mode` on one call's pairs, a host array of
    (batch, 2, H, W, 3) normalised pixels copied to the card in the call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..harness import compare
from ..reference import modular_dust3r as reference

spec = reference.param_spec
IMAGE_MEAN, IMAGE_STD = reference.IMAGE_MEAN, reference.IMAGE_STD


def _port_config(cfg: dict):
    from mapanything_tpu_torch.models.modular_dust3r import ModularDUSt3RConfig
    from mapanything_tpu_torch.nn.croco import CROCO_CONFIGS

    widths = dict(embed_dim=cfg["encoder_embed_dim"],
                  depth=cfg["encoder_depth"], num_heads=cfg["encoder_num_heads"])
    sizes = [name for name, w in CROCO_CONFIGS.items() if w == widths]
    if not sizes:
        raise ValueError(f"the program has no CroCo encoder of {widths}")
    return ModularDUSt3RConfig(
        encoder_size=sizes[0], patch_size=cfg["patch_size"],
        decoder_dim=cfg["decoder_dim"], decoder_depth=cfg["decoder_depth"],
        decoder_num_heads=cfg["decoder_num_heads"],
        dtype=getattr(torch, cfg["compute_dtype"]))


def build(cfg: dict, sd: dict, device):
    from mapanything_tpu_torch.models.modular_dust3r import ModularDUSt3R

    model = ModularDUSt3R(_port_config(cfg), device=device)
    model.load_state_dict(sd, strict=True)
    return model


def call_flops(cfg: dict, traffic: dict) -> int:
    return reference.flops(cfg, traffic["batch"], traffic["views"],
                           traffic["height"], traffic["width"])


def attention_calls(cfg: dict, traffic: dict) -> list:
    return reference.attention_calls(cfg, traffic["batch"], traffic["views"],
                                     traffic["height"], traffic["width"])


def host_inputs(images: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(images)


def make_call(model, traffic: dict, seed: int):
    if traffic["entry"] != "forward":
        raise ValueError(f"ModularDUSt3R has no entry {traffic['entry']!r}")
    device = next(model.parameters()).device

    def call(pairs):
        with torch.inference_mode():
            return model({"img": torch.from_numpy(pairs).to(device)})
    return call


def collect(outputs: dict) -> dict:
    return outputs


def run_reference(sd: dict, cfg: dict, images: np.ndarray, device,
                  precision: str = "fp32") -> dict:
    return reference.forward(sd, cfg, torch.from_numpy(images).to(device),
                             precision)


def numbers(got: dict, ref: dict) -> dict:
    """Relative L2 gaps of both branches' points and of their confidences'
    logits, log(conf - 1), which undo the adaptor's exponential."""
    return {"pts3d": compare.rel_l2(got["pts3d"], ref["pts3d"]),
            "conf": compare.rel_l2(torch.log(got["conf"] - 1.0),
                                   torch.log(ref["conf"] - 1.0))}
