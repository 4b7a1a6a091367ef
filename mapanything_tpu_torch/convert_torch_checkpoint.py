"""Convert a checkpoint in the reference's layout into a file of this
package; counterpart of scripts/convert_torch_checkpoint.py.

Reads a MapAnything or DINOv2 state dict (an HF snapshot directory, a
*.safetensors file, or a torch file holding the state dict directly or
under "model" / "state_dict"), prints what it holds, maps it with
utils/weights.py's conversion rules onto the port's model, and writes the
model's state dict with train/checkpoints.py::save_params. A MapAnything
file loads with models/pretrained.py::from_pretrained (bitwise the
converted weights); a DINOv2 file holds a nn/dinov2.py::DinoViT.

    python -m mapanything_tpu_torch.convert_torch_checkpoint \
        --input model.safetensors --output model.pt \
        [--kind auto|mapanything|dinov2] [--report] [--device cpu]

`--report` prints the key groups (utils/weights.py::inspect_state_dict).
The architecture's fields that the shapes cannot give (the encoder size,
heads, the taps of a flat trunk) are the released config's, or
`main(argv, config_overrides)`'s. Torch files load with weights_only=True
(the JAX package's script loads them with weights_only=False).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import numpy as np
import torch


def _dinov2_size(sd) -> str:
    """The nn/dinov2.py size whose width and depth the state dict has."""
    from .nn.dinov2 import DINOV2_CONFIGS

    dim = int(np.shape(sd["pos_embed"])[-1])
    depth = 0
    while f"blocks.{depth}.norm1.weight" in sd:
        depth += 1
    for size, cfg in DINOV2_CONFIGS.items():
        if (cfg["embed_dim"], cfg["depth"]) == (dim, depth):
            return size
    raise ValueError(f"no DINOv2 size of width {dim} and depth {depth} "
                     f"(nn/dinov2.py has {sorted(DINOV2_CONFIGS)})")


def _leaves(tree) -> int:
    return sum(_leaves(v) if isinstance(v, dict) else 1 for v in tree.values())


def convert_dinov2_model(sd, device) -> tuple:
    """(a DinoViT holding a torch-hub DINOv2 state dict, the number of
    tensors the conversion took)."""
    from .nn.dinov2 import DinoViT
    from .utils.weights import convert_dinov2, load_jax_params

    registers = (int(np.shape(sd["register_tokens"])[1])
                 if "register_tokens" in sd else 0)
    model = DinoViT(_dinov2_size(sd),
                    patch_size=int(np.shape(sd["patch_embed.proj.weight"])[-1]),
                    num_register_tokens=registers, device=device)
    tree = convert_dinov2(sd)
    return load_jax_params(model, tree).eval(), _leaves(tree)


def main(argv=None,
         config_overrides: Optional[Dict[str, Any]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--kind", default="auto",
                    choices=["auto", "mapanything", "dinov2"])
    ap.add_argument("--report", action="store_true",
                    help="print the key-group inventory and unconverted keys")
    ap.add_argument("--device", default=None,
                    help="'cpu' to build the model on the CPU; the card by "
                         "default")
    args = ap.parse_args(argv)

    from .models.pretrained import _state_dict, convert_reference
    from .train.checkpoints import save_params
    from .utils.device import resolve_device
    from .utils.weights import inspect_state_dict

    device = resolve_device(args.device)
    sd, reference = _state_dict(args.input)
    if not reference:
        raise ValueError(f"{args.input}: already a file of this package "
                         "(models/pretrained.py::from_pretrained reads it)")
    print(f"loaded {len(sd)} tensors from {args.input}")
    if args.report:
        for group, count in inspect_state_dict(sd, depth=2).items():
            print(f"  {group}: {count}")

    kind = args.kind
    if kind == "auto":
        kind = "dinov2" if "blocks.0.attn.qkv.weight" in sd else "mapanything"

    if kind == "dinov2":
        model, used = convert_dinov2_model(sd, device)
        print(f"converted DINOv2 encoder ({used}/{len(sd)} tensors)")
    else:
        model, report = convert_reference(sd, config_overrides=config_overrides,
                                          device=device, strict=False)
        aliases, unconverted = report["aliases"], report["unconverted"]
        if aliases:
            print(f"skipped {len(aliases)} known duplicate keys "
                  "(dense_head.* Sequential aliases / mask_token)")
        if unconverted:
            print(f"WARNING: {len(unconverted)} unmapped keys, e.g. "
                  f"{unconverted[:5]} — extend utils/weights.py mapping "
                  "rules against this checkpoint")
        if report["inferred"]:
            print(f"inferred architecture from shapes: {report['inferred']}")

    save_params(args.output, model)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
