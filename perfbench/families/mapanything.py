"""The MapAnything family: the program's model made from a configuration
file and a state dict, the calls a window drives, and the comparison of
their outputs with the plain reference.

Entries (a traffic file's "entry"):
  * "infer": `utils/inference.py::InferencePipeline.infer` on one call's
    views, each view's images a host array of (batch, H, W, 3) normalised
    pixels, as `load_images` hands them over; the copy to the card is part
    of the call. The traffic's "infer" object gives its keyword arguments.
  * "train": one step of `train/step.py::make_train_step` (the released
    loss, clip and AdamW, OptimConfig's defaults) under the traffic's
    "task" mix of priors, its masks drawn from a generator seeded with the
    run's seed, on a host batch (harness/synthetic.py) copied to the card
    in the call. The traffic's "warmup" steps (the set-up's) record the
    losses, the first gradient as the optimizer took it and the
    parameters' change, which `train_readings` holds to the reference.
"""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from ..harness import compare
from ..reference import mapanything as reference
from ..reference import train as train_reference

# each number in units of the gap that rounding every product's operands
# to bfloat16 (the configuration's precision) opens to float32: a call's,
# or the checked steps', rounding floor. With seeded weights the raw gaps
# swing from seed to seed (ray directions normalised from short raw
# vectors; a step's sensitivity to rounding); over the floor they do not.
FLOOR_PRECISION = "bf16"

spec = reference.param_spec
IMAGE_MEAN, IMAGE_STD = reference.IMAGE_MEAN, reference.IMAGE_STD


def call_flops(cfg: dict, traffic: dict) -> int:
    """A call's products: the forward's, three times over for a training
    step (the backward counted as twice the forward; the prior encoders'
    few and the recomputation not counted)."""
    f = reference.flops(cfg, traffic["batch"], traffic["views"],
                        traffic["height"], traffic["width"])
    return 3 * f if traffic["entry"] == "train" else f


def attention_calls(cfg: dict, traffic: dict) -> list:
    return reference.attention_calls(cfg, traffic["batch"], traffic["views"],
                                     traffic["height"], traffic["width"])


def _port_config(cfg: dict):
    from mapanything_tpu_torch.models.mapanything import MapAnythingConfig
    from mapanything_tpu_torch.nn.dinov2 import DINOV2_CONFIGS

    widths = dict(embed_dim=cfg["encoder_embed_dim"],
                  depth=cfg["encoder_depth"], num_heads=cfg["encoder_num_heads"])
    sizes = [name for name, w in DINOV2_CONFIGS.items() if w == widths]
    if not sizes:
        raise ValueError(f"the program has no DINOv2 encoder of {widths}")
    return MapAnythingConfig(
        encoder_size=sizes[0], patch_size=cfg["patch_size"],
        trunk_dim=cfg["trunk_dim"], trunk_depth=cfg["trunk_depth"],
        trunk_num_heads=cfg["trunk_num_heads"],
        trunk_indices=tuple(cfg["trunk_taps"]),
        dpt_feature_dim=cfg["dpt_feature_dim"],
        dpt_hidden_dims=tuple(cfg["dpt_hidden_dims"]),
        dpt_out_channels=tuple(cfg["dpt_out_channels"]),
        dense_output_dim=cfg["dense_output_dim"],
        pose_num_resconv=cfg["pose_num_resconv"],
        dtype=getattr(torch, cfg["compute_dtype"]))


def build(cfg: dict, sd: dict, device):
    """The program's MapAnything with the state dict `sd` loaded (strict:
    every name and shape of the reference's spec)."""
    from mapanything_tpu_torch.models.mapanything import MapAnything

    model = MapAnything(_port_config(cfg), device=device)
    model.load_state_dict(sd, strict=True)
    return model


def host_inputs(item):
    """An image pool item (B, V, H, W, 3) -> the V views' contiguous
    (B, H, W, 3) arrays; a training batch as it is."""
    if isinstance(item, dict):
        return item
    return [np.ascontiguousarray(item[:, i]) for i in range(item.shape[1])]


def _to_device(batch: dict, device) -> dict:
    return {part: {k: torch.from_numpy(a).to(device) for k, a in d.items()}
            for part, d in batch.items()}


def _train_call(model, traffic: dict, seed: int):
    from mapanything_tpu_torch.models.tasks import task_config
    from mapanything_tpu_torch.train.step import (OptimConfig,
                                                  create_train_state,
                                                  make_train_step)

    device = next(model.parameters()).device
    state = create_train_state(model, OptimConfig())
    step = make_train_step(model, task_config(traffic["task"]))
    gen = torch.Generator(device=device).manual_seed(seed)
    opt = state.optimizer
    # the starting weights wait on the host, off the card's peak
    start = [p.detach().to("cpu", copy=True) for p in opt.params]
    record = {"losses": []}
    checked = traffic["warmup"]

    def norms(tensors):
        return dict(zip(opt.names, torch.stack(
            [torch.linalg.vector_norm(t) for t in tensors]).tolist()))

    def call(batch):
        nonlocal state
        state, metrics = step(state, _to_device(batch, device), gen)
        if len(record["losses"]) < checked:
            record["losses"].append(float(metrics["loss"]))
            if len(record["losses"]) == 1:  # the clipped gradient, from mu
                record["grad"] = norms([m / (1 - opt.cfg.b1) for m in opt.mu])
            if len(record["losses"]) == checked:
                record["change"] = norms([p.detach() - p0.to(device)
                                          for p, p0 in zip(opt.params, start)])
                start.clear()
        return metrics

    call.record = record
    return call


def make_call(model, traffic: dict, seed: int):
    """call(inputs) -> outputs, for the traffic's entry."""
    if traffic["entry"] == "train":
        return _train_call(model, traffic, seed)
    if traffic["entry"] != "infer":
        raise ValueError(f"MapAnything has no entry {traffic['entry']!r}")
    from mapanything_tpu_torch.utils.inference import InferencePipeline

    pipeline = InferencePipeline(model)
    kwargs = dict(traffic.get("infer", {}))

    def call(views):
        return pipeline.infer([{"img": img, "data_norm_type": "dinov2"}
                               for img in views], **kwargs)
    return call


KEYS = ("pts3d", "ray_directions", "depth_along_ray", "conf", "mask",
        "non_ambiguous_mask_logits", "cam_quats", "cam_trans")


def collect(outputs: list) -> dict:
    """infer's per-view dicts -> (B, V, ...) tensors of the compared keys."""
    out = {key: torch.stack([view[key] for view in outputs], dim=1)
           for key in KEYS}
    out["metric_scaling_factor"] = outputs[0]["metric_scaling_factor"]
    return out


def run_reference(sd: dict, cfg: dict, images: np.ndarray, device,
                  precision: str = "fp32") -> dict:
    img = torch.from_numpy(images).to(device)
    return reference.infer(sd, cfg, img, precision)


def numbers(got: dict, ref: dict) -> dict:
    """The gaps of one call, each a relative L2 gap unless said otherwise:
    the world points, and the log of the depth along the ray over the
    metric scale, where both masks keep the pixel; the ray directions; the
    confidence's logit, log(conf - 1); the mask's logits; the poses
    (quaternion, and translation, which carries the metric scale as the
    points do); and the share of pixels whose mask differs. The logs undo
    the adaptors' exponentials (and the depth's scale), so a gap in the
    dense head's raw output is not hidden under their offsets. The metric
    scale, one number a scene, has no gap of its own: its rounding gap
    swings from call to call by nature."""
    both = got["mask"][..., 0] & ref["mask"][..., 0]

    def log_depth(out):
        s = out["metric_scaling_factor"][:, None, None, None, None]
        return torch.log(torch.where(both[..., None],
                                     out["depth_along_ray"] / s, 1.0))

    def pose(out):
        return torch.cat([out["cam_quats"], out["cam_trans"]], -1)

    return {
        "pts3d": compare.rel_l2(got["pts3d"], ref["pts3d"], both),
        "depth": compare.rel_l2(log_depth(got), log_depth(ref), both),
        "ray_dirs": compare.rel_l2(got["ray_directions"],
                                   ref["ray_directions"]),
        "conf": compare.rel_l2(torch.log(got["conf"] - 1.0),
                               torch.log(ref["conf"] - 1.0)),
        "mask_logits": compare.rel_l2(got["non_ambiguous_mask_logits"],
                                      ref["non_ambiguous_mask_logits"]),
        "pose": compare.rel_l2(pose(got), pose(ref)),
        "mask": compare.mismatch(got["mask"], ref["mask"]),
    }


def train_numbers(got: dict, ref: dict) -> dict:
    """The training gaps, by parameter: the gap between the program's and
    the reference's norms over the larger of the reference's norm of that
    parameter and of the median parameter; of the first gradient the
    median parameter's gap, of the change over the checked steps the 95th
    percentile's. Parameters whose reference gradient is under a
    thousandth of the median one's (zero to rounding, moved by Adam's
    round-off alone) are left out. The worst parameter's gaps swing from
    seed to seed with a few parameters' own sensitivity to rounding (one
    seed in thirty read 0.28 on the first gradient of the dense head's
    regressor, the reference with bf16 operands 0.29 there). The losses'
    gap, by step, is only printed: the float8 control's overlaps the
    program's."""
    med_g = statistics.median(ref["grad"].values())
    kept = [k for k, g in ref["grad"].items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][k] for k in kept)

    def gaps(key, med):
        return [abs(got[key][k] - ref[key][k]) / max(ref[key][k], med)
                for k in kept]

    return {"grad": statistics.median(gaps("grad", med_g)),
            "change": statistics.quantiles(gaps("change", med_c), n=20)[18]}


def loss_gaps(got: dict, ref: dict) -> list:
    """Each checked step's relative loss gap."""
    return [abs(g - r) / abs(r) for g, r in zip(got["losses"],
                                                ref["losses"])]


def train_readings(record: dict, sd: dict, cfg: dict, traffic: dict,
                   pool: list, seed: int, device, control=None):
    """(the program's numbers, the control's or None): the reference's
    steps on the set-up's batches (the traffic's "warmup" steps, each on
    its own pool item), with masks from a generator seeded as the
    program's was. Each number is the gap over the same gap of the
    reference with bf16 operands: how far a seed's steps move under
    rounding swings from seed to seed, for the program and the float8
    control alike, so that raw gaps of the two overlap; over that floor
    they stand apart."""
    batches = [_to_device(pool[k % len(pool)], device)
               for k in range(traffic["warmup"])]
    mix = traffic["priors"]

    def steps(precision):
        gen = torch.Generator(device=device).manual_seed(seed)
        return train_reference.train_steps(sd, cfg, batches, mix, gen,
                                           precision)

    ref = steps("fp32")
    floor = train_numbers(steps(FLOOR_PRECISION), ref)
    gaps = train_numbers(record, ref)
    print(f"perfbench: loss gaps by step {loss_gaps(record, ref)}; "
          f"train gaps {gaps} floor {floor}", file=sys.stderr)
    ctl = None
    if control is not None:
        ctl = compare.over_floor(train_numbers(steps(control), ref), floor)
    return compare.over_floor(gaps, floor), ctl
