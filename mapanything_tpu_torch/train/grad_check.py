"""Flash against math attention on the gradient of the released loss.

    python -m mapanything_tpu_torch.train.grad_check [--steps 14] [--out FILE]

`compare` runs one batch through the model twice, with attn_impl "auto"
(the flash kernels on the card) and "math", and reads the parameter
gradient three ways:

  * pulled back from one shared cotangent, the math path's d loss / d
    predictions: this holds the network, where the attention runs, to the
    math path (`grad_rel_l2`, and `qkv_grad_rel_l2` over the attention's
    qkv weights alone), each beside its noise floor (below). How far
    bf16-level differences of the forward are amplified here depends on
    the parameters: a seeded init reads the same in every run, a state
    reached by training steps (which are not bitwise deterministic on the
    GPU) differs from run to run;
  * of the whole loss (`full_loss_grad_rel_l2`), beside its noise floor:
    the math path against itself with the image perturbed by N(0, 1e-3^2)
    from seed 5 (`full_loss_grad_noise_floor`). The released loss has
    branches that a bf16-level change flips (the quaternion double cover
    min(|q - gt|, |q + gt|) and the exclude-top-N% ranking), so this
    gradient can move by O(1) between two equally valid forwards;
  * the same two readings for each term of the loss (`term_losses`).

The command line builds the released MapAnythingConfig() on the GPU with
the model's own seeded init, as chip_smoke.py's training phase does, and
reads `compare` on a 1-view 518x518 batch before each of `--steps` train
steps on a 4-view batch, one JSON line per model state.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict

import torch

from .losses import OverallLossConfig, overall_loss

_CONF = re.compile(r"(.+)_conf_loss_view\d+$")
_EXCLUDE = re.compile(r"(.+)_bot[\d.]+%_view\d+$")
_MASK = re.compile(r"NonAmbiguousMaskLoss_mask_view\d+$")
_PIXEL = re.compile(r"FactoredGeometry\w+?_(.+)_view\d+$")


def term_losses(details: Dict[str, torch.Tensor], n_views: int,
                cfg: OverallLossConfig = OverallLossConfig()
                ) -> Dict[str, torch.Tensor]:
    """overall_loss's total as a sum of named scalar terms, summed over the
    views, from its details: the conf-weighted set, the exclude-top-N% sets,
    every set reduced plainly and the weighted mask loss. Raises if the
    terms do not add up to details["total"]."""
    terms: Dict[str, torch.Tensor] = {}

    def add(name, value):
        terms[name] = terms.get(name, 0.0) + value

    wrapped = set()
    for key, val in details.items():
        for pattern, kind in ((_CONF, "conf"), (_EXCLUDE, "exclude top")):
            m = pattern.match(key)
            if m:
                add(f"{m.group(1)} ({kind})", val)
                wrapped.add(m.group(1))
    for key, val in details.items():
        m = _PIXEL.match(key)
        if m and m.group(1) not in wrapped:
            add(m.group(1), val)
        elif _MASK.match(key):
            add("non_ambiguous_mask", cfg.mask_loss_weight * val)
    if n_views > 2:
        terms = {k: v * (2.0 / n_views) for k, v in terms.items()}
    total = details["total"].detach()
    err = float((sum(terms.values()).detach() - total).abs())
    if not err <= 1e-4 * max(float(total.abs()), 1e-6):
        raise ValueError(f"the loss terms miss the total by {err:.3e}")
    return terms


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


NOISE, NOISE_SEED = 1e-3, 5


def compare(model, batch: Dict) -> Dict:
    """The readings of the module docstring for one batch ("views" with
    "img", and "gt"), with the model's current parameters."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    n_views = batch["gt"]["pts3d"].shape[1]

    def forward(impl, noise=False):
        img = batch["views"]["img"]
        if noise:
            gen = torch.Generator(device=img.device).manual_seed(NOISE_SEED)
            img = img + NOISE * torch.randn(img.shape, generator=gen,
                                            device=img.device)
        model.set_attn_impl(impl)
        try:
            preds = model({"img": img})
        finally:
            model.set_attn_impl("auto")
        loss, details = overall_loss(batch["gt"], preds)
        outs = [v for _, v in sorted(preds.items()) if v.is_floating_point()]
        return loss, details, outs

    def flat(outputs, cotangents=None):
        grads = torch.autograd.grad(outputs, params, cotangents,
                                    retain_graph=True, allow_unused=True)
        return torch.cat([(torch.zeros_like(p) if g is None else g).flatten()
                          for g, p in zip(grads, params)])

    loss_m, det_m, outs_m = forward("math")
    loss_a, det_a, outs_a = forward("auto")
    loss_n, det_n, outs_n = forward("math", noise=True)
    cot = [torch.zeros_like(o) if c is None else c for c, o in zip(
        torch.autograd.grad(loss_m, outs_m, retain_graph=True,
                            allow_unused=True), outs_m)]
    vjp_m, vjp_a, vjp_n = (flat(o, cot) for o in (outs_m, outs_a, outs_n))
    ends = torch.tensor([p.numel() for p in params]).cumsum(0).tolist()
    qkv = [slice(end - p.numel(), end)
           for n, p, end in zip(names, params, ends) if ".qkv." in n]

    def qkv_part(v):
        return torch.cat([v[q] for q in qkv])

    la, lm = loss_a.item(), loss_m.item()
    res = {"loss_auto": la, "loss_math": lm,
           "loss_rel_diff": abs(la - lm) / max(abs(lm), 1e-30),
           "grad_rel_l2": _rel_l2(vjp_a, vjp_m),
           "grad_noise_floor_rel_l2": _rel_l2(vjp_n, vjp_m),
           "qkv_grad_rel_l2": _rel_l2(qkv_part(vjp_a), qkv_part(vjp_m)),
           "qkv_grad_noise_floor_rel_l2": _rel_l2(qkv_part(vjp_n),
                                                  qkv_part(vjp_m))}
    del vjp_m, vjp_a, vjp_n, cot, outs_m, outs_a, outs_n

    tm, ta, tn = (term_losses(d, n_views) for d in (det_m, det_a, det_n))
    pairs = {"total": (loss_m, loss_a, loss_n),
             **{k: (tm[k], ta[k], tn[k]) for k in tm}}
    res["terms"] = {}
    for name, (m, a, n) in pairs.items():
        g_m, g_a, g_n = (flat(x) if x.requires_grad else None
                         for x in (m, a, n))
        if g_m is None:  # a term that no parameter reaches (0 at 1 view)
            continue
        res["terms"][name] = {"math": m.item(), "auto": a.item(),
                              "flash_rel_l2": _rel_l2(g_a, g_m),
                              "noise_floor_rel_l2": _rel_l2(g_n, g_m)}
        del g_m, g_a, g_n
    res["full_loss_grad_rel_l2"] = res["terms"]["total"]["flash_rel_l2"]
    res["full_loss_grad_noise_floor"] = (
        res["terms"]["total"]["noise_floor_rel_l2"])
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=14,
                        help="train steps on the 4-view batch")
    parser.add_argument("--out", help="also write the JSON lines here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("grad_check needs a CUDA device", file=sys.stderr)
        return 1
    from ..data.synthetic import make_synthetic_batch
    from ..models import MapAnything, MapAnythingConfig, images_only_config
    from .step import OptimConfig, create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = MapAnything(MapAnythingConfig(), device="cuda", generator=(
        torch.Generator(device="cuda").manual_seed(1)))
    check = make_synthetic_batch(1, 1, 518, 518, seed=1, device="cuda")
    train = make_synthetic_batch(1, 4, 518, 518, seed=0, device="cuda")
    state = create_train_state(model, OptimConfig(warmup_steps=2,
                                                  total_steps=100))
    step = make_train_step(model, images_only_config())
    out = open(args.out, "w") if args.out else None
    try:
        for i in range(args.steps + 1):
            res = {"state": f"after {i} steps", **compare(model, check)}
            line = json.dumps(res)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
            if i < args.steps:
                state, _ = step(state, train)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
