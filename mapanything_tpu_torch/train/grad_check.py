"""Flash against math attention on the gradient of a training loss.

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
  * the same two readings for each term of the released loss
    (`term_losses`); another criterion (`compare(loss_fn=...)`) is read as
    a whole.

`compare_sharded` reads the view-sharded loss and gradient
(train/seq_parallel.py) against the unsharded ones the same ways.

Both take a `geom_cfg`: the forwards then feed the batch's views with
their priors (the noise perturbs the image alone), and where the config
draws at random each forward gets its own generator seeded `seed` on the
batch's device, so that every forward sees the same masks.

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


def _rel_l2(a: torch.Tensor, b: torch.Tensor,
            chunk: int = 1 << 26) -> float:
    """|a - b| / |b| with fp64 sums, over chunks of the flat vectors: a
    flat gradient of a billion parameters would take 8 GiB in fp64."""
    diff = ref = 0.0
    for i in range(0, a.numel(), chunk):
        x, y = a[i:i + chunk].double(), b[i:i + chunk].double()
        diff += float((x - y).square().sum())
        ref += float(y.square().sum())
    return (diff / max(ref, 1e-60)) ** 0.5


NOISE, NOISE_SEED = 1e-3, 5


def _noisy(img: torch.Tensor) -> torch.Tensor:
    """img + N(0, NOISE^2) noise from NOISE_SEED."""
    gen = torch.Generator(device=img.device).manual_seed(NOISE_SEED)
    return img + NOISE * torch.randn(img.shape, generator=gen,
                                     device=img.device)


def _float_outputs(preds: Dict) -> list:
    """The predictions a parameter reaches (a model without the scale
    token predicts a constant metric scale of 1)."""
    return [v for _, v in sorted(preds.items())
            if v.is_floating_point() and v.requires_grad]


def _flat_grad(outputs, params, cotangents=None,
               retain_graph: bool = True) -> torch.Tensor:
    """The gradient of `outputs` (pulled back from `cotangents`) with
    respect to every parameter, flattened into one vector."""
    grads = torch.autograd.grad(outputs, params, cotangents,
                                retain_graph=retain_graph, allow_unused=True)
    return torch.cat([(torch.zeros_like(p) if g is None else g).flatten()
                      for g, p in zip(grads, params)])


def _inputs(batch: Dict, geom_cfg, seed: int):
    """(views, geom_cfg, generator factory) of one reading: the images alone
    without a geom_cfg; else the batch's views, and a fresh generator
    seeded `seed` per forward where `geom_cfg` draws at random."""
    from ..models import images_only_config

    views = batch["views"]
    if geom_cfg is None:
        return {"img": views["img"]}, images_only_config(), lambda: None
    img = views["img"]
    draws = (not geom_cfg.deterministic()) or geom_cfg.sparse_depth_prob > 0

    def generator():
        if not draws:
            return None
        return torch.Generator(device=img.device).manual_seed(seed)

    return views, geom_cfg, generator


def compare(model, batch: Dict, geom_cfg=None, seed: int = 0,
            loss_fn=None) -> Dict:
    """The readings of the module docstring for one batch ("views" with
    "img", and "gt"), with the model's current parameters; the images
    alone, or the views with their priors under `geom_cfg`.

    `loss_fn(gt, preds) -> (loss, details)` is the loss read, by default
    the released criterion (train/losses.py::overall_loss) with the
    readings of each of its terms; any other criterion (a composed
    train/criteria.py MultiLoss) is read as a whole, the pulled-back
    gradients and the total's, one forward's graph at a time."""
    per_term = loss_fn is None
    loss_fn = overall_loss if loss_fn is None else loss_fn
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    n_views = batch["gt"]["pts3d"].shape[1]
    views, geom, generator = _inputs(batch, geom_cfg, seed)

    def forward(impl, noise=False):
        img = views["img"]
        model.set_attn_impl(impl)
        try:
            preds = model(dict(views, img=_noisy(img) if noise else img),
                          geom, generator())
        finally:
            model.set_attn_impl("auto")
        loss, details = loss_fn(batch["gt"], preds)
        return loss, details, _float_outputs(preds)

    def flat(outputs, cotangents=None):
        return _flat_grad(outputs, params, cotangents)

    ends = torch.tensor([p.numel() for p in params]).cumsum(0).tolist()
    qkv = [slice(end - p.numel(), end)
           for n, p, end in zip(names, params, ends) if ".qkv." in n]

    def qkv_part(v):
        return torch.cat([v[q] for q in qkv])

    if not per_term:
        return _whole_loss_readings(forward, params, qkv_part)
    loss_m, det_m, outs_m = forward("math")
    loss_a, det_a, outs_a = forward("auto")
    loss_n, det_n, outs_n = forward("math", noise=True)
    cot = _cotangent(loss_m, outs_m)
    vjp_m, vjp_a, vjp_n = (flat(o, cot) for o in (outs_m, outs_a, outs_n))

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


def _cotangent(loss, outs) -> list:
    """d loss / d outs, zeros for an output the loss does not read."""
    return [torch.zeros_like(o) if c is None else c for c, o in zip(
        torch.autograd.grad(loss, outs, retain_graph=True,
                            allow_unused=True), outs)]


def _whole_loss_readings(forward, params, qkv_part) -> Dict:
    """compare's readings of a loss read as a whole, with one forward's
    graph alive at a time: the math forward's cotangent and its two
    gradients first, then the flash forward's and the perturbed image's,
    each held against them and freed before the next forward."""
    loss_m, _, outs_m = forward("math")
    cot = _cotangent(loss_m, outs_m)
    vjp_m = _flat_grad(outs_m, params, cot)
    full_m = _flat_grad(loss_m, params, retain_graph=False)
    del outs_m
    res = {"loss_math": loss_m.item()}
    total = {"math": res["loss_math"]}
    for impl, noise, key in (("auto", False, ""),
                             ("math", True, "_noise_floor")):
        loss, _, outs = forward(impl, noise)
        vjp = _flat_grad(outs, params, cot)
        res[f"grad{key}_rel_l2"] = _rel_l2(vjp, vjp_m)
        res[f"qkv_grad{key}_rel_l2"] = _rel_l2(qkv_part(vjp), qkv_part(vjp_m))
        del vjp, outs
        full = _flat_grad(loss, params, retain_graph=False)
        total["noise_floor_rel_l2" if noise else "flash_rel_l2"] = _rel_l2(
            full, full_m)
        del full
        if not noise:
            total["auto"] = res["loss_auto"] = loss.item()
    res["loss_rel_diff"] = (abs(res["loss_auto"] - res["loss_math"])
                            / max(abs(res["loss_math"]), 1e-30))
    res["terms"] = {"total": total}
    res["full_loss_grad_rel_l2"] = total["flash_rel_l2"]
    res["full_loss_grad_noise_floor"] = total["noise_floor_rel_l2"]
    return res


def compare_sharded(model, batch: Dict, group,
                    cfg: OverallLossConfig = OverallLossConfig(),
                    geom_cfg=None, seed: int = 0) -> Dict:
    """The view-sharded loss and parameter gradient (train/seq_parallel.py,
    over the ranks of `group`) against the unsharded ones, on the same
    model and batch ("views" with "img", and "gt"; with `geom_cfg` the
    views' priors too, the masks of both calls drawn from generators seeded
    `seed`):

      * `loss_unsharded`, `loss_sharded` and `loss_rel_diff`;
      * `grad_rel_l2`: the sharded forward's parameter gradient pulled back
        from the unsharded path's d loss / d predictions (each rank its
        views' slice of it, the replicated metric scale's at 1/p, summed
        over the ranks) against the unsharded forward's pulled back from
        the same cotangent; beside it `grad_noise_floor_rel_l2`, the
        unsharded forward on the image perturbed by N(0, 1e-3^2) from seed
        5 against it;
      * `full_loss_grad_rel_l2`: the gradient of the sharded loss (every
        rank's share, summed) against the unsharded loss's, beside
        `full_loss_grad_noise_floor` (the perturbed image's loss's); the
        released loss's branches flip under bf16-level changes (module
        docstring), so these are read, not held to a limit.

    Each forward's graph is freed before the next one is built. Every rank
    returns the same numbers."""
    import torch.distributed as dist

    from .seq_parallel import shard_views, view_sharded_overall_loss

    params = [p for _, p in model.named_parameters()]
    p = dist.get_world_size(group)
    views, geom, generator = _inputs(batch, geom_cfg, seed)
    img = views["img"]
    n_views = img.shape[1]

    def unsharded(image):
        preds = model(dict(views, img=image), geom, generator())
        loss, _ = overall_loss(batch["gt"], preds, cfg)
        return loss, _float_outputs(preds)

    loss_u, outs = unsharded(img)
    cot = _cotangent(loss_u, outs)
    vjp_u = _flat_grad(outs, params, cot)
    full_u = _flat_grad(loss_u, params, retain_graph=False)
    del outs
    loss_n, outs = unsharded(_noisy(img))
    vjp_n = _flat_grad(outs, params, cot)
    full_n = _flat_grad(loss_n, params, retain_graph=False)
    del outs, loss_n

    local, gt = shard_views(dict(batch, views=views), group)
    lo = dist.get_rank(group) * (n_views // p)
    preds = model(local, geom, generator(), seq_group=group)
    total, details = view_sharded_overall_loss(gt, preds, cfg, group)
    share = details["_share"]
    outs = _float_outputs(preds)
    # this rank's part of the shared cotangent: its views of each per-view
    # output, the replicated metric scale's at 1/p
    local_cot = [c[:, lo:lo + o.shape[1]] if c.dim() >= 2 else c / p
                 for c, o in zip(cot, outs)]
    vjp_s = _flat_grad(outs, params, local_cot)
    full_s = _flat_grad(share, params, retain_graph=False)
    del outs, preds, share, details
    for vec in (vjp_s, full_s):
        dist.all_reduce(vec, group=group)
    lu, ls = loss_u.item(), total.item()
    return {"views": n_views, "ranks": p, "loss_unsharded": lu,
            "loss_sharded": ls,
            "loss_rel_diff": abs(ls - lu) / max(abs(lu), 1e-30),
            "grad_rel_l2": _rel_l2(vjp_s, vjp_u),
            "grad_noise_floor_rel_l2": _rel_l2(vjp_n, vjp_u),
            "full_loss_grad_rel_l2": _rel_l2(full_s, full_u),
            "full_loss_grad_noise_floor": _rel_l2(full_n, full_u)}


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
    model = MapAnything(MapAnythingConfig(), generator=(
        torch.Generator(device="cuda").manual_seed(1)))
    check = make_synthetic_batch(1, 1, 518, 518, seed=1)
    train = make_synthetic_batch(1, 4, 518, 518, seed=0)
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
