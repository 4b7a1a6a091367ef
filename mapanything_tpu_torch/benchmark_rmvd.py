"""Robust-MVD benchmark CLI; counterpart of scripts/benchmark_rmvd.py (the
reference's benchmarking/rmvd_mvs_benchmark/benchmark.py).

Hands benchmarks/rmvd.py::RMVDAdaptor to the external `rmvd` package's
evaluation with the reference's call shape (benchmark.py:63-117):
`create_dataset(name, "mvd", input_size, root)`, `create_evaluation("mvd",
out_dir, inputs, alignment, max_source_views=7)`, then
`evaluation(dataset=..., model=adaptor)`. The package is imported only
there; without it the CLI says so and exits 2. `--selftest` runs the same
adaptor through the package-free `evaluate_mvs_depth` on seeded samples.

    python -m mapanything_tpu_torch.benchmark_rmvd --dataset eth3d \\
        --data-root DIR --checkpoint CKPT --conditioning image+intrinsics \\
        --out out/rmvd
    python -m mapanything_tpu_torch.benchmark_rmvd --selftest --device cpu

`--checkpoint` is read by models/pretrained.py::from_pretrained (bf16);
without it the model is a tiny one with its seeded init: the JAX script's
in fp32 on the CPU, and on the card, whose kernels take bf16 at head dim
64, the same in bf16 with the DINOv2-S encoder and one trunk head.
`--device` (the card unless it says "cpu") takes the place of the JAX
script's platform choice.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

# scripts/benchmark_rmvd.py's random-weights model (fp32)
SELFTEST_CONFIG = dict(
    encoder_size="test", trunk_dim=64, trunk_depth=2, trunk_num_heads=2,
    trunk_indices=(0, 1), dpt_feature_dim=32,
    dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
# its twin on the card: bf16 at head dim 64, what the attention kernel takes
CARD_SELFTEST_CONFIG = dict(SELFTEST_CONFIG, encoder_size="small",
                            trunk_num_heads=1)
MAX_SOURCE_VIEWS = 7  # the reference's benchmark.py:88 (MVSAnywhere)


def build_adaptor(args):
    from .benchmarks.rmvd import RMVDAdaptor
    from .models import MapAnything, MapAnythingConfig
    from .models.pretrained import from_pretrained
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    if args.checkpoint:
        model = from_pretrained(args.checkpoint, device=device)
    else:  # random weights: contract and selftest runs
        cfg = (MapAnythingConfig(dtype=torch.float32, **SELFTEST_CONFIG)
               if device.type == "cpu" else
               MapAnythingConfig(dtype=torch.bfloat16, **CARD_SELFTEST_CONFIG))
        model = MapAnything(
            cfg, device=device,
            generator=torch.Generator(device=device).manual_seed(0)).eval()
    adaptor = RMVDAdaptor(model, inference_conditioning=args.conditioning,
                          evaluate_single_view=args.views == "single_view")
    adaptor.name = args.name
    return adaptor


def run_external(args) -> dict:
    """Drive the `rmvd` harness (the reference's benchmark.py:63-121)."""
    from rmvd import create_dataset, create_evaluation

    w, h = args.resolution
    dataset = create_dataset(args.dataset, "mvd", input_size=(h, w),
                             root=os.path.join(args.data_root, args.dataset))
    inputs = []
    if "intrinsics" in args.conditioning:
        inputs.append("intrinsics")
    if "pose" in args.conditioning:
        inputs.append("poses")
    evaluation = create_evaluation(
        evaluation_type="mvd", out_dir=args.out, inputs=inputs,
        alignment=None if args.alignment == "none" else args.alignment,
        eval_uncertainty=False, max_source_views=MAX_SOURCE_VIEWS)
    results = evaluation(dataset=dataset, model=build_adaptor(args))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "setting.json"), "w") as f:
        json.dump(vars(args), f, indent=1)
    return {"results": repr(results)}


def selftest_samples(res: int, count: int = 2, views: int = 2):
    """`count` seeded RMVD samples of `views` views: uint8 images of res x
    res, a uniform GT depth, the same K for every view, identity poses."""
    rng = np.random.default_rng(0)
    h = w = res
    k = np.array([[[w / 2.0, 0, w / 2], [0, w / 2.0, h / 2], [0, 0, 1]]],
                 np.float32)
    samples = []
    for _ in range(count):
        samples.append({
            "images": [rng.integers(0, 255, size=(1, 3, h, w)).astype(
                np.uint8) for _ in range(views)],
            "keyview_idx": 0,
            "gt_depth": rng.uniform(1, 4, size=(h, w)).astype(np.float32),
            "intrinsics": [k] * views,
            "poses": [np.eye(4, dtype=np.float32)[None]] * views,
        })
    return samples


def run_selftest(args) -> dict:
    """The adaptor through the package-free evaluation loop."""
    from .benchmarks.rmvd import evaluate_mvs_depth

    metrics = evaluate_mvs_depth(build_adaptor(args),
                                 selftest_samples(args.selftest_res))
    if not np.isfinite(metrics["depth_abs_rel"]):
        raise RuntimeError(f"selftest metrics are not finite: {metrics}")
    return metrics


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mapanything_tpu_torch.benchmark_rmvd",
        description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="eth3d",
                    help="rmvd dataset name (eth3d, kitti, scannet, ...)")
    ap.add_argument("--data-root", default="",
                    help="external_benchmark_data_root (benchmark.py:58)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--name", default="mapanything_tpu_torch")
    ap.add_argument("--conditioning", default="image",
                    choices=("image", "image+intrinsics",
                             "image+intrinsics+pose"))
    ap.add_argument("--views", default="multi_view",
                    choices=("multi_view", "single_view"))
    ap.add_argument("--alignment", default="median",
                    help="rmvd alignment mode or 'none'")
    ap.add_argument("--resolution", type=int, nargs=2, default=(518, 384),
                    metavar=("W", "H"))
    ap.add_argument("--out", default="out/rmvd")
    ap.add_argument("--selftest", action="store_true",
                    help="run the adaptor through the built-in evaluation "
                         "loop (no rmvd package needed)")
    ap.add_argument("--selftest-res", type=int, default=56)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card by default")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parser().parse_args(argv)
    if args.selftest:
        out = run_selftest(args)
    else:
        try:
            import rmvd  # noqa: F401
        except ImportError:
            print("ERROR: the `rmvd` package is not installed; the external "
                  "harness cannot run. Use --selftest for the adaptor-"
                  "contract check, or install rmvd where that is possible.",
                  file=sys.stderr)
            return 2
        out = run_external(args)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
