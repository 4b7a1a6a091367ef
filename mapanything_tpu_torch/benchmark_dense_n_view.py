"""Dense N-view benchmark CLI; counterpart of scripts/benchmark_dense_n_view.py
(the reference's bash_scripts/benchmark/dense_n_view and
benchmarking/dense_n_view/benchmark.py).

Sweeps (batch, views) pairs of the reference protocol ((10, 2) (10, 4)
(10, 8) (5, 16) (4, 24) (2, 32) (1, 50) (1, 100) at full scale) over the
test split of a WAI dataset and writes the per-set and summary JSON:
OUTPUT_DIR/{dataset}_{views}views.json and OUTPUT_DIR/summary.json.

    python -m mapanything_tpu_torch.benchmark_dense_n_view \\
        --wai_root /data/wai --checkpoint ckpt.pt --resolution 518 392 \\
        --views 2 4 --batch_sizes 10 10 --output_dir out/bench

On the CPU, at the tiny size: add `--tiny --device cpu` (fp32, as the JAX
script's; `--tiny` on the card is bf16, the kernels' type). `--checkpoint`
is a file of train/checkpoints.py::save_params; without it the weights are
the model's seeded init and the numbers mean nothing. `--device` (the card
unless it says "cpu") takes the place of the JAX script's `--cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch

# scripts/benchmark_dense_n_view.py's --tiny model (fp32 on the CPU), head
# dim 64 throughout as the attention kernel takes it
TINY_CONFIG = dict(encoder_size="small", trunk_dim=384, trunk_depth=4,
                   trunk_num_heads=6, trunk_indices=(1, 2), dpt_feature_dim=32)
NUM_WORKERS = 2


def build_model(tiny: bool, checkpoint: Optional[str], device=None):
    """The evaluated MapAnything: the released config in bf16, or the tiny
    one (fp32 on the CPU, bf16 on the card), on `device` (the card when
    None), with the weights of a save_params `checkpoint` or the model's
    init seeded 0."""
    from .models import MapAnything, MapAnythingConfig
    from .train.checkpoints import load_params
    from .utils.device import resolve_device

    device = resolve_device(device)
    cfg = (MapAnythingConfig(dtype=torch.float32 if device.type == "cpu"
                             else torch.bfloat16, **TINY_CONFIG) if tiny
           else MapAnythingConfig(dtype=torch.bfloat16))
    if checkpoint:
        model = load_params(checkpoint, MapAnything(cfg, device=device))
    else:
        model = MapAnything(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(0))
        print("WARNING: random weights (no --checkpoint)")
    return model.eval()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mapanything_tpu_torch.benchmark_dense_n_view",
        description=__doc__.splitlines()[0])
    ap.add_argument("--wai_root", required=True)
    ap.add_argument("--dataset", default="eth3d")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--views", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--batch_sizes", type=int, nargs="+", default=None)
    ap.add_argument("--resolution", type=int, nargs=2, default=[56, 42])
    ap.add_argument("--num_sets", type=int, default=8,
                    help="multi-view sets per views-count")
    ap.add_argument("--output_dir", default="./benchmark_out")
    ap.add_argument("--task", default="images_only",
                    choices=["images_only", "all_priors"])
    ap.add_argument("--memory_efficient", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card by default")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the sweep; returns {views: summary}."""
    args = parser().parse_args(argv)
    batch_sizes = args.batch_sizes or [max(1, 20 // v) for v in args.views]
    if len(batch_sizes) != len(args.views):
        raise SystemExit("--batch_sizes needs one size per --views entry")

    from .benchmarks import run_dense_n_view_benchmark
    from .data.loader import get_test_data_loader
    from .data.wai_datasets import WAIDataset
    from .models import GeometricInputConfig, images_only_config

    model = build_model(args.tiny, args.checkpoint, args.device)
    geom_cfg = (images_only_config() if args.task == "images_only"
                else GeometricInputConfig())
    all_results = {}
    for n_views, bs in zip(args.views, batch_sizes):
        ds = WAIDataset(
            ROOT=args.wai_root, spec=args.dataset, split="test",
            num_views=n_views, covisibility_thres=0.25,
            resolution=tuple(args.resolution), data_norm_type="dinov2", seed=0)
        loader = get_test_data_loader(args.num_sets @ ds, batch_size=bs,
                                      num_workers=NUM_WORKERS)
        summary = run_dense_n_view_benchmark(
            model, loader, geom_cfg,
            output_json=os.path.join(args.output_dir,
                                     f"{args.dataset}_{n_views}views.json"),
            memory_efficient=args.memory_efficient)
        all_results[n_views] = summary
        print(f"views={n_views}: " + json.dumps(summary), flush=True)

    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
        json.dump(all_results, f, indent=1)
    print(f"wrote {args.output_dir}/summary.json")
    return all_results


if __name__ == "__main__":
    main()
