"""Calibration benchmark CLI; counterpart of scripts/benchmark_calibration.py
(the reference's bash_scripts/benchmark/calibration and
benchmarking/calibration/benchmark.py:25-235).

The angular error, in degrees, of the predicted per-pixel ray directions of
single views over the test split of a WAI dataset; writes
OUTPUT_DIR/{dataset}_calibration.json.

    python -m mapanything_tpu_torch.benchmark_calibration \\
        --wai_root /data/wai --checkpoint ckpt.pt --resolution 518 392 \\
        --output_dir out/calib

On the CPU, at the tiny size: add `--tiny --device cpu`. `--checkpoint` and
`--device` as in benchmark_dense_n_view.py.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mapanything_tpu_torch.benchmark_calibration",
        description=__doc__.splitlines()[0])
    ap.add_argument("--wai_root", required=True)
    ap.add_argument("--dataset", default="eth3d")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--batch_size", type=int, default=10)
    ap.add_argument("--resolution", type=int, nargs=2, default=[56, 42])
    ap.add_argument("--num_sets", type=int, default=20,
                    help="single-view samples drawn from the test split")
    ap.add_argument("--output_dir", default="./calibration_out")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card by default")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the benchmark; returns its summary."""
    args = parser().parse_args(argv)

    from .benchmark_dense_n_view import NUM_WORKERS, build_model
    from .benchmarks import run_calibration_benchmark
    from .data.loader import get_test_data_loader
    from .data.wai_datasets import WAIDataset
    from .models import images_only_config

    model = build_model(args.tiny, args.checkpoint, args.device)
    # the dataset yields sets of 2 views; the harness keeps view 0 only
    ds = WAIDataset(
        ROOT=args.wai_root, spec=args.dataset, split="test", num_views=2,
        covisibility_thres=0.25, resolution=tuple(args.resolution),
        data_norm_type="dinov2", seed=0)
    loader = get_test_data_loader(args.num_sets @ ds,
                                  batch_size=args.batch_size,
                                  num_workers=NUM_WORKERS)
    summary = run_calibration_benchmark(
        model, loader, images_only_config(),
        output_json=os.path.join(args.output_dir,
                                 f"{args.dataset}_calibration.json"))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
