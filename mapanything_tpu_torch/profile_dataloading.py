"""The input pipeline's throughput without the model; counterpart of
scripts/profile_dataloading.py (the reference's
train/profile_dataloading.py).

Runs epochs of the training loader (train/loop.py::build_dataset_mix and
data/loader.py::get_train_data_loader, as the training CLI builds them),
copies each batch to the device as the trainer does
(utils/device.py::to_device, then a synchronise), and prints each epoch's
batch count, the block timers (each epoch's wall, and the copies') and the
images per second over the whole run.

    python -m mapanything_tpu_torch.profile_dataloading --wai_root /data/wai \
        --dataset_spec "32 @ WAIDataset(ROOT=wai_root, spec='eth3d', \
        num_views=4, covisibility_thres=0.25, resolution=(518, 392), \
        seed=0)" [--epochs 2] [--max_imgs_per_device 48] [--num_workers 8] \
        [--device cpu]

`main(argv)` returns {"batches": per epoch, "images", "seconds",
"images_per_s", "timers"}.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wai_root", required=True)
    ap.add_argument("--dataset_spec", required=True)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--max_imgs_per_device", type=int, default=48)
    ap.add_argument("--num_workers", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="'cpu' to copy the batches nowhere; the card by "
                         "default")
    args = ap.parse_args(argv)

    import torch

    from .data.loader import get_train_data_loader
    from .perf.timing import BlockTimeManager, block_timer
    from .train.loop import build_dataset_mix
    from .utils.device import resolve_device, to_device

    device = resolve_device(args.device)
    dataset = build_dataset_mix(args.dataset_spec, wai_root=args.wai_root)
    loader = get_train_data_loader(
        dataset, max_num_of_imgs_per_gpu=args.max_imgs_per_device,
        num_workers=args.num_workers,
    )

    timers = BlockTimeManager()
    batches, total_imgs = [], 0
    t_start = time.perf_counter()
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        n_batches = 0
        with block_timer(f"epoch_{epoch}", timers):
            for batch in loader:
                with block_timer("to_device", timers):
                    to_device(batch, device)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                b, v = batch["views"]["img"].shape[:2]
                total_imgs += b * v
                n_batches += 1
        batches.append(n_batches)
        print(f"epoch {epoch}: {n_batches} batches")
    elapsed = time.perf_counter() - t_start
    print(timers)
    print(f"TOTAL: {total_imgs} images in {elapsed:.2f}s "
          f"-> {total_imgs / elapsed:.1f} images/s "
          f"({args.num_workers} workers)")
    return {"batches": batches, "images": total_imgs, "seconds": elapsed,
            "images_per_s": total_imgs / elapsed, "timers": timers.summary()}


if __name__ == "__main__":
    main()
