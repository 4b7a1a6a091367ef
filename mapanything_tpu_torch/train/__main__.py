"""The training CLI; counterpart of scripts/train.py.

Trains MapAnything on a mix of WAI datasets described by the dataset-mix
DSL (train/loop.py::build_dataset_mix), with the knobs of the reference's
hydra tree as flags: the model (the released config in bf16, or --tiny in
fp32), the task's prior mix, the optimizer's schedule and the dynamic
batching of views (--max_imgs_per_device images per batch, split into
batch = max_imgs_per_device // num_views samples of one aspect-ratio
bucket each).

    python -m mapanything_tpu_torch.train --wai_root /data/wai \\
        --dataset_spec "1000 @ WAIDataset(ROOT=wai_root, spec='eth3d', \\
            num_views=4, covisibility_thres=0.25, \\
            resolution=[(518, 392), (518, 336)], transform='colorjitter', \\
            seed=7)" --max_imgs_per_device 8 --output_dir runs/eth3d

On the CPU, at the tiny size: add `--tiny --device cpu` and a resolution
such as (56, 42).

Several processes train one model under torchrun:

    torchrun --nproc_per_node 4 -m mapanything_tpu_torch.train --tp 2 ...

builds the (data, model) mesh of parallel/mesh.py over the WORLD_SIZE
ranks, WORLD_SIZE / tp data ranks by tp model ranks (rank r at (r // tp,
r % tp)): the ranks of one model group split the encoder's and the trunk's
attention and MLP layers and hold the same rows; each data rank loads its
rows of the batch drawn at data-ranks times --max_imgs_per_device images
(data/loader.py::RowShardSampler), and the step is that of one process on
the whole batch (train/step.py). NCCL on the card, gloo with --device cpu.
A world that --tp does not divide raises.

The names the DSL can use are WAIDataset, make_wai_dataset and wai_root
(the --wai_root flag). The run resumes from OUTPUT_DIR/checkpoint-last
when it exists.

Differences from scripts/train.py: `--device` (the card unless it says
"cpu") takes the place of `--cpu`; `--single_device` is gone: one process
builds no mesh (it has one device), several always do.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# scripts/train.py's --tiny model (fp32)
TINY_CONFIG = dict(encoder_size="test", trunk_dim=64, trunk_depth=4,
                   trunk_num_heads=2, trunk_indices=(1, 2), dpt_feature_dim=32,
                   dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
VAL_BATCH = 2  # samples per validation batch, as scripts/train.py


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mapanything_tpu_torch.train",
        description="Train MapAnything on a mix of WAI datasets.")
    ap.add_argument("--wai_root", required=True)
    ap.add_argument("--dataset_spec", required=True,
                    help="dataset mix DSL, e.g. '100 @ WAIDataset(...)'")
    ap.add_argument("--val_dataset_spec", default=None)
    ap.add_argument("--output_dir", default="./out")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--encoder_lr_scale", type=float, default=0.05)
    ap.add_argument("--warmup_steps", type=int, default=100)
    ap.add_argument("--total_steps", type=int, default=10000)
    ap.add_argument("--max_imgs_per_device", type=int, default=48)
    ap.add_argument("--accum_steps", type=int, default=1)
    ap.add_argument("--num_workers", type=int, default=4)
    ap.add_argument("--print_freq", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model for smoke runs")
    ap.add_argument("--task", default="aug_training",
                    choices=["aug_training", "images_only"])
    ap.add_argument("--device", default=None,
                    help="'cpu' to train on the CPU; the card by default")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width: the mesh's model axis, "
                         "which must divide the world size")
    return ap


def mesh_shape(tp: int) -> tuple:
    """(n_data, n_model) of the run: the world (the process group's, else
    torchrun's WORLD_SIZE, else 1) over --tp. Raises ValueError where --tp
    does not divide the world."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if tp < 1 or world % tp:
        raise ValueError(f"--tp {tp} does not divide the world of {world} "
                         "processes")
    return world // tp, tp


def build_model(tiny: bool, device=None, seed: int = 0):
    """The model the CLI trains: the released config in bf16, or the tiny
    one in fp32, with the model's own init from a generator seeded `seed`
    on `device` (the card when None)."""
    from ..models import MapAnything, MapAnythingConfig
    from ..utils.device import resolve_device

    cfg = (MapAnythingConfig(dtype=torch.float32, **TINY_CONFIG) if tiny
           else MapAnythingConfig(dtype=torch.bfloat16))
    device = resolve_device(device)
    return MapAnything(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(seed))


def main(argv: Optional[Sequence[str]] = None):
    """Parse `argv`, build the loaders and the model, and train; returns
    the final TrainState (its model trained in place). Several processes
    (a process group already made, or torchrun's) train on a mesh."""
    args = parser().parse_args(argv)
    n_data, n_model = mesh_shape(args.tp)

    from ..data.loader import get_test_data_loader, get_train_data_loader
    from ..models import aug_training_config, images_only_config
    from ..parallel.distributed import init_distributed
    from ..parallel.mesh import make_mesh
    from .loop import TrainLoopConfig, build_dataset_mix, train
    from .step import OptimConfig

    mesh = None
    owns_group = n_data * n_model > 1 and not dist.is_initialized()
    if n_data * n_model > 1:
        init_distributed(args.device)
        mesh = make_mesh(n_data, n_model)
    main_rank = mesh is None or dist.get_rank() == 0
    try:
        dataset = build_dataset_mix(args.dataset_spec,
                                    wai_root=args.wai_root)
        train_loader = get_train_data_loader(
            dataset, max_num_of_imgs_per_gpu=args.max_imgs_per_device,
            num_workers=args.num_workers, data_shard=(
                None if mesh is None else (mesh.data_rank, mesh.n_data)))
        test_loaders = None
        if args.val_dataset_spec:
            val_ds = build_dataset_mix(args.val_dataset_spec,
                                       wai_root=args.wai_root)
            test_loaders = {"val": get_test_data_loader(
                val_ds, batch_size=VAL_BATCH, num_workers=args.num_workers)}

        model = build_model(args.tiny, args.device, args.seed)
        if main_rank:
            n_params = sum(p.numel() for p in model.parameters()) / 1e6
            print(f"model: {n_params:.1f} M parameters on "
                  f"{next(model.parameters()).device}; "
                  f"{len(train_loader)} batches an epoch"
                  + ("" if mesh is None else f"; mesh {mesh.shape}"),
                  flush=True)
        geom_cfg = (aug_training_config() if args.task == "aug_training"
                    else images_only_config())
        state = train(
            model, train_loader,
            TrainLoopConfig(output_dir=args.output_dir, epochs=args.epochs,
                            print_freq=args.print_freq, seed=args.seed),
            OptimConfig(lr=args.lr, encoder_lr_scale=args.encoder_lr_scale,
                        warmup_steps=args.warmup_steps,
                        total_steps=args.total_steps,
                        accum_steps=args.accum_steps),
            geom_cfg=geom_cfg, test_loaders=test_loaders,
            device=args.device, mesh=mesh)
        if main_rank:
            print("training finished", flush=True)
        return state
    finally:
        if owns_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
