"""Per-source dataset -> WAI conversion CLI with its follow-on stages;
counterpart of scripts/convert_dataset.py.

The reference runs each dataset's conversion as its own slurm script
(data_processing/wai_processing/scripts/conversion/<source>.py via
convert_scenes_wrapper); this CLI drives the same recipes over a local
tree, one scene after another, with the stages the reference schedules
separately:

    python -m mapanything_tpu_torch.convert_dataset eth3d RAW WAI
    python -m mapanything_tpu_torch.convert_dataset scannetppv2 RAW WAI \\
        --test-split-file test_scenes.txt --undistort --render-depth

The conversion and the undistortion run on the host; the mesh ray cast
(`--render-depth`) and the MoGe labelling (`--pseudo-depth MOGE_CKPT`, a
MoGe model pickled whole, which runs code as it loads: a trusted file only)
run on the card, or on the CPU with `--device cpu`.
Without a card and without `--device cpu` the CLI raises before it
converts anything. Generic COLMAP captures go through `python -m
mapanything_tpu_torch.data.conversion` instead.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import List, Optional, Sequence

def _discover_scenes(dataset, root):
    """Source-specific scene-name discovery, mirroring each reference
    script's get_original_scene_names: dl3dv buckets scenes under
    1K..11K (name '<split>_<id>'), megadepth enumerates dense<i>
    subscenes ('<scene>_<i>'), spring nests under train/test,
    dynamicreplica collapses the _left/_right stereo dirs, mpsd walks
    reconstruction_data/<split>/<folder>."""
    join, isdir, ls = os.path.join, os.path.isdir, os.listdir

    def subdirs(p):
        return sorted(d for d in ls(p) if isdir(join(p, d)))

    if dataset == "dl3dv":
        out = []
        for k in range(1, 12):
            split = f"{k}K"
            if isdir(join(root, split)):
                out += [f"{split}_{s}" for s in subdirs(join(root, split))]
        return out
    if dataset == "megadepth":
        out = []
        for scene in subdirs(root):
            for d in sorted(os.listdir(join(root, scene))):
                if d.startswith("dense") and isdir(join(root, scene, d)):
                    out.append(f"{scene}_{d[len('dense'):]}")
        return out
    if dataset == "spring":
        out = []
        for split in ("train", "test"):
            if isdir(join(root, split)):
                out += [s for s in subdirs(join(root, split))
                        if s.isdigit()]
        return out
    if dataset == "dynamicreplica":
        bases = {d[:-len("_left")] if d.endswith("_left")
                 else d[:-len("_right")]
                 for d in subdirs(root)
                 if d.endswith(("_left", "_right"))}
        return sorted(bases)
    if dataset == "mpsd":
        recon = join(root, "reconstruction_data")
        out = []
        if isdir(recon):
            for split in subdirs(recon):
                out += [f"{split}_{f}" for f in subdirs(join(recon, split))]
        return out
    return subdirs(root)


def parser() -> argparse.ArgumentParser:
    from .data.converters_corpus import CORPUS_CONVERTERS

    ap = argparse.ArgumentParser(
        prog="python -m mapanything_tpu_torch.convert_dataset",
        description=__doc__.splitlines()[0])
    ap.add_argument("dataset", choices=("eth3d", "scannetppv2", "tav2_wb",
                                        *sorted(CORPUS_CONVERTERS)))
    ap.add_argument("original_root", help="raw dataset tree")
    ap.add_argument("out_root", help="WAI output root")
    ap.add_argument("--scenes", nargs="*", default=None,
                    help="scene names (default: every subdirectory)")
    ap.add_argument("--copy", action="store_true",
                    help="copy files instead of symlinking")
    ap.add_argument("--ase-calib", default=None,
                    help="ase: aria device-calibration JSON path")
    ap.add_argument("--test-split-file", default=None,
                    help="scannetppv2: file with one benchmark test scene "
                         "name per line (test frames excluded for those)")
    ap.add_argument("--undistort", action="store_true",
                    help="run the undistortion stage after conversion "
                         "(distorted sources, e.g. scannetppv2)")
    ap.add_argument("--render-depth", action="store_true",
                    help="ray-cast the scene mesh into every frame "
                         "(scannetppv2 rendered_depth modality)")
    ap.add_argument("--pseudo-depth", metavar="MOGE_CKPT", default=None,
                    help="run the MoGe pseudo-depth stage after conversion "
                         "with this local torch file, a MoGe model pickled "
                         "whole: loading it runs code, so pass only a "
                         "trusted file")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run the device stages on the CPU; the "
                         "card by default")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> List[Path]:
    """Convert every scene (and run the asked stages); returns the
    converted scene roots."""
    from .data import converters
    from .data.converters_corpus import CORPUS_CONVERTERS
    from .utils.device import resolve_device

    ap = parser()
    args = ap.parse_args(argv)
    if args.dataset == "ase" and not args.ase_calib:
        ap.error("--ase-calib is required for the ase recipe")
    device = resolve_device(args.device)

    scenes = args.scenes or _discover_scenes(args.dataset,
                                             args.original_root)
    test_scenes = ()
    if args.test_split_file:
        with open(args.test_split_file) as f:
            test_scenes = tuple(line.strip() for line in f if line.strip())

    link = not args.copy
    src, dst = args.original_root, args.out_root
    recipes = {
        "eth3d": lambda s: converters.convert_eth3d_scene(src, dst, s,
                                                          link=link),
        "scannetppv2": lambda s: converters.convert_scannetppv2_scene(
            src, dst, s, test_scene_names=test_scenes, link=link),
        "tav2_wb": lambda s: converters.convert_tav2_wb_scene(src, dst, s,
                                                              link=link),
        # mpsd re-stores (resizes) rather than symlinking; ase needs the
        # device calibration JSON
        "ase": lambda s: CORPUS_CONVERTERS["ase"](
            src, dst, s, calib_json_path=args.ase_calib),
        "mpsd": lambda s: CORPUS_CONVERTERS["mpsd"](src, dst, s),
    }
    if args.dataset not in recipes:
        fn = CORPUS_CONVERTERS[args.dataset]
        recipes[args.dataset] = lambda s: fn(src, dst, s, link=link)
    convert = recipes[args.dataset]
    moge = None
    if args.pseudo_depth:
        import torch

        # a whole pickled module, as the JAX script loads it: the port's
        # weights-only rule cannot read one
        moge = torch.load(args.pseudo_depth, map_location=device,
                          weights_only=False)

    roots = []
    for scene in scenes:
        print(f"[{args.dataset}] converting {scene}", flush=True)
        root = convert(scene)
        if args.undistort:
            print(f"[{args.dataset}] undistorting {scene}", flush=True)
            converters.undistort_scene(root)
        if args.render_depth:
            print(f"[{args.dataset}] rendering mesh depth {scene}",
                  flush=True)
            converters.render_scene_depth_stage(root, device=device)
        if moge is not None:
            from .data.pseudo_depth import run_pseudo_depth_stage
            from .models.adapters import MoGeAdapter

            print(f"[{args.dataset}] pseudo-depth {scene}", flush=True)
            run_pseudo_depth_stage(root, MoGeAdapter(moge))
        roots.append(Path(root))
    print(f"converted {len(scenes)} scene(s) -> {args.out_root}")
    return roots


if __name__ == "__main__":
    main()
