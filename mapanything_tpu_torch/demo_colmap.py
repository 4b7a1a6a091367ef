"""COLMAP export demo; counterpart of scripts/demo_colmap.py.

Loads a folder of images, runs MapAnything inference with the confidence
mask, and writes a COLMAP sparse model (sparse/cameras.bin, images.bin,
points3D.bin): the feed-forward export path.

    python -m mapanything_tpu_torch.demo_colmap --image_folder PATH \
        --output_dir colmap_out [--memory_efficient] [--conf_percentile 10] \
        [--max_points 1000000] [--tiny] [--device cpu]

The port has no checkpoint reader yet (ROADMAP queue A item 0): the
weights are seeded random normals (`--seed`). The refinement branch
(`--ba`: tracks and bundle adjustment) and the GLB point cloud wait for
their modules (ROADMAP queue A item 15).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

BA_ITEM = "ROADMAP queue A item 15 (the COLMAP demo's --ba and GLB)"


def export_predictions(preds: List[Dict[str, torch.Tensor]],
                       names: Sequence[str], output_dir: str,
                       max_points: int = 1_000_000) -> Dict:
    """Write `infer`'s outputs (sample 0 of each view) as a COLMAP sparse
    model under output_dir/sparse: one PINHOLE camera and one image per
    view, and the masked points, subsampled to `max_points` with
    numpy.random.default_rng(0). Returns {"sparse_dir", "cameras",
    "points"}."""
    from .utils.colmap_io import export_colmap_reconstruction

    def host(t):
        return t.detach().float().cpu().numpy()

    intrinsics = np.stack([host(p["intrinsics"][0]) for p in preds])
    poses = np.stack([host(p["camera_poses"][0]) for p in preds])
    h, w = preds[0]["pts3d"].shape[1:3]
    pts, cols = [], []
    for p in preds:
        m = p["mask"][0, ..., 0].bool()
        pts.append(host(p["pts3d"][0][m]))
        cols.append(host(p["img_no_norm"][0][m]))
    pts, cols = np.concatenate(pts), np.concatenate(cols)
    if len(pts) > max_points:
        idx = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts, cols = pts[idx], cols[idx]
    sparse_dir = export_colmap_reconstruction(
        os.path.join(output_dir, "sparse"), intrinsics, poses,
        [(w, h)] * len(preds), list(names), pts, cols)
    return {"sparse_dir": sparse_dir, "cameras": len(preds),
            "points": len(pts)}


def view_names(views: List[Dict]) -> List[str]:
    """The image file names of load_images' views."""
    return [os.path.basename(v["instance"][0]) or f"view_{i}.png"
            for i, v in enumerate(views)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image_folder", required=True)
    ap.add_argument("--output_dir", default="colmap_out")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--memory_efficient", action="store_true")
    ap.add_argument("--conf_percentile", type=float, default=10.0)
    ap.add_argument("--max_points", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card by default")
    ap.add_argument("--ba", action="store_true",
                    help=f"not ported yet: {BA_ITEM}")
    args = ap.parse_args(argv)
    if args.ba:
        raise NotImplementedError(f"--ba: {BA_ITEM}")

    from .data.image import load_images
    from .models import MapAnything, MapAnythingConfig
    from .utils.inference import InferencePipeline
    from .utils.weights import random_normal_

    views = load_images(args.image_folder, verbose=True)
    cfg = (MapAnythingConfig(encoder_size="small", trunk_dim=384,
                             trunk_depth=4, trunk_num_heads=6,
                             trunk_indices=(1, 2), dpt_feature_dim=32)
           if args.tiny else MapAnythingConfig())
    model = random_normal_(MapAnything(cfg, device=args.device),
                           seed=args.seed).eval()
    print("WARNING: random weights (the port reads no checkpoint yet)")
    preds = InferencePipeline(model).infer(
        views, memory_efficient_inference=args.memory_efficient,
        apply_confidence_mask=True,
        confidence_percentile=args.conf_percentile)
    res = export_predictions(preds, view_names(views), args.output_dir,
                             args.max_points)
    print(f"wrote COLMAP reconstruction ({res['cameras']} cameras, "
          f"{res['points']} points) -> {res['sparse_dir']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
