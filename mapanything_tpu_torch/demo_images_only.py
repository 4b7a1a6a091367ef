"""Images-only metric 3D reconstruction demo; counterpart of
scripts/demo_images_only_inference.py.

Loads a folder of images, runs MapAnything inference, prints a line per
view (valid pixels, focal lengths, depth range, metric scale) and writes
the masked points as an ASCII PLY and, beside it, a GLB scene with the
point cloud and one camera frustum per view.

    python -m mapanything_tpu_torch.demo_images_only --image_folder PATH \
        [--checkpoint PATH] [--output reconstruction.ply] [--views N] \
        [--resolution_set 518] [--memory_efficient] \
        [--apply_confidence_mask] [--tiny] [--seed 0] [--device cpu]

`--checkpoint` is read by models/pretrained.py::from_pretrained (the
reference's layout or the port's own files). Without it the weights are
seeded random normals (`--seed`) and the geometry is meaningless, but the
whole path runs.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def write_ply(path: str, points: np.ndarray, colors: np.ndarray) -> None:
    """An ASCII PLY point cloud, in the bytes of the JAX demo's writer."""
    points = points.reshape(-1, 3)
    colors = (np.clip(colors.reshape(-1, 3), 0, 1) * 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(points, colors):
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {c[0]} {c[1]} {c[2]}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image_folder", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="an HF snapshot, a *.safetensors file, the "
                         "reference's state dict or a file of the port's "
                         "trainer; seeded random weights without it")
    ap.add_argument("--output", default="reconstruction.ply")
    ap.add_argument("--views", type=int, default=None, help="limit #views")
    ap.add_argument("--resolution_set", type=int, default=518)
    ap.add_argument("--memory_efficient", action="store_true")
    ap.add_argument("--apply_confidence_mask", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="a tiny architecture (fast smoke run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card by default")
    args = ap.parse_args(argv)

    from .data.image import load_images
    from .demo_colmap import TINY_CONFIG, masked_points
    from .models import MapAnything, MapAnythingConfig
    from .models.pretrained import from_pretrained
    from .utils.inference import InferencePipeline
    from .utils.viz import write_glb_scene
    from .utils.weights import random_normal_

    t0 = time.perf_counter()
    views = load_images(args.image_folder,
                        resolution_set=args.resolution_set, verbose=True)
    if args.views:
        views = views[:args.views]
    print(f"loaded {len(views)} views in {time.perf_counter() - t0:.2f}s; "
          f"shape {views[0]['img'].shape}")

    overrides = TINY_CONFIG if args.tiny else {}
    if args.checkpoint:
        model = from_pretrained(args.checkpoint, torch.bfloat16, overrides,
                                args.device)
        print(f"loaded checkpoint {args.checkpoint}")
    else:
        model = random_normal_(MapAnything(MapAnythingConfig(**overrides),
                                           device=args.device),
                               seed=args.seed).eval()
        print("WARNING: random weights (no --checkpoint) - smoke mode")
    print(f"device: {next(model.parameters()).device}")

    t0 = time.perf_counter()
    preds = InferencePipeline(model).infer(
        views, memory_efficient_inference=args.memory_efficient,
        apply_confidence_mask=args.apply_confidence_mask)
    pts, cols = masked_points(preds)  # the copy to the host waits for it
    print(f"inference: {time.perf_counter() - t0:.2f}s for {len(views)} "
          "views")

    for i, p in enumerate(preds):
        k = p["intrinsics"][0]
        depth = p["depth_z"][0]
        print(f"view {i}: {int(p['mask'][0].sum())} valid px, "
              f"fx={float(k[0, 0]):.1f} fy={float(k[1, 1]):.1f}, "
              f"depth_z range [{float(depth.min()):.3f}, "
              f"{float(depth.max()):.3f}], "
              f"scale={float(p['metric_scaling_factor'][0]):.4f}")

    write_ply(args.output, pts, cols)
    print(f"wrote {len(pts)} points -> {args.output}")
    glb = os.path.splitext(args.output)[0] + ".glb"
    poses = np.stack([p["camera_poses"][0].float().cpu().numpy()
                      for p in preds])
    ks = np.stack([p["intrinsics"][0].float().cpu().numpy() for p in preds])
    h, w = preds[0]["pts3d"].shape[1:3]
    write_glb_scene(glb, pts, cols, poses, ks, (w, h))
    print(f"wrote GLB scene with {len(preds)} camera frustums -> {glb}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
