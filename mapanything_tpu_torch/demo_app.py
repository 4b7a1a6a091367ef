"""The interactive demo app, headless by default; counterpart of
scripts/demo_app.py (the reference's scripts/gradio_app.py flow).

A folder of images -> inference -> a GLB scene (triangle meshes and camera
markers, or a point cloud), a coloured depth and normal map per view, an
optional measurement between two pixels and optional sky masks, all through
utils/demo_core.py. Each stage's wall prints on its own line. With `--ui`
and gradio installed, the same functions back a small web UI; without
gradio the app says so and runs headless.

    python -m mapanything_tpu_torch.demo_app --image_folder PATH \
        [--out_dir demo_out] [--checkpoint PATH] [--tiny] \
        [--resolution 518] [--views N] [--pointcloud] \
        [--conf_percentile P] [--filter_black_bg] [--filter_white_bg] \
        [--no_mask_edges] [--measure x1,y1,x2,y2 --view N] [--sky_masks] \
        [--ui] [--seed 0] [--device cpu]

`--checkpoint` is read by models/pretrained.py::from_pretrained (the
reference's layout or the port's own files), for the architecture `--tiny`
selects where the file does not say. Without it the weights are seeded
random normals (`--seed`). The sky masks are the heuristic of
utils/demo_core.py::sky_mask_heuristic: a sky-segmentation model is an ONNX
session the caller passes to `segment_sky`.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from .perf.timing import BlockTimeManager, block_timer

# the stages whose walls the app prints, in order
STAGES = ("load", "model", "infer", "normals", "glb", "pngs", "measure",
          "sky")


def build_pipeline(args):
    """The InferencePipeline of --checkpoint, or of seeded random weights,
    in bf16 on --device (the card by default)."""
    from .demo_colmap import TINY_CONFIG
    from .models import MapAnything, MapAnythingConfig
    from .models.pretrained import from_pretrained
    from .utils.inference import InferencePipeline
    from .utils.weights import random_normal_

    overrides = TINY_CONFIG if args.tiny else {}
    if args.checkpoint:
        model = from_pretrained(args.checkpoint, torch.bfloat16, overrides,
                                args.device)
    else:
        model = random_normal_(MapAnything(MapAnythingConfig(**overrides),
                                           device=args.device),
                               seed=args.seed).eval()
        print("running with RANDOM weights (smoke mode)")
    print(f"device: {next(model.parameters()).device}")
    return InferencePipeline(model)


def export_outputs(args, predictions, processed, manager=None):
    """scene.glb, depth_NNN.png, normal_NNN.png and, when asked,
    measure.json and sky/skymask_NNN.png under --out_dir."""
    from PIL import Image

    from .utils import demo_core as dc

    manager = manager or BlockTimeManager()
    os.makedirs(args.out_dir, exist_ok=True)
    glb_path = os.path.join(args.out_dir, "scene.glb")
    with block_timer("glb", manager):
        n = dc.predictions_to_glb_scene(
            glb_path, predictions,
            as_mesh=not args.pointcloud,
            conf_percentile=args.conf_percentile,
            mask_black_bg=args.filter_black_bg,
            mask_white_bg=args.filter_white_bg,
        )
    print(f"wrote {glb_path} ({n} vertices)")

    with block_timer("pngs", manager):
        for i, view in processed.items():
            Image.fromarray(dc.colorize_depth(view["depth"], view["mask"])
                            ).save(os.path.join(args.out_dir,
                                                f"depth_{i:03d}.png"))
            Image.fromarray(dc.colorize_normal(view["normal"], view["mask"])
                            ).save(os.path.join(args.out_dir,
                                                f"normal_{i:03d}.png"))
    print(f"wrote {len(processed)} depth + normal maps")

    if args.measure:
        with block_timer("measure", manager):
            x1, y1, x2, y2 = (int(v) for v in args.measure.split(","))
            result = dc.measure(processed[args.view], (x1, y1), (x2, y2))
            path = os.path.join(args.out_dir, "measure.json")
            with open(path, "w") as f:
                json.dump(result, f, indent=2)
        if result["valid"] and "distance" in result:
            print(f"measure: {result['distance']:.3f} m  -> {path}")
        else:
            print(f"measure: invalid click (masked/out of bounds) -> {path}")

    if args.sky_masks:
        with block_timer("sky", manager):
            sky_dir = os.path.join(args.out_dir, "sky")
            os.makedirs(sky_dir, exist_ok=True)
            for i, view in processed.items():
                mask = dc.segment_sky(view["image"])
                Image.fromarray(mask).save(
                    os.path.join(sky_dir, f"skymask_{i:03d}.png"))
        print(f"wrote {len(processed)} sky masks (heuristic)")


def launch_ui(pipeline, args):
    """A gradio page over run_model and the GLB export (needs gradio)."""
    import gradio as gr

    from .data.image import load_images
    from .utils import demo_core as dc

    def run(files, conf_percentile, as_mesh):
        views = load_images([f.name for f in files],
                            resolution_set=args.resolution)
        predictions, _ = dc.run_model(pipeline, views)
        out = os.path.join(args.out_dir, "scene.glb")
        dc.predictions_to_glb_scene(
            out, predictions, as_mesh=as_mesh,
            conf_percentile=conf_percentile or None)
        return out

    demo = gr.Interface(
        fn=run,
        inputs=[gr.File(file_count="multiple"),
                gr.Slider(0, 100, value=0, label="conf percentile"),
                gr.Checkbox(value=True, label="as mesh")],
        outputs=gr.Model3D(),
        title="MapAnything",
    )
    demo.launch()


def print_walls(manager: BlockTimeManager) -> None:
    for stage in STAGES:
        if stage in manager.timers:
            print(f"wall {stage}: {manager.timers[stage].total:.4f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image_folder", required=True)
    ap.add_argument("--out_dir", default="demo_out")
    ap.add_argument("--checkpoint", default=None,
                    help="an HF snapshot, a *.safetensors file, the "
                         "reference's state dict or a file of the port's "
                         "trainer; seeded random weights without it")
    ap.add_argument("--tiny", action="store_true",
                    help="a tiny architecture (fast smoke run)")
    ap.add_argument("--resolution", type=int, default=518)
    ap.add_argument("--views", type=int, default=None)
    ap.add_argument("--pointcloud", action="store_true",
                    help="export a point cloud instead of meshes")
    ap.add_argument("--conf_percentile", type=float, default=None)
    ap.add_argument("--filter_black_bg", action="store_true")
    ap.add_argument("--filter_white_bg", action="store_true")
    ap.add_argument("--no_mask_edges", action="store_true")
    ap.add_argument("--measure", default=None,
                    help="x1,y1,x2,y2 pixel pair to measure")
    ap.add_argument("--view", type=int, default=0,
                    help="view index for --measure")
    ap.add_argument("--sky_masks", action="store_true")
    ap.add_argument("--ui", action="store_true",
                    help="launch the gradio UI (requires gradio)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card by default")
    args = ap.parse_args(argv)

    from .data.image import load_images
    from .utils import demo_core as dc
    from .utils.device import resolve_device

    args.device = resolve_device(args.device)
    manager = BlockTimeManager()
    with block_timer("load", manager):
        views = load_images(args.image_folder,
                            resolution_set=args.resolution)
        if args.views:
            views = views[: args.views]
    print(f"loaded {len(views)} views, shape {views[0]['img'].shape}")

    with block_timer("model", manager):
        pipeline = build_pipeline(args)

    if args.ui:
        try:
            launch_ui(pipeline, args)
            return 0
        except ImportError:
            print("gradio not installed; falling back to headless export")
    predictions, processed = dc.run_model(
        pipeline, views,
        mask_edges=not args.no_mask_edges,
        filter_black_bg=args.filter_black_bg,
        filter_white_bg=args.filter_white_bg,
        manager=manager,
    )
    export_outputs(args, predictions, processed, manager)
    print_walls(manager)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
