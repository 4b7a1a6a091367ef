"""COLMAP export demo; counterpart of scripts/demo_colmap.py.

Loads a folder of images, runs MapAnything inference with the confidence
mask, and writes a COLMAP sparse model (sparse/cameras.bin, images.bin,
points3D.bin) and the masked points as points.glb: the feed-forward export
path. `--ba` refines the poses, the shared intrinsics and a set of tracked
points and writes them as sparse_ba/: the frames ranked by the model's own
DINOv2 encoder, points selected in the query frames and tracked into every
frame by coarse-to-fine NCC (utils/tracking.py), and Levenberg-Marquardt
bundle adjustment (utils/ba.py), all on the model's device; they stand in
for the reference's VGGSfM tracks and pycolmap.

    python -m mapanything_tpu_torch.demo_colmap --image_folder PATH \
        --output_dir colmap_out [--checkpoint PATH] [--memory_efficient] \
        [--conf_percentile 10] [--max_points 1000000] [--ba \
        [--max_query_pts 1024] [--num_query_frames 3] [--vis_thresh 0.6] \
        [--ba_iters 20]] [--tiny] [--device cpu]

`--checkpoint` is read by models/pretrained.py::from_pretrained (the
reference's layout or the port's own files), for the architecture `--tiny`
selects where the file does not say. Without it the weights are seeded
random normals (`--seed`), and a warning says so.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# the --tiny architecture (scripts/demo_colmap.py's)
TINY_CONFIG = dict(encoder_size="small", trunk_dim=384, trunk_depth=4,
                   trunk_num_heads=6, trunk_indices=(1, 2), dpt_feature_dim=32)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def masked_points(preds: List[Dict[str, torch.Tensor]]):
    """The masked points and colors of sample 0 of every view, on the
    host: (N, 3) float32 each."""
    pts, cols = [], []
    for p in preds:
        m = p["mask"][0, ..., 0].bool()
        pts.append(_host(p["pts3d"][0][m]))
        cols.append(_host(p["img_no_norm"][0][m]))
    return np.concatenate(pts), np.concatenate(cols)


def export_predictions(preds: List[Dict[str, torch.Tensor]],
                       names: Sequence[str], output_dir: str,
                       max_points: int = 1_000_000) -> Dict:
    """Write `infer`'s outputs (sample 0 of each view) as a COLMAP sparse
    model under output_dir/sparse, one PINHOLE camera and one image per
    view, and the masked points, subsampled to `max_points` with
    numpy.random.default_rng(0), also as output_dir/points.glb. Returns
    {"sparse_dir", "glb", "cameras", "points"}."""
    from .utils.colmap_io import export_colmap_reconstruction
    from .utils.viz import write_glb_pointcloud

    intrinsics = np.stack([_host(p["intrinsics"][0]) for p in preds])
    poses = np.stack([_host(p["camera_poses"][0]) for p in preds])
    h, w = preds[0]["pts3d"].shape[1:3]
    pts, cols = masked_points(preds)
    if len(pts) > max_points:
        idx = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts, cols = pts[idx], cols[idx]
    sparse_dir = export_colmap_reconstruction(
        os.path.join(output_dir, "sparse"), intrinsics, poses,
        [(w, h)] * len(preds), list(names), pts, cols)
    glb = os.path.join(output_dir, "points.glb")
    write_glb_pointcloud(glb, pts, cols)
    return {"sparse_dir": sparse_dir, "glb": glb, "cameras": len(preds),
            "points": len(pts)}


def view_names(views: List[Dict]) -> List[str]:
    """The image file names of load_images' views."""
    return [os.path.basename(v["instance"][0]) or f"view_{i}.png"
            for i, v in enumerate(views)]


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def luma_histograms(images: torch.Tensor, bins: int = 64) -> torch.Tensor:
    """(V, H, W, 3) images in [0, 1] -> (V, bins) fp32 counts of their luma
    over [0, 1]: the JAX demo's frame descriptors for a model without a
    DINOv2 encoder."""
    from .utils.tracking import to_gray

    return torch.stack([torch.histc(to_gray(im.float()), bins=bins, min=0.0,
                                    max=1.0) for im in images])


def refine(preds: List[Dict[str, torch.Tensor]], images: torch.Tensor,
           encoder: Optional[Callable[[torch.Tensor], torch.Tensor]],
           max_query_pts: int = 1024, num_query_frames: int = 3,
           vis_thresh: float = 0.6, ba_iters: int = 20) -> Dict:
    """The --ba branch of scripts/demo_colmap.py on `infer`'s outputs, on
    their device.

    Args:
        preds: infer's per-view outputs (sample 0 is used).
        images: (V, H, W, 3) the normalised images the model saw, for the
            query-frame ranking.
        encoder: the model's DINOv2 encoder, (F', H, W, 3) -> patch
            tokens, whose features rank the query frames; None (a CroCo or
            RADIO model) ranks them by 64-bin luma histograms of the images,
            as the JAX demo does.
        max_query_pts, num_query_frames, vis_thresh, ba_iters: the CLI's
            flags.

    Returns:
        {"query_frames", "tracks_xy" (V, P, 2), "track_mask" (V, P),
        "points" (P, 3) the predicted points the tracks start from,
        "point_rgb" (P, 3) uint8, "ba": bundle_adjust's output,
        "seconds": the wall of the ranking, tracking and bundle adjustment}
        (tensors on the predictions' device).
    """
    from .geometry import rotation_matrix_to_quaternion
    from .utils.ba import BAProblem, bundle_adjust
    from .utils.tracking import (
        frame_features_from_encoder,
        rank_query_frames,
        select_query_points,
        to_gray,
        track_points,
    )

    imgs = torch.stack([p["img_no_norm"][0] for p in preds]).float()
    device = imgs.device
    v = len(preds)
    seconds = {}

    # the most central frames by the model's own encoder, frame 0 first
    t0 = time.perf_counter()
    query_frames = [0]
    if num_query_frames > 1 and v > 1:
        if encoder is None:
            feats = luma_histograms(imgs)
        else:
            feats = frame_features_from_encoder(encoder, images.to(device))
        ranked = rank_query_frames(feats, num_query_frames)
        query_frames += [i for i in ranked if i != 0]
        query_frames = query_frames[:num_query_frames]
    seconds["ranking"] = time.perf_counter() - t0

    # track from every query frame; the track sets are concatenated
    t0 = time.perf_counter()
    per_frame = max(1, max_query_pts // len(query_frames))
    xy, vis, pts, rgb = [], [], [], []
    for qf in query_frames:
        conf = preds[qf]["conf"][0] if "conf" in preds[qf] else \
            torch.ones(imgs.shape[1:3], device=device)
        q_yx, _ = select_query_points(conf.float(), to_gray(imgs[qf]),
                                      per_frame)
        tracks_yx, vis_q = track_points(imgs, q_yx, query_frame=qf)
        xy.append(tracks_yx.flip(-1))
        vis.append(vis_q > vis_thresh)
        qi = q_yx.long()
        pts.append(preds[qf]["pts3d"][0][qi[:, 0], qi[:, 1]].float())
        rgb.append((imgs[qf][qi[:, 0], qi[:, 1]] * 255).to(torch.uint8))
    tracks_xy, track_mask = torch.cat(xy, dim=1), torch.cat(vis, dim=1)
    _synchronize(device)
    seconds["tracking"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    w2c = torch.linalg.inv(torch.stack(
        [p["camera_poses"][0] for p in preds]).float())
    k0 = preds[0]["intrinsics"][0].float()
    problem = BAProblem(
        tracks=tracks_xy, track_mask=track_mask,
        base_quats=rotation_matrix_to_quaternion(w2c[:, :3, :3]),
        base_trans=w2c[:, :3, 3],
        intrinsics=torch.stack([k0[0, 0], k0[1, 1], k0[0, 2], k0[1, 2]]),
        points=torch.cat(pts))
    ba = bundle_adjust(problem, iters=ba_iters)
    ba["rms_before"], ba["rms_after"] = (float(ba["rms_before"]),
                                         float(ba["rms_after"]))
    seconds["bundle_adjustment"] = time.perf_counter() - t0
    return {"query_frames": query_frames, "tracks_xy": tracks_xy,
            "track_mask": track_mask, "points": problem.points,
            "point_rgb": torch.cat(rgb), "ba": ba, "seconds": seconds}


def export_refined(refined: Dict, names: Sequence[str], image_wh,
                   output_dir: str) -> str:
    """Write refine()'s poses, intrinsics and points as a COLMAP sparse
    model under output_dir/sparse_ba; returns its directory."""
    from .geometry import pose_quats_trans_to_matrix
    from .utils.colmap_io import export_colmap_reconstruction

    ba = refined["ba"]
    w2c = _host(pose_quats_trans_to_matrix(ba["cam_quats"], ba["cam_trans"]))
    fx, fy, cx, cy = _host(ba["intrinsics"])
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    return export_colmap_reconstruction(
        os.path.join(output_dir, "sparse_ba"), np.stack([k] * len(w2c)),
        np.linalg.inv(w2c), [tuple(image_wh)] * len(w2c), list(names),
        _host(ba["points"]), refined["point_rgb"].cpu().numpy())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image_folder", required=True)
    ap.add_argument("--output_dir", default="colmap_out")
    ap.add_argument("--checkpoint", default=None,
                    help="an HF snapshot, a *.safetensors file, the "
                         "reference's state dict or a file of the port's "
                         "trainer; seeded random weights without it")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--memory_efficient", action="store_true")
    ap.add_argument("--conf_percentile", type=float, default=10.0)
    ap.add_argument("--max_points", type=int, default=1_000_000)
    ap.add_argument("--ba", action="store_true",
                    help="refine with on-device tracks and bundle adjustment")
    ap.add_argument("--max_query_pts", type=int, default=1024)
    ap.add_argument("--num_query_frames", type=int, default=3,
                    help="track from this many ranked query frames "
                         "(1 = frame 0 only)")
    ap.add_argument("--vis_thresh", type=float, default=0.6)
    ap.add_argument("--ba_iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card by default")
    args = ap.parse_args(argv)

    from .data.image import load_images
    from .models import MapAnything, MapAnythingConfig
    from .models.pretrained import from_pretrained
    from .utils.inference import InferencePipeline
    from .utils.weights import random_normal_

    views = load_images(args.image_folder, verbose=True)
    overrides = TINY_CONFIG if args.tiny else {}
    if args.checkpoint:
        model = from_pretrained(args.checkpoint, torch.bfloat16, overrides,
                                args.device)
    else:
        model = random_normal_(MapAnything(MapAnythingConfig(**overrides),
                                           device=args.device),
                               seed=args.seed).eval()
        print("WARNING: random weights (no --checkpoint)")
    device = next(model.parameters()).device
    t0 = time.perf_counter()
    preds = InferencePipeline(model).infer(
        views, memory_efficient_inference=args.memory_efficient,
        apply_confidence_mask=True,
        confidence_percentile=args.conf_percentile)
    _synchronize(device)
    walls = {"infer": time.perf_counter() - t0}
    names = view_names(views)
    t0 = time.perf_counter()
    res = export_predictions(preds, names, args.output_dir, args.max_points)
    walls["export"] = time.perf_counter() - t0
    print(f"wrote COLMAP reconstruction ({res['cameras']} cameras, "
          f"{res['points']} points) -> {res['sparse_dir']}, {res['glb']}")

    if args.ba:
        images = torch.from_numpy(np.concatenate([v["img"] for v in views]))
        refined = refine(preds, images,
                         model.encoder if model.cfg.encoder_type == "dinov2"
                         else None,
                         max_query_pts=args.max_query_pts,
                         num_query_frames=args.num_query_frames,
                         vis_thresh=args.vis_thresh, ba_iters=args.ba_iters)
        walls.update(refined["seconds"])
        ba = refined["ba"]
        print(f"query frames: {refined['query_frames']}")
        print(f"BA: rms {ba['rms_before']:.6f} px -> {ba['rms_after']:.6f} "
              f"px over {int(refined['track_mask'].sum())} observations of "
              f"{refined['track_mask'].shape[1]} tracks")
        t0 = time.perf_counter()
        h, w = preds[0]["pts3d"].shape[1:3]
        ba_dir = export_refined(refined, names, (w, h), args.output_dir)
        walls["export"] += time.perf_counter() - t0
        print(f"wrote BA-refined reconstruction -> {ba_dir}")
    print(f"stage walls (s): {json.dumps(walls)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
