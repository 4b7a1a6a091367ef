"""The interactive demo app's computations, without the UI; counterpart of
mapanything_tpu/utils/demo_core.py.

Functions over `infer()`'s per-view outputs (the reference's HF-Spaces demo,
`scripts/gradio_app.py`: run_model:88, process_predictions_for_
visualization:653, colorize_depth:600, colorize_normal:633, measure:366;
`utils/hf_utils/viz.py`: predictions_to_glb:155, segment_sky:614).
`demo_app.py` drives them headless; a gradio UI plugs in on top.

The predictions are packed on the host (numpy), as the JAX package packs
them; the normal maps are the one computation that goes back to a device:
`process_for_visualization` runs geometry/edges.py::points_to_normals on
all views at once on the model's device and copies the result to the host
once. The colormaps come from utils/colormaps.py (matplotlib's tables,
without matplotlib), and the sky model's resizes are cv2's INTER_LINEAR in
numpy (`resize_linear`), so neither matplotlib nor cv2 is needed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry.edges import points_to_normals
from ..perf.timing import BlockTimeManager, block_timer
from . import mesh as _mesh
from .colormaps import apply_colormap
from .device import resolve_device
from .viz import write_glb_scene

# ---------------------------------------------------------------------------
# Prediction packing (run_model's output contract)


def _host(x, dtype=np.float32) -> np.ndarray:
    """A tensor or array on the host as numpy of `dtype`."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = x.float() if dtype == np.float32 else x
        return x.numpy().astype(dtype, copy=False)
    return np.asarray(x, dtype)


def pack_predictions(outputs: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Stack infer()'s per-view dicts (tensors or arrays, sample 0 of each
    view) into the demo's host arrays (reference gradio_app.py:135-204):
    extrinsic (S,4,4), intrinsic (S,3,3), world_points (S,H,W,3), depth
    (S,H,W,1), conf (S,H,W), images (S,H,W,3), final_mask (S,H,W)."""
    def grab(key, required=True):
        rows = []
        for i, p in enumerate(outputs):
            if key not in p:
                if required:
                    raise KeyError(
                        f"pipeline output for view {i} is missing {key!r}: "
                        "pack_predictions needs the full infer() key set "
                        f"(got {sorted(p)})")
                return None
            rows.append(_host(p[key][0]))
        return np.stack(rows)

    world = grab("pts3d")
    depth = grab("depth_z")
    imgs = grab("img_no_norm")
    conf = grab("conf", required=False)
    if conf is not None and conf.ndim == 4:
        conf = conf[..., 0]
    masks = []
    for p in outputs:
        if "mask" in p:
            m = _host(p["mask"][0], bool)
            masks.append(m[..., 0] if m.ndim == 3 else m)
        else:
            masks.append(np.ones(depth.shape[1:3], bool))
    # the reference's valid-depth requirement and per-view mask
    # (gradio_app.py:152-167)
    final_mask = np.stack(masks) & (depth[..., 0] > 0)
    preds = {
        "extrinsic": grab("camera_poses"),
        "intrinsic": grab("intrinsics"),
        "world_points": world,
        "depth": depth,
        "images": imgs,
        "final_mask": final_mask,
    }
    if conf is not None:
        preds["conf"] = conf
    return preds


def run_model(
    pipeline,
    views: List[Dict[str, Any]],
    apply_mask: bool = True,
    mask_edges: bool = True,
    filter_black_bg: bool = False,
    filter_white_bg: bool = False,
    manager: Optional[BlockTimeManager] = None,
    **infer_flags,
) -> Tuple[Dict[str, np.ndarray], Dict[int, Dict[str, Any]]]:
    """Inference and the demo's packing: the reference's run_model
    (gradio_app.py:88) without the UI. `pipeline` is an InferencePipeline
    (or anything with its `.infer(views, **flags)` and `.model`); the
    normals run on its model's device. With `manager`, the walls of
    "infer" (to the packed host arrays) and "normals" land in its timers.
    Returns (predictions, per-view visualization data)."""
    manager = manager or BlockTimeManager()
    with block_timer("infer", manager):
        outputs = pipeline.infer(
            views, apply_mask=apply_mask, mask_edges=mask_edges,
            **infer_flags)
        predictions = pack_predictions(outputs)
    device = next(pipeline.model.parameters()).device
    with block_timer("normals", manager):
        processed = process_for_visualization(
            predictions, filter_black_bg=filter_black_bg,
            filter_white_bg=filter_white_bg, device=device)
    return predictions, processed


# ---------------------------------------------------------------------------
# Per-view visualization data (depth / normal / measure tabs)


def background_mask(
    image01: np.ndarray, filter_black: bool = False, filter_white: bool = False
) -> np.ndarray:
    """(H, W) bool keep-mask from background filters on a [0,1] RGB
    image: black = RGB sum < 16/255, white = all channels > 240/255
    (reference thresholds, gradio_app.py:680-698)."""
    keep = np.ones(image01.shape[:2], bool)
    u8 = image01 * 255.0 if image01.max() <= 1.0 else image01
    if filter_black:
        keep &= u8.sum(axis=2) >= 16
    if filter_white:
        keep &= ~((u8[..., 0] > 240) & (u8[..., 1] > 240)
                  & (u8[..., 2] > 240))
    return keep


def process_for_visualization(
    predictions: Dict[str, np.ndarray],
    filter_black_bg: bool = False,
    filter_white_bg: bool = False,
    device=None,
) -> Dict[int, Dict[str, Any]]:
    """Per-view image/points3d/depth/normal/mask dicts for the demo tabs
    (reference process_predictions_for_visualization, gradio_app.py:653).
    The normals of all views are one points_to_normals call on `device`
    (the card when None) and one copy back to the host."""
    imgs = predictions["images"]
    masks = predictions["final_mask"].copy()
    for i in range(len(imgs)):
        masks[i] &= background_mask(
            imgs[i], filter_black_bg, filter_white_bg)
    device = resolve_device(device)
    normals, _ = points_to_normals(
        torch.from_numpy(predictions["world_points"]).to(device),
        torch.from_numpy(masks).to(device))
    normals = normals.cpu().numpy()
    return {
        i: {
            "image": imgs[i],
            "points3d": predictions["world_points"][i],
            "depth": predictions["depth"][i, ..., 0],
            "normal": normals[i],
            "mask": masks[i],
        }
        for i in range(len(imgs))
    }


def colorize_depth(
    depth: np.ndarray, mask: Optional[np.ndarray] = None
) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) uint8, turbo_r over the [p5, p95] valid
    range, invalid pixels white (reference colorize_depth,
    gradio_app.py:600)."""
    valid = depth > 0
    if mask is not None:
        valid = valid & mask
    norm = depth.astype(np.float64).copy()
    if valid.any():
        p5, p95 = np.percentile(norm[valid], [5, 95])
        norm[valid] = (norm[valid] - p5) / max(p95 - p5, 1e-12)
    colored = apply_colormap("turbo_r", norm)[..., :3]
    colored = (colored * 255).astype(np.uint8)
    colored[~valid] = 255
    return colored


def colorize_normal(
    normal: np.ndarray, mask: Optional[np.ndarray] = None
) -> np.ndarray:
    """(H, W, 3) unit normals -> uint8 RGB, masked pixels at the [0,0,0]
    grey midpoint (reference colorize_normal, gradio_app.py:633)."""
    vis = normal.copy()
    if mask is not None:
        vis[~mask] = 0.0
    return (np.clip((vis + 1.0) / 2.0, 0, 1) * 255).astype(np.uint8)


def measure(
    view_data: Dict[str, Any],
    point1: Sequence[int],
    point2: Optional[Sequence[int]] = None,
) -> Dict[str, Any]:
    """The measure tab's math (reference measure, gradio_app.py:366):
    points are (x, y) pixel clicks. Returns per-point depth and, with
    two points, the metric 3-D distance. ``valid`` is False when a
    click lands on a masked pixel (the UI rejects it)."""
    pts3d, depth, mask = (
        view_data["points3d"], view_data["depth"], view_data["mask"])
    result: Dict[str, Any] = {"valid": True, "points": []}
    for p in (point1, point2):
        if p is None:
            continue
        x, y = int(p[0]), int(p[1])
        if not (0 <= y < depth.shape[0] and 0 <= x < depth.shape[1]):
            result["valid"] = False
            break
        if mask is not None and not mask[y, x]:
            result["valid"] = False
            break
        result["points"].append(
            {"xy": (x, y), "depth": float(depth[y, x]),
             "xyz": pts3d[y, x].tolist()})
    if result["valid"] and len(result["points"]) == 2:
        a = np.asarray(result["points"][0]["xyz"])
        b = np.asarray(result["points"][1]["xyz"])
        result["distance"] = float(np.linalg.norm(a - b))
    return result


# ---------------------------------------------------------------------------
# GLB scene export


def predictions_to_glb_scene(
    path: str,
    predictions: Dict[str, np.ndarray],
    as_mesh: bool = True,
    frame: Optional[int] = None,
    conf_percentile: Optional[float] = None,
    mask_black_bg: bool = False,
    mask_white_bg: bool = False,
    mask_ambiguous: bool = True,
    show_cam: bool = True,
    align_to_first_camera: bool = True,
) -> int:
    """The demo's GLB export (reference predictions_to_glb,
    hf_utils/viz.py:155): per-frame triangle meshes from the pixel
    lattice (masked quads dropped, shorter-diagonal split) or a point
    cloud, camera pyramids coloured by frame, the scene aligned to camera
    0's OpenGL view. Returns the number of vertices written."""
    world = predictions["world_points"]
    imgs = predictions["images"]
    extr = predictions["extrinsic"]
    s, h, w = world.shape[:3]
    frames = range(s) if frame is None else [frame]

    align = (_mesh.alignment_transform(extr)
             if align_to_first_camera else np.eye(4))

    def frame_mask(i: int) -> np.ndarray:
        m = np.ones((h, w), bool)
        if mask_ambiguous:
            m &= predictions["final_mask"][i]
        m &= background_mask(imgs[i], mask_black_bg, mask_white_bg)
        if conf_percentile is not None and "conf" in predictions:
            c = predictions["conf"][i]
            m &= c >= np.percentile(c, conf_percentile)
        return m

    # camera markers, gist_rainbow by frame index (hf_utils/viz.py:436)
    markers = []
    if show_cam:
        # the span is the percentiles of the KEPT points only (reference
        # viz.py:257-270): the postprocess zeroes masked pixels, which
        # would drag the 5th/95th percentiles to 0 in sky-heavy scenes
        kept = np.concatenate(
            [world[i].reshape(-1, 3)[frame_mask(i).reshape(-1)]
             for i in frames]) if len(list(frames)) else np.zeros((0, 3))
        if len(kept) == 0:
            span = 1.0
        else:
            span = float(np.linalg.norm(
                np.percentile(kept, 95, axis=0)
                - np.percentile(kept, 5, axis=0)))
        for i in range(s):
            v, f = _mesh.camera_marker_mesh(
                extr[i], scale=0.03 * max(span, 1e-6))
            v = _mesh.transform_points(align, v).astype(np.float32)
            color = (apply_colormap("gist_rainbow", i / max(s, 1))[:3]
                     * 255).astype(np.uint8)
            markers.append((v, f, color))

    if as_mesh:
        all_v, all_f, all_c = [], [], []
        base = 0
        for i in frames:
            faces, verts, cols = _mesh.image_mesh(
                world[i], imgs[i], mask=frame_mask(i), tri=True,
                diagonal_attr=0)
            all_v.append(verts)
            all_f.append(faces + base)
            all_c.append(cols)
            base += len(verts)
        verts = (np.concatenate(all_v) if all_v
                 else np.zeros((0, 3), np.float32))
        verts = _mesh.transform_points(align, verts).astype(np.float32)
        faces = (np.concatenate(all_f) if all_f
                 else np.zeros((0, 3), np.int32))
        cols = np.concatenate(all_c) if all_c else np.zeros((0, 3))
        _mesh.write_glb_mesh(path, verts, faces, vertex_colors=cols,
                             extra_meshes=markers)
        return len(verts)

    pts, cols = [], []
    for i in frames:
        m = frame_mask(i).reshape(-1)
        pts.append(world[i].reshape(-1, 3)[m])
        cols.append(imgs[i].reshape(-1, 3)[m])
    pts = np.concatenate(pts) if pts else np.zeros((0, 3), np.float32)
    cols = np.concatenate(cols) if cols else np.zeros((0, 3))
    pts = _mesh.transform_points(align, pts).astype(np.float32)
    poses = np.einsum("ij,vjk->vik", align, extr) if show_cam else None
    write_glb_scene(
        path, pts, cols, camera_poses=poses,
        intrinsics=predictions.get("intrinsic") if show_cam else None,
        image_wh=(w, h))
    return len(pts)


# ---------------------------------------------------------------------------
# Sky segmentation


def _linear_taps(dst: int, src: int, clamp_weights: bool
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """cv2 INTER_LINEAR's source indices and 11-bit weights along one axis:
    the half-pixel map f = (d + 0.5) * src / dst - 0.5 in fp32, each weight
    rounded to nearest even of w * 2048, the indices clipped to the image.
    OpenCV also zeroes the fraction where f leaves the image along x
    (`clamp_weights`), and not along y, where both taps then read the edge
    row."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0.astype(np.float32)
    if clamp_weights:
        low = i0 < 0
        frac[low], i0[low] = 0, 0
        high = i0 >= src - 1
        frac[high], i0[high] = 0, src - 1
    w0 = np.rint((np.float32(1) - frac) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(frac * np.float32(2048)).astype(np.int64)
    return (np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w0, w1)


def resize_linear(image: np.ndarray, dsize: Sequence[int]) -> np.ndarray:
    """cv2.resize(image, dsize) of a uint8 image ((H, W) or (H, W, C);
    dsize is (width, height)) with INTER_LINEAR, in numpy: the horizontal
    pass in integers with 11-bit weights, the vertical pass as OpenCV's
    vectorised fixed point ((x >> 4) * w >> 16 per row, then (sum + 2) >>
    2, saturated). Within 1 grey level of cv2."""
    src = np.asarray(image)
    if src.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8, not {src.dtype}")
    dst_w, dst_h = int(dsize[0]), int(dsize[1])
    x0, x1, a0, a1 = _linear_taps(dst_w, src.shape[1], True)
    y0, y1, b0, b1 = _linear_taps(dst_h, src.shape[0], False)
    chan = (slice(None),) + (None,) * (src.ndim - 2)
    s = src.astype(np.int64)
    rows = s[:, x0] * a0[chan] + s[:, x1] * a1[chan]  # (H, dst_w, ...)
    b0 = b0[(slice(None), None) + chan[1:]]
    b1 = b1[(slice(None), None) + chan[1:]]
    t = ((rows[y0] >> 4) * b0 >> 16) + ((rows[y1] >> 4) * b1 >> 16)
    return np.clip((t + 2) >> 2, 0, 255).astype(np.uint8)


def run_skyseg(onnx_session, input_size: Sequence[int],
               image_bgr: np.ndarray) -> np.ndarray:
    """Run a sky-segmentation ONNX model (the reference's protocol,
    hf_utils/viz.py:645): resize, BGR->RGB, imagenet-normalize, NCHW,
    then min-max rescale the logits to uint8. `onnx_session` is anything
    with onnxruntime.InferenceSession's get_inputs/get_outputs/run."""
    x = resize_linear(image_bgr, (input_size[0], input_size[1]))
    x = x[..., ::-1].astype(np.float32) / 255.0  # BGR -> RGB
    x = (x - [0.485, 0.456, 0.406]) / [0.229, 0.224, 0.225]
    x = x.transpose(2, 0, 1)[None].astype(np.float32)
    name_in = onnx_session.get_inputs()[0].name
    name_out = onnx_session.get_outputs()[0].name
    out = np.asarray(
        onnx_session.run([name_out], {name_in: x})).squeeze()
    lo, hi = out.min(), out.max()
    return ((out - lo) / max(hi - lo, 1e-12) * 255).astype(np.uint8)


def sky_mask_heuristic(image_rgb01: np.ndarray) -> np.ndarray:
    """Offline sky mask (255 = non-sky) when no sky model is given: sky =
    bright, low-texture pixels connected to the top border. Not learned;
    the JAX package's documented fallback."""
    from scipy import ndimage

    img = image_rgb01.astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    lum = img.mean(axis=2)
    gy, gx = np.gradient(ndimage.gaussian_filter(lum, 1.5))
    texture = np.hypot(gx, gy)
    blueish = img[..., 2] >= img[..., 0] - 0.05
    candidate = (lum > 0.45) & (texture < 0.02) & blueish
    labels, n = ndimage.label(candidate)
    top_labels = np.unique(labels[0])
    sky = np.isin(labels, top_labels[top_labels > 0])
    return np.where(sky, 0, 255).astype(np.uint8)


def segment_sky(
    image_rgb: np.ndarray, onnx_session=None
) -> np.ndarray:
    """(H, W) uint8 mask, 255 = non-sky, 0 = sky (the reference's
    documented convention, hf_utils/viz.py:614; its code sets 255 on the
    low-logit side, against its own docstring, and this follows the
    docstring so both paths here agree). Uses the sky model when a session
    is given, otherwise the heuristic."""
    if onnx_session is None:
        return sky_mask_heuristic(image_rgb)
    rgb = ((np.clip(image_rgb, 0, 1) * 255).astype(np.uint8)
           if image_rgb.dtype != np.uint8 else image_rgb)
    logits = run_skyseg(onnx_session, [320, 320],
                        np.ascontiguousarray(rgb[..., ::-1]))  # RGB -> BGR
    resized = resize_linear(logits, (image_rgb.shape[1], image_rgb.shape[0]))
    # low rescaled logits = sky (reference comment, hf_utils/viz.py:636)
    return np.where(resized < 32, 0, 255).astype(np.uint8)
