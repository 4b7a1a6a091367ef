"""Pseudo-depth labelling of WAI scenes and its consistency filter;
counterpart of mapanything_tpu/data/pseudo_depth.py.

The reference's offline labelling stage
(data_processing/wai_processing/scripts/run_moge.py: MoGe over every
frame, storing depth EXRs + sky/ambiguity masks and registering the
modalities in scene_meta; run_mvsanywhere.py is the MVS analogue that also
stores a confidence map) and its filtering half
(depth_consistency_confidence.py), which `run_depth_consistency_stage`
runs through `data/covisibility.py` on the card, producing the
`depth_confidence/<model>` maps the dl3dv-style quirk pipeline thresholds
at load time (wai_datasets.py confidence_modality).

The model plugs in through the port's adapter contract
(`models/adapters.py`): called as ``adapter(views)`` with the stacked
(B, V, H, W, 3) normalised images on the adapter's device, it returns
{pts3d_cam, non_ambiguous_mask, ...} as tensors. MoGe labels through
`MoGeAdapter` (the reference's stage; `convert_dataset --pseudo-depth`),
MapAnything self-labels through `MapAnythingAdapter`. The JAX package calls ``adapter.apply(params, views)``
with numpy (1, V, H, W, 3) images instead.

Modalities are written under the flat keys the port's reader consumes
("pred_depth/moge2" with the same string as frame key), the layout
`wai_datasets.py`'s quirk table reads; the reference nests the same
content as {pred_depth: {moge2: ...}} (run_moge.py:130-157).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from .wai import load_frame, load_scene_meta, store_data

__all__ = ["run_pseudo_depth_stage", "run_depth_consistency_stage"]


def _normalize_images(imgs01: np.ndarray, data_norm_type: str) -> np.ndarray:
    from .image import IMAGE_NORMALIZATION_DICT

    mean, std = IMAGE_NORMALIZATION_DICT[data_norm_type]
    return (imgs01 - mean.astype(np.float32)) / std.astype(np.float32)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def run_pseudo_depth_stage(
    scene_root: str,
    adapter: Any,
    model_name: str = "moge2",
    batch_frames: int = 4,
    data_norm_type: str = "dinov2",
    image_modality: str = "image",
) -> Path:
    """Label every frame of a WAI scene with predicted depth + valid mask.

    Args:
        scene_root: converted (and, for distorted sources, undistorted)
            WAI scene directory.
        adapter: a model of the adapter contract (`models/adapters.py`),
            e.g. ``MapAnythingAdapter(model)``; its parameters (or its
            ``device`` attribute) name the device the images go to.
        model_name: modality suffix; "moge2" reproduces the reference's
            cfg.model_name and is what `wai_datasets.py` quirk specs read.
        batch_frames: frames per adapter call (run_moge.py batch_size).

    Writes pred_depth/<model>/<frame>.exr (z-depth) and
    pred_mask/<model>/<frame>.png, registers both frame modalities, and
    returns the scene root. When the adapter emits its own per-pixel
    confidence (a "conf" output: MVS models score their matching cost,
    MapAnything its confidence head), it is stored as
    depth_confidence/<model>, the modality name the consistency filter
    (`run_depth_consistency_stage`) produces, so the quirk pipeline
    thresholds either source alike.
    """
    from ..benchmarks.dense_n_view import model_device

    scene_root = Path(scene_root)
    meta = load_scene_meta(scene_root / "scene_meta.json")
    frames = meta["frames"]
    depth_key = f"pred_depth/{model_name}"
    mask_key = f"pred_mask/{model_name}"
    conf_key = f"depth_confidence/{model_name}"
    wrote_conf = False
    device = model_device(adapter)
    step = max(int(batch_frames), 1)

    for start in range(0, len(frames), step):
        chunk = frames[start:start + step]
        imgs = []
        for fr in chunk:
            data = load_frame(scene_root, fr["frame_name"],
                              modalities=[image_modality], scene_meta=meta)
            imgs.append(np.asarray(data[image_modality], np.float32) / 255.0)
        # (B=1, V=len(chunk), H, W, 3) normalised, the contract's layout
        img = _normalize_images(np.stack(imgs)[None], data_norm_type)
        with torch.inference_mode():
            preds = adapter({"img": torch.from_numpy(img).to(device)})
        z = _host(preds["pts3d_cam"][..., 2])[0]
        m = _host(preds["non_ambiguous_mask"])[0].astype(bool)
        z = np.where(np.isfinite(z) & (z > 0), z, 0.0)
        conf = None
        if "conf" in preds:  # model-emitted confidence (MVS-style)
            conf = _host(preds["conf"])[0]
            conf = np.where(np.isfinite(conf), conf, 0.0)
        for i, fr in enumerate(chunk):
            name = fr["frame_name"]
            rel_depth = f"pred_depth/{model_name}/{name}.exr"
            rel_mask = f"pred_mask/{model_name}/{name}.png"
            store_data(scene_root / rel_depth, z[i], "depth")
            store_data(scene_root / rel_mask, m[i], "binary")
            fr[depth_key] = rel_depth
            fr[mask_key] = rel_mask
            if conf is not None:
                rel_conf = f"depth_confidence/{model_name}/{name}.exr"
                store_data(scene_root / rel_conf, conf[i], "depth")
                fr[conf_key] = rel_conf
                wrote_conf = True

    meta["frame_modalities"][depth_key] = {"frame_key": depth_key,
                                           "format": "depth"}
    meta["frame_modalities"][mask_key] = {"frame_key": mask_key,
                                          "format": "binary"}
    if wrote_conf:
        meta["frame_modalities"][conf_key] = {"frame_key": conf_key,
                                              "format": "depth"}
    meta.pop("frame_names", None)  # derived; regenerated by the reader
    store_data(scene_root / "scene_meta.json", meta, "readable")
    return scene_root


def run_depth_consistency_stage(
    scene_root: str,
    depth_modality: str,
    model_name: Optional[str] = None,
    target_size: int = 360,
    device=None,
    **consistency_kwargs,
) -> Path:
    """Score a (pseudo-)depth modality's multi-view consistency per pixel.

    The filtering half of the pseudo-depth pipeline (reference
    depth_consistency_confidence.py): unproject every frame's depth,
    reproject into the others, and store inlier-fraction confidence maps
    as `depth_confidence/<model>`, the modality the dl3dv-style quirk
    pipeline thresholds at train time (wai_datasets.py
    confidence_modality / confidence_threshold).

    Args:
        depth_modality: which depth to score, e.g. "pred_depth/moge2".
        model_name: output suffix; defaults to depth_modality's tail.
        device: where the scores are computed; the card when None.
    """
    from .covisibility import compute_depth_consistency_confidence

    scene_root = Path(scene_root)
    meta = load_scene_meta(scene_root / "scene_meta.json")
    frames = meta["frames"]
    model_name = model_name or depth_modality.rsplit("/", 1)[-1]
    conf_key = f"depth_confidence/{model_name}"

    depths, Ks, poses = [], [], []
    for fr in frames:
        data = load_frame(scene_root, fr["frame_name"],
                          modalities=[depth_modality], scene_meta=meta)
        depths.append(np.asarray(data[depth_modality], np.float32))
        Ks.append(data["intrinsics"])
        poses.append(data["extrinsics"])
    conf = compute_depth_consistency_confidence(
        np.stack(depths), np.stack(Ks), np.stack(poses),
        target_size=target_size, device=device, **consistency_kwargs)

    for i, fr in enumerate(frames):
        rel = f"depth_confidence/{model_name}/{fr['frame_name']}.exr"
        store_data(scene_root / rel, conf[i], "depth")
        fr[conf_key] = rel
    meta["frame_modalities"][conf_key] = {"frame_key": conf_key,
                                          "format": "depth"}
    meta.pop("frame_names", None)
    store_data(scene_root / "scene_meta.json", meta, "readable")
    return scene_root
