"""Host-side image loading and preprocessing with aspect-ratio bucketing;
counterpart of mapanything_tpu/data/image.py (numpy and PIL only).

Every input set maps to one of ten (W, H) buckets per resolution set, chosen
by the average aspect ratio; each image is Lanczos-downscaled (bicubic when
upscaling) to cover the bucket and cropped to it. With intrinsics the crop
keeps the principal point where the camera put it and the intrinsics follow
the scale and the crop (COLMAP pixel-centre convention); z-depth follows by
a nearest-neighbour resize with OpenCV's index rule, written in numpy, as
do the masks the datasets crop with it (`additional_quantities`).
Images leave as (1, H, W, 3) float32 NHWC numpy arrays, normalised.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import PIL.Image
from PIL.ImageOps import exif_transpose

# name -> (mean, std) of the encoders' input normalisation
IMAGE_NORMALIZATION_DICT = {
    "dinov2": (np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])),
    "croco": (np.array([0.5, 0.5, 0.5]), np.array([0.5, 0.5, 0.5])),
    "dust3r": (np.array([0.5, 0.5, 0.5]), np.array([0.5, 0.5, 0.5])),
    "radio": (np.array([0.0, 0.0, 0.0]), np.array([1.0, 1.0, 1.0])),
    "identity": (np.array([0.0, 0.0, 0.0]), np.array([1.0, 1.0, 1.0])),
}

# aspect ratio -> (width, height), per resolution set
RESOLUTION_MAPPINGS = {
    518: {
        1.000: (518, 518), 1.321: (518, 392), 1.542: (518, 336),
        1.762: (518, 294), 2.056: (518, 252), 3.083: (518, 168),
        0.757: (392, 518), 0.649: (336, 518), 0.567: (294, 518),
        0.486: (252, 518),
    },
    512: {
        1.000: (512, 512), 1.333: (512, 384), 1.524: (512, 336),
        1.778: (512, 288), 2.000: (512, 256), 3.200: (512, 160),
        0.750: (384, 512), 0.656: (336, 512), 0.562: (288, 512),
        0.500: (256, 512),
    },
}

SUPPORTED_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".heic")


def find_closest_aspect_ratio(aspect_ratio: float, resolution_set: int = 518):
    """Closest bucket (width, height) for an aspect ratio."""
    table = RESOLUTION_MAPPINGS[resolution_set]
    return table[min(table, key=lambda k: abs(k - aspect_ratio))]


def rgb(img: np.ndarray, norm_type: str = "dinov2") -> np.ndarray:
    """Normalised images back to [0, 1] RGB float32 on the host (the
    visualisers' denormalisation): HWC or NHWC, or CHW / NCHW (moved to
    channels last); uint8 is divided by 255, floats get img * std + mean,
    clipped."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] == 3:
        img = img.transpose(1, 2, 0)
    elif img.ndim == 4 and img.shape[1] == 3 and img.shape[-1] != 3:
        img = img.transpose(0, 2, 3, 1)
    if img.dtype == np.uint8:
        return np.float32(img) / 255.0
    mean, std = IMAGE_NORMALIZATION_DICT[norm_type]
    return np.clip(img * std + mean, 0.0, 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Rescaling and cropping with the intrinsics' bookkeeping
# ---------------------------------------------------------------------------


def _colmap_shift(K: np.ndarray, sign: float) -> np.ndarray:
    K = K.copy()
    K[0, 2] += 0.5 * sign
    K[1, 2] += 0.5 * sign
    return K


def camera_matrix_of_crop(input_camera_matrix: np.ndarray, input_resolution,
                          output_resolution, scaling: float = 1.0,
                          offset_factor: float = 0.5) -> np.ndarray:
    """Intrinsics after a scale and a crop: in COLMAP's pixel-centre
    convention, scale focal and principal point, shift by the crop's
    offset (`offset_factor` of the margins)."""
    margins = (np.asarray(input_resolution) * scaling
               - np.asarray(output_resolution))
    if not np.all(margins >= 0.0):
        raise ValueError(f"crop larger than the image: margins {margins}")
    K = _colmap_shift(input_camera_matrix, +1)  # OpenCV -> COLMAP
    K[:2, :] *= scaling
    K[:2, 2] -= offset_factor * margins
    return _colmap_shift(K, -1)  # COLMAP -> OpenCV


def bbox_from_intrinsics_in_out(input_camera_matrix, output_camera_matrix,
                                output_resolution):
    """The crop box (left, top, right, bottom) that moves the principal
    point from the input intrinsics' to the output's."""
    out_width, out_height = output_resolution
    left, top = np.int32(np.round(
        input_camera_matrix[:2, 2] - output_camera_matrix[:2, 2]))
    return (left, top, left + out_width, top + out_height)


def resize_nearest(arr: np.ndarray, size) -> np.ndarray:
    """`arr` (H, W, ...) resized to `size` (W, H) by nearest neighbour with
    the index rule of OpenCV's INTER_NEAREST: source index
    min(floor(i * (1 / (dst / src))), src - 1), in float64."""
    w, h = (int(x) for x in size)
    sh, sw = arr.shape[:2]
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(np.int64),
                    sh - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(np.int64),
                    sw - 1)
    return arr[ys[:, None], xs]


def rescale_image_and_other_optional_info(
        image: PIL.Image.Image, output_resolution,
        depthmap: Optional[np.ndarray] = None,
        camera_intrinsics: Optional[np.ndarray] = None,
        additional_quantities: Optional[List[np.ndarray]] = None):
    """Scale so the image covers `output_resolution` (W, H): Lanczos when
    downscaling, bicubic when upscaling, nearest for the depth and each
    additional (H, W, ...) quantity; the intrinsics follow the scale.
    Returns (image, depthmap, intrinsics, additional quantities), None
    where none was given."""
    input_resolution = np.array(image.size)  # (W, H)
    scale_final = max(np.array(output_resolution) / image.size) + 1e-8
    target = np.floor(input_resolution * scale_final).astype(int)

    resample = PIL.Image.LANCZOS if scale_final < 1 else PIL.Image.BICUBIC
    image = image.resize(tuple(target), resample=resample)
    if depthmap is not None:
        depthmap = resize_nearest(depthmap, target)
    if additional_quantities is not None:
        additional_quantities = [resize_nearest(q, target)
                                 for q in additional_quantities]
    if camera_intrinsics is not None:
        camera_intrinsics = camera_matrix_of_crop(
            camera_intrinsics, input_resolution, target, scaling=scale_final)
    return image, depthmap, camera_intrinsics, additional_quantities


def crop_image_and_other_optional_info(image, crop_bbox, depthmap=None,
                                       camera_intrinsics=None,
                                       additional_quantities=None):
    """Crop the image, the depth and each additional quantity to
    `crop_bbox`; the principal point moves with the crop. Returns (image,
    depthmap, intrinsics, additional quantities)."""
    left, top, right, bottom = crop_bbox
    image = image.crop((left, top, right, bottom))
    if depthmap is not None:
        depthmap = depthmap[top:bottom, left:right]
    if additional_quantities is not None:
        additional_quantities = [q[top:bottom, left:right]
                                 for q in additional_quantities]
    if camera_intrinsics is not None:
        camera_intrinsics = camera_intrinsics.copy()
        camera_intrinsics[0, 2] -= left
        camera_intrinsics[1, 2] -= top
    return image, depthmap, camera_intrinsics, additional_quantities


def crop_resize_if_necessary(image, resolution,
                             depthmap: Optional[np.ndarray] = None,
                             intrinsics: Optional[np.ndarray] = None,
                             additional_quantities: Optional[
                                 List[np.ndarray]] = None):
    """Cover `resolution` (W, H), then crop to it: centred without
    intrinsics; with them, the crop that keeps the principal point's offset
    (camera_matrix_of_crop at offset factor 0.5). Returns the image alone,
    or a tuple of the image, then the depth, the intrinsics and the list of
    additional quantities (each resized and cropped as the depth) that were
    given."""
    if not isinstance(image, PIL.Image.Image):
        image = PIL.Image.fromarray(image)

    image, depthmap, intrinsics, additional_quantities = (
        rescale_image_and_other_optional_info(
            image, resolution, depthmap, intrinsics, additional_quantities))

    if intrinsics is not None:
        new_intrinsics = camera_matrix_of_crop(intrinsics, image.size,
                                               resolution, offset_factor=0.5)
        crop_bbox = bbox_from_intrinsics_in_out(intrinsics, new_intrinsics,
                                                resolution)
    else:
        w, h = image.size
        tw, th = resolution
        left, top = (w - tw) // 2, (h - th) // 2
        crop_bbox = (left, top, left + tw, top + th)

    image, depthmap, intrinsics, additional_quantities = (
        crop_image_and_other_optional_info(image, crop_bbox, depthmap,
                                           intrinsics, additional_quantities))
    out = (image,) + tuple(x for x in (depthmap, intrinsics,
                                       additional_quantities)
                           if x is not None)
    return out if len(out) > 1 else out[0]


# ---------------------------------------------------------------------------
# load_images / preprocess_inputs
# ---------------------------------------------------------------------------


def _normalize(img: PIL.Image.Image, norm_type: str) -> np.ndarray:
    arr = np.asarray(img, dtype=np.float32) / 255.0
    mean, std = IMAGE_NORMALIZATION_DICT[norm_type]
    return (arr - mean.astype(np.float32)) / std.astype(np.float32)


def load_images(folder_or_list: Union[str, Sequence], norm_type: str = "dinov2",
                resolution_set: int = 518, stride: int = 1,
                verbose: bool = False) -> List[Dict[str, Any]]:
    """Load a folder or list of images (paths or PIL images) into view
    dicts: 'img' (1, H, W, 3) float32 normalised, 'true_shape', 'idx',
    'instance', 'data_norm_type'."""
    if isinstance(folder_or_list, str):
        entries = sorted(
            os.path.join(folder_or_list, f)
            for f in os.listdir(folder_or_list)
            if f.lower().endswith(SUPPORTED_EXTENSIONS))
    else:
        entries = list(folder_or_list)
    entries = entries[::stride]
    if not entries:
        raise ValueError("no images found")

    pil_images = []
    for e in entries:
        img = e if isinstance(e, PIL.Image.Image) else PIL.Image.open(e)
        pil_images.append(exif_transpose(img).convert("RGB"))

    avg_ar = float(np.mean([im.size[0] / im.size[1] for im in pil_images]))
    target_w, target_h = find_closest_aspect_ratio(avg_ar, resolution_set)
    if verbose:
        print(f"load_images: {len(pil_images)} frames -> bucket "
              f"({target_w}x{target_h}) for avg AR {avg_ar:.3f}")

    views = []
    for idx, im in enumerate(pil_images):
        im = crop_resize_if_necessary(im, (target_w, target_h))
        entry = entries[idx]
        views.append({
            "img": _normalize(im, norm_type)[None],
            "true_shape": [(target_h, target_w)],
            "idx": [idx],
            "instance": [str(idx) if isinstance(entry, PIL.Image.Image)
                         else str(entry)],
            "data_norm_type": [norm_type],
        })
    return views


def preprocess_inputs(views: List[Dict[str, Any]], norm_type: str = "dinov2",
                      resolution_set: int = 518) -> List[Dict[str, Any]]:
    """The multimodal counterpart of load_images: every view's image into
    the bucket of the set's average aspect ratio, its z-depth resized with
    it (nearest) and its intrinsics rescaled and shifted by the crop.

    Input views carry 'img' as an HWC uint8 or [0, 1] float array or a PIL
    image, and optionally 'depth_z' (H, W) or (H, W, 1), 'intrinsics'
    (3, 3), 'camera_poses' (4, 4) and 'is_metric_scale'. The output views
    follow the inference API: 'img' (1, H, W, 3) normalised, 'depth_z'
    (1, H, W, 1), 'intrinsics' (1, 3, 3), 'camera_poses' (1, 4, 4),
    'is_metric_scale' (1,) bool, with 'true_shape', 'idx', 'instance' and
    'data_norm_type'.
    """
    pil_images = []
    for v in views:
        img = v["img"]
        if isinstance(img, PIL.Image.Image):
            pil_images.append(img.convert("RGB"))
        else:
            arr = np.asarray(img)
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            pil_images.append(PIL.Image.fromarray(arr))

    avg_ar = float(np.mean([im.size[0] / im.size[1] for im in pil_images]))
    target_w, target_h = find_closest_aspect_ratio(avg_ar, resolution_set)

    out_views = []
    for idx, (v, im) in enumerate(zip(views, pil_images)):
        depth = v.get("depth_z")
        if depth is not None:
            depth = np.asarray(depth, np.float32)
            if depth.ndim == 3:
                depth = depth[..., 0]
        K = v.get("intrinsics")
        if K is not None:
            K = np.asarray(K, np.float32).copy()

        result = crop_resize_if_necessary(im, (target_w, target_h),
                                          depthmap=depth, intrinsics=K)
        result = list(result) if isinstance(result, tuple) else [result]
        im2 = result.pop(0)
        depth2 = result.pop(0) if depth is not None else None
        K2 = result.pop(0) if K is not None else None

        out = {
            "img": _normalize(im2, norm_type)[None],
            "true_shape": [(target_h, target_w)],
            "idx": [idx],
            "instance": [str(idx)],
            "data_norm_type": [norm_type],
        }
        if depth2 is not None:
            out["depth_z"] = depth2[None, ..., None]
        if K2 is not None:
            out["intrinsics"] = K2[None]
        if "camera_poses" in v:
            poses = np.asarray(v["camera_poses"], np.float32)
            out["camera_poses"] = poses[None] if poses.ndim == 2 else poses
        if "is_metric_scale" in v:
            # a (1,) bool array, batched along axis 0 like every other
            # per-view array (serve.py merges scenes that way)
            out["is_metric_scale"] = np.atleast_1d(
                np.asarray(v["is_metric_scale"], bool))
        out_views.append(out)
    return out_views
