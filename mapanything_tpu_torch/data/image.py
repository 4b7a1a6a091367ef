"""Host-side image loading with aspect-ratio bucketing; counterpart of
mapanything_tpu/data/image.py::load_images (numpy and PIL only).

Every input set maps to one of ten (W, H) buckets per resolution set, chosen
by the average aspect ratio; each image is Lanczos-downscaled (bicubic when
upscaling) to cover the bucket, centre-cropped and normalised. Images leave
as (1, H, W, 3) float32 NHWC numpy arrays.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence, Union

import numpy as np
import PIL.Image
from PIL.ImageOps import exif_transpose

# name -> (mean, std) of the encoders' input normalisation
IMAGE_NORMALIZATION_DICT = {
    "dinov2": (np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])),
    "croco": (np.array([0.5, 0.5, 0.5]), np.array([0.5, 0.5, 0.5])),
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


def resize_and_center_crop(image: PIL.Image.Image,
                           resolution: tuple[int, int]) -> PIL.Image.Image:
    """Scale so the image covers `resolution` (W, H) - Lanczos down,
    bicubic up - then crop its centre."""
    size = np.array(image.size)
    scale = max(np.array(resolution) / size) + 1e-8
    target = tuple(np.floor(size * scale).astype(int))
    resample = PIL.Image.LANCZOS if scale < 1 else PIL.Image.BICUBIC
    image = image.resize(target, resample=resample)
    w, h = image.size
    tw, th = resolution
    left, top = (w - tw) // 2, (h - th) // 2
    return image.crop((left, top, left + tw, top + th))


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
        im = resize_and_center_crop(im, (target_w, target_h))
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
