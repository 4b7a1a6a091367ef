"""WAI-format scene IO; counterpart of mapanything_tpu/data/wai.py (the
reference's mapanything/utils/wai/core.py and io.py).

WAI ("World-As-Input") is the on-disk scene format all 14 training datasets
share: per-scene directory with
    scene_meta.json        — frames list (frame_name, transform_matrix,
                             optional per-frame fx/fy/cx/cy/h/w),
                             frame_names (name -> index), frame_modalities
                             (modality -> {frame_key, format}), shared
                             intrinsics, camera_model, scale_type
    covisibility/v0/*.npy  — NxN pairwise covisibility matrix (mmap'd)
    <modality dirs>        — images (jpg/png), depth (EXR / 16-bit png / npy)

Host code (numpy and PIL); the loader hands its batches to the trainer as
numpy arrays.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import PIL.Image

_DEPTH_SCALE_PNG16 = 1000.0  # mm-encoded 16-bit png depth


def load_scene_meta(path: Union[str, Path]) -> Dict[str, Any]:
    """Load scene_meta.json (reference wai/core.py:32 'scene_meta' format)."""
    with open(path) as f:
        meta = json.load(f)
    if "frame_names" not in meta:
        meta["frame_names"] = {
            fr["frame_name"]: i for i, fr in enumerate(meta["frames"])
        }
    return meta


def load_covisibility_mmap(scene_root: Union[str, Path],
                           version: str = "v0") -> np.ndarray:
    """Memory-map the scene's pairwise covisibility matrix
    (reference pattern: datasets/wai/scannetpp.py:88-101)."""
    covis_dir = Path(scene_root) / "covisibility" / version
    npy = next(f for f in os.listdir(covis_dir) if f.endswith(".npy"))
    return np.load(covis_dir / npy, mmap_mode="r")


def _load_depth(path: Path) -> np.ndarray:
    suffix = path.suffix.lower()
    if suffix == ".npy":
        return np.load(path).astype(np.float32)
    if suffix == ".exr":
        # the pure-Python codec (data/exr.py): no EXR package is needed
        from .exr import read_exr

        d = read_exr(path)
        if d.ndim == 3:
            d = d[..., 0]
        return d.astype(np.float32)
    if suffix == ".png":
        d = np.asarray(PIL.Image.open(path))
        if d.dtype == np.uint16:
            return d.astype(np.float32) / _DEPTH_SCALE_PNG16
        return d.astype(np.float32)
    raise ValueError(f"unsupported depth format: {path}")


def get_intrinsics(meta: Dict[str, Any], frame: Dict[str, Any]) -> np.ndarray:
    """Pinhole K from per-frame or scene-shared focal/principal-point keys.

    Accepts both this repo's fx/fy spelling and the reference WAI format's
    fl_x/fl_y (reference utils/wai/camera.py:19 PINHOLE_CAM_KEYS)."""
    def get(*keys):
        for k in keys:
            v = frame.get(k, meta.get(k))
            if v is not None:
                return v
        raise KeyError(f"intrinsics key {keys[0]!r} (or alias) missing from "
                       "frame and scene meta")

    K = np.eye(3, dtype=np.float32)
    K[0, 0] = float(get("fx", "fl_x"))
    K[1, 1] = float(get("fy", "fl_y"))
    K[0, 2] = float(get("cx"))
    K[1, 2] = float(get("cy"))
    return K


def load_frame(
    scene_root: Union[str, Path],
    frame_key: Union[int, str],
    modalities: Optional[List[str]] = None,
    scene_meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Load one frame: extrinsics (opencv cam2world), pinhole intrinsics, and
    the requested modalities (reference wai/core.py:357, fmt='np')."""
    scene_root = Path(scene_root)
    if scene_meta is None:
        scene_meta = load_scene_meta(scene_root / "scene_meta.json")

    if isinstance(frame_key, str):
        idx = scene_meta["frame_names"][frame_key]
    else:
        idx = int(frame_key)
    frame = scene_meta["frames"][idx]

    out: Dict[str, Any] = {
        "frame_name": frame["frame_name"],
        "frame_idx": idx,
        "w": frame.get("w", scene_meta.get("w")),
        "h": frame.get("h", scene_meta.get("h")),
    }
    if "transform_matrix" in frame:
        out["extrinsics"] = np.asarray(frame["transform_matrix"], np.float32)
    camera_model = frame.get("camera_model", scene_meta.get("camera_model", "PINHOLE"))
    out["camera_model"] = camera_model
    if camera_model == "PINHOLE":
        out["intrinsics"] = get_intrinsics(scene_meta, frame)

    frame_modalities = scene_meta.get("frame_modalities", {})
    for modality in modalities or []:
        fm = frame_modalities.get(modality)
        if fm is None:
            raise KeyError(
                f"modality {modality!r} not in scene (has: {sorted(frame_modalities)})"
            )
        frame_key_field = fm["frame_key"] if isinstance(fm, dict) else fm
        rel_path = frame[frame_key_field]
        path = scene_root / rel_path
        if "depth" in modality:
            out[modality] = _load_depth(path)
        elif modality in ("image", "rendered_image"):
            out[modality] = np.asarray(
                PIL.Image.open(path).convert("RGB"), dtype=np.uint8
            )
        elif "mask" in modality:
            out[modality] = np.asarray(PIL.Image.open(path)).astype(bool)
        else:
            # generic: npy or image
            if str(path).endswith(".npy"):
                out[modality] = np.load(path)
            else:
                out[modality] = np.asarray(PIL.Image.open(path))
    return out


# ---------------------------------------------------------------------------
# Writer / format-dispatch surface (reference wai/core.py:32-77 load_data /
# store_data and io.py per-format _store_* handlers). Host-side by design.
# ---------------------------------------------------------------------------

def _depth_format(path: Path) -> str:
    return path.suffix.lower().lstrip(".")


def store_data(path: Union[str, Path], data: Any,
               format_type: Optional[str] = None) -> Path:
    """Write `data` in a WAI on-disk format, dispatched on format_type (or
    the file extension). Formats: image | depth | binary | numpy | mmap |
    readable (json). Ref: wai/core.py:55, io.py:145-797."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fmt = format_type or {
        ".png": "image", ".jpg": "image", ".jpeg": "image",
        ".exr": "depth", ".npy": "numpy", ".json": "readable",
    }.get(path.suffix.lower(), None)
    if fmt is None:
        raise ValueError(f"cannot infer format for {path}")

    if fmt == "readable":
        with open(path, "w") as f:
            json.dump(data, f, indent=1)
    elif fmt == "image":
        arr = np.asarray(data)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        PIL.Image.fromarray(arr).save(path)
    elif fmt == "binary":
        arr = np.asarray(data).astype(bool)
        PIL.Image.fromarray(arr.astype(np.uint8) * 255).save(path)
    elif fmt == "depth":
        arr = np.asarray(data, np.float32)
        sfx = _depth_format(path)
        if sfx == "npy":
            np.save(path, arr)
        elif sfx == "exr":
            from .exr import write_exr

            write_exr(path, arr)
        elif sfx == "png":  # 16-bit mm-encoded png
            mm = np.clip(arr * _DEPTH_SCALE_PNG16, 0, 65535).astype(np.uint16)
            PIL.Image.fromarray(mm).save(path)
        else:
            raise ValueError(f"unsupported depth ext: {path}")
    elif fmt == "numpy":
        np.save(path, np.asarray(data))
    elif fmt == "mmap":
        np.save(path, np.asarray(data))  # np.load(..., mmap_mode) reads it
    else:
        raise ValueError(f"unknown format_type {fmt!r}")
    return path


def load_data(path: Union[str, Path], format_type: Optional[str] = None):
    """Read counterpart of store_data (reference wai/core.py:32)."""
    path = Path(path)
    fmt = format_type or {
        ".png": "image", ".jpg": "image", ".jpeg": "image",
        ".exr": "depth", ".npy": "numpy", ".json": "readable",
    }.get(path.suffix.lower(), None)
    if fmt == "readable":
        with open(path) as f:
            return json.load(f)
    if fmt == "image":
        return np.asarray(PIL.Image.open(path).convert("RGB"), np.uint8)
    if fmt == "binary":
        return np.asarray(PIL.Image.open(path)).astype(bool)
    if fmt == "depth":
        return _load_depth(path)
    if fmt == "numpy":
        return np.load(path)
    if fmt == "mmap":
        return np.load(path, mmap_mode="r")
    raise ValueError(f"unknown format_type {fmt!r} for {path}")


def set_frame(scene_meta: Dict[str, Any], frame_name: str,
              frame: Dict[str, Any]) -> None:
    """Insert/replace a frame record in scene_meta (wai/core.py:446)."""
    names = scene_meta.setdefault("frame_names", {})
    frame = dict(frame, frame_name=frame_name)
    if frame_name in names:
        scene_meta["frames"][names[frame_name]] = frame
    else:
        names[frame_name] = len(scene_meta.get("frames", []))
        scene_meta.setdefault("frames", []).append(frame)


def write_scene(
    scene_root: Union[str, Path],
    frames: List[Dict[str, Any]],
    intrinsics: Dict[str, float],
    covisibility: Optional[np.ndarray] = None,
    depth_format: str = "npy",
    scene_meta_extra: Optional[Dict[str, Any]] = None,
) -> Path:
    """Serialize a scene into the WAI on-disk layout.

    Each frame dict: {"frame_name", "image" (H,W,3), "depth" (H,W),
    "transform_matrix" (4,4) opencv cam2world, optional "masks": {name:
    bool (H,W)}}. `intrinsics`: fx/fy/cx/cy (+ w/h). The inverse of this
    reader module — gives the framework the offline data_processing writer
    role for WAI conversion (reference data_processing/*, wai io.py
    writers)."""
    scene_root = Path(scene_root)
    meta: Dict[str, Any] = {
        "scene_name": scene_root.name,
        "camera_model": "PINHOLE",
        **intrinsics,
        "frames": [],
        "frame_names": {},
        "frame_modalities": {
            "image": {"frame_key": "image", "format": "image"},
            "depth": {"frame_key": "depth", "format": "depth"},
        },
        **(scene_meta_extra or {}),
    }
    for fr in frames:
        name = fr["frame_name"]
        img_rel = f"images/{name}.png"
        depth_rel = f"depth/{name}.{depth_format}"
        store_data(scene_root / img_rel, fr["image"], "image")
        store_data(scene_root / depth_rel, fr["depth"], "depth")
        rec = {
            "transform_matrix": np.asarray(fr["transform_matrix"],
                                           np.float64).tolist(),
            "image": img_rel,
            "depth": depth_rel,
        }
        for mname, m in (fr.get("masks") or {}).items():
            rel = f"{mname}/{name}.png"
            store_data(scene_root / rel, m, "binary")
            rec[mname] = rel
            meta["frame_modalities"].setdefault(
                mname, {"frame_key": mname, "format": "binary"}
            )
        set_frame(meta, name, rec)
    if covisibility is not None:
        store_data(scene_root / "covisibility" / "v0" / "covis.npy",
                   covisibility, "mmap")
    store_data(scene_root / "scene_meta.json", meta, "readable")
    return scene_root


# ---------------------------------------------------------------------------
# Frame accessors + camera interpolation (reference wai/core.py:78-213,
# camera.py:94-170). Float frame keys interpolate between the neighbors.
# ---------------------------------------------------------------------------

_CAMERA_KEYS = ("fx", "fy", "cx", "cy")


def interpolate_intrinsics(frame1: Dict[str, Any], frame2: Dict[str, Any],
                           alpha: float) -> Dict[str, Any]:
    """Linear fx/fy/cx/cy interpolation (camera.py:94)."""
    out = {}
    for key in _CAMERA_KEYS:
        if key in frame1 and key in frame2:
            out[key] = (1 - alpha) * frame1[key] + alpha * frame2[key]
    return out


def quaternion_slerp(q1: np.ndarray, q2: np.ndarray, alpha: float
                     ) -> np.ndarray:
    """Spherical interpolation between quaternions (..., 4) [xyzw] in
    float64: the shorter arc, a normalised lerp where the two are nearly
    parallel; alpha 0 gives q1, alpha 1 gives q2."""
    q1 = np.asarray(q1, np.float64)
    q2 = np.asarray(q2, np.float64)
    q1 = q1 / np.linalg.norm(q1, axis=-1, keepdims=True)
    q2 = q2 / np.linalg.norm(q2, axis=-1, keepdims=True)
    dot = np.sum(q1 * q2, axis=-1, keepdims=True)
    q2 = np.where(dot < 0, -q2, q2)  # shortest path
    theta = np.arccos(np.clip(np.abs(dot), -1.0, 1.0))
    sin_theta = np.sin(theta)
    near = sin_theta < 1e-5
    safe = np.where(near, 1.0, sin_theta)
    w1 = np.where(near, 1.0 - alpha, np.sin((1.0 - alpha) * theta) / safe)
    w2 = np.where(near, alpha, np.sin(alpha * theta) / safe)
    out = w1 * q1 + w2 * q2
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def quaternion_to_rotation_matrix(quat: np.ndarray) -> np.ndarray:
    """Quaternion (4,) [xyzw] -> (3, 3) rotation matrix, float64."""
    x, y, z, w = np.asarray(quat, np.float64) / np.linalg.norm(quat)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def interpolate_extrinsics(matrix1, matrix2, alpha: float) -> np.ndarray:
    """SLERP rotation + lerp translation between 4x4 poses (camera.py:117),
    in float64 numpy."""
    from .base_dataset import rotation_matrix_to_quaternion_np

    m1 = np.asarray(matrix1, np.float64).reshape(4, 4)
    m2 = np.asarray(matrix2, np.float64).reshape(4, 4)
    q = quaternion_slerp(rotation_matrix_to_quaternion_np(m1[:3, :3]),
                         rotation_matrix_to_quaternion_np(m2[:3, :3]), alpha)
    out = np.eye(4)
    out[:3, :3] = quaternion_to_rotation_matrix(q)
    out[:3, 3] = (1 - alpha) * m1[:3, 3] + alpha * m2[:3, 3]
    return out


def get_frame_index(scene_meta: Dict[str, Any],
                    frame_key: Union[int, str, float]):
    """Resolve a frame key (name | index | fractional index) to an index
    (int, or float for interpolation). Ref: wai/core.py:146."""
    if isinstance(frame_key, bool):
        raise TypeError("bool is not a frame key")
    if isinstance(frame_key, str):
        return scene_meta["frame_names"][frame_key]
    if isinstance(frame_key, float) and not frame_key.is_integer():
        return frame_key
    return int(frame_key)


def get_frame(scene_meta: Dict[str, Any],
              frame_key: Union[int, str, float]) -> Dict[str, Any]:
    """Frame record by name/index; fractional keys return an interpolated
    virtual frame (pose SLERP + intrinsics lerp). Ref: wai/core.py:78."""
    idx = get_frame_index(scene_meta, frame_key)
    if isinstance(idx, int):
        frame = dict(scene_meta["frames"][idx])
        frame["_is_interpolated"] = False
        return frame
    # floor, not int(): int(-0.5) == 0 would slip a negative key past the
    # range check and EXTRApolate (negative slerp weight) instead of raising
    left = math.floor(idx)
    if not 0 <= left < len(scene_meta["frames"]) - 1:
        raise IndexError(f"fractional frame key {idx} out of range")
    f1 = scene_meta["frames"][left]
    f2 = scene_meta["frames"][left + 1]
    alpha = idx - left
    frame: Dict[str, Any] = {"frame_name": frame_key,
                             "_is_interpolated": True}
    frame["transform_matrix"] = interpolate_extrinsics(
        f1["transform_matrix"], f2["transform_matrix"], alpha
    ).tolist()
    frame.update(interpolate_intrinsics(
        {k: f1.get(k, scene_meta.get(k)) for k in _CAMERA_KEYS},
        {k: f2.get(k, scene_meta.get(k)) for k in _CAMERA_KEYS},
        alpha,
    ))
    return frame


def get_extrinsics(scene_meta: Dict[str, Any],
                   frame_key: Union[int, str, float]) -> Optional[np.ndarray]:
    """(4, 4) opencv cam2world pose for a (possibly virtual) frame.
    Ref: wai/core.py:129."""
    frame = get_frame(scene_meta, frame_key)
    if "transform_matrix" not in frame:
        return None
    return np.asarray(frame["transform_matrix"], np.float64).reshape(4, 4)


def nest_modality(frame_modalities: Dict[str, Any],
                  modality_name: str) -> Dict[str, Any]:
    """Flat modality entry -> nested {name: entry} form (wai/core.py:475)."""
    frame_modality: Dict[str, Any] = {}
    if modality_name in frame_modalities:
        frame_modality = frame_modalities[modality_name]
        if "frame_key" in frame_modality:
            nested_name = frame_modality["frame_key"].split("_")[0]
            frame_modality = {nested_name: frame_modality}
    return frame_modality
