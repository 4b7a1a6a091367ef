"""Generic COLMAP -> WAI scene converter; counterpart of
mapanything_tpu/data/conversion.py (host numpy, covisibility on the card).

The reference ships 14 per-source conversion scripts under
``data_processing/wai_processing/scripts/conversion/``; the COLMAP-backed
ones (``eth3d.py``, ``dl3dv.py``, ``megadepth.py``, ``scannetppv2.py``,
``blendedmvs.py``) share one recipe: read a COLMAP sparse reconstruction,
invert the world2cam quaternion poses (``eth3d.py
pose_matrix_from_quaternion``), carry pinhole intrinsics, and store images
+ depth + poses in the WAI layout via ``store_data``.

This module is that shared recipe as one generic converter built on the
port's pure-numpy COLMAP binary readers (`utils/colmap_io.py`) and WAI
writers (`data/wai.py`), so any COLMAP-format capture (ETH3D, DL3DV,
MegaDepth, a ScanNet++-style rig, or `demo_colmap.py`'s exports) becomes a
WAI scene that `data/wai_datasets.py` can train on.

Depth sources, mirroring the reference scripts' three modes:
  * ``"points"`` (default): z-buffer the sparse points3D into every view,
    the sparse-depth supervision COLMAP-only datasets provide.
  * ``"none"``: images + cameras only (the dl3dv.py posture, which stores
    no depth at conversion time).
  * ``external_depths``: a ``{image_name: (H, W) float array}`` map for
    datasets that ship dense depth alongside COLMAP (eth3d.py raw-depth,
    megadepth.py H5 depth role).

Covisibility (the reference's separate offline
``wai_processing/scripts/covisibility.py`` stage) can be computed inline
from dense depths with ``covisibility=True``: it runs
`data/covisibility.py` on ``device`` (the card by default) and stores the
matrix the samplers' random walk reads.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from .wai import set_frame, store_data

__all__ = ["colmap_to_wai", "sparse_depth_from_points"]


def _camera_K(cam: Dict) -> np.ndarray:
    """Pinhole K from a COLMAP camera record (SIMPLE_PINHOLE or PINHOLE)."""
    p = cam["params"]
    K = np.eye(3, dtype=np.float64)
    if cam["model_id"] == 0:  # SIMPLE_PINHOLE: f, cx, cy
        K[0, 0] = K[1, 1] = p[0]
        K[0, 2], K[1, 2] = p[1], p[2]
    elif cam["model_id"] == 1:  # PINHOLE: fx, fy, cx, cy
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = p[:4]
    else:
        raise ValueError(
            f"unsupported COLMAP camera model id {cam['model_id']}; "
            "undistort to PINHOLE first (data/undistort.py handles OPENCV "
            "and OPENCV_FISHEYE; the reference scripts use pycolmap "
            "image_undistorter)"
        )
    return K


def sparse_depth_from_points(
    points_world: np.ndarray,
    intrinsics: np.ndarray,
    cam2world: np.ndarray,
    height: int,
    width: int,
) -> np.ndarray:
    """Z-buffer render of sparse 3D points into one view.

    Returns an (H, W) float32 depth map, 0 where no point lands — the
    sparse-depth modality COLMAP-only datasets supervise with. Nearest
    point wins per pixel (vectorized scatter-min via argsort).
    """
    pts = np.asarray(points_world, np.float64)
    w2c_R = np.asarray(cam2world)[:3, :3].T
    w2c_t = -w2c_R @ np.asarray(cam2world)[:3, 3]
    pc = pts @ w2c_R.T + w2c_t
    z = pc[:, 2]
    front = z > 1e-6
    pc, z = pc[front], z[front]
    K = np.asarray(intrinsics, np.float64)
    u = K[0, 0] * pc[:, 0] / z + K[0, 2]
    v = K[1, 1] * pc[:, 1] / z + K[1, 2]
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    ok = (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    ui, vi, z = ui[ok], vi[ok], z[ok]
    depth = np.zeros((height, width), np.float32)
    # scatter-min: sort descending by z so the nearest point writes last
    order = np.argsort(-z)
    depth[vi[order], ui[order]] = z[order].astype(np.float32)
    return depth


def colmap_to_wai(
    sparse_dir: Union[str, Path],
    images_dir: Union[str, Path],
    out_dir: Union[str, Path],
    *,
    depth_source: str = "points",
    external_depths: Optional[Dict[str, np.ndarray]] = None,
    covisibility: bool = False,
    depth_format: str = "npy",
    scene_name: Optional[str] = None,
    device=None,
) -> Path:
    """Convert one COLMAP sparse reconstruction into a WAI scene.

    Args:
        sparse_dir: directory holding cameras.bin / images.bin /
            points3D.bin (a COLMAP ``sparse/0``).
        images_dir: directory holding the images referenced by images.bin.
        out_dir: WAI scene root to create.
        depth_source: "points" (z-buffer sparse points3D), "external"
            (take maps from ``external_depths``), or "none".
        external_depths: {image_name: (H, W) depth} when
            ``depth_source == "external"``.
        covisibility: compute + store the pairwise covisibility mmap
            (requires dense-ish depth, i.e. ``depth_source == "external"``).
        depth_format: "npy", "exr", or "png" (16-bit millimetre PNG).
        device: where the covisibility is computed; the card when None.

    Returns the scene root. The output loads through `wai.load_frame`
    and `wai_datasets.WAIDataset` unchanged.
    """
    from PIL import Image

    from ..utils.colmap_io import (
        quaternion_wxyz_to_matrix_np,
        read_cameras_bin,
        read_images_bin,
        read_points3d_bin,
    )

    sparse_dir, images_dir = Path(sparse_dir), Path(images_dir)
    out_dir = Path(out_dir)
    cameras = {c["camera_id"]: c for c in read_cameras_bin(
        str(sparse_dir / "cameras.bin"))}
    images = read_images_bin(str(sparse_dir / "images.bin"))
    points_path = sparse_dir / "points3D.bin"
    points = None
    if depth_source == "points":
        if not points_path.exists():
            raise FileNotFoundError(
                f"{points_path} missing but depth_source='points'")
        points, _ = read_points3d_bin(str(points_path))
    elif depth_source == "external":
        if external_depths is None:
            raise ValueError("depth_source='external' needs external_depths")
    elif depth_source != "none":
        raise ValueError(f"unknown depth_source {depth_source!r}")
    if covisibility and depth_source != "external":
        # fail before anything is written, not after the full scene is
        # on disk
        raise ValueError(
            "covisibility needs dense depth (depth_source='external'); "
            "sparse point renders under-count overlap")

    if not images:
        raise ValueError(
            f"{sparse_dir}: reconstruction registered zero images "
            "(failed COLMAP run?) — nothing to convert")
    images = sorted(images, key=lambda im: im["name"])
    shared_cam = len({im["camera_id"] for im in images}) == 1

    # frame keys must be unique: basenames alone collide for multi-camera
    # rigs (cam0/0001.png vs cam1/0001.png), so keep the relative path
    def _frame_key(name: str) -> str:
        return Path(name).with_suffix("").as_posix().replace("/", "_")

    keys = [_frame_key(im["name"]) for im in images]
    if len(set(keys)) != len(keys):
        dup = sorted({k for k in keys if keys.count(k) > 1})
        raise ValueError(f"frame keys collide after path flattening: {dup}")

    meta: Dict = {
        "scene_name": scene_name or out_dir.name,
        "camera_model": "PINHOLE",
        "frames": [],
        "frame_names": {},
        "frame_modalities": {"image": {"frame_key": "image",
                                       "format": "image"}},
        "source": "colmap",
    }
    has_depth = depth_source != "none"
    if has_depth:
        meta["frame_modalities"]["depth"] = {
            "frame_key": "depth", "format": "depth"}

    all_depths: List[np.ndarray] = []
    all_K: List[np.ndarray] = []
    all_c2w: List[np.ndarray] = []
    for im in images:
        cam = cameras[im["camera_id"]]
        K = _camera_K(cam)
        R_w2c = quaternion_wxyz_to_matrix_np(im["qvec"])
        t_w2c = np.asarray(im["tvec"], np.float64)
        c2w = np.eye(4, dtype=np.float64)
        c2w[:3, :3] = R_w2c.T
        c2w[:3, 3] = -R_w2c.T @ t_w2c

        img_path = images_dir / im["name"]
        img = np.asarray(Image.open(img_path).convert("RGB"))
        h, w = img.shape[:2]
        if (w, h) != (cam["width"], cam["height"]):
            raise ValueError(
                f"{im['name']}: image is {w}x{h} but COLMAP camera says "
                f"{cam['width']}x{cam['height']}")

        stem = _frame_key(im["name"])
        img_rel = f"images/{stem}.png"
        store_data(out_dir / img_rel, img, "image")
        rec: Dict = {
            "transform_matrix": c2w.tolist(),
            "image": img_rel,
            "h": int(h),
            "w": int(w),
        }
        if not shared_cam:
            rec.update(fx=float(K[0, 0]), fy=float(K[1, 1]),
                       cx=float(K[0, 2]), cy=float(K[1, 2]))

        if has_depth:
            if depth_source == "points":
                depth = sparse_depth_from_points(points, K, c2w, h, w)
            else:
                if im["name"] not in external_depths:
                    raise KeyError(f"no external depth for {im['name']}")
                depth = np.asarray(external_depths[im["name"]], np.float32)
                if depth.shape != (h, w):
                    raise ValueError(
                        f"{im['name']}: external depth is {depth.shape} but "
                        f"the image is {(h, w)} — resample it first "
                        "(covisibility would silently score against the "
                        "wrong intrinsics)")
            depth_rel = f"depth/{stem}.{depth_format}"
            store_data(out_dir / depth_rel, depth, "depth")
            rec["depth"] = depth_rel
            all_depths.append(depth)
        all_K.append(K)
        all_c2w.append(c2w)
        set_frame(meta, stem, rec)

    K0 = all_K[0]
    if shared_cam:
        meta.update(fx=float(K0[0, 0]), fy=float(K0[1, 1]),
                    cx=float(K0[0, 2]), cy=float(K0[1, 2]))
    first = images[0]
    cam0 = cameras[first["camera_id"]]
    meta.update(w=int(cam0["width"]), h=int(cam0["height"]))

    if covisibility:
        from .covisibility import compute_pairwise_covisibility

        covis = compute_pairwise_covisibility(
            np.stack(all_depths), np.stack(all_K).astype(np.float32),
            np.stack(all_c2w).astype(np.float32), device=device)
        store_data(out_dir / "covisibility" / "v0" / "covis.npy",
                   covis, "mmap")

    store_data(out_dir / "scene_meta.json", meta, "readable")
    return out_dir


def main(argv: Optional[List[str]] = None) -> None:
    """CLI: convert COLMAP reconstruction(s) to WAI scene(s)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sparse_dir", help="COLMAP sparse/0 dir (cameras.bin …)")
    ap.add_argument("images_dir", help="directory with the source images")
    ap.add_argument("out_dir", help="WAI scene root to create")
    ap.add_argument("--depth-source", default="points",
                    choices=["points", "none"],
                    help="sparse z-buffer depth from points3D, or no depth")
    ap.add_argument("--depth-format", default="npy",
                    choices=["npy", "exr", "png"])
    args = ap.parse_args(argv)
    root = colmap_to_wai(
        args.sparse_dir, args.images_dir, args.out_dir,
        depth_source=args.depth_source, depth_format=args.depth_format)
    n = len(os.listdir(Path(root) / "images"))
    print(f"wrote WAI scene {root} ({n} frames)")


if __name__ == "__main__":
    main()
