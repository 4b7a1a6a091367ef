"""GLB exports of point clouds and camera frustums; counterpart of
mapanything_tpu/utils/viz.py (numpy, no trimesh).

The files are glTF 2.0 binaries: a POSITION + COLOR_0 point primitive and,
in a scene, a LINES primitive tracing one frustum per camera. Their bytes
equal the JAX package's writer's on the same inputs.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional

import numpy as np


def write_glb_pointcloud(path: str, points: np.ndarray, colors: np.ndarray
                         ) -> None:
    """points (N, 3) float32, colors (N, 3) float [0,1] or uint8."""
    points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    if len(points) == 0:
        # glTF requires accessor.count >= 1, and min()/max() of an empty
        # array raises — tell the user what filtered everything instead
        raise ValueError(
            "no points to export (all pixels masked out? lower the "
            "confidence percentile / disable masking)")
    if colors.dtype != np.uint8:
        colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    colors = np.ascontiguousarray(colors).reshape(-1, 3)
    # pad colors to vec4 ubyte normalized? vec3 ubyte requires 4-byte stride
    # alignment; use vec4 with alpha 255 for safety
    rgba = np.concatenate(
        [colors, np.full((len(colors), 1), 255, np.uint8)], axis=1
    )

    pos_bytes = points.tobytes()
    col_bytes = rgba.tobytes()
    bin_chunk = pos_bytes + col_bytes
    pad = (-len(bin_chunk)) % 4
    bin_chunk += b"\x00" * pad

    gltf = {
        "asset": {"version": "2.0", "generator": "mapanything_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{
            "primitives": [{
                "attributes": {"POSITION": 0, "COLOR_0": 1},
                "mode": 0,  # POINTS
            }]
        }],
        "accessors": [
            {
                "bufferView": 0, "componentType": 5126, "count": len(points),
                "type": "VEC3",
                "min": points.min(0).tolist(), "max": points.max(0).tolist(),
            },
            {
                "bufferView": 1, "componentType": 5121, "count": len(rgba),
                "type": "VEC4", "normalized": True,
            },
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(pos_bytes)},
            {"buffer": 0, "byteOffset": len(pos_bytes),
             "byteLength": len(col_bytes)},
        ],
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    json_bytes = json.dumps(gltf).encode()
    json_bytes += b" " * ((-len(json_bytes)) % 4)

    with open(path, "wb") as f:
        total = 12 + 8 + len(json_bytes) + 8 + len(bin_chunk)
        f.write(struct.pack("<4sII", b"glTF", 2, total))
        f.write(struct.pack("<I4s", len(json_bytes), b"JSON"))
        f.write(json_bytes)
        f.write(struct.pack("<I4s", len(bin_chunk), b"BIN\x00"))
        f.write(bin_chunk)


def predictions_to_glb(
    path: str,
    preds: List[Dict],
    max_points: Optional[int] = 2_000_000,
    seed: int = 0,
) -> int:
    """Export per-view prediction dicts (the infer() output contract) as a
    colored GLB point cloud; returns the number of points written."""
    all_pts, all_cols = [], []
    for p in preds:
        pts = np.asarray(p["pts3d"]).reshape(-1, 3)
        cols = np.asarray(p["img_no_norm"]).reshape(-1, 3)
        if "mask" in p:
            m = np.asarray(p["mask"]).reshape(-1).astype(bool)
            pts, cols = pts[m], cols[m]
        all_pts.append(pts)
        all_cols.append(cols)
    pts = np.concatenate(all_pts) if all_pts else np.zeros((0, 3), np.float32)
    cols = np.concatenate(all_cols) if all_cols else np.zeros((0, 3))
    if max_points and len(pts) > max_points:
        idx = np.random.default_rng(seed).choice(
            len(pts), max_points, replace=False
        )
        pts, cols = pts[idx], cols[idx]
    write_glb_pointcloud(path, pts, cols)
    return len(pts)


def _frustum_segments(pose: np.ndarray, K: np.ndarray, wh, scale: float
                      ) -> np.ndarray:
    """(8 segments, 2, 3) world-frame line segments tracing a camera
    frustum pyramid for one cam2world pose."""
    w, h = wh
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    corners_px = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    rays = np.stack([
        (corners_px[:, 0] - cx) / fx,
        (corners_px[:, 1] - cy) / fy,
        np.ones(4),
    ], axis=-1)
    cam_pts = rays * scale  # image-plane corners at depth `scale`
    world = cam_pts @ pose[:3, :3].T + pose[:3, 3]
    center = np.broadcast_to(pose[:3, 3], (4, 3))
    segs = []
    for i in range(4):  # apex -> corners
        segs.append([center[i], world[i]])
    for i in range(4):  # image-plane rectangle
        segs.append([world[i], world[(i + 1) % 4]])
    return np.asarray(segs, np.float32)


def write_glb_scene(
    path: str,
    points: np.ndarray,
    colors: np.ndarray,
    camera_poses: Optional[np.ndarray] = None,
    intrinsics: Optional[np.ndarray] = None,
    image_wh: Optional[tuple] = None,
    frustum_scale: Optional[float] = None,
) -> None:
    """GLB with a colored point cloud + camera-frustum line wireframes
    (the reference predictions_to_glb scene contents, hf_utils/viz.py
    trimesh camera cones — rebuilt as raw glTF LINES primitives).

    Args:
        camera_poses: (V, 4, 4) cam2world; intrinsics: (V, 3, 3);
        image_wh: (w, h) pixel size matching the intrinsics.
    """
    points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    if colors.dtype != np.uint8:
        colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    rgba = np.concatenate(
        [colors.reshape(-1, 3), np.full((len(points), 1), 255, np.uint8)],
        axis=1,
    )

    if camera_poses is None:
        write_glb_pointcloud(path, points, colors)
        return
    camera_poses = np.asarray(camera_poses, np.float64).reshape(-1, 4, 4)
    intrinsics = np.asarray(intrinsics, np.float64).reshape(-1, 3, 3)
    if frustum_scale is None:
        span = (points.max(0) - points.min(0)) if len(points) else np.ones(3)
        frustum_scale = 0.08 * float(np.linalg.norm(span) + 1e-6)
    segs = np.concatenate([
        _frustum_segments(p, k, image_wh, frustum_scale)
        for p, k in zip(camera_poses, intrinsics)
    ])  # (S, 2, 3)
    line_pts = np.ascontiguousarray(segs.reshape(-1, 3), np.float32)
    # alternate endpoint colors: red frustums
    line_cols = np.tile(np.array([[255, 40, 40, 255]], np.uint8),
                        (len(line_pts), 1))

    pos_bytes = points.tobytes()
    col_bytes = rgba.tobytes()
    lpos_bytes = line_pts.tobytes()
    lcol_bytes = line_cols.tobytes()
    offsets = []
    buf = b""
    for chunk in (pos_bytes, col_bytes, lpos_bytes, lcol_bytes):
        offsets.append(len(buf))
        buf += chunk + b"\x00" * ((-len(chunk)) % 4)
    bin_chunk = buf + b"\x00" * ((-len(buf)) % 4)

    def acc_minmax(arr):
        if len(arr) == 0:
            return [0, 0, 0], [0, 0, 0]
        return arr.min(0).tolist(), arr.max(0).tolist()

    pmin, pmax = acc_minmax(points)
    lmin, lmax = acc_minmax(line_pts)
    gltf = {
        "asset": {"version": "2.0", "generator": "mapanything_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [{"mesh": 0}, {"mesh": 1}],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0, "COLOR_0": 1},
                             "mode": 0}]},  # POINTS
            {"primitives": [{"attributes": {"POSITION": 2, "COLOR_0": 3},
                             "mode": 1}]},  # LINES
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(points),
             "type": "VEC3", "min": pmin, "max": pmax},
            {"bufferView": 1, "componentType": 5121, "count": len(rgba),
             "type": "VEC4", "normalized": True},
            {"bufferView": 2, "componentType": 5126, "count": len(line_pts),
             "type": "VEC3", "min": lmin, "max": lmax},
            {"bufferView": 3, "componentType": 5121, "count": len(line_cols),
             "type": "VEC4", "normalized": True},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": offsets[0],
             "byteLength": len(pos_bytes)},
            {"buffer": 0, "byteOffset": offsets[1],
             "byteLength": len(col_bytes)},
            {"buffer": 0, "byteOffset": offsets[2],
             "byteLength": len(lpos_bytes)},
            {"buffer": 0, "byteOffset": offsets[3],
             "byteLength": len(lcol_bytes)},
        ],
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    json_bytes = json.dumps(gltf).encode()
    json_bytes += b" " * ((-len(json_bytes)) % 4)
    with open(path, "wb") as f:
        total = 12 + 8 + len(json_bytes) + 8 + len(bin_chunk)
        f.write(struct.pack("<4sII", b"glTF", 2, total))
        f.write(struct.pack("<I4s", len(json_bytes), b"JSON"))
        f.write(json_bytes)
        f.write(struct.pack("<I4s", len(bin_chunk), b"BIN\x00"))
        f.write(bin_chunk)
