"""COLMAP sparse-model binaries (numpy); counterpart of
mapanything_tpu/utils/colmap_io.py.

Writes cameras.bin, images.bin and points3D.bin in the format COLMAP and
downstream tools (gsplat, nerfstudio) read (COLMAP
src/colmap/scene/reconstruction_io.cc), and reads them back for checks.
COLMAP stores world-to-camera poses with wxyz quaternions; the model's
poses are camera-to-world with xyzw quaternions.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional

import numpy as np

# COLMAP camera model ids
CAMERA_MODELS = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1}

# COLMAP camera model id -> parameter count (src/colmap/sensor/models.h)
COLMAP_CAMERA_MODEL_PARAMS = {
    0: 3,   # SIMPLE_PINHOLE
    1: 4,   # PINHOLE
    2: 4,   # SIMPLE_RADIAL
    3: 5,   # RADIAL
    4: 8,   # OPENCV
    5: 8,   # OPENCV_FISHEYE
    6: 12,  # FULL_OPENCV
    7: 5,   # FOV
    8: 4,   # SIMPLE_RADIAL_FISHEYE
    9: 5,   # RADIAL_FISHEYE
    10: 12,  # THIN_PRISM_FISHEYE
}


def rotation_matrix_to_quaternion_np(rot: np.ndarray) -> np.ndarray:
    """3x3 rotation -> xyzw quaternion (float32), standardised to w >= 0."""
    m = rot
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], dtype=np.float32)
    return -q if q[3] < 0 else q


def quaternion_wxyz_to_matrix_np(qvec) -> np.ndarray:
    """A COLMAP wxyz quaternion -> its 3x3 rotation (float64)."""
    w, x, y, z = np.asarray(qvec, np.float64) / np.linalg.norm(qvec)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def write_cameras_bin(path: str, cameras: List[Dict]) -> None:
    """cameras: [{camera_id, model ("PINHOLE"), width, height,
    params [fx, fy, cx, cy]}]."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras:
            f.write(struct.pack("<iiQQ", cam["camera_id"],
                                CAMERA_MODELS[cam.get("model", "PINHOLE")],
                                cam["width"], cam["height"]))
            for p in cam["params"]:
                f.write(struct.pack("<d", float(p)))


def write_images_bin(path: str, images: List[Dict]) -> None:
    """images: [{image_id, qvec (wxyz, world to camera), tvec, camera_id,
    name, xys (N, 2), point3d_ids (N,)}]; xys may be absent."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images:
            f.write(struct.pack("<i", im["image_id"]))
            for v in im["qvec"]:
                f.write(struct.pack("<d", float(v)))
            for v in im["tvec"]:
                f.write(struct.pack("<d", float(v)))
            f.write(struct.pack("<i", im["camera_id"]))
            f.write(im["name"].encode() + b"\x00")
            xys = np.asarray(im.get("xys", np.zeros((0, 2))))
            ids = np.asarray(im.get("point3d_ids", np.full(len(xys), -1)))
            f.write(struct.pack("<Q", len(xys)))
            for (x, y), pid in zip(xys, ids):
                f.write(struct.pack("<ddq", float(x), float(y), int(pid)))


# one points3D.bin record with an empty track, packed as COLMAP writes it
_POINT_RECORD = np.dtype([("id", "<u8"), ("xyz", "<f8", (3,)),
                          ("rgb", "u1", (3,)), ("error", "<f8"),
                          ("track_len", "<u8")])


def write_points3d_bin(path: str, points: np.ndarray, colors: np.ndarray,
                       errors: Optional[np.ndarray] = None) -> None:
    """points (N, 3); colors (N, 3) uint8, or float in [0, 1]; each point
    with an empty track."""
    points = np.asarray(points, np.float64)
    if colors.dtype != np.uint8:
        colors = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    if errors is None:
        errors = np.ones(len(points))
    rec = np.zeros(len(points), _POINT_RECORD)
    rec["id"] = np.arange(1, len(points) + 1)
    rec["xyz"] = points
    rec["rgb"] = colors
    rec["error"] = errors
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        f.write(rec.tobytes())


def export_colmap_reconstruction(out_dir: str, intrinsics: np.ndarray,
                                 cam2world: np.ndarray, image_sizes: List,
                                 image_names: List[str], points: np.ndarray,
                                 colors: np.ndarray) -> str:
    """Write a sparse model into `out_dir` and return it: intrinsics
    (V, 3, 3), cam2world (V, 4, 4), image_sizes [(w, h)] per view, the
    image names, points (N, 3) and their colors (N, 3)."""
    os.makedirs(out_dir, exist_ok=True)
    cameras, images = [], []
    for i in range(len(intrinsics)):
        k = np.asarray(intrinsics[i])
        w, h = image_sizes[i]
        cameras.append(dict(camera_id=i + 1, model="PINHOLE", width=int(w),
                            height=int(h),
                            params=[k[0, 0], k[1, 1], k[0, 2], k[1, 2]]))
        pose = np.asarray(cam2world[i])
        rot_w2c = pose[:3, :3].T
        t_w2c = -rot_w2c @ pose[:3, 3]
        q_xyzw = rotation_matrix_to_quaternion_np(rot_w2c)
        images.append(dict(image_id=i + 1,
                           qvec=[q_xyzw[3], q_xyzw[0], q_xyzw[1], q_xyzw[2]],
                           tvec=t_w2c, camera_id=i + 1, name=image_names[i]))
    write_cameras_bin(os.path.join(out_dir, "cameras.bin"), cameras)
    write_images_bin(os.path.join(out_dir, "images.bin"), images)
    write_points3d_bin(os.path.join(out_dir, "points3D.bin"), points, colors)
    return out_dir


def read_cameras_bin(path: str) -> List[Dict]:
    out = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, model, w, h = struct.unpack("<iiQQ", f.read(24))
            n_params = COLMAP_CAMERA_MODEL_PARAMS[model]
            params = struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            out.append(dict(camera_id=cid, model_id=model, width=w, height=h,
                            params=list(params)))
    return out


def read_images_bin(path: str) -> List[Dict]:
    out = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (iid,) = struct.unpack("<i", f.read(4))
            qvec = struct.unpack("<4d", f.read(32))
            tvec = struct.unpack("<3d", f.read(24))
            (cid,) = struct.unpack("<i", f.read(4))
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (n_pts,) = struct.unpack("<Q", f.read(8))
            f.read(24 * n_pts)
            out.append(dict(image_id=iid, qvec=list(qvec), tvec=list(tvec),
                            camera_id=cid, name=name.decode()))
    return out


def read_points3d_bin(path: str):
    """-> points (N, 3) float64, colors (N, 3) uint8."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        if os.fstat(f.fileno()).st_size == 8 + n * _POINT_RECORD.itemsize:
            rec = np.frombuffer(f.read(), _POINT_RECORD)  # no track anywhere
            return rec["xyz"].copy(), rec["rgb"].copy()
        pts = np.zeros((n, 3))
        cols = np.zeros((n, 3), np.uint8)
        for i in range(n):
            f.read(8)  # id
            pts[i] = struct.unpack("<3d", f.read(24))
            cols[i] = struct.unpack("<3B", f.read(3))
            f.read(8)  # error
            (track_len,) = struct.unpack("<Q", f.read(8))
            f.read(12 * track_len)
    return pts, cols
