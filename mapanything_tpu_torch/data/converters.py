"""Per-source WAI conversion recipes: ETH3D, ScanNetPP-v2, TartanAirV2-WB;
counterpart of mapanything_tpu/data/converters.py.

The generic COLMAP recipe lives in `data/conversion.py`; this module
carries the three benchmark datasets' source-specific quirks so their raw
releases convert to WAI scenes end to end. Each recipe mirrors one
reference script:

  * `convert_eth3d_scene`: reference
    data_processing/wai_processing/scripts/conversion/eth3d.py: text-COLMAP
    calibration, raw float32 depth undistorted by reprojecting the pinhole
    grid through the THIN_PRISM_FISHEYE model, and the originally-portrait
    image rotation quirk (camera params + pose counter-rotated).
  * `convert_scannetppv2_scene`: scannetppv2.py: nerfstudio
    transforms.json in OpenGL convention (gl2cv flip), distorted
    images + anonymization masks carried as `image_distorted` /
    `anon_mask_distorted` with the fisheye camera model, frames merged
    with test_frames unless the scene is a benchmark test scene, and the
    COLMAP text reconstruction linked as a scene modality.
  * `convert_tav2_wb_scene`: tav2_wb.py: per-frame .npy intrinsics/poses
    (already opencv cam2world) + EXR depths, all symlinked.

Two follow-on stages close the pipeline the reference runs as separate
slurm scripts:

  * `undistort_scene`: the wai_processing undistortion stage; rewrites a
    scene's distorted modalities to PINHOLE `image` (+ masks) via
    `data/undistort.py`.
  * `render_scene_depth_stage`: the wai_processing rendering stage
    (run_rendering.py); ray-casts the scene mesh into every (pinhole)
    frame and stores the `rendered_depth` modality `wai_datasets.py`'s
    scannetpp spec trains on. Meshes load through the minimal PLY reader
    below (no trimesh).

Host code (file IO and numpy) but for the ray cast, which
`data/rendering.py` runs in torch on the card.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .undistort import undistort_frame
from .wai import load_scene_meta, store_data

__all__ = [
    "convert_eth3d_scene",
    "convert_scannetppv2_scene",
    "convert_tav2_wb_scene",
    "undistort_scene",
    "render_scene_depth_stage",
    "read_ply",
    "thin_prism_fisheye_img_from_cam",
    "undistort_eth3d_depth",
]


# ---------------------------------------------------------------------------
# shared small pieces
# ---------------------------------------------------------------------------

def _pose_from_quat_t(qwxyz: Sequence[float],
                      t: Sequence[float]) -> np.ndarray:
    """4x4 matrix from a COLMAP-style (qw,qx,qy,qz) + translation
    (eth3d.py pose_matrix_from_quaternion)."""
    w, x, y, z = np.asarray(qwxyz, np.float64)
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(t, np.float64)
    return T


def _gl2cv(c2w: np.ndarray) -> np.ndarray:
    """OpenGL -> OpenCV cam2world: flip the camera Y/Z axes (reference
    utils/wai/camera.py gl2cv; cmat = diag(1,-1,-1,1) right-multiplied)."""
    out = np.asarray(c2w, np.float64).copy()
    out[..., :3, 1] *= -1.0
    out[..., :3, 2] *= -1.0
    return out


def _parse_colmap_text_cameras(path) -> Dict[int, Dict]:
    """cameras.txt -> {camera_id: {model, width, height, params}}.

    3-line header then `CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]` rows
    (eth3d.py:516-536 reads the same file with a manual split)."""
    out: Dict[int, Dict] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out[int(parts[0])] = {
                "model": parts[1],
                "width": int(parts[2]),
                "height": int(parts[3]),
                "params": np.array([float(p) for p in parts[4:]]),
            }
    return out


def _parse_colmap_text_images(path) -> List[Dict]:
    """images.txt -> ordered [{image_id, qwxyz, t, camera_id, name}].

    4-line header; image rows alternate with POINTS2D rows, which are
    skipped exactly as the reference does with `lines[::2]`
    (eth3d.py:538-546) — but robust to blank/comment lines."""
    rows: List[Dict] = []
    expecting_points = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if expecting_points:  # POINTS2D[] row of the previous image
                expecting_points = False
                continue
            p = line.split()
            rows.append({
                "image_id": int(p[0]),
                "qwxyz": [float(v) for v in p[1:5]],
                "t": [float(v) for v in p[5:8]],
                "camera_id": int(p[8]),
                "name": p[9],
            })
            expecting_points = True
    return rows


# ---------------------------------------------------------------------------
# ETH3D (reference conversion/eth3d.py)
# ---------------------------------------------------------------------------

# Images that are originally portrait but stored landscape in the ETH3D
# release — rotated 90deg clockwise at conversion with camera params and
# pose counter-rotated (protocol constants, eth3d.py:212-250).
ETH3D_PORTRAIT_IMAGES: Dict[str, Tuple[str, ...]] = {
    "delivery_area": ("DSC_0711.JPG", "DSC_0712.JPG", "DSC_0713.JPG",
                      "DSC_0714.JPG"),
    "playground": ("DSC_0587.JPG", "DSC_0588.JPG", "DSC_0589.JPG",
                   "DSC_0590.JPG", "DSC_0591.JPG", "DSC_0592.JPG"),
    "relief": ("DSC_0427.JPG", "DSC_0428.JPG", "DSC_0429.JPG",
               "DSC_0430.JPG", "DSC_0431.JPG", "DSC_0432.JPG",
               "DSC_0433.JPG", "DSC_0434.JPG", "DSC_0435.JPG",
               "DSC_0436.JPG", "DSC_0437.JPG", "DSC_0438.JPG",
               "DSC_0439.JPG"),
    "relief_2": ("DSC_0458.JPG", "DSC_0459.JPG", "DSC_0460.JPG",
                 "DSC_0461.JPG", "DSC_0462.JPG", "DSC_0463.JPG",
                 "DSC_0464.JPG", "DSC_0465.JPG", "DSC_0466.JPG",
                 "DSC_0467.JPG", "DSC_0468.JPG"),
}

# ETH3D raw ground_truth_depth binaries are full-resolution DSLR scans
# (eth3d.py load_eth3d_raw_depth hardcodes the same shape).
ETH3D_RAW_DEPTH_HW = (4032, 6048)


def thin_prism_fisheye_img_from_cam(xy: np.ndarray,
                                    params: np.ndarray) -> np.ndarray:
    """COLMAP THIN_PRISM_FISHEYE projection of normalized cam points.

    `params` = [fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, sx1, sy1] (the
    model ETH3D's dslr_calibration_jpg ships; the reference projects
    through it with pycolmap.Camera.img_from_cam, eth3d.py:305-312).
    Equidistant fisheye warp first (u*atan(r)/r), then polynomial
    radial + tangential + thin-prism terms.
    """
    params = np.asarray(params, np.float64)
    fx, fy, cx, cy = params[:4]
    k1, k2, p1, p2, k3, k4, sx1, sy1 = (list(params[4:12]) + [0.0] * 8)[:8]
    u, v = np.asarray(xy, np.float64).T
    r = np.sqrt(u * u + v * v)
    safe = r > np.finfo(np.float64).eps
    scale = np.where(safe, np.arctan(r) / np.where(safe, r, 1.0), 1.0)
    u, v = u * scale, v * scale
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2**2 + k3 * r2**3 + k4 * r2**4
    du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2) + sx1 * r2
    dv = v * radial + p1 * (r2 + 2 * v2) + 2 * p2 * uv + sy1 * r2
    x = fx * (u + du) + cx
    y = fy * (v + dv) + cy
    return np.stack([x, y], axis=-1)


def undistort_eth3d_depth(
    raw_depth: np.ndarray,
    pinhole_params: Sequence[float],
    pinhole_hw: Tuple[int, int],
    fisheye_params: np.ndarray,
    fisheye_hw: Tuple[int, int],
) -> np.ndarray:
    """Sample a raw (distorted) ETH3D depth map on the undistorted pinhole
    grid: pinhole pixel -> normalized cam ray -> THIN_PRISM_FISHEYE pixel
    -> nearest raw depth (eth3d.py undistort_depth_maps steps 4-6).
    Depth here is z-depth, invariant under the purely-2D resampling."""
    h, w = int(pinhole_hw[0]), int(pinhole_hw[1])
    fx, fy, cx, cy = [float(p) for p in pinhole_params[:4]]
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    xy = np.stack([(gx.ravel() - cx) / fx, (gy.ravel() - cy) / fy], axis=-1)
    dist_xy = thin_prism_fisheye_img_from_cam(xy, fisheye_params)
    # reference clips to the *undistorted* bounds then indexes the raw map
    # (eth3d.py:353-354); clip to the raw map's own bounds, which is what
    # keeps the gather in range whenever the two resolutions differ
    fh, fw = int(fisheye_hw[0]), int(fisheye_hw[1])
    xi = np.clip(dist_xy[:, 0], 0, fw - 1).astype(np.int64)
    yi = np.clip(dist_xy[:, 1], 0, fh - 1).astype(np.int64)
    out = np.nan_to_num(raw_depth, nan=0.0, posinf=0.0, neginf=0.0)
    return out[yi, xi].reshape(h, w).astype(np.float32)


def _rot90cw_camera(params, width, height):
    """fx,fy,cx,cy after rotating the IMAGE 90deg clockwise == adjusting
    for one counter-clockwise param rotation (eth3d.py
    adjust_camera_params_for_rotation, k=1)."""
    fx, fy, cx, cy = params
    return [fy, fx, height - cy, cx]


_ROT90CCW = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float64)


def _rot90cw_pose(c2w: np.ndarray) -> np.ndarray:
    """cam2world after the image content rotates 90deg clockwise
    (eth3d.py adjust_pose_for_rotation, k=1: R <- R @ rot^T)."""
    out = np.asarray(c2w, np.float64).copy()
    out[:3, :3] = out[:3, :3] @ _ROT90CCW.T
    return out


def convert_eth3d_scene(
    original_root: str,
    out_root: str,
    scene_name: str,
    raw_depth_hw: Tuple[int, int] = ETH3D_RAW_DEPTH_HW,
    link: bool = True,
) -> Path:
    """One ETH3D scene -> WAI (reference process_eth3d_scene).

    Source layout: <original_root>/<scene>/{dslr_calibration_undistorted,
    dslr_calibration_jpg, ground_truth_depth/dslr_images,
    images/dslr_images_undistorted}. Raw depths are flat float32 files at
    `raw_depth_hw`; they are undistorted here (THIN_PRISM_FISHEYE ->
    PINHOLE resample) and stored as EXR, images symlink (or copy when
    `link=False`, for filesystems without symlinks)."""
    src = Path(original_root) / scene_name
    dst = Path(out_root) / scene_name
    (dst / "images").mkdir(parents=True, exist_ok=True)
    (dst / "depth").mkdir(parents=True, exist_ok=True)

    pin_cams = _parse_colmap_text_cameras(
        src / "dslr_calibration_undistorted" / "cameras.txt")
    images = _parse_colmap_text_images(
        src / "dslr_calibration_undistorted" / "images.txt")
    fish_cams_path = src / "dslr_calibration_jpg" / "cameras.txt"
    fish_cams = (_parse_colmap_text_cameras(fish_cams_path)
                 if fish_cams_path.exists() else {})
    fish_images = {}
    fish_images_path = src / "dslr_calibration_jpg" / "images.txt"
    if fish_images_path.exists():
        for row in _parse_colmap_text_images(fish_images_path):
            fish_images[os.path.basename(row["name"])] = row["camera_id"]

    portrait = set(ETH3D_PORTRAIT_IMAGES.get(scene_name, ()))
    wai_frames = []
    for row in images:
        base = os.path.basename(row["name"])
        cam = pin_cams[row["camera_id"]]
        if cam["model"] != "PINHOLE":
            raise ValueError(
                f"{scene_name}/{base}: dslr_calibration_undistorted must be "
                f"PINHOLE, got {cam['model']}")
        fx, fy, cx, cy = cam["params"][:4]
        width, height = cam["width"], cam["height"]

        img_src = src / "images" / "dslr_images_undistorted" / base
        if not img_src.exists():
            continue

        # raw depth -> undistorted EXR (the reference caches these under
        # ground_truth_depth/dslr_images_undistorted; written straight to
        # the WAI scene here)
        raw_path = src / "ground_truth_depth" / "dslr_images" / base
        depth = None
        if raw_path.exists():
            raw = np.fromfile(raw_path, np.float32)
            raw = raw.reshape(raw_depth_hw)
            fish_cam_id = fish_images.get(base, row["camera_id"])
            if fish_cam_id in fish_cams:
                fc = fish_cams[fish_cam_id]
                depth = undistort_eth3d_depth(
                    raw, [fx, fy, cx, cy], (height, width),
                    fc["params"], (fc["height"], fc["width"]))
            else:  # already-pinhole fixture/source: resample-free carry
                depth = np.nan_to_num(raw, nan=0.0, posinf=0.0,
                                      neginf=0.0)[:height, :width]

        c2w = np.linalg.inv(_pose_from_quat_t(row["qwxyz"], row["t"]))

        frame_name = os.path.splitext(base)[0]
        rel_img = f"images/{frame_name}.png"
        rel_depth = f"depth/{frame_name}.exr"
        is_portrait = base in portrait
        if is_portrait:
            import PIL.Image

            img = PIL.Image.open(img_src).rotate(-90, expand=True)
            img.save(dst / rel_img)
            if depth is not None:
                depth = np.ascontiguousarray(np.rot90(depth, k=3))
            fx, fy, cx, cy = _rot90cw_camera([fx, fy, cx, cy], width, height)
            c2w = _rot90cw_pose(c2w)
            height, width = width, height
        else:
            target = dst / rel_img
            if not target.exists():
                if link:
                    os.symlink(img_src, target)
                else:
                    import shutil

                    shutil.copyfile(img_src, target)
        if depth is not None:
            store_data(dst / rel_depth, depth, "depth")

        wai_frame = {
            "frame_name": frame_name,
            "image": rel_img,
            "file_path": rel_img,
            "transform_matrix": c2w.tolist(),
            "h": int(height), "w": int(width),
            "fl_x": float(fx), "fl_y": float(fy),
            "cx": float(cx), "cy": float(cy),
            "is_portrait": str(is_portrait),
        }
        if depth is not None:
            wai_frame["depth"] = rel_depth
        wai_frames.append(wai_frame)

    scene_meta = {
        "scene_name": scene_name,
        "dataset_name": "eth3d",
        "version": "0.1",
        "shared_intrinsics": False,
        "camera_model": "PINHOLE",
        "camera_convention": "opencv",
        "scale_type": "metric",
        "scene_modalities": {},
        "frames": wai_frames,
        "frame_modalities": {
            "image": {"frame_key": "image", "format": "image"},
            "depth": {"frame_key": "depth", "format": "depth"},
        },
    }
    store_data(dst / "scene_meta.json", scene_meta, "readable")
    return dst


# ---------------------------------------------------------------------------
# ScanNetPP v2 (reference conversion/scannetppv2.py)
# ---------------------------------------------------------------------------

_SNPP_CAMERA_KEYS = ("fl_x", "fl_y", "cx", "cy", "w", "h",
                     "k1", "k2", "k3", "k4", "p1", "p2")


def convert_scannetppv2_scene(
    original_root: str,
    out_root: str,
    scene_name: str,
    test_scene_names: Sequence[str] = (),
    modality: str = "dslr",
    link: bool = True,
) -> Path:
    """One ScanNetPP-v2 scene -> WAI (reference convert_scene).

    Reads <scene>/<modality>/nerfstudio/transforms.json (OpenGL c2w ->
    gl2cv), carries DISTORTED images (+ anonymization masks) with the
    source fisheye camera model — undistortion is the separate
    `undistort_scene` stage, exactly like the reference pipeline. Frames
    and test_frames merge unless the scene is a benchmark test scene
    (scannetppv2.py:257-263). The COLMAP text reconstruction links in as
    a scene modality; a `scans/mesh_aligned_0.05.ply` source mesh links as
    the mesh modality for the rendering stage."""
    src = Path(original_root) / scene_name
    dst = Path(out_root) / scene_name
    img_dir = dst / "images_distorted"
    img_dir.mkdir(parents=True, exist_ok=True)

    def _carry(source: Path, target: Path):
        if target.exists():
            return
        if link:
            os.symlink(source, target)
        else:
            import shutil

            if source.is_dir():
                shutil.copytree(source, target)
            else:
                shutil.copyfile(source, target)

    with open(src / modality / "nerfstudio" / "transforms.json") as f:
        meta = json.load(f)
    frames = list(meta["frames"])
    test_paths = {f["file_path"] for f in meta.get("test_frames", ())}
    if scene_name not in set(test_scene_names):
        frames += list(meta.get("test_frames", ()))
    frames.sort(key=lambda fr: fr["file_path"])

    has_mask = (src / modality / "resized_anon_masks").exists()
    if has_mask:
        (dst / "anon_masks_distorted").mkdir(exist_ok=True)

    wai_frames = []
    for frame in frames:
        frame_name = Path(frame["file_path"]).stem
        src_img = src / modality / "resized_images" / frame["file_path"]
        if not src_img.exists():
            if frame["file_path"] in test_paths:
                continue  # missing eval frame: warn-and-skip posture
            raise FileNotFoundError(str(src_img))
        rel_img = f"images_distorted/{frame_name}.jpg"
        _carry(src_img, dst / rel_img)

        c2w = _gl2cv(np.array(frame["transform_matrix"], np.float64))
        wai_frame = {
            "frame_name": frame_name,
            "image_distorted": rel_img,
            "file_path": rel_img,
            "transform_matrix": c2w.tolist(),
        }
        if has_mask and "mask_path" in frame:
            src_mask = (src / modality / "resized_anon_masks"
                        / frame["mask_path"])
            if src_mask.exists():
                rel_mask = f"anon_masks_distorted/{frame_name}.png"
                _carry(src_mask, dst / rel_mask)
                wai_frame["anon_mask_distorted"] = rel_mask
        for key in _SNPP_CAMERA_KEYS:  # optional per-frame intrinsics
            if key in frame:
                wai_frame[key] = frame[key]
        if "is_bad" in frame:
            wai_frame["is_bad"] = frame["is_bad"]
        wai_frames.append(wai_frame)

    scene_meta = {
        "scene_name": scene_name,
        "dataset_name": "scannetppv2",
        "version": "0.2",
        "shared_intrinsics": True,
        "camera_model": meta.get("camera_model", "OPENCV_FISHEYE"),
        "camera_convention": "opencv",
        "scale_type": "metric",
        "frames": wai_frames,
        "frame_modalities": {
            "image_distorted": {"frame_key": "image_distorted",
                                "format": "image"},
            "anon_mask_distorted": {"frame_key": "anon_mask_distorted",
                                    "format": "binary"},
        },
        "scene_modalities": {},
    }
    for key in _SNPP_CAMERA_KEYS:  # shared intrinsics live on the scene
        if key in meta:
            scene_meta[key] = meta[key]

    colmap_src = src / modality / "colmap"
    if colmap_src.exists():
        _carry(colmap_src, dst / "colmap")
        scene_meta["scene_modalities"]["colmap"] = {
            name: {"path": f"colmap/{name}.txt", "format": "readable"}
            for name in ("cameras", "images", "points3D")
        }
    mesh_src = src / "scans" / "mesh_aligned_0.05.ply"
    if mesh_src.exists():
        _carry(mesh_src, dst / "mesh_aligned.ply")
        scene_meta["scene_modalities"]["mesh"] = {
            "path": "mesh_aligned.ply", "format": "mesh"}

    store_data(dst / "scene_meta.json", scene_meta, "readable")
    return dst


# ---------------------------------------------------------------------------
# TartanAirV2-WB (reference conversion/tav2_wb.py)
# ---------------------------------------------------------------------------

def convert_tav2_wb_scene(
    original_root: str,
    out_root: str,
    scene_name: str,
    link: bool = True,
) -> Path:
    """One TAv2-WB scene -> WAI (reference process_tav2_wb_scene).

    Source: <scene>/{images/*.png, depth/*.exr, camera_params/*.npy (3x3
    K), poses/*.npy (4x4 opencv cam2world)}. Everything symlinks; only
    the metadata is rewritten."""
    import PIL.Image

    src = Path(original_root) / scene_name
    dst = Path(out_root) / scene_name
    (dst / "images").mkdir(parents=True, exist_ok=True)
    (dst / "depth").mkdir(parents=True, exist_ok=True)

    def _carry(source: Path, target: Path):
        if target.exists():
            return
        if link:
            os.symlink(source, target)
        else:
            import shutil

            shutil.copyfile(source, target)

    image_files = sorted(f for f in os.listdir(src / "images")
                         if f.endswith(".png"))
    wai_frames = []
    for image_file in image_files:
        frame_name = image_file.rsplit(".", 1)[0]
        rel_img = f"images/{image_file}"
        rel_depth = f"depth/{frame_name}.exr"
        _carry(src / "images" / image_file, dst / rel_img)
        _carry(src / "depth" / f"{frame_name}.exr", dst / rel_depth)
        K = np.load(src / "camera_params" / f"{frame_name}.npy")
        c2w = np.load(src / "poses" / f"{frame_name}.npy")
        with PIL.Image.open(src / "images" / image_file) as im:
            w, h = im.size
        wai_frames.append({
            "frame_name": frame_name,
            "image": rel_img,
            "file_path": rel_img,
            "depth": rel_depth,
            "transform_matrix": np.asarray(c2w, np.float64).tolist(),
            "h": int(h), "w": int(w),
            "fl_x": float(K[0, 0]), "fl_y": float(K[1, 1]),
            "cx": float(K[0, 2]), "cy": float(K[1, 2]),
        })

    scene_meta = {
        "scene_name": scene_name,
        "dataset_name": "tav2_wb",
        "version": "0.1",
        "shared_intrinsics": False,
        "camera_model": "PINHOLE",
        "camera_convention": "opencv",
        "scale_type": "metric",
        "scene_modalities": {},
        "frames": wai_frames,
        "frame_modalities": {
            "image": {"frame_key": "image", "format": "image"},
            "depth": {"frame_key": "depth", "format": "depth"},
        },
    }
    store_data(dst / "scene_meta.json", scene_meta, "readable")
    return dst


# ---------------------------------------------------------------------------
# undistortion stage (reference wai_processing undistortion script)
# ---------------------------------------------------------------------------

def undistort_scene(scene_root: str, balance: float = 0.0) -> Path:
    """Rewrite a converted scene's distorted modalities to PINHOLE.

    For every frame: load `image_distorted` (+ `anon_mask_distorted`),
    run `data/undistort.py undistort_frame` with the scene's fisheye /
    opencv camera model, store the pinhole `image` (+ `anon_mask`), and
    update the scene meta with the new shared intrinsics. The pipeline
    position (conversion -> THIS -> rendering -> covisibility) matches the
    reference's wai_processing stage ordering."""
    import PIL.Image

    scene_root = Path(scene_root)
    meta = load_scene_meta(scene_root / "scene_meta.json")
    if meta.get("camera_model") == "PINHOLE":
        return scene_root  # nothing to do

    (scene_root / "images").mkdir(exist_ok=True)
    fm = meta["frame_modalities"]
    has_mask_modality = "anon_mask_distorted" in fm
    new_cam = None
    for frame in meta["frames"]:
        mods = {}
        img_rel = frame.get("image_distorted")
        if img_rel is None:
            continue
        mods["image"] = np.asarray(
            PIL.Image.open(scene_root / img_rel).convert("RGB"))
        mask_rel = frame.get("anon_mask_distorted")
        if mask_rel is not None:
            mods["anon_mask"] = np.asarray(
                PIL.Image.open(scene_root / mask_rel)).astype(bool)
        cam_meta = {k: frame.get(k, meta.get(k))
                    for k in (*_SNPP_CAMERA_KEYS, "camera_model")
                    if frame.get(k, meta.get(k)) is not None}
        out, new_cam = undistort_frame(mods, cam_meta, balance=balance)
        name = frame["frame_name"]
        rel_img = f"images/{name}.png"
        store_data(scene_root / rel_img, out["image"], "image")
        frame["image"] = rel_img
        frame["file_path"] = rel_img
        if "anon_mask" in out:
            rel_mask = f"anon_masks/{name}.png"
            store_data(scene_root / rel_mask, out["anon_mask"], "binary")
            frame["anon_mask"] = rel_mask

    if new_cam is not None:
        for k in ("fl_x", "fl_y", "cx", "cy", "w", "h"):
            if k in new_cam:
                meta[k] = new_cam[k]
        for k in ("k1", "k2", "k3", "k4", "p1", "p2"):
            meta.pop(k, None)
        meta["camera_model"] = "PINHOLE"
    fm["image"] = {"frame_key": "image", "format": "image"}
    if has_mask_modality:
        fm["anon_mask"] = {"frame_key": "anon_mask", "format": "binary"}
    meta.pop("frame_names", None)  # derived; regenerated by the reader
    store_data(scene_root / "scene_meta.json", meta, "readable")
    return scene_root


# ---------------------------------------------------------------------------
# mesh rendering stage (reference wai_processing run_rendering.py)
# ---------------------------------------------------------------------------

def read_ply(path) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal PLY reader: (vertices (N,3) float32, faces (T,3) int32).

    Handles ascii and binary_little_endian with float vertex properties
    (extra properties like color skipped) and uchar/int-counted int face
    lists, the format scannetpp's mesh_aligned_0.05.ply uses. The
    rendering stage needs only positions and triangles."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        props: List[Tuple[str, str]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated header")
            tok = line.decode("ascii", "replace").split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                props = []
                elements.append((tok[1], int(tok[2]), props))
            elif tok[0] == "property":
                if tok[1] == "list":
                    props.append(("list", f"{tok[2]}:{tok[3]}"))
                else:
                    props.append((tok[2], tok[1]))
            elif tok[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format {fmt!r}")

        np_of = {"float": np.float32, "float32": np.float32,
                 "double": np.float64, "float64": np.float64,
                 "uchar": np.uint8, "uint8": np.uint8,
                 "char": np.int8, "int8": np.int8,
                 "short": np.int16, "int16": np.int16,
                 "ushort": np.uint16, "uint16": np.uint16,
                 "int": np.int32, "int32": np.int32,
                 "uint": np.uint32, "uint32": np.uint32}

        verts = faces = None
        for name, count, eprops in elements:
            if name == "vertex":
                dtype = np.dtype([(pname, np_of[ptype])
                                  for pname, ptype in eprops])
                if fmt == "ascii":
                    rows = [f.readline().split()[:len(eprops)]
                            for _ in range(count)]
                    arr = np.array(rows, np.float64)
                    data = np.zeros(count, dtype)
                    for i, (pname, _pt) in enumerate(eprops):
                        data[pname] = arr[:, i]
                else:
                    data = np.frombuffer(f.read(dtype.itemsize * count),
                                         dtype=dtype, count=count)
                verts = np.stack([data["x"], data["y"], data["z"]],
                                 axis=-1).astype(np.float32)
            elif name == "face":
                count_t, idx_t = eprops[0][1].split(":")
                out = np.empty((count, 3), np.int32)
                if fmt == "ascii":
                    for i in range(count):
                        row = [int(v) for v in f.readline().split()]
                        if row[0] != 3:
                            raise ValueError("non-triangle face in PLY")
                        out[i] = row[1:4]
                else:
                    csz = np.dtype(np_of[count_t]).itemsize
                    isz = np.dtype(np_of[idx_t]).itemsize
                    for i in range(count):
                        n = int(np.frombuffer(f.read(csz),
                                              np_of[count_t])[0])
                        if n != 3:
                            raise ValueError("non-triangle face in PLY")
                        out[i] = np.frombuffer(f.read(isz * 3),
                                               np_of[idx_t])
                faces = out
            else:  # skip unknown binary elements conservatively
                if fmt == "ascii":
                    for _ in range(count):
                        f.readline()
                else:
                    raise ValueError(
                        f"{path}: unsupported element {name!r} in binary PLY")
    if verts is None:
        raise ValueError(f"{path}: no vertex element")
    if faces is None:
        faces = np.zeros((0, 3), np.int32)
    return verts, faces


def render_scene_depth_stage(
    scene_root: str,
    hw: Optional[Tuple[int, int]] = None,
    mesh_path: Optional[str] = None,
    device=None,
    **render_kwargs,
) -> Path:
    """Ray-cast the scene mesh into every frame -> `rendered_depth` EXRs.

    The reference runs this as the wai_processing rendering stage
    (run_rendering.py:213-455, a rasterizer); here the z-buffer is
    `data/rendering.py`'s ray cast on `device` (the card when None). The
    scene must already be PINHOLE (run `undistort_scene` first). Writes
    the modality `wai_datasets.py`'s scannetpp spec consumes
    (depth_modality='rendered_depth')."""
    from .rendering import render_mesh_depth
    from .wai import get_intrinsics

    scene_root = Path(scene_root)
    meta = load_scene_meta(scene_root / "scene_meta.json")
    if meta.get("camera_model") != "PINHOLE":
        raise ValueError("render stage needs a PINHOLE scene — run "
                         "undistort_scene first (reference stage order)")
    if mesh_path is None:
        mesh_mod = (meta.get("scene_modalities") or {}).get("mesh")
        if mesh_mod is None:
            raise ValueError(f"{scene_root}: no mesh scene modality")
        mesh_path = scene_root / mesh_mod["path"]
    verts, faces = read_ply(mesh_path)

    for frame in meta["frames"]:
        K = get_intrinsics(meta, frame)
        c2w = np.asarray(frame["transform_matrix"], np.float64)
        fh = int(frame.get("h", meta.get("h")))
        fw = int(frame.get("w", meta.get("w")))
        out_hw = (int(hw[0]), int(hw[1])) if hw is not None else (fh, fw)
        if out_hw != (fh, fw):  # render at reduced res: scale K
            K = K.copy()
            K[0] *= out_hw[1] / fw
            K[1] *= out_hw[0] / fh
        depth = render_mesh_depth(verts, faces, K, c2w, out_hw,
                                  device=device, **render_kwargs)
        name = frame["frame_name"]
        rel = f"rendered_depth/{name}.exr"
        store_data(scene_root / rel, depth, "depth")
        frame["rendered_depth"] = rel

    meta["frame_modalities"]["rendered_depth"] = {
        "frame_key": "rendered_depth", "format": "depth"}
    meta.pop("frame_names", None)
    store_data(scene_root / "scene_meta.json", meta, "readable")
    return scene_root
