"""Per-source WAI conversion recipes for the 11 training-corpus datasets;
counterpart of mapanything_tpu/data/converters_corpus.py.

Together with `data/converters.py` (ETH3D, ScanNetPP-v2, TAv2-WB — the
benchmark trio) this completes the 14-corpus conversion surface the
reference ships as one slurm script per source under
`data_processing/wai_processing/scripts/conversion/<name>.py`. Each recipe
here mirrors one reference script's source-specific quirks (depth units,
handedness flips, metadata layouts) and is exercised by a synthetic raw
fixture in the tests:

  * ase — aria trajectory CSV + device-calibration JSON, Fisheye624 ->
    pinhole undistortion, range->z-depth, mm->m, portrait rotation
    (conversion/ase.py:134-359);
  * blendedmvs — PFM depths, `*_cam.txt` (w2c 4x4 + K), colmap scale
    (conversion/blendedmvs.py:26-178);
  * dl3dv — nerfstudio transforms.json, OpenGL->OpenCV, distorted images
    + colmap cache carried, portrait scenes refused
    (conversion/dl3dv.py:40-120);
  * dynamicreplica — gzip frame annotations, NDC intrinsics, pytorch3d
    pose convention, float16-coded 16-bit PNG depths, stereo frames
    (conversion/dynamicreplica.py:80-339);
  * megadepth — manhattan sparse text model, pairs-npz image filter, h5
    depths, SIMPLE_RADIAL -> rectified pinhole intrinsics
    (conversion/megadepth.py:28-340);
  * mpsd — normalized focal, Rodrigues shot poses, cm->m depth pngs,
    image resized to depth res, <2-frame scenes skipped
    (conversion/mpsd.py:32-260);
  * mvs_synth — EXR depths with inf sky, /10 metric rescale of depth AND
    translation, RUF->RDF flip (conversion/mvs_synth.py:25-152);
  * paralleldomain4d — scene json data entries, npz depths, <500 validity,
    LFU->RDF pose rotation (conversion/paralleldomain4d.py:26-192);
  * sailvos3d — camera YAMLs, NDC-matrix principal-point shift, rage
    P_inv NDC->camera depth, gl2cv, bmp->png
    (conversion/sailvos3d.py:27-277);
  * spring — per-frame intrinsics rows, dsp5 disparity (HDF5) subsampled
    2x -> metric depth via the 0.065 m baseline, stereo right pose offset,
    skymasks (conversion/spring.py:28-311);
  * unrealstereo4k — stereo extrinsics txt, npy disparity -> depth via
    measured baseline, RUF->RDF flip (conversion/unrealstereo4k.py:24-211).

Host code (file IO, numpy and PIL). h5py (MegaDepth, Spring) and PyYAML
(SAIL-VOS 3D) are imported inside the converters that read those formats;
without the package the converter raises ImportError naming it. No cv2:
MegaDepth's rectified intrinsics are OpenCV's rule in numpy
(`_rectified_pinhole_K`).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .converters import _gl2cv
from .wai import store_data

__all__ = [
    "convert_ase_scene",
    "convert_blendedmvs_scene",
    "convert_dl3dv_scene",
    "convert_dynamicreplica_scene",
    "convert_megadepth_scene",
    "convert_mpsd_scene",
    "convert_mvs_synth_scene",
    "convert_paralleldomain4d_scene",
    "convert_sailvos3d_scene",
    "convert_spring_scene",
    "convert_unrealstereo4k_scene",
    "load_pfm",
    "load_dsp5_disparity",
    "load_float16_png_depth",
    "fisheye624_img_from_cam",
    "CORPUS_CONVERTERS",
]


# ---------------------------------------------------------------------------
# shared small pieces
# ---------------------------------------------------------------------------

# natural sort: embedded integers compare numerically ("2" < "10"), the
# ordering the reference gets from natsort.natsorted
def _natsorted(names):
    def key(s):
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", str(s))]

    return sorted(names, key=key)


def _quat_xyzw_to_rot(q) -> np.ndarray:
    """(qx,qy,qz,qw) -> 3x3 rotation (scipy Rotation.from_quat order, the
    convention ase.py:107 and paralleldomain4d.py:137-145 read)."""
    x, y, z, w = np.asarray(q, np.float64)
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _axis_angle_to_rot(rvec) -> np.ndarray:
    """Rodrigues: axis-angle vector -> 3x3 rotation (what mpsd.py:156 gets
    from cv2.Rodrigues)."""
    rvec = np.asarray(rvec, np.float64)
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _rt44(R: np.ndarray, t) -> np.ndarray:
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(t, np.float64).reshape(3)
    return T


# RUF (left-handed, y up) -> RDF/opencv: negate the camera y axis row
# (mvs_synth.py:106-111, unrealstereo4k.py:104-110 flip_y @ c2w)
_FLIP_Y = np.diag([1.0, -1.0, 1.0, 1.0])

# LFU -> RDF permutation (paralleldomain4d.py:151-155)
_LFU_TO_RDF = np.array([[0, 0, 1, 0], [1, 0, 0, 0],
                        [0, 1, 0, 0], [0, 0, 0, 1]], np.float64)


def _carry(source: Path, target: Path, link: bool = True):
    if target.exists() or target.is_symlink():
        return
    if link:
        os.symlink(source, target)
    else:
        import shutil

        if Path(source).is_dir():
            shutil.copytree(source, target)
        else:
            shutil.copyfile(source, target)


def _pinhole_frame(frame_name, rel_img, c2w, h, w, fx, fy, cx, cy,
                   rel_depth=None, **extra):
    out = {
        "frame_name": frame_name,
        "image": str(rel_img),
        "file_path": str(rel_img),
        "transform_matrix": np.asarray(c2w, np.float64).tolist(),
        "h": int(h), "w": int(w),
        "fl_x": float(fx), "fl_y": float(fy),
        "cx": float(cx), "cy": float(cy),
    }
    if rel_depth is not None:
        out["depth"] = str(rel_depth)
    out.update(extra)
    return out


def _store_scene_meta(dst: Path, scene_name: str, dataset_name: str,
                      frames: List[dict], scale_type: str,
                      camera_model: str = "PINHOLE",
                      shared_intrinsics: bool = False,
                      frame_modalities: Optional[dict] = None,
                      scene_modalities: Optional[dict] = None,
                      meta_name: str = "scene_meta.json",
                      **extra) -> Path:
    if frame_modalities is None:
        frame_modalities = {
            "image": {"frame_key": "image", "format": "image"},
            "depth": {"frame_key": "depth", "format": "depth"},
        }
    meta = {
        "scene_name": scene_name,
        "dataset_name": dataset_name,
        "version": "0.1",
        "shared_intrinsics": shared_intrinsics,
        "camera_model": camera_model,
        "camera_convention": "opencv",
        "scale_type": scale_type,
        "scene_modalities": scene_modalities or {},
        "frames": frames,
        "frame_modalities": frame_modalities,
    }
    meta.update(extra)
    store_data(dst / meta_name, meta, "readable")
    return dst


# ---------------------------------------------------------------------------
# BlendedMVS (reference conversion/blendedmvs.py)
# ---------------------------------------------------------------------------

def load_pfm(path) -> np.ndarray:
    """PFM depth loader (blendedmvs.py:26-60): 'Pf' (gray) / 'PF' (color)
    header, endianness from the sign of the scale line, rows stored
    bottom-up (flipped on load)."""
    with open(path, "rb") as f:
        header = f.readline().decode("ascii").strip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(r"^(\d+)\s(\d+)\s*$", f.readline().decode("ascii"))
        if not dims:
            raise ValueError(f"{path}: bad PFM dimensions line")
        w, h = map(int, dims.groups())
        scale = float(f.readline().decode("ascii").strip())
        data = np.frombuffer(f.read(), "<f" if scale < 0 else ">f")
        shape = (h, w, 3) if header == "PF" else (h, w)
        return np.ascontiguousarray(data.reshape(shape)[::-1])


def _load_blendedmvs_cam(path) -> Tuple[np.ndarray, np.ndarray]:
    """`*_cam.txt` -> (K 3x3, opencv cam2world 4x4). Layout: 'extrinsic'
    header + 4x4 w2c rows, blank, 'intrinsic' header + 3x3 K rows
    (blendedmvs.py:63-76 loadtxt skiprows)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    # drop the section headers, keep numeric rows in order
    rows = [ln for ln in lines if not ln[0].isalpha()]
    w2c = np.array([r.split() for r in rows[:4]], np.float64)
    K = np.array([r.split() for r in rows[4:7]], np.float64)
    return K, np.linalg.inv(w2c)


def convert_blendedmvs_scene(original_root: str, out_root: str,
                             scene_name: str, link: bool = True) -> Path:
    """One BlendedMVS scene -> WAI (blendedmvs.py process_blendedmvs_scene):
    images symlink, PFM depths -> EXR, per-frame K + w2c->c2w poses,
    scale_type 'colmap' (SfM scale, not metric)."""
    src = Path(original_root) / scene_name
    dst = Path(out_root) / scene_name
    (dst / "images").mkdir(parents=True, exist_ok=True)
    (dst / "depth").mkdir(parents=True, exist_ok=True)

    names = _natsorted(f[:-8] for f in os.listdir(src / "cams")
                       if not f.startswith("pair"))
    frames = []
    for name in names:
        img = src / "blended_images" / f"{name}.jpg"
        if not img.exists():
            continue
        rel_img = f"images/{name}.jpg"
        _carry(img, dst / rel_img, link)
        depth = np.asarray(load_pfm(
            src / "rendered_depth_maps" / f"{name}.pfm"), np.float32)
        rel_depth = f"depth/{name}.exr"
        store_data(dst / rel_depth, depth, "depth")
        K, c2w = _load_blendedmvs_cam(src / "cams" / f"{name}_cam.txt")
        frames.append(_pinhole_frame(
            name, rel_img, c2w, depth.shape[0], depth.shape[1],
            K[0, 0], K[1, 1], K[0, 2], K[1, 2], rel_depth))
    return _store_scene_meta(dst, scene_name, "blendedmvs", frames,
                             scale_type="colmap")


# ---------------------------------------------------------------------------
# DL3DV (reference conversion/dl3dv.py)
# ---------------------------------------------------------------------------

_DL3DV_CAMERA_KEYS = ("fl_x", "fl_y", "cx", "cy", "w", "h",
                      "k1", "k2", "k3", "k4", "p1", "p2")


def convert_dl3dv_scene(original_root: str, out_root: str, scene_name: str,
                        link: bool = True) -> Path:
    """One DL3DV scene -> WAI (dl3dv.py convert_scene). `scene_name` is
    '<split>_<id>' mapping to <original_root>/<split>/<id> (the 1K..11K
    bucket layout, dl3dv.py:22-44). Carries DISTORTED images + the colmap
    cache; portrait scenes are refused (dl3dv.py:61-64); the nerfstudio
    `applied_transform` and the gl2cv matrix are stored so the original
    colmap poses stay recoverable."""
    src = Path(original_root) / scene_name.replace("_", "/", 1)
    for req in ("transforms.json", "colmap", "images"):
        if not (src / req).exists():
            raise FileNotFoundError(f"{src / req} (dl3dv source layout)")
    with open(src / "transforms.json") as f:
        meta = json.load(f)
    if meta["h"] > meta["w"]:
        raise ValueError(
            f"{scene_name}: portrait DL3DV scenes are not supported "
            "(reference dl3dv.py:61-64 'data_issue')")

    dst = Path(out_root) / scene_name
    (dst / "images_distorted").mkdir(parents=True, exist_ok=True)
    frames = []
    for frame in meta["frames"]:
        name = Path(frame["file_path"]).stem
        rel_img = f"images_distorted/{name}.png"
        _carry(src / frame["file_path"], dst / rel_img, link)
        c2w = _gl2cv(np.asarray(frame["transform_matrix"], np.float64))
        wai_frame = {
            "frame_name": name,
            "image_distorted": rel_img,
            "file_path": rel_img,
            "transform_matrix": c2w.tolist(),
        }
        if "colmap_im_id" in frame:
            wai_frame["colmap_im_id"] = frame["colmap_im_id"]
        frames.append(wai_frame)

    _carry(src / "colmap", dst / "colmap", link)
    applied = np.concatenate([
        np.asarray(meta["applied_transform"], np.float64).reshape(3, 4),
        [[0.0, 0.0, 0.0, 1.0]]])
    gl2cv_cmat = np.diag([1.0, -1.0, -1.0, 1.0])
    extra = {k: meta[k] for k in _DL3DV_CAMERA_KEYS if k in meta}
    return _store_scene_meta(
        dst, scene_name, "dl3dv", frames, scale_type="colmap",
        camera_model=meta.get("camera_model", "OPENCV"),
        shared_intrinsics=True,
        frame_modalities={"image_distorted": {
            "frame_key": "image_distorted", "format": "image"}},
        scene_modalities={"colmap": {"scene_key": "colmap"}},
        meta_name="scene_meta_distorted.json",
        _applied_transform=applied.tolist(),
        _applied_transforms={"opengl2opencv": gl2cv_cmat.tolist()},
        **extra)


# ---------------------------------------------------------------------------
# DynamicReplica (reference conversion/dynamicreplica.py)
# ---------------------------------------------------------------------------

def load_float16_png_depth(path) -> np.ndarray:
    """16-bit PNG whose uint16 payload is bit-cast float16 depth
    (dynamicreplica.py:116-123)."""
    import PIL.Image

    with PIL.Image.open(path) as im:
        arr = np.array(im, dtype=np.uint16)
        return arr.view(np.float16).astype(np.float32).reshape(
            im.size[1], im.size[0])


def _dr_intrinsics(viewpoint, w, h) -> np.ndarray:
    """NDC-isotropic focal/principal -> pixel K
    (dynamicreplica.py:80-98)."""
    half = np.array([w, h]) / 2.0
    rescale = float(half.min())
    f = np.asarray(viewpoint["focal_length"], np.float64) * rescale
    c = half - np.asarray(viewpoint["principal_point"], np.float64) * rescale
    return np.array([[f[0], 0, c[0]], [0, f[1], c[1]], [0, 0, 1]])


def _dr_extrinsics(viewpoint) -> np.ndarray:
    """pytorch3d R/T -> opencv cam2world: flip x/y columns of R and x/y of
    T, then c2w = [R | -R T] (dynamicreplica.py:101-113)."""
    R = np.asarray(viewpoint["R"], np.float64).copy()
    t = np.asarray(viewpoint["T"], np.float64).copy()
    R[:, :2] *= -1
    t[:2] *= -1
    return _rt44(R, -R @ t)


def load_dynamicreplica_annotations(original_root: str) -> Dict[str, dict]:
    """frame_annotations_{train,valid,test}.jgz -> {frame_id: annotation}
    with frame_id '<scene>_source_<camera>-<frame_number>'
    (dynamicreplica.py:28-56). Missing split files are skipped (fixtures
    carry a subset)."""
    out: Dict[str, dict] = {}
    for split in ("train", "valid", "test"):
        path = Path(original_root) / f"frame_annotations_{split}.jgz"
        if not path.exists():
            continue
        with gzip.open(path, "rt", encoding="utf-8") as f:
            for annot in json.load(f):
                fid = (f"{annot['sequence_name']}_source_"
                       f"{annot['camera_name']}-{annot['frame_number']}")
                out[fid] = annot
    return out


def convert_dynamicreplica_scene(
    original_root: str, out_root: str, scene_name: str,
    annotations: Optional[Dict[str, dict]] = None, link: bool = True,
) -> Path:
    """One DynamicReplica stereo scene -> WAI (dynamicreplica.py
    process_dynamicreplica_scene): `scene_name` names the pair base; the
    `_left` / `_right` source dirs become interleaved frames of ONE wai
    scene, depths decoded from float16-coded PNGs, intrinsics from NDC,
    poses from the pytorch3d viewpoint convention."""
    if annotations is None:
        annotations = load_dynamicreplica_annotations(original_root)
    src_root = Path(original_root)
    dst = Path(out_root) / scene_name
    (dst / "images").mkdir(parents=True, exist_ok=True)
    (dst / "depth").mkdir(parents=True, exist_ok=True)

    def files(side):
        d = src_root / f"{scene_name}_{side}" / "images"
        if not d.exists():
            raise FileNotFoundError(f"{d} (dynamicreplica stereo layout)")
        return {f.split("-")[-1].split(".")[0]: f
                for f in os.listdir(d) if f != "done.ok"}

    left, right = files("left"), files("right")
    common = _natsorted(set(left) & set(right))
    if not common:
        raise ValueError(f"{scene_name}: no matching stereo frame pairs")

    frames = []
    for fid in common:
        for side, fmap in (("left", left), ("right", right)):
            annot = annotations[f"{scene_name}_{side}-{int(fid)}"]
            img_name = Path(annot["image"]["path"]).name
            rel_img = f"images/{img_name}"
            _carry(src_root / f"{scene_name}_{side}" / "images" / fmap[fid],
                   dst / rel_img, link)
            depth = load_float16_png_depth(
                src_root / annot["depth"]["path"])
            stem = img_name[: img_name.rfind(".")]
            rel_depth = f"depth/{stem}.exr"
            store_data(dst / rel_depth, depth, "depth")
            h, w = annot["image"]["size"]
            K = _dr_intrinsics(annot["viewpoint"], w, h)
            frames.append(_pinhole_frame(
                stem, rel_img, _dr_extrinsics(annot["viewpoint"]), h, w,
                K[0, 0], K[1, 1], K[0, 2], K[1, 2], rel_depth))
    return _store_scene_meta(dst, scene_name, "dynamicreplica", frames,
                             scale_type="metric")


# ---------------------------------------------------------------------------
# MegaDepth (reference conversion/megadepth.py)
# ---------------------------------------------------------------------------

def _require(package: str, dataset: str):
    """Import an optional format package, or raise ImportError naming it."""
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as exc:
        raise ImportError(
            f"{dataset} conversion reads its files with the {package!r} "
            f"package, which is not installed") from exc


def _undistort_points_opencv(px: np.ndarray, K: np.ndarray, dist,
                             iters: int = 5) -> np.ndarray:
    """cv2.undistortPoints(px, K, dist, P=K): pixels -> undistorted pixels
    by OpenCV's fixed-point iteration, its default criterion (5 iterations,
    no epsilon test), stopping a point at its distorted position where the
    rational radial factor turns negative. `dist` is OpenCV's
    [k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4] (zero-padded); the
    tilted-sensor pair is not supported."""
    k = np.zeros(14)
    d = np.asarray(dist, np.float64).ravel()
    k[:len(d)] = d
    if k[12] or k[13]:
        raise NotImplementedError("tilted-sensor distortion (tau_x, tau_y)")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x0 = (px[..., 0] - cx) * (1.0 / fx)
    y0 = (px[..., 1] - cy) * (1.0 / fy)
    x, y = x0.copy(), y0.copy()
    live = np.ones(x.shape, bool)
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = ((1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2)
                  / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2))
        stop = live & (icdist < 0)
        dx = (2 * k[2] * x * y + k[3] * (r2 + 2 * x * x) + k[8] * r2
              + k[9] * r2 * r2)
        dy = (k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y + k[10] * r2
              + k[11] * r2 * r2)
        step = live & ~stop
        x = np.where(step, (x0 - dx) * icdist, np.where(stop, x0, x))
        y = np.where(step, (y0 - dy) * icdist, np.where(stop, y0, y))
        live = step
    return np.stack([fx * x + K[0, 1] * y + cx, fy * y + cy], axis=-1)


def _rectified_pinhole_K(K: np.ndarray, dist, imsize_pre,
                         imsize_post) -> np.ndarray:
    """cv2.getOptimalNewCameraMatrix(K, dist, imsize_pre, alpha=0,
    newImgSize=imsize_post, centerPrincipalPoint=True) in numpy (what
    megadepth.py:290-297 calls): undistort a 9 x 9 grid over the source
    pixels (corners at 0 and size - 1), take the inscribed rectangle (the
    innermost of each border column and row), and scale the focal by the
    largest factor that puts that rectangle's sides at or beyond the new
    image's half extents around the new principal point
    ((size - 1) / 2)."""
    K = np.asarray(K, np.float64)
    w0, h0 = (int(v) for v in imsize_pre)
    w1, h1 = (int(v) for v in imsize_post)
    n = 9
    gx, gy = np.meshgrid(np.arange(n), np.arange(n))
    grid = np.stack([gx * (w0 - 1) / (n - 1), gy * (h0 - 1) / (n - 1)], -1)
    und = _undistort_points_opencv(grid, K, dist)
    x_lo, x_hi = und[:, 0, 0].max(), und[:, -1, 0].min()
    y_lo, y_hi = und[0, :, 1].max(), und[-1, :, 1].min()
    cx0, cy0 = K[0, 2], K[1, 2]
    cx, cy = (w1 - 1) * 0.5, (h1 - 1) * 0.5
    s = max(cx / (cx0 - x_lo), cy / (cy0 - y_lo), cx / (x_hi - cx0),
            cy / (y_hi - cy0))
    out = K.copy()
    out[0, 0] *= s
    out[1, 1] *= s
    out[0, 2], out[1, 2] = cx, cy
    return out


def _parse_manhattan_cameras(path) -> Dict[int, tuple]:
    """MegaDepth sparse/manhattan cameras.txt rows:
    `ID MODEL W H f cx cy k0` (SIMPLE_RADIAL; megadepth.py:44-66)."""
    out = {}
    with open(path) as f:
        for line in f.readlines()[3:]:
            parts = line.split()
            if not parts:
                continue
            w, h, focal, cx, cy, k0 = [float(v) for v in parts[2:8]]
            K = np.array([[focal, 0, cx], [0, focal, cy], [0, 0, 1.0]])
            out[int(parts[0])] = ((int(w), int(h)), K, (k0, 0.0, 0.0, 0.0))
    return out


def convert_megadepth_scene(original_root: str, out_root: str,
                            scene_subscene: str, link: bool = True) -> Path:
    """One MegaDepth (scene, subscene) -> WAI (megadepth.py
    process_megadepth_scene): only images named by megadepth_pairs.npz
    convert; h5 depths -> EXR; the distorted SIMPLE_RADIAL intrinsics are
    rectified to the depth resolution with alpha=0 + centered principal
    point; scale_type 'colmap'."""
    h5py = _require("h5py", "megadepth")

    parts = scene_subscene.split("_")
    subscene, scene_name = parts[-1], "_".join(parts[:-1])
    src = Path(original_root)
    dense = src / scene_name / f"dense{subscene}"
    dst = Path(out_root) / scene_subscene
    (dst / "images").mkdir(parents=True, exist_ok=True)
    (dst / "depth").mkdir(parents=True, exist_ok=True)

    cams = _parse_manhattan_cameras(
        src / scene_name / "sparse" / "manhattan" / subscene / "cameras.txt")
    poses_w2c: Dict[str, np.ndarray] = {}
    cam_of: Dict[str, int] = {}
    with open(src / scene_name / "sparse" / "manhattan" / subscene
              / "images.txt") as f:
        raw = f.read().splitlines()[4:]
    for image_row in raw[::2]:  # image rows alternate with POINTS2D rows
        p = image_row.split(" ")
        image_id = p[-1]
        cam_of[image_id] = int(p[-2])
        vals = [float(v) for v in p[1:-2]]
        R = _quat_xyzw_to_rot([vals[1], vals[2], vals[3], vals[0]])
        poses_w2c[image_id] = _rt44(R, vals[4:7])

    pairs_path = src / "megadepth_pairs.npz"
    if not pairs_path.exists():
        raise FileNotFoundError(
            f"{pairs_path}: megadepth conversion requires the pairs file "
            "(megadepth.py:210-214)")
    data = np.load(pairs_path, allow_pickle=True)
    scenes, images, pairs = data["scenes"], data["images"], data["pairs"]
    current = f"{scene_name} {subscene}"
    wanted = set()
    for scene_id, im1, im2, _score in pairs:
        if str(scenes[int(scene_id)]) == current:
            wanted.add(str(images[int(im1)]))
            wanted.add(str(images[int(im2)]))
    if not wanted:
        raise LookupError(
            f"scene {scene_subscene} not found in megadepth_pairs.npz")

    frames = []
    for image_id in _natsorted(wanted):
        img = dense / "imgs" / image_id
        h5_path = dense / "depths" / (Path(image_id).stem + ".h5")
        if not img.exists() or not h5_path.exists():
            continue
        rel_img = f"images/{image_id}"
        _carry(img, dst / rel_img, link)
        with h5py.File(h5_path, "r") as hd5:
            depth = np.asarray(hd5["depth"], np.float32)
        H, W = depth.shape
        rel_depth = f"depth/{Path(image_id).stem}.exr"
        store_data(dst / rel_depth, depth, "depth")
        imsize_pre, K_pre, dist = cams[cam_of[image_id]]
        K = _rectified_pinhole_K(K_pre, dist, imsize_pre, (W, H))
        c2w = np.linalg.inv(poses_w2c[image_id])
        frames.append(_pinhole_frame(
            Path(image_id).stem, rel_img, c2w, H, W,
            K[0, 0], K[1, 1], K[0, 2], K[1, 2], rel_depth))
    return _store_scene_meta(dst, scene_subscene, "megadepth", frames,
                             scale_type="colmap")


# ---------------------------------------------------------------------------
# MPSD (reference conversion/mpsd.py)
# ---------------------------------------------------------------------------

def convert_mpsd_scene(original_root: str, out_root: str, scene_name: str,
                       recon_split: Optional[str] = None) -> Path:
    """One MPSD scene -> WAI (mpsd.py convert_scene): scene_name is
    '<recon_split>_<folder>'; depth PNGs are centimeters -> /100 m; the
    image is RESIZED to the depth resolution (stored, not symlinked);
    fx=fy=focal*max(W,H) with a centered principal point; axis-angle shot
    poses; scenes with <2 valid frames write an empty-frames meta with a
    `skipped_reason` (mpsd.py:228-246)."""
    import PIL.Image

    src = Path(original_root)
    if recon_split is None:  # derive it from the on-disk layout
        recon_root = src / "reconstruction_data"
        matches = [d.name for d in recon_root.iterdir() if d.is_dir()
                   and scene_name.startswith(d.name + "_")]
        if not matches:
            raise LookupError(f"no reconstruction split for {scene_name}")
        recon_split = max(matches, key=len)  # longest prefix wins
    folder = scene_name[len(recon_split) + 1:]
    recon = src / "reconstruction_data" / recon_split / folder
    dst = Path(out_root) / scene_name
    (dst / "images").mkdir(parents=True, exist_ok=True)
    (dst / "depth").mkdir(parents=True, exist_ok=True)

    meta: Dict[str, dict] = {}
    for split in ("train", "val"):
        p = src / f"{split}.json"
        if p.exists():
            with open(p) as f:
                for name, m in json.load(f).items():
                    meta[name] = dict(m, split=split)

    with open(recon / "image_list.txt") as f:
        image_list = [ln.split("/")[-1] for ln in f.read().splitlines()
                      if ln.strip()]
    with open(recon / "reconstruction.json") as f:
        shots = json.load(f)[0]["shots"]

    frames = []
    for name in _natsorted(image_list):
        if name not in meta or name not in shots:
            continue
        m = meta[name]
        w2c = _rt44(_axis_angle_to_rot(shots[name]["rotation"]),
                    shots[name]["translation"])
        c2w = np.linalg.inv(w2c)
        depth = np.asarray(PIL.Image.open(
            src / m["split"] / f"{name}.png"), np.float64) / 100.0
        dh, dw = depth.shape
        img = PIL.Image.open(src / m["split"] / f"{name}.jpg").resize(
            (dw, dh))
        rel_img, rel_depth = f"images/{name}.jpg", f"depth/{name}.exr"
        store_data(dst / rel_img, np.asarray(img), "image")
        store_data(dst / rel_depth, depth.astype(np.float32), "depth")
        f = m["focal"] * max(dw, dh)
        frames.append(_pinhole_frame(
            name, rel_img, c2w, dh, dw, f, f, dw / 2, dh / 2, rel_depth))

    if len(frames) < 2:
        import shutil

        shutil.rmtree(dst / "images", ignore_errors=True)
        shutil.rmtree(dst / "depth", ignore_errors=True)
        return _store_scene_meta(
            dst, scene_name, "mpsd", [], scale_type="metric",
            frame_modalities={},
            skipped_reason=(f"Scene has only {len(frames)} valid frames "
                            "(minimum required: 2)"))
    return _store_scene_meta(dst, scene_name, "mpsd", frames,
                             scale_type="metric")


# ---------------------------------------------------------------------------
# MVS-Synth (reference conversion/mvs_synth.py)
# ---------------------------------------------------------------------------

def convert_mvs_synth_scene(original_root: str, out_root: str,
                            scene_name: str, link: bool = True) -> Path:
    """One MVS-Synth scene -> WAI (mvs_synth.py process_mvs_synth_scene):
    EXR depths with inf sky zeroed, depth AND translation divided by 10
    (the reference's empirical metric recalibration, mvs_synth.py:85-87,
    113-115), w2c json poses inverted then RUF->RDF flipped."""
    from .wai import load_data

    src = Path(original_root) / scene_name
    dst = Path(out_root) / scene_name
    (dst / "images").mkdir(parents=True, exist_ok=True)
    (dst / "depth").mkdir(parents=True, exist_ok=True)

    frames = []
    for image_file in _natsorted(f for f in os.listdir(src / "images")
                                 if f.endswith(".png")):
        name = image_file[:-4]
        rel_img = f"images/{image_file}"
        _carry(src / "images" / image_file, dst / rel_img, link)
        depth = np.asarray(load_data(src / "depths" / f"{name}.exr",
                                     "depth"), np.float32)
        depth = np.where(np.isinf(depth), 0.0, depth) / 10.0
        rel_depth = f"depth/{name}.exr"
        store_data(dst / rel_depth, depth, "depth")
        with open(src / "poses" / f"{name}.json") as f:
            cam = json.load(f)
        c2w = _FLIP_Y @ np.linalg.inv(
            np.asarray(cam["extrinsic"], np.float64))
        c2w[:3, 3] /= 10.0
        frames.append(_pinhole_frame(
            name, rel_img, c2w, depth.shape[0], depth.shape[1],
            cam["f_x"], cam["f_y"], cam["c_x"], cam["c_y"], rel_depth))
    return _store_scene_meta(dst, scene_name, "mvs_synth", frames,
                             scale_type="metric")


# ---------------------------------------------------------------------------
# ParallelDomain-4D (reference conversion/paralleldomain4d.py)
# ---------------------------------------------------------------------------

def convert_paralleldomain4d_scene(original_root: str, out_root: str,
                                   scene_name: str,
                                   link: bool = True) -> Path:
    """One PD-4D scene -> WAI (paralleldomain4d.py): camera entries from
    the scene json (annotation '6' = depth npz), validity depth<500,
    LFU->RDF pose permutation, per-camera intrinsics from the calibration
    json."""
    src = Path(original_root) / scene_name
    dst = Path(out_root) / scene_name
    (dst / "images").mkdir(parents=True, exist_ok=True)
    (dst / "depth").mkdir(parents=True, exist_ok=True)

    meta_files = glob.glob(str(src / "scene_*.json"))
    if not meta_files:
        raise FileNotFoundError(f"{src}/scene_*.json")
    with open(meta_files[0]) as f:
        scene_json = json.load(f)
    calib_file = os.listdir(src / "calibration")[0]
    with open(src / "calibration" / calib_file) as f:
        calib = json.load(f)
    intr_of = dict(zip(calib["names"], calib["intrinsics"]))

    frames = []
    for entry in scene_json["data"]:
        if "image" not in entry["datum"]:
            continue
        rgb_rel = entry["datum"]["image"]["filename"]
        depth_rel = entry["datum"]["image"]["annotations"]["6"]
        if not ((src / rgb_rel).exists() and (src / depth_rel).exists()):
            continue
        _, camera, file_name = rgb_rel.split("/")
        file_name = os.path.splitext(file_name)[0]
        name = f"{file_name}_{camera}"
        rel_img = f"images/{name}.png"
        _carry(src / rgb_rel, dst / rel_img, link)
        depth = np.load(src / depth_rel)["data"].astype(np.float32)
        depth = np.where(depth < 500.0, depth, 0.0)
        rel_depth = f"depth/{name}.exr"
        store_data(dst / rel_depth, depth, "depth")
        pose = entry["datum"]["image"]["pose"]
        q, t = pose["rotation"], pose["translation"]
        pose_lfu = _rt44(_quat_xyzw_to_rot([q["qx"], q["qy"], q["qz"],
                                            q["qw"]]),
                         [t["x"], t["y"], t["z"]])
        c2w = _LFU_TO_RDF @ pose_lfu
        intr = intr_of[camera]
        frames.append(_pinhole_frame(
            name, rel_img, c2w, depth.shape[0], depth.shape[1],
            intr["fx"], intr["fy"], intr["cx"], intr["cy"], rel_depth))
    return _store_scene_meta(dst, scene_name, "paralleldomain4d", frames,
                             scale_type="metric")


# ---------------------------------------------------------------------------
# SAIL-VOS 3D (reference conversion/sailvos3d.py)
# ---------------------------------------------------------------------------

def _sailvos_ndc_depth_to_cam(depth: np.ndarray,
                              P_inv: np.ndarray) -> np.ndarray:
    """NDC-coded game depth -> camera z-depth (sailvos3d.py:51-98):
    rescale by /6 - 4e-5, lift each pixel to NDC xy in [-1, 1] (y up), push
    through P_inv, dehomogenize, negate z."""
    h, w = depth.shape
    scaled = depth.astype(np.float64) / 6.0 - 4e-5
    px, py = np.meshgrid(np.arange(w), np.arange(h))
    x_ndc = (2.0 / (w - 1)) * px.reshape(-1) - 1.0
    y_ndc = (-2.0 / (h - 1)) * py.reshape(-1) + 1.0
    ndc = np.stack([x_ndc, y_ndc, scaled.reshape(-1),
                    np.ones(h * w)], axis=1)
    cam = ndc @ np.asarray(P_inv, np.float64)
    cam /= cam[:, -1:]
    return (-cam[:, 2]).reshape(h, w)


def convert_sailvos3d_scene(original_root: str, out_root: str,
                            scene_name: str, link: bool = True) -> Path:
    """One SAIL-VOS-3D scene -> WAI (sailvos3d.py): camera YAMLs carry K
    (NDC-origin: +w/2, +h/2 shift) and w2c Rt; depth NPYs are NDC values
    decoded through the rage-matrix P_inv; depth==24e-5 is sky; poses are
    OpenGL -> gl2cv'd; BMP images re-encode to PNG."""
    import PIL.Image

    yaml = _require("yaml", "sailvos3d")
    src = Path(original_root) / scene_name
    dst = Path(out_root) / scene_name
    (dst / "images").mkdir(parents=True, exist_ok=True)
    (dst / "depth").mkdir(parents=True, exist_ok=True)
    if not (src / "images").exists():
        raise FileNotFoundError(f"{src}/images (sailvos3d layout)")

    cam_files = sorted((src / "camera").glob("*.yaml"))
    img_stems = {p.stem for p in (src / "images").glob("*.bmp")}
    common = [c for c in cam_files if c.stem in img_stems]
    if not common:
        raise ValueError(f"{scene_name}: no camera/image stem overlap")

    frames = []
    for cam_file in common:
        name = cam_file.stem
        with open(cam_file) as f:
            cam = yaml.safe_load(f)
        depth = np.load(src / "depth" / f"{name}.npy")
        sky = depth == 24e-5
        h, w = depth.shape
        K = np.asarray(cam["K"], np.float64)
        fl_x, fl_y = K[0, 0], K[1, 1]
        cx, cy = K[0, 2] + w / 2.0, K[1, 2] + h / 2.0
        w2c = np.eye(4)
        w2c[:3, :] = np.asarray(cam["Rt"], np.float64)
        c2w = _gl2cv(np.linalg.inv(w2c))
        rage = np.load(src / "rage_matrices" / f"{name}.npz")
        depth_m = _sailvos_ndc_depth_to_cam(depth, rage["P_inv"])
        depth_m = np.where(sky, 0.0, depth_m).astype(np.float32)
        rel_img = f"images/{name}.png"
        with PIL.Image.open(src / "images" / f"{name}.bmp") as im:
            im.convert("RGB").save(dst / rel_img)
        rel_depth = f"depth/{name}.exr"
        store_data(dst / rel_depth, depth_m, "depth")
        frames.append(_pinhole_frame(name, rel_img, c2w, h, w,
                                     fl_x, fl_y, cx, cy, rel_depth))
    return _store_scene_meta(dst, scene_name, "sailvos3d", frames,
                             scale_type="metric")


# ---------------------------------------------------------------------------
# Spring (reference conversion/spring.py)
# ---------------------------------------------------------------------------

SPRING_BASELINE_M = 0.065  # spring.py:55 stereo rig baseline


def load_dsp5_disparity(path) -> np.ndarray:
    """dsp5 = HDF5 with a 'disparity' dataset (spring.py:45-52)."""
    h5py = _require("h5py", "spring")

    with h5py.File(path, "r") as f:
        if "disparity" not in f:
            raise IOError(f"{path}: no 'disparity' key — not a dsp5 file")
        return np.asarray(f["disparity"])


def _spring_depth(disp_path, K) -> np.ndarray:
    """Disparity (stored at 2x resolution, subsampled [::2, ::2]) ->
    metric depth via fx * baseline / disp (spring.py:55-73)."""
    disp = load_dsp5_disparity(disp_path)[::2, ::2]
    valid = disp > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        depth = K[0, 0] * SPRING_BASELINE_M / disp
    return np.where(valid, depth, 0.0).astype(np.float32)


def convert_spring_scene(original_root: str, out_root: str, scene_name: str,
                         split: Optional[str] = None,
                         link: bool = True) -> Path:
    """One Spring scene -> WAI (spring.py process_spring_scene): per-frame
    intrinsics rows; train scenes carry disp1 left/right -> metric depth
    plus nearest-resized skymasks; the right camera pose is the left w2c
    with the 0.065 m baseline subtracted on x; test scenes are
    images+intrinsics only (no extrinsics released)."""
    import PIL.Image

    src_root = Path(original_root)
    if split is None:
        split = next((s for s in ("train", "test")
                      if (src_root / s / scene_name).exists()), None)
        if split is None:
            raise FileNotFoundError(f"{scene_name} under train/ or test/")
    src = src_root / split / scene_name
    dst = Path(out_root) / scene_name
    (dst / "images").mkdir(parents=True, exist_ok=True)
    is_train = split == "train"

    intr_rows = np.loadtxt(src / "cam_data" / "intrinsics.txt", ndmin=2)
    extr = None
    if is_train:
        extr = np.loadtxt(src / "cam_data" / "extrinsics.txt",
                          ndmin=2).reshape(-1, 4, 4)

    frames = []
    left_files = _natsorted(os.listdir(src / "frame_left"))
    modalities = {"image": {"frame_key": "image", "format": "image"}}
    for idx, left_name in enumerate(left_files):
        right_name = left_name.replace("frame_left", "frame_right")
        frame_num = left_name.split(".")[0].replace("frame_left_", "")
        fx, fy, cx, cy = intr_rows[idx]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        with PIL.Image.open(src / "frame_left" / left_name) as im:
            w, h = im.size

        for side, img_name in (("left", left_name), ("right", right_name)):
            rel_img = f"images/{img_name}"
            _carry(src / f"frame_{side}" / img_name, dst / rel_img, link)
            frame = {
                "frame_name": img_name.split(".")[0],
                "file_path": rel_img, "image": rel_img,
                "h": int(h), "w": int(w),
                "fl_x": float(fx), "fl_y": float(fy),
                "cx": float(cx), "cy": float(cy),
            }
            if extr is not None:
                w2c = extr[idx].copy()
                if side == "right":
                    w2c[0, 3] -= SPRING_BASELINE_M
                frame["transform_matrix"] = np.linalg.inv(w2c).tolist()
            if is_train:
                depth = _spring_depth(
                    src / f"disp1_{side}" / f"disp1_{side}_{frame_num}.dsp5",
                    K)
                rel_depth = f"depth/{img_name.replace('.png', '.exr')}"
                store_data(dst / rel_depth, depth, "depth")
                frame["depth"] = rel_depth
                modalities["depth"] = {"frame_key": "depth",
                                       "format": "depth"}
                sky_path = (src / "maps" / f"skymap_{side}"
                            / f"skymap_{side}_{frame_num}.png")
                if sky_path.exists():
                    with PIL.Image.open(sky_path) as sky:
                        sky = np.asarray(
                            sky.resize((w, h), PIL.Image.NEAREST))
                    rel_sky = f"skymasks/{img_name}"
                    store_data(dst / rel_sky, sky.astype(bool), "binary")
                    frame["skymask"] = rel_sky
                    modalities["skymask"] = {"frame_key": "skymask",
                                             "format": "binary"}
            frames.append(frame)
    return _store_scene_meta(dst, scene_name, "spring", frames,
                             scale_type="metric",
                             frame_modalities=modalities)


# ---------------------------------------------------------------------------
# UnrealStereo4K (reference conversion/unrealstereo4k.py)
# ---------------------------------------------------------------------------

def _us4k_cam(path) -> Tuple[np.ndarray, np.ndarray]:
    """Extrinsics<i>/<frame>.txt: line 1 = 3x3 K flattened, line 2 = 3x4
    w2c flattened (unrealstereo4k.py:77-99)."""
    with open(path) as f:
        k_line, e_line = f.read().strip().splitlines()
    K = np.fromstring(k_line, sep=" ", dtype=np.float64).reshape(3, 3)
    w2c = np.eye(4)
    w2c[:3, :] = np.fromstring(e_line, sep=" ",
                               dtype=np.float64).reshape(3, 4)
    return K, w2c


def convert_unrealstereo4k_scene(original_root: str, out_root: str,
                                 scene_name: str,
                                 link: bool = True) -> Path:
    """One UnrealStereo4K scene -> WAI (unrealstereo4k.py): both cameras
    of each stereo frame convert; depth = baseline * fx / disparity with
    the baseline measured from the pair's extrinsics, validity
    depth<10000; RUF->RDF flip on both poses."""
    src = Path(original_root) / scene_name
    dst = Path(out_root) / scene_name
    (dst / "images").mkdir(parents=True, exist_ok=True)
    (dst / "depth").mkdir(parents=True, exist_ok=True)

    frames = []
    for stem in _natsorted(p.stem for p in (src / "Image0").glob("*.png")):
        K0, w2c0 = _us4k_cam(src / "Extrinsics0" / f"{stem}.txt")
        K1, w2c1 = _us4k_cam(src / "Extrinsics1" / f"{stem}.txt")
        baseline = float(np.linalg.norm(
            (w2c0 @ np.linalg.inv(w2c1))[:3, 3]))
        for cam_idx, (K, w2c) in enumerate(((K0, w2c0), (K1, w2c1))):
            name = f"{stem}_cam{cam_idx}"
            rel_img = f"images/{name}.png"
            _carry(src / f"Image{cam_idx}" / f"{stem}.png",
                   dst / rel_img, link)
            disp = np.load(src / f"Disp{cam_idx}" / f"{stem}.npy")
            with np.errstate(divide="ignore", invalid="ignore"):
                depth = baseline * K[0, 0] / disp
            depth = np.where(depth < 10000.0, depth, 0.0).astype(np.float32)
            rel_depth = f"depth/{name}.exr"
            store_data(dst / rel_depth, depth, "depth")
            c2w = _FLIP_Y @ np.linalg.inv(w2c)
            frames.append(_pinhole_frame(
                name, rel_img, c2w, depth.shape[0], depth.shape[1],
                K[0, 0], K[1, 1], K[0, 2], K[1, 2], rel_depth))
    return _store_scene_meta(dst, scene_name, "unrealstereo4k", frames,
                             scale_type="metric")


# ---------------------------------------------------------------------------
# ASE / Aria Synthetic Environments (reference conversion/ase.py)
# ---------------------------------------------------------------------------

ASE_RGB_IMAGE_SIZE = 704  # ase.py:29 (stored size is wrongly 2880)
ASE_SENSOR_RENDER_DIR = {"camera-slam-left": "0", "camera-slam-right": "1",
                         "camera-rgb": "2"}  # ase.py:32-36
_ASE_ROT90 = np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float64)


def fisheye624_img_from_cam(xy: np.ndarray, params: np.ndarray,
                            n_radial: int = 6) -> np.ndarray:
    """Aria FisheyeRadTanThinPrism (Fisheye624) projection of normalized
    cam points -> pixels. `params` = [f, cx, cy, k0..k5, p0, p1,
    s0..s3] (the layout projectaria's device calibration JSON stores;
    ase.py undistorts through this model via
    calibration.distort_by_calibration). Equidistant warp with a
    6-coefficient odd polynomial, then tangential (p) and thin-prism (s)
    terms on the radially-warped coords."""
    params = np.asarray(params, np.float64)
    f, cx, cy = params[:3]
    ks = params[3:3 + n_radial]
    p0, p1 = params[3 + n_radial:5 + n_radial]
    s0, s1, s2, s3 = params[5 + n_radial:9 + n_radial]
    u, v = np.asarray(xy, np.float64).T
    r = np.sqrt(u * u + v * v)
    theta = np.arctan(r)
    th2 = theta * theta
    theta_d = theta * (1.0 + sum(k * th2 ** (i + 1)
                                 for i, k in enumerate(ks)))
    safe = r > np.finfo(np.float64).eps
    scale = np.where(safe, theta_d / np.where(safe, r, 1.0), 1.0)
    ur, vr = u * scale, v * scale
    r2 = ur * ur + vr * vr
    du = (2 * p0 * ur * vr + p1 * (r2 + 2 * ur * ur)
          + s0 * r2 + s1 * r2 * r2)
    dv = (p0 * (r2 + 2 * vr * vr) + 2 * p1 * ur * vr
          + s2 * r2 + s3 * r2 * r2)
    x = f * (ur + du) + cx
    y = f * (vr + dv) + cy
    return np.stack([x, y], axis=-1)


def _ase_resample_to_pinhole(src_img: np.ndarray, fish_params, src_hw,
                             pin_K, pin_hw, nearest: bool) -> np.ndarray:
    """Undistort by inverse-mapping the pinhole grid through the Fisheye624
    projection and sampling the source (the same resample structure the
    reference gets from calibration.distort_by_calibration)."""
    h, w = pin_hw
    fx, fy, cx, cy = pin_K
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    xy = np.stack([(gx.ravel() - cx) / fx, (gy.ravel() - cy) / fy], axis=-1)
    dist_xy = fisheye624_img_from_cam(xy, fish_params)
    sh, sw = src_hw
    inside = ((dist_xy[:, 0] >= 0) & (dist_xy[:, 0] <= sw - 1)
              & (dist_xy[:, 1] >= 0) & (dist_xy[:, 1] <= sh - 1))
    xi = np.clip(np.round(dist_xy[:, 0]), 0, sw - 1).astype(np.int64)
    yi = np.clip(np.round(dist_xy[:, 1]), 0, sh - 1).astype(np.int64)
    out = src_img[yi, xi]
    out = np.where(inside.reshape(-1, *([1] * (out.ndim - 1))), out, 0)
    if not nearest and src_img.dtype == np.uint8:
        # bilinear for images (reference uses BILINEAR for RGB)
        x0 = np.clip(np.floor(dist_xy[:, 0]), 0, sw - 1).astype(np.int64)
        y0 = np.clip(np.floor(dist_xy[:, 1]), 0, sh - 1).astype(np.int64)
        x1, y1 = np.minimum(x0 + 1, sw - 1), np.minimum(y0 + 1, sh - 1)
        ax = (dist_xy[:, 0] - x0)[:, None]
        ay = (dist_xy[:, 1] - y0)[:, None]
        v00 = src_img[y0, x0].astype(np.float64)
        v01 = src_img[y0, x1].astype(np.float64)
        v10 = src_img[y1, x0].astype(np.float64)
        v11 = src_img[y1, x1].astype(np.float64)
        blend = (v00 * (1 - ax) * (1 - ay) + v01 * ax * (1 - ay)
                 + v10 * (1 - ax) * ay + v11 * ax * ay)
        out = np.where(inside[:, None], blend, 0.0).astype(np.uint8)
    return out.reshape(h, w, *src_img.shape[2:])


def _read_ase_trajectory(path) -> Tuple[np.ndarray, np.ndarray]:
    """gt_trajectory_mps.csv -> (T_world_device (N,4,4), timestamps):
    columns [_, timestamp, _, tx, ty, tz, qx, qy, qz, qw]
    (ase.py:100-131)."""
    transforms, stamps = [], []
    with open(path) as f:
        f.readline()  # header
        for line in f:
            parts = line.rstrip().split(",")
            if len(parts) < 10:
                continue
            stamps.append(int(parts[1]))
            t = [float(p) for p in parts[3:6]]
            R = _quat_xyzw_to_rot([float(p) for p in parts[6:10]])
            transforms.append(_rt44(R, t))
    return np.stack(transforms), np.asarray(stamps)


def _load_ase_calibration(calib_json_path) -> Dict[str, dict]:
    """Aria device-calibration JSON -> {label: {T_device_camera,
    projection_params, image_size}} (the fields
    device_calibration_from_json_string reads, ase.py:381-385)."""
    with open(calib_json_path) as f:
        calib = json.load(f)
    out = {}
    for cam in calib.get("CameraCalibrations", []):
        tdc = cam["T_Device_Camera"]
        q = tdc["UnitQuaternion"]  # [w, [x, y, z]] (aria convention)
        R = _quat_xyzw_to_rot([q[1][0], q[1][1], q[1][2], q[0]])
        out[cam["Label"]] = {
            "T_device_camera": _rt44(R, tdc["Translation"]),
            "projection_params": np.asarray(cam["Projection"]["Params"],
                                            np.float64),
            "image_size": (int(cam["ImageSizes"][0]),
                           int(cam["ImageSizes"][1])),  # (W, H)
        }
    return out


def convert_ase_scene(
    original_root: str, out_root: str, scene_name: str,
    calib_json_path: str,
    sensor_names: Sequence[str] = ("camera-rgb",),
    rotate_to_portrait: bool = True,
) -> Path:
    """One ASE scene -> WAI (ase.py convert_ase_scene + process_sensor).

    Per sensor: device trajectory x T_device_camera gives cam2world; the
    Fisheye624 renders undistort to a pinhole with the same focal and a
    centered principal point (projectaria get_linear_camera_calibration
    semantics); range PNGs (mm, uint16) mask 0/65535 as invalid, scale to
    meters, convert range->z-depth, and everything rotates 90deg cw to
    portrait (intrinsics via rotate_pinhole_90degcw, pose columns by
    rot90). camera-rgb forces the 704px size (stored size is wrong,
    ase.py:153-158)."""
    import PIL.Image

    src = Path(original_root) / scene_name
    render_root = src / "render" / "images"
    if not render_root.exists():
        raise FileNotFoundError(f"{render_root} (ase render layout)")
    dst = Path(out_root) / scene_name
    for sub in ("images", "depth", "masks"):
        (dst / sub).mkdir(parents=True, exist_ok=True)

    traj, _stamps = _read_ase_trajectory(src / "gt_trajectory_mps.csv")
    calib = _load_ase_calibration(calib_json_path)

    frames = []
    for sensor in sorted(sensor_names):
        cam = calib[sensor]
        T_dc = cam["T_device_camera"].copy()
        if rotate_to_portrait:
            T_dc[:3, :3] = T_dc[:3, :3] @ _ASE_ROT90
        cam2worlds = traj @ T_dc

        if sensor == "camera-rgb":
            W = H = ASE_RGB_IMAGE_SIZE
        else:
            W, H = cam["image_size"]
        f = float(cam["projection_params"][0])
        # linear (pinhole) target: same focal, centered principal point
        fx = fy = f
        cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
        pin_K = (fx, fy, cx, cy)
        # range (distance along ray) -> z-depth divisor per pixel
        gx, gy = np.meshgrid(np.arange(W, dtype=np.float64),
                             np.arange(H, dtype=np.float64))
        ray_norm = np.sqrt(((gx - cx) / fx) ** 2
                           + ((gy - cy) / fy) ** 2 + 1.0)

        wai_fx, wai_fy, wai_cx, wai_cy, wai_w, wai_h = fx, fy, cx, cy, W, H
        if rotate_to_portrait:
            wai_w, wai_h, wai_fx, wai_fy, wai_cx, wai_cy = (
                H, W, fy, fx, H - 1 - cy, cx)

        render_dir = render_root / ASE_SENSOR_RENDER_DIR[sensor]
        prefix = sensor.replace("camera-", "").replace("-", "_")
        for rgb_path in sorted(render_dir.glob("rgb*")):
            m = re.match(r"rgb(\d+)", rgb_path.stem)
            if not m:
                continue
            idx = m.group(1)
            range_path = render_dir / f"depth{idx}.png"
            if not range_path.exists():
                raise FileNotFoundError(str(range_path))
            img = np.asarray(PIL.Image.open(rgb_path).convert("RGB"))
            rng = np.asarray(PIL.Image.open(range_path),
                             np.float32)
            mask = ((rng != 0) & (rng != np.iinfo(np.uint16).max))
            rng = np.where(mask, rng, 0.0)

            src_hw = img.shape[:2]
            fish = cam["projection_params"]
            img_u = _ase_resample_to_pinhole(img, fish, src_hw, pin_K,
                                             (H, W), nearest=False)
            rng_u = _ase_resample_to_pinhole(rng, fish, src_hw, pin_K,
                                             (H, W), nearest=True)
            mask_u = _ase_resample_to_pinhole(
                mask.astype(np.uint8), fish, src_hw, pin_K, (H, W),
                nearest=True).astype(bool)
            depth = (rng_u / 1000.0) / ray_norm  # mm -> m, range -> z

            if rotate_to_portrait:
                img_u = np.rot90(img_u, axes=(1, 0))
                depth = np.rot90(depth, axes=(1, 0))
                mask_u = np.rot90(mask_u, axes=(1, 0))

            name = f"{prefix}_{idx}"
            rel_img = f"images/{name}.jpg"
            rel_depth = f"depth/{name}.exr"
            rel_mask = f"masks/{name}.png"
            store_data(dst / rel_img, np.ascontiguousarray(img_u), "image")
            store_data(dst / rel_depth,
                       np.ascontiguousarray(depth).astype(np.float32),
                       "depth")
            store_data(dst / rel_mask, np.ascontiguousarray(mask_u),
                       "binary")
            frame_idx = min(int(idx), len(cam2worlds) - 1)
            frames.append(_pinhole_frame(
                name, rel_img, cam2worlds[frame_idx], wai_h, wai_w,
                wai_fx, wai_fy, wai_cx, wai_cy, rel_depth,
                mask_path=rel_mask))

    if not frames:
        raise RuntimeError(f"{scene_name}: processed 0 wai frames")
    modalities = {
        "image": {"frame_key": "image", "format": "image"},
        "depth": {"frame_key": "depth", "format": "depth"},
        "mask": {"frame_key": "mask_path", "format": "binary"},
    }
    extra = {}
    if rotate_to_portrait:
        extra["_applied_transform"] = _ASE_ROT90.tolist()
        extra["_applied_transforms"] = {
            "image_rotation": _ASE_ROT90.tolist()}
    shared = len(sensor_names) == 1
    if shared:  # single sensor: intrinsics live on the scene (ase.py:337)
        for key in ("fl_x", "fl_y", "cx", "cy", "h", "w"):
            extra[key] = frames[0][key]
        for frame in frames:
            for key in ("fl_x", "fl_y", "cx", "cy", "h", "w"):
                del frame[key]
    return _store_scene_meta(dst, scene_name, "ase", frames,
                             scale_type="metric",
                             shared_intrinsics=shared,
                             frame_modalities=modalities, **extra)


# the CLI's registry (convert_dataset.py)
CORPUS_CONVERTERS = {
    "ase": convert_ase_scene,
    "blendedmvs": convert_blendedmvs_scene,
    "dl3dv": convert_dl3dv_scene,
    "dynamicreplica": convert_dynamicreplica_scene,
    "megadepth": convert_megadepth_scene,
    "mpsd": convert_mpsd_scene,
    "mvs_synth": convert_mvs_synth_scene,
    "paralleldomain4d": convert_paralleldomain4d_scene,
    "sailvos3d": convert_sailvos3d_scene,
    "spring": convert_spring_scene,
    "unrealstereo4k": convert_unrealstereo4k_scene,
}
