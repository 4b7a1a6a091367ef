"""Scenes with known geometry for the offline data-processing stages, and
the comparison of two WAI trees. No JAX: `chip_smoke.py` builds its
phase-14 inputs from this module too.

  * `room_mesh`: a closed box room, each wall a grid of triangles with
    vertex colours, whose z-depth from any camera inside is known in
    closed form (`room_depth`);
  * `room_cameras`: cameras inside it, turned about the vertical axis;
  * `write_ply`: a binary little-endian PLY with colours, ScanNet++'s mesh
    format;
  * `write_scannetpp_raw`: a raw ScanNet++ v2 scene (nerfstudio
    transforms.json in OpenGL convention, OPENCV_FISHEYE DSLR frames with
    anonymisation masks, the COLMAP text directory and the mesh);
  * `FakeMonoAdapter` / `FakeMVSAdapter`: the pseudo-depth stage's
    stand-ins in the port's adapter contract;
  * `assert_trees_equal`: two WAI trees file by file, and the limits two
    fp32 runs of the device stages are held to.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path

import numpy as np
import PIL.Image
import torch

ROOM = (8.0, 3.0, 6.0)  # x (width), y (height, +y down), z (depth) in metres

# Two fp32 computations of the same stage (the port against JAX, the card
# against the CPU) differ by rounding: a reprojected pixel can round to its
# neighbour, a ray on an edge can flip between triangles. The limits:
COVIS_PIXELS = 4  # covisibility: max-abs COVIS_PIXELS / (h w)
# confidence: the share of pixels differing by > 1e-6. A pixel's score
# moves when one of its reprojections rounds to the neighbouring target
# pixel, which on rough depth changes that target's vote: an H100
# against the CPU differed on 2.6e-3 of the pixels of a randomly
# initialised MapAnything's depth, 2.9e-4 on smooth depth
CONF_SHARE = 1e-2
RENDER_RTOL = 1e-5  # rendered depth where both hit ...
HIT_SHARE = 1e-3  # ... and the share of pixels where one of them misses
ANALYTIC_RTOL = 1e-4  # rendered depth against the room's closed form


def room_mesh(size=ROOM, cells: int = 66):
    """A closed box [-sx/2, sx/2] x [-sy/2, sy/2] x [-sz/2, sz/2]; each of
    the six walls a cells x cells grid of quads, two triangles each
    (12 cells^2 triangles: 52272 at 66). Returns (vertices (N, 3) float32,
    faces (T, 3) int32, colours (N, 3) uint8: a checkerboard texture)."""
    half = np.asarray(size, np.float64) / 2
    g = np.linspace(-1.0, 1.0, cells + 1)
    uu, vv = np.meshgrid(g, g, indexing="ij")
    verts, faces, colours = [], [], []
    base = 0
    for axis in range(3):
        a, b = [k for k in range(3) if k != axis]
        for sign in (-1.0, 1.0):
            p = np.zeros(uu.shape + (3,))
            p[..., axis] = sign * half[axis]
            p[..., a] = uu * half[a]
            p[..., b] = vv * half[b]
            verts.append(p.reshape(-1, 3))
            check = ((np.arange(cells + 1)[:, None]
                      + np.arange(cells + 1)[None]) % 2).reshape(-1)
            colours.append(np.stack([
                60 + 150 * check, np.full_like(check, 90 + 40 * axis),
                np.full_like(check, 120 + 60 * (sign > 0))], -1))
            idx = base + np.arange((cells + 1) ** 2).reshape(cells + 1,
                                                             cells + 1)
            q00, q01 = idx[:-1, :-1], idx[:-1, 1:]
            q10, q11 = idx[1:, :-1], idx[1:, 1:]
            faces.append(np.stack([q00, q10, q11], -1).reshape(-1, 3))
            faces.append(np.stack([q00, q11, q01], -1).reshape(-1, 3))
            base += (cells + 1) ** 2
    return (np.concatenate(verts).astype(np.float32),
            np.concatenate(faces).astype(np.int32),
            np.concatenate(colours).astype(np.uint8))


def room_depth(K, cam2world, hw, size=ROOM) -> np.ndarray:
    """Closed-form z-depth (H, W) of the room from a camera inside it:
    the nearest positive crossing of each pixel's ray (z-component 1 in
    the camera frame) with the six wall planes, in float64."""
    h, w = hw
    K = np.asarray(K, np.float64)
    c2w = np.asarray(cam2world, np.float64)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    dirs = np.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                     np.ones_like(xs)], -1) @ c2w[:3, :3].T
    centre = c2w[:3, 3]
    half = np.asarray(size, np.float64) / 2
    best = np.full((h, w), np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for axis in range(3):
            for sign in (-1.0, 1.0):
                t = (sign * half[axis] - centre[axis]) / dirs[..., axis]
                best = np.where((t > 0) & (t < best), t, best)
    return best


def yaw_pose(yaw: float, position) -> np.ndarray:
    """OpenCV cam2world looking along +z turned by `yaw` about the
    vertical (y) axis, at `position`."""
    c, s = math.cos(yaw), math.sin(yaw)
    pose = np.eye(4)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = position
    return pose


def room_cameras(n: int, radius: float = 0.2, step=None) -> np.ndarray:
    """(n, 4, 4) cameras on a circle of `radius` about the room's centre,
    frame k turned by k * step (2 pi / n by default: then, for even n,
    frame k + n / 2 faces away from frame k)."""
    step = 2 * math.pi / n if step is None else step
    out = []
    for k in range(n):
        yaw = step * k
        out.append(yaw_pose(yaw, [radius * math.cos(yaw), 0.1,
                                  radius * math.sin(yaw)]))
    return np.stack(out)


def write_ply(path, verts, faces, colours) -> None:
    """Binary little-endian PLY: float xyz + uchar rgb vertices, uchar-
    counted int triangles (ScanNet++'s mesh_aligned_0.05.ply layout)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = "\n".join([
        "ply", "format binary_little_endian 1.0",
        f"element vertex {len(verts)}", "property float x",
        "property float y", "property float z", "property uchar red",
        "property uchar green", "property uchar blue",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices", "end_header"]) + "\n"
    vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                    ("r", "u1"), ("g", "u1"), ("b", "u1")])
    v = np.empty(len(verts), vdt)
    v["x"], v["y"], v["z"] = np.asarray(verts, np.float32).T
    v["r"], v["g"], v["b"] = np.asarray(colours, np.uint8).T
    fdt = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
    f = np.empty(len(faces), fdt)
    f["n"], f["i"] = 3, faces
    with open(path, "wb") as fh:
        fh.write(header.encode())
        fh.write(v.tobytes())
        fh.write(f.tobytes())


# ScanNet++ v2's DSLR frames are 1752 x 1168 with a fisheye model
SNPP_FISHEYE = {"fl_x": 1100.0, "fl_y": 1100.0, "k1": -0.02, "k2": 0.004,
                "k3": -0.001, "k4": 0.0002}


def write_scannetpp_raw(root, scene: str, poses, w: int, h: int,
                        mesh=None, n_test: int = 0, seed: int = 0,
                        camera=None) -> Path:
    """A raw ScanNet++ v2 scene under root/scene: dslr/resized_images and
    resized_anon_masks, dslr/nerfstudio/transforms.json (OpenGL poses,
    OPENCV_FISHEYE shared intrinsics scaled to w; the last n_test poses as
    test_frames), dslr/colmap and, given (verts, faces, colours),
    scans/mesh_aligned_0.05.ply."""
    src = Path(root) / scene
    dslr = src / "dslr"
    for sub in ("resized_images", "resized_anon_masks", "nerfstudio",
                "colmap"):
        (dslr / sub).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    cam = dict(SNPP_FISHEYE if camera is None else camera)
    scale = w / 1752.0
    cam["fl_x"] *= scale
    cam["fl_y"] *= scale
    frames, test_frames = [], []
    for i, c2w_cv in enumerate(poses):
        name = f"DSC{i:05d}"
        img = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
        PIL.Image.fromarray(img).save(dslr / "resized_images" / f"{name}.JPG",
                                      format="JPEG", quality=90)
        mask = np.full((h, w), 255, np.uint8)
        mask[: h // 16, : w // 16] = 0  # an anonymised patch
        PIL.Image.fromarray(mask).save(
            dslr / "resized_anon_masks" / f"{name}.png")
        c2w_gl = np.asarray(c2w_cv, np.float64).copy()
        c2w_gl[:3, 1] *= -1
        c2w_gl[:3, 2] *= -1
        rec = {"file_path": f"{name}.JPG", "mask_path": f"{name}.png",
               "transform_matrix": c2w_gl.tolist()}
        if i < len(poses) - n_test:
            frames.append(rec)
        else:
            rec["is_bad"] = False
            test_frames.append(rec)
    meta = {"camera_model": "OPENCV_FISHEYE", "cx": w / 2, "cy": h / 2,
            "w": w, "h": h, **cam, "frames": frames,
            "test_frames": test_frames}
    with open(dslr / "nerfstudio" / "transforms.json", "w") as f:
        json.dump(meta, f)
    for name in ("cameras", "images", "points3D"):
        (dslr / "colmap" / f"{name}.txt").write_text("# empty\n")
    if mesh is not None:
        write_ply(src / "scans" / "mesh_aligned_0.05.ply", *mesh)
    return src


class FakeMonoAdapter(torch.nn.Module):
    """The port-contract stand-in of a monocular labeller: depth = 1 +
    |mean normalised intensity| per pixel, mask = every column but the
    two leftmost (content-dependent, so the stage's plumbing shows)."""

    def __init__(self, device="cpu"):
        super().__init__()
        self.device = device

    def forward(self, views, geom_cfg=None, memory_efficient=False):
        img = views["img"].float()  # (B, V, H, W, 3) normalised
        z = 1.0 + img.mean(-1).abs()
        zero = torch.zeros_like(z)
        mask = torch.ones(z.shape, dtype=torch.bool, device=z.device)
        mask[..., :2] = False
        return {"pts3d_cam": torch.stack([zero, zero, z], -1),
                "non_ambiguous_mask": mask}


class FakeMVSAdapter(FakeMonoAdapter):
    """An MVS-style stand-in that also emits its own confidence, 1 /
    depth (run_mvsanywhere.py's posture)."""

    def forward(self, views, geom_cfg=None, memory_efficient=False):
        out = super().forward(views, geom_cfg, memory_efficient)
        out["conf"] = 1.0 / out["pts3d_cam"][..., 2]
        return out


# ---------------------------------------------------------------------------
# WAI trees, file by file


def assert_render_close(want, got):
    """Two renders of one view agree within RENDER_RTOL where both hit,
    and hit the same pixels but for HIT_SHARE of them."""
    both = (want > 0) & (got > 0)
    assert ((want > 0) != (got > 0)).mean() <= HIT_SHARE
    np.testing.assert_allclose(got[both], want[both], rtol=RENDER_RTOL)


def tree_entries(root) -> dict:
    """{relative path: 'link' | 'dir' | 'file'} of everything under root;
    symlinks are not followed."""
    out = {}
    root = Path(root)
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            p = Path(dirpath) / name
            rel = p.relative_to(root).as_posix()
            out[rel] = ("link" if p.is_symlink() else
                        "dir" if p.is_dir() else "file")
    return out


def json_close(a, b, rtol: float, path: str = "") -> list:
    """The paths at which two parsed JSON values differ (floats within
    rtol relative)."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(set(a) ^ set(b))}"]
        return [d for k in a for d in json_close(a[k], b[k], rtol,
                                                 f"{path}/{k}")]
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{path}: lengths {len(a)} / {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in json_close(x, y, rtol, f"{path}[{i}]")]
    if (isinstance(a, float) and isinstance(b, (int, float))
            and not isinstance(b, bool)):
        ok = abs(a - b) <= rtol * max(abs(a), abs(b))
        return [] if ok else [f"{path}: {a!r} / {b!r}"]
    return [] if a == b and type(a) is type(b) else [f"{path}: {a!r} / {b!r}"]


def assert_trees_equal(ref_root, got_root, json_rtol: float = 0.0,
                       depth_atol: float = 1e-6, compare=None) -> int:
    """Hold `got_root` to `ref_root` file by file: the same entries (links
    as links), JSON equal as parsed (floats within json_rtol relative),
    images and masks bitwise, EXR / npy arrays within depth_atol, any
    other file byte for byte. `compare` maps a path prefix to a function
    (ref array, got array) that checks the arrays of the files under it
    instead. Returns the number of files compared."""
    from mapanything_tpu_torch.data.wai import load_data

    ref, got = tree_entries(ref_root), tree_entries(got_root)
    assert ref == got, (sorted(set(ref.items()) ^ set(got.items())))[:10]
    n = 0
    for rel, kind in ref.items():
        a, b = Path(ref_root) / rel, Path(got_root) / rel
        if kind == "dir":
            continue
        if kind == "link" and a.is_dir():
            assert sorted(os.listdir(a)) == sorted(os.listdir(b)), rel
            continue
        sfx = a.suffix.lower()
        if sfx == ".json":
            with open(a) as fa, open(b) as fb:
                diffs = json_close(json.load(fa), json.load(fb), json_rtol)
            assert not diffs, (rel, diffs[:10])
        elif sfx in (".png", ".jpg", ".jpeg", ".bmp"):
            x, y = np.asarray(PIL.Image.open(a)), np.asarray(PIL.Image.open(b))
            assert x.dtype == y.dtype and np.array_equal(x, y), rel
        elif sfx in (".exr", ".npy"):
            fmt = "depth" if sfx == ".exr" else "numpy"
            x = np.asarray(load_data(a, fmt))
            y = np.asarray(load_data(b, fmt))
            assert x.shape == y.shape and x.dtype == y.dtype, rel
            check = next((fn for prefix, fn in (compare or {}).items()
                          if rel.startswith(prefix)), None)
            if check is not None:
                check(x, y)
            else:
                np.testing.assert_allclose(y, x, rtol=0, atol=depth_atol,
                                           err_msg=rel)
        else:
            assert a.read_bytes() == b.read_bytes(), rel
        n += 1
    return n
