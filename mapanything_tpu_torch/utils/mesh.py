"""Pixel-lattice meshing and the GLB triangle-mesh writer (host numpy);
counterpart of mapanything_tpu/utils/mesh.py, whose numpy this copies so
that the meshes and files are bitwise the same.

The demo app turns per-view (H, W) prediction grids into triangle meshes,
the behaviour of the reference's trimesh-based helpers
(`mapanything/utils/hf_utils/viz.py`: image_mesh:95, triangulate:49,
remove_unreferenced_vertices:22, integrate_camera_into_scene:450,
apply_scene_alignment:502) without trimesh, on the raw-glTF writer of
`viz.py`.

Conventions shared with the reference:
- grid quads connect pixel (r, c) to (r+1, c), (r+1, c+1), (r, c+1);
- quads split along their shorter 3-D diagonal (``backslash`` choice),
  decided in fp32 on the host;
- compacting a masked mesh renumbers faces and drops unused vertices.
"""

from __future__ import annotations

import json
import struct
from typing import Optional, Tuple

import numpy as np

# glTF component types
_F32, _U8, _U32 = 5126, 5121, 5125


def grid_quad_faces(height: int, width: int) -> np.ndarray:
    """(T, 4) int32 quad faces over an H*W pixel lattice, vertices in
    row-major pixel order. Quad k at (r, c) is
    [r*w+c, (r+1)*w+c, (r+1)*w+c+1, r*w+c+1]."""
    r = np.arange(height - 1, dtype=np.int32)[:, None]
    c = np.arange(width - 1, dtype=np.int32)[None, :]
    tl = r * width + c  # (H-1, W-1)
    quads = np.stack(
        [tl, tl + width, tl + width + 1, tl + 1], axis=-1
    )
    return quads.reshape(-1, 4)


def triangulate(
    faces: np.ndarray,
    vertices: Optional[np.ndarray] = None,
    backslash: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Polygon faces -> (T, 3) triangles.

    Quads may pass ``vertices`` to pick each quad's split along its
    shorter diagonal (or an explicit ``backslash`` bool per face); any
    other polygon degree fan-triangulates. Index patterns
    [0,1,2|0,2,3] vs [0,1,3|3,1,2] are the reference protocol
    (hf_utils/viz.py:49-93).
    """
    faces = np.asarray(faces)
    p = faces.shape[-1]
    if p == 3:
        return faces
    if backslash is None and vertices is not None:
        if p != 4:
            raise ValueError("diagonal-split triangulation needs quads")
        d02 = np.linalg.norm(
            vertices[faces[:, 0]] - vertices[faces[:, 2]], axis=-1)
        d13 = np.linalg.norm(
            vertices[faces[:, 1]] - vertices[faces[:, 3]], axis=-1)
        backslash = d02 < d13
    if backslash is None:
        fan = np.stack([
            np.zeros(p - 2, np.int64),
            np.arange(1, p - 1),
            np.arange(2, p),
        ], axis=1)
        return faces[:, fan].reshape(-1, 3)
    if p != 4:
        raise ValueError("backslash split only defined for quads")
    split_a = faces[:, [0, 1, 2, 0, 2, 3]]
    split_b = faces[:, [0, 1, 3, 3, 1, 2]]
    return np.where(
        np.asarray(backslash)[:, None], split_a, split_b
    ).reshape(-1, 3)


def compact_vertices(
    faces: np.ndarray, *vertex_attrs: np.ndarray, return_indices: bool = False
) -> Tuple[np.ndarray, ...]:
    """Drop vertices no face references; renumber faces densely.
    Returns (faces, *attrs[kept]) and optionally the kept indices."""
    kept, inverse = np.unique(faces, return_inverse=True)
    faces = inverse.astype(np.int32).reshape(faces.shape)
    out = [faces] + [a[kept] for a in vertex_attrs]
    if return_indices:
        out.append(kept)
    return tuple(out)


def image_mesh(
    *pixel_attrs: np.ndarray,
    mask: Optional[np.ndarray] = None,
    tri: bool = False,
    diagonal_attr: Optional[int] = None,
    return_indices: bool = False,
) -> Tuple[np.ndarray, ...]:
    """Mesh an image grid: pixels are vertices, 2x2 neighborhoods are
    quad faces (triangulated when ``tri``). A quad survives ``mask``
    only if all four corners are valid; masked meshes are compacted.

    Args: any number of (H, W, [C]) per-pixel attribute maps — each is
    returned flattened to per-vertex rows in the same order.
    ``diagonal_attr``: index of the attribute (typically the 3-D
    pointmap) used to split each quad along its shorter 3-D diagonal —
    avoids sliver triangles across depth jumps. Default None matches
    the reference exactly (its tri=True path fan-splits every quad,
    hf_utils/viz.py:136,147).
    """
    if not pixel_attrs and mask is None:
        raise ValueError("need at least one attribute map or a mask")
    h, w = (pixel_attrs[0] if pixel_attrs else mask).shape[:2]
    for a in pixel_attrs:
        if a.shape[:2] != (h, w):
            raise ValueError("attribute maps must share (H, W)")
    faces = grid_quad_faces(h, w)
    flat = [a.reshape(h * w, *a.shape[2:]) for a in pixel_attrs]
    split_verts = None
    if diagonal_attr is not None:
        if not tri:
            raise ValueError("diagonal_attr requires tri=True")
        split_verts = np.asarray(flat[diagonal_attr], np.float32)
        if split_verts.ndim != 2 or split_verts.shape[-1] != 3:
            raise ValueError("diagonal_attr must index an (H, W, 3) map")
    if mask is None:
        if tri:
            faces = triangulate(faces, vertices=split_verts)
        out = [faces, *flat]
        if return_indices:
            out.append(np.arange(h * w, dtype=np.int32))
        return tuple(out)
    corner_ok = (mask[:-1, :-1] & mask[1:, :-1]
                 & mask[1:, 1:] & mask[:-1, 1:])
    faces = faces[corner_ok.reshape(-1)]
    if tri:
        faces = triangulate(faces, vertices=split_verts)
    return compact_vertices(faces, *flat, return_indices=return_indices)


# ---------------------------------------------------------------------------
# Camera markers and scene alignment


OPENGL_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def alignment_transform(extrinsics: np.ndarray) -> np.ndarray:
    """4x4 world transform putting the scene in camera 0's OpenGL frame
    (cam 0 at the origin looking down -z). Same intent as the reference
    apply_scene_alignment (hf_utils/viz.py:502) but composed so the
    OpenCV->OpenGL axis flip happens AFTER the world->cam0 map — the
    reference multiplies the other way round, which leaves camera 0 off
    the origin; extrinsics are cam2world 4x4 (or 3x4 top rows)."""
    e0 = np.eye(4)
    e0[: extrinsics.shape[1]] = extrinsics[0][: extrinsics.shape[1]]
    return OPENGL_FLIP @ np.linalg.inv(e0)


def transform_points(transform: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to (N, 3) points."""
    return points @ transform[:3, :3].T + transform[:3, 3]


def camera_marker_mesh(
    pose: np.ndarray, scale: float = 0.6
) -> Tuple[np.ndarray, np.ndarray]:
    """Solid 4-sided pyramid marking a camera (apex at the optical
    center, base toward +z / the viewing direction). Returns
    (vertices (5,3) world frame, faces (6,3))."""
    s = scale
    base = np.array([
        [-s, -s, 2 * s], [s, -s, 2 * s], [s, s, 2 * s], [-s, s, 2 * s],
    ])
    verts = np.concatenate([np.zeros((1, 3)), base])
    faces = np.array([
        [0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1],  # sides
        [1, 3, 2], [1, 4, 3],  # base
    ], np.int32)
    pose = np.asarray(pose, np.float64)
    return transform_points(pose, verts).astype(np.float32), faces


# ---------------------------------------------------------------------------
# GLB triangle-mesh writer


def _pad4(b: bytes, fill: bytes = b"\x00") -> bytes:
    return b + fill * ((-len(b)) % 4)


def write_glb_mesh(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray,
    vertex_colors: Optional[np.ndarray] = None,
    vertex_normals: Optional[np.ndarray] = None,
    extra_meshes: Optional[list] = None,
) -> None:
    """Indexed-TRIANGLES glTF 2.0 binary. ``extra_meshes`` is a list of
    (vertices, faces, rgb_uint8_color) solid-colored meshes appended as
    separate nodes (camera markers)."""
    prims = [(vertices, faces, vertex_colors, vertex_normals)]
    for v, f, color in (extra_meshes or []):
        cols = np.broadcast_to(
            np.asarray(color, np.uint8), (len(v), 3)).copy()
        prims.append((v, f, cols, None))
    # glTF 2.0 requires accessor.count >= 1 — drop empty prims (e.g. a
    # fully-masked scene mesh) so the remaining nodes stay loadable
    prims = [p for p in prims if len(p[0]) and len(p[1])]
    if not prims:
        raise ValueError(
            "nothing to export: every mesh is empty (all pixels masked?)")

    buf = b""
    views, accessors, meshes = [], [], []
    for verts, fcs, cols, norms in prims:
        verts = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
        fcs = np.ascontiguousarray(fcs, np.uint32).reshape(-1, 3)
        attrs = {}

        def add(data: bytes, target_len: int, ctype: int, atype: str,
                normalized: bool = False, minmax=None) -> int:
            nonlocal buf
            views.append({"buffer": 0, "byteOffset": len(buf),
                          "byteLength": len(data)})
            buf += _pad4(data)
            acc = {"bufferView": len(views) - 1, "componentType": ctype,
                   "count": target_len, "type": atype}
            if normalized:
                acc["normalized"] = True
            if minmax is not None:
                acc["min"], acc["max"] = minmax
            accessors.append(acc)
            return len(accessors) - 1

        mm = ([verts.min(0).tolist(), verts.max(0).tolist()]
              if len(verts) else [[0] * 3, [0] * 3])
        attrs["POSITION"] = add(verts.tobytes(), len(verts), _F32, "VEC3",
                                minmax=mm)
        if cols is not None:
            cols = np.asarray(cols)
            if cols.dtype != np.uint8:
                cols = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
            rgba = np.concatenate(
                [cols.reshape(-1, 3),
                 np.full((len(verts), 1), 255, np.uint8)], axis=1)
            attrs["COLOR_0"] = add(rgba.tobytes(), len(rgba), _U8, "VEC4",
                                   normalized=True)
        if norms is not None:
            norms = np.ascontiguousarray(norms, np.float32).reshape(-1, 3)
            attrs["NORMAL"] = add(norms.tobytes(), len(norms), _F32, "VEC3")
        idx = add(fcs.tobytes(), fcs.size, _U32, "SCALAR")
        meshes.append({"primitives": [
            {"attributes": attrs, "indices": idx, "mode": 4}
        ]})

    gltf = {
        "asset": {"version": "2.0", "generator": "mapanything_tpu"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(meshes)))}],
        "nodes": [{"mesh": i} for i in range(len(meshes))],
        "meshes": meshes,
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"byteLength": len(_pad4(buf))}],
    }
    bin_chunk = _pad4(buf)
    json_bytes = _pad4(json.dumps(gltf).encode(), b" ")
    with open(path, "wb") as f:
        total = 12 + 8 + len(json_bytes) + 8 + len(bin_chunk)
        f.write(struct.pack("<4sII", b"glTF", 2, total))
        f.write(struct.pack("<I4s", len(json_bytes), b"JSON"))
        f.write(json_bytes)
        f.write(struct.pack("<I4s", len(bin_chunk), b"BIN\x00"))
        f.write(bin_chunk)
