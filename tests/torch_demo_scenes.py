"""Scenes with known geometry for the tracker and the bundle adjustment,
in numpy, without JAX: the CPU parity tests, their `cuda` twins and
chip_smoke.py phase 11d build their inputs here.

`ba_problem` is tests/test_ba.py's construction (random points in a box
seen by perturbed cameras, noisy projections, dropped observations), with
optional outlier observations and any intrinsics. `plane_views` renders a
textured plane from cameras related to the first by plane-induced
homographies (tests/test_ba.py's parallax test), so every pixel has an
exact correspondence.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

INTRINSICS = (300.0, 310.0, 160.0, 120.0)


def _quat(rng, eps):
    a = rng.normal(size=3) * eps
    th = np.linalg.norm(a)
    if th < 1e-9:
        return np.array([0, 0, 0, 1.0], np.float32)
    return np.array([*(a / th * np.sin(th / 2)), np.cos(th / 2)], np.float32)


def quat_mat(q) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def quat_mul(q1, q2) -> np.ndarray:
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], np.float32)


def ba_problem(seed: int, n_f: int = 5, n_p: int = 60, noise_px: float = 0.1,
               perturb: float = 0.02, drop: float = 0.1,
               outliers: Sequence[Tuple[int, int, float]] = (),
               intrinsics: Sequence[float] = INTRINSICS):
    """The arrays of a BAProblem (tracks, track_mask, base_quats,
    base_trans, intrinsics, points) and the true cam-from-world
    quaternions. `outliers`: (frame, point, pixels) added to those
    observations."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n_p, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    fx, fy, cx, cy = intrinsics
    qs, ts, tracks = [], [], []
    for _ in range(n_f):
        q = _quat(rng, 0.1)
        t = rng.normal(size=3).astype(np.float32) * 0.2
        pc = pts @ quat_mat(q).T + t
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                       fy * pc[:, 1] / pc[:, 2] + cy], -1)
        tracks.append(uv + rng.normal(size=uv.shape) * noise_px)
        qs.append(q)
        ts.append(t)
    tracks = np.stack(tracks).astype(np.float32)
    qs0 = np.stack([quat_mul(_quat(rng, perturb), q) for q in qs])
    ts0 = np.stack(ts) + rng.normal(size=(n_f, 3)).astype(
        np.float32) * perturb
    pts0 = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.03
    mask = rng.uniform(size=(n_f, n_p)) > drop
    mask[0] = True
    for f, p, px in outliers:
        tracks[f, p] += px
    arrays = (tracks, mask, qs0.astype(np.float32), ts0.astype(np.float32),
              np.array(intrinsics, np.float32), pts0.astype(np.float32))
    return arrays, np.stack(qs)


def _smooth(x, it):
    for _ in range(it):
        x = (x + np.roll(x, 1, 0) + np.roll(x, -1, 0)
             + np.roll(x, 1, 1) + np.roll(x, -1, 1)) / 5.0
    return x


def _rot(ax, ay, az):
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _bilinear(img, y, x):
    y = np.clip(y, 0, img.shape[0] - 2)
    x = np.clip(x, 0, img.shape[1] - 2)
    y0, x0 = np.floor(y).astype(int), np.floor(x).astype(int)
    fy, fx = y - y0, x - x0
    return (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0 + 1, x0] * fy * (1 - fx)
            + img[y0, x0 + 1] * (1 - fy) * fx + img[y0 + 1, x0 + 1] * fy * fx)


def plane_views(seed: int, n: int, h: int, w: int, focal: float,
                angle: float = 0.01, shift: float = 0.04,
                depth: float = 4.0):
    """(n, h, w, 3) float32 views of a textured plane at `depth` in front of
    view 0, the others moved by seeded rotations (std `angle` rad a
    axis) and translations (std `shift`), and the (n, 3, 3) homographies
    taking view 0's pixels (x, y, 1) to each view's."""
    rng = np.random.default_rng(seed)
    pad = 64
    tex = _smooth(rng.uniform(0, 1, (h + 2 * pad, w + 2 * pad)), 2)
    k = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    normal = np.array([0.0, 0.0, 1.0])
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    pix = np.stack([xx, yy, np.ones_like(xx)], -1)
    frames, homs = [], []
    for i in range(n):
        rot, t = ((np.eye(3), np.zeros(3)) if i == 0 else
                  (_rot(*rng.normal(size=3) * angle),
                   rng.normal(size=3) * shift))
        hom = k @ (rot + np.outer(t, normal) / depth) @ np.linalg.inv(k)
        p = pix @ np.linalg.inv(hom).T
        u, v = p[..., 0] / p[..., 2], p[..., 1] / p[..., 2]
        frames.append(_bilinear(tex, v + pad, u + pad))
        homs.append(hom)
    views = np.stack(frames)[..., None].repeat(3, axis=-1).astype(np.float32)
    return views, np.stack(homs)


def plane_correspondences(homs: np.ndarray, query_yx: np.ndarray):
    """(n, P, 2) (y, x) of view 0's pixels `query_yx` in every view."""
    p = np.stack([query_yx[:, 1], query_yx[:, 0],
                  np.ones(len(query_yx))], -1)
    out = np.einsum("nij,pj->npi", homs, p)
    return np.stack([out[..., 1] / out[..., 2], out[..., 0] / out[..., 2]],
                    -1)


def grid_points(h: int, w: int, n_side: int, margin: int, seed: int = 0):
    """n_side^2 (y, x) points on a jittered grid at least `margin` pixels
    inside the image."""
    rng = np.random.default_rng(seed)
    ys = np.linspace(margin, h - 1 - margin, n_side)
    xs = np.linspace(margin, w - 1 - margin, n_side)
    pts = np.stack(np.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
    return (pts + rng.uniform(-0.5, 0.5, pts.shape)).astype(np.float32)
