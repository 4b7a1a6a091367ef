"""Camera undistortion: OPENCV and OPENCV_FISHEYE -> PINHOLE; the port's
copy of mapanything_tpu/data/undistort.py (numpy, host side).

The WAI preprocessing stage that turns distorted captures into the
pinhole frames every dataset reader assumes (reference
data_processing/wai_processing/scripts/undistort.py:27-264, which wraps
cv2; rebuilt from the distortion models themselves: closed-form forward
distortion for map generation, Newton/fixed-point inverses for point
undistortion, a vectorized numpy remap). No cv2: the card's machine has
none; the tests hold the maps and the resampling against cv2 where it
imports.

Models:
- OPENCV: radial k1,k2,k3 + tangential p1,p2
  (x_d = x(1+k1 r^2+k2 r^4+k3 r^6) + 2 p1 x y + p2 (r^2+2x^2), ...)
- OPENCV_FISHEYE: equidistant theta_d = theta (1 + k1 t^2 + k2 t^4 +
  k3 t^6 + k4 t^8)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

DISTORTION_PARAM_KEYS = ("k1", "k2", "k3", "k4", "p1", "p2")


# ---------------------------------------------------------------------------
# Forward distortion (normalized camera coords -> distorted normalized)


def distort_opencv(xy: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """dist = [k1, k2, p1, p2, k3] (the cv2 ordering)."""
    k1, k2, p1, p2, k3 = (float(d) for d in dist[:5])
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def distort_fisheye(xy: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """dist = [k1, k2, k3, k4] (equidistant polynomial)."""
    k1, k2, k3, k4 = (float(d) for d in dist[:4])
    x, y = xy[..., 0], xy[..., 1]
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = np.where(r > 1e-12, theta_d / np.maximum(r, 1e-12), 1.0)
    return xy * scale[..., None]


def _distort(xy, dist, model):
    if model == "OPENCV":
        return distort_opencv(xy, dist)
    if model == "OPENCV_FISHEYE":
        return distort_fisheye(xy, dist)
    raise NotImplementedError(f"camera model {model!r}")


# ---------------------------------------------------------------------------
# Inverse distortion (distorted normalized -> undistorted normalized)


def undistort_points_normalized(
    xyd: np.ndarray, dist: np.ndarray, model: str, iters: int = 20
) -> np.ndarray:
    if model == "OPENCV":
        # cv2-style fixed point: x = (xd - tangential(x)) / radial(x)
        k1, k2, p1, p2, k3 = (float(d) for d in dist[:5])
        xd, yd = xyd[..., 0], xyd[..., 1]
        x, y = xd.copy(), yd.copy()
        for _ in range(iters):
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            x = (xd - dx) / radial
            y = (yd - dy) / radial
        return np.stack([x, y], axis=-1)
    if model == "OPENCV_FISHEYE":
        # scalar Newton on theta: g(t) = t (1 + k1 t^2 + ...) - theta_d,
        # g'(t) = 1 + 3 k1 t^2 + 5 k2 t^4 + 7 k3 t^6 + 9 k4 t^8
        k1, k2, k3, k4 = (float(d) for d in dist[:4])
        rd = np.linalg.norm(xyd, axis=-1)
        theta = rd.copy()  # good init for mild distortion
        for _ in range(iters):
            t2 = theta * theta
            poly = 1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
            dg = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3
                                                         + t2 * 9 * k4)))
            g = theta * poly - rd
            # outside the model's monotonic range g' can go negative;
            # clamp magnitude only, keep the sign
            dg = np.where(np.abs(dg) > 1e-9, dg, np.where(dg < 0, -1e-9,
                                                          1e-9))
            theta = theta - g / dg
        r = np.tan(theta)
        scale = np.where(rd > 1e-12, r / np.maximum(rd, 1e-12), 1.0)
        return xyd * scale[..., None]
    raise NotImplementedError(f"camera model {model!r}")


# ---------------------------------------------------------------------------
# New pinhole intrinsics


def _border_ring(width: int, height: int, n: int = 64) -> np.ndarray:
    """(4n, 2) pixel coords tracing the image border."""
    xs = np.linspace(0, width - 1, n)
    ys = np.linspace(0, height - 1, n)
    top = np.stack([xs, np.zeros(n)], -1)
    bot = np.stack([xs, np.full(n, height - 1.0)], -1)
    left = np.stack([np.zeros(n), ys], -1)
    right = np.stack([np.full(n, width - 1.0), ys], -1)
    return np.concatenate([top, bot, left, right])


def estimate_new_intrinsics(
    K: np.ndarray,
    dist: np.ndarray,
    model: str,
    size: Tuple[int, int],
    balance: float = 0.0,
    center_principal_point: bool = True,
) -> np.ndarray:
    """New pinhole K for the undistorted image (the role of cv2's
    estimateNewCameraMatrixForUndistortRectify / getOptimalNewCameraMatrix
    — same contract, own algorithm): undistort the border ring, then pick
    the focal between the inscribed box (balance=0: every output pixel is
    backed by source content) and the circumscribed box (balance=1: every
    source pixel survives)."""
    w, h = size
    ring = _border_ring(w, h)
    xyd = (ring - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
    xyu = undistort_points_normalized(xyd, dist, model)

    # circumscribed: full extent of the undistorted border
    x_min, y_min = xyu.min(0)
    x_max, y_max = xyu.max(0)
    # inscribed: tightest border excursion toward the center per side
    top, bot, left, right = np.split(xyu, 4)
    in_x_min = left[:, 0].max()
    in_x_max = right[:, 0].min()
    in_y_min = top[:, 1].max()
    in_y_max = bot[:, 1].min()

    if center_principal_point:
        # with cx = w/2, output x spans [-(w/2)/f, (w/2-1)/f]; each box
        # side constrains f through its own half-extent
        def half(extent, span):
            return span / max(extent, 1e-9)

        f_in = max(half(-in_x_min, w / 2), half(in_x_max, w / 2 - 1),
                   half(-in_y_min, h / 2), half(in_y_max, h / 2 - 1))
        f_out = min(half(-x_min, w / 2), half(x_max, w / 2 - 1),
                    half(-y_min, h / 2), half(y_max, h / 2 - 1))
        f = f_in * (1 - balance) + f_out * balance
        return np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])

    def focal(x0, x1, y0, y1, rule):
        fx = (w - 1) / max(x1 - x0, 1e-9)
        fy = (h - 1) / max(y1 - y0, 1e-9)
        return rule(fx, fy)

    # balance=0: output must fit INSIDE the inscribed box on BOTH axes ->
    # the tighter (max) focal; balance=1: output must CONTAIN the
    # circumscribed box -> the looser (min) focal. The principal point
    # follows the matching box midpoint (they differ under asymmetric
    # distortion), blended by balance.
    f_in = focal(in_x_min, in_x_max, in_y_min, in_y_max, max)
    f_out = focal(x_min, x_max, y_min, y_max, min)
    f = f_in * (1 - balance) + f_out * balance
    mx = (1 - balance) * 0.5 * (in_x_min + in_x_max) \
        + balance * 0.5 * (x_min + x_max)
    my = (1 - balance) * 0.5 * (in_y_min + in_y_max) \
        + balance * 0.5 * (y_min + y_max)
    cx = -mx * f + (w - 1) / 2
    cy = -my * f + (h - 1) / 2
    return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])


# ---------------------------------------------------------------------------
# Rectify maps + remap


def undistort_rectify_maps(
    K: np.ndarray,
    dist: np.ndarray,
    model: str,
    size: Tuple[int, int],
    new_K: Optional[np.ndarray] = None,
    new_size: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(map_x, map_y), each (new_h, new_w) float32: for every output
    (undistorted) pixel, the source (distorted) pixel to sample — the
    forward distortion model evaluated on the output grid (closed form;
    no iteration, same construction as cv2.initUndistortRectifyMap)."""
    w, h = size
    nw, nh = new_size if new_size is not None else (w, h)
    if new_K is None:
        new_K = K
    u, v = np.meshgrid(np.arange(nw, dtype=np.float64),
                       np.arange(nh, dtype=np.float64))
    xy = np.stack([(u - new_K[0, 2]) / new_K[0, 0],
                   (v - new_K[1, 2]) / new_K[1, 1]], axis=-1)
    xyd = _distort(xy, np.asarray(dist, np.float64), model)
    map_x = (xyd[..., 0] * K[0, 0] + K[0, 2]).astype(np.float32)
    map_y = (xyd[..., 1] * K[1, 1] + K[1, 2]).astype(np.float32)
    return map_x, map_y


def _reflect101(idx: np.ndarray, size: int) -> np.ndarray:
    """OpenCV BORDER_REFLECT_101 index folding (edge pixel not doubled)."""
    if size == 1:
        return np.zeros_like(idx)
    period = 2 * (size - 1)
    idx = np.abs(idx) % period
    return np.where(idx >= size, period - idx, idx)


def remap(
    image: np.ndarray,
    map_x: np.ndarray,
    map_y: np.ndarray,
    interpolation: str = "linear",
    border: str = "constant",
    border_value: float = 0.0,
) -> np.ndarray:
    """Sample `image` at (map_y, map_x) per output pixel (cv2.remap's
    contract): bilinear or nearest, constant or reflect-101 borders."""
    h, w = image.shape[:2]
    if image.dtype == np.bool_:
        # np.iinfo(bool) raises in the integer round/clip path; resample
        # as uint8 {0,255} and re-threshold (cv2.remap rejects bool too)
        out = remap(image.astype(np.uint8) * 255, map_x, map_y,
                    interpolation, border, border_value=255.0
                    if border_value else 0.0)
        return out >= 128
    chan = image.ndim == 3
    img = image if chan else image[..., None]

    if interpolation == "nearest":
        xi = np.round(map_x).astype(np.int64)
        yi = np.round(map_y).astype(np.int64)
        if border == "reflect101":
            xi, yi = _reflect101(xi, w), _reflect101(yi, h)
            out = img[yi, xi]
        else:
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            out = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
            out = np.where(inside[..., None], out,
                           np.asarray(border_value, img.dtype))
        return out if chan else out[..., 0]

    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    fx = (map_x - x0)[..., None]
    fy = (map_y - y0)[..., None]

    def tap(yy, xx):
        if border == "reflect101":
            return img[_reflect101(yy, h), _reflect101(xx, w)].astype(
                np.float64)
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        vals = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(
            np.float64)
        return np.where(inside[..., None], vals, float(border_value))

    out = (tap(y0, x0) * (1 - fy) * (1 - fx)
           + tap(y0, x0 + 1) * (1 - fy) * fx
           + tap(y0 + 1, x0) * fy * (1 - fx)
           + tap(y0 + 1, x0 + 1) * fy * fx)
    out = out.astype(image.dtype if np.issubdtype(image.dtype, np.floating)
                     else np.float64)
    if not np.issubdtype(image.dtype, np.floating):
        out = np.clip(np.round(out), np.iinfo(image.dtype).min,
                      np.iinfo(image.dtype).max).astype(image.dtype)
    return out if chan else out[..., 0]


# ---------------------------------------------------------------------------
# The stage recipe (per-frame)


def undistort_frame(
    modalities: Dict[str, np.ndarray],
    cam_meta: Dict,
    balance: float = 0.0,
    center_principal_point: bool = True,
) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Undistort a frame's modalities and rewrite its camera meta to
    PINHOLE (the reference's undistort_scene inner loop, undistort.py
    :150-264): images resample bilinear/reflect-101, depth nearest with
    -1 fill, masks linear-then-threshold with 255 fill. Returns
    (new modalities, pinhole cam meta)."""
    # the reference WAI format spells focals fl_x/fl_y (camera.py:19);
    # this repo's writers use fx/fy — accept either, emit both below
    def _focal(meta, *keys):
        for k in keys:
            if k in meta:
                return float(meta[k])
        raise KeyError(f"camera meta missing {keys[0]!r} (or alias)")

    K = np.array([[_focal(cam_meta, "fl_x", "fx"), 0, cam_meta["cx"]],
                  [0, _focal(cam_meta, "fl_y", "fy"), cam_meta["cy"]],
                  [0, 0, 1.0]])
    w, h = int(cam_meta["w"]), int(cam_meta["h"])
    model = cam_meta["camera_model"]
    if model == "OPENCV_FISHEYE":
        dist = np.array([cam_meta.get(k, 0.0)
                         for k in ("k1", "k2", "k3", "k4")])
    elif model == "OPENCV":
        dist = np.array([cam_meta.get(k, 0.0)
                         for k in ("k1", "k2", "p1", "p2", "k3")])
    else:
        raise NotImplementedError(f"camera model {model!r}")

    new_K = estimate_new_intrinsics(
        K, dist, model, (w, h), balance=balance,
        center_principal_point=center_principal_point)
    map_x, map_y = undistort_rectify_maps(K, dist, model, (w, h), new_K)

    out = {}
    for name, data in modalities.items():
        if "mask" in name:
            u8 = (np.asarray(data).astype(np.uint8) * 255
                  if data.dtype == bool else np.asarray(data, np.uint8))
            # 255 border fill + <255 -> 0 threshold is the reference's
            # exact recipe (undistort.py:214-216). At the default
            # balance=0 every output pixel is backed by source content
            # (estimate_new_intrinsics inscribed-box focal), so the fill
            # is unreachable; at balance>0 unbacked corners inherit the
            # reference's valid-fill semantics.
            r = remap(u8, map_x, map_y, "linear", "constant", 255.0)
            r = np.where(r < 255, 0, 255).astype(np.uint8)
            out[name] = r if data.dtype != bool else r > 0
        elif "depth" in name:
            out[name] = remap(np.asarray(data, np.float32), map_x, map_y,
                              "nearest", "constant", -1.0)
        else:
            out[name] = remap(data, map_x, map_y, "linear", "reflect101")

    new_meta = dict(cam_meta)
    new_meta.update(
        w=w, h=h,
        fl_x=float(new_K[0, 0]), fl_y=float(new_K[1, 1]),
        fx=float(new_K[0, 0]), fy=float(new_K[1, 1]),
        cx=float(new_K[0, 2]), cy=float(new_K[1, 2]),
        camera_model="PINHOLE",
    )
    for k in DISTORTION_PARAM_KEYS:
        new_meta.pop(k, None)
    return out, new_meta
