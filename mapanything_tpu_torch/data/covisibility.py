"""Pairwise covisibility and the depth-consistency confidence, in torch on
the card; counterpart of mapanything_tpu/data/covisibility.py.

The reference's offline covisibility stage
(data_processing/wai_processing/scripts/covisibility.py:32-140 with
configs/covisibility/covisibility_gt_depth.yaml) and its pseudo-depth
filter (depth_consistency_confidence.py:36-158): every source frame's
depth unprojects to world points, which reproject into every frame and
meet the target's depth by a nearest lookup. Covisibility scores the share
of consistent pixels (the (F, F) matrix the samplers' random walk reads);
the confidence scores each source pixel's inliers over inliers + outliers.

JAX runs one jit, `lax.map` over source frames and `vmap` over targets.
Here a Python loop runs over source frames with the targets batched, which
bounds a step's memory the same way: the (F, h, w, 3) reprojection and a
dozen (F, h, w) masks and maps, about 15 fp32 words a (target, pixel) pair,
so 256 frames at 224 x 149 take ~0.5 GB a step (0.80 GiB at the peak with
the inputs, on an H100; 0.6 s for the 256 x 256 matrix). The arithmetic
is fp32 with TF32 off (`utils/device.py::full_fp32`); JAX's semantics are
kept: the nearest downsample on the host, round-half-to-even then a
clamp, JAX's bounds of each test and its strict comparisons.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import full_fp32, resolve_device

__all__ = ["compute_pairwise_covisibility",
           "compute_depth_consistency_confidence"]

# the reference's association threshold adds -log(0.5) * temp
_LN2 = np.float32(math.log(2.0))


def _downsample(depths: np.ndarray, intrinsics: np.ndarray, target: int):
    """Nearest downsample of (F, H, W) depths to `target` long side, K
    scaled to match; unchanged when already at or below it."""
    f, h, w = depths.shape
    scale = target / max(h, w)
    if scale >= 1.0:
        return depths, intrinsics
    nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    ri = np.clip((np.arange(nh) + 0.5) * h / nh, 0, h - 1).astype(np.int64)
    ci = np.clip((np.arange(nw) + 0.5) * w / nw, 0, w - 1).astype(np.int64)
    d = depths[:, ri][:, :, ci]
    K = intrinsics.copy().astype(np.float32)
    K[:, 0, :] *= nw / w
    K[:, 1, :] *= nh / h
    return d, K


def _unproject_world(depths, intrinsics, cam2world):
    """(F, h, w, 3) world points from z-depth, K and cam2world."""
    f, h, w = depths.shape
    dev = depths.device
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    fx = intrinsics[:, 0, 0][:, None, None]
    fy = intrinsics[:, 1, 1][:, None, None]
    cx = intrinsics[:, 0, 2][:, None, None]
    cy = intrinsics[:, 1, 2][:, None, None]
    x_c = (gx[None] - cx) * depths / fx
    y_c = (gy[None] - cy) * depths / fy
    pts_cam = torch.stack([x_c, y_c, depths], dim=-1)
    return (torch.einsum("fij,fhwj->fhwi", cam2world[:, :3, :3], pts_cam)
            + cam2world[:, :3, 3][:, None, None, :])


def _to_targets(world_i, w2c):
    """One source's world points (h, w, 3) in every target's camera frame:
    (F, h, w, 3)."""
    return (torch.einsum("fij,hwj->fhwi", w2c[:, :3, :3], world_i)
            + w2c[:, :3, 3][:, None, None, :])


def _lookup(depths, u, v):
    """Nearest target depth at (u, v) of each (target, pixel): round half
    to even, then clamp into the image (JAX's `jnp.round` + `clip`)."""
    f, h, w = depths.shape
    ui = torch.round(u).to(torch.int64).clamp(0, w - 1)
    vi = torch.round(v).to(torch.int64).clamp(0, h - 1)
    flat = (vi * w + ui).reshape(f, -1)
    return depths.reshape(f, -1).gather(1, flat).reshape(u.shape)


def _inputs(depths, intrinsics, cam2world, target_size, device):
    d, K = _downsample(np.asarray(depths, np.float32),
                       np.asarray(intrinsics, np.float32), target_size)
    c2w = np.asarray(cam2world, np.float32)
    return (torch.from_numpy(np.ascontiguousarray(d)).to(device),
            torch.from_numpy(np.ascontiguousarray(K)).to(device),
            torch.from_numpy(np.ascontiguousarray(c2w)).to(device))


def compute_pairwise_covisibility(
    depths: np.ndarray,
    intrinsics: np.ndarray,
    cam2world: np.ndarray,
    target_size: int = 224,
    depth_assoc_error_thres: float = 0.1,
    depth_assoc_error_temp: float = 0.1,
    depth_assoc_rel_error_thres: float = 0.005,
    denominator_mode: str = "valid_target_depth",
    device=None,
) -> np.ndarray:
    """Pairwise covisibility (F, F) in [0, 1], row = source, column =
    target.

    Args:
        depths: (F, H, W) z-depth, 0 = invalid.
        intrinsics: (F, 3, 3) pinhole K.
        cam2world: (F, 4, 4) OpenCV cam2world poses.
        target_size: depths are nearest-downsampled to this long side first
            (covisibility_gt_depth.yaml:16).
        denominator_mode: "valid_target_depth" | "full"
            (covisibility.py:117-131).
        device: where the scores are computed; the card when None.
    """
    if denominator_mode not in ("valid_target_depth", "full"):
        raise ValueError(f"unknown denominator_mode {denominator_mode!r}")
    device = resolve_device(device)
    d, K, c2w = _inputs(depths, intrinsics, cam2world, target_size, device)
    f, h, w = d.shape
    thres = float(np.float32(depth_assoc_error_thres))
    rel = float(np.float32(depth_assoc_rel_error_thres))
    temp_term = float(_LN2 * np.float32(depth_assoc_error_temp))
    fx, fy = K[:, 0, 0][:, None, None], K[:, 1, 1][:, None, None]
    cx, cy = K[:, 0, 2][:, None, None], K[:, 1, 2][:, None, None]
    out = torch.empty((f, f), dtype=torch.float32, device=device)
    with full_fp32():
        w2c = torch.linalg.inv(c2w)
        world = _unproject_world(d, K, c2w)
        valid_depth = d > 0
        n_valid = valid_depth.sum(dim=(1, 2)).clamp_min(1).float()
        for i in range(f):
            pc = _to_targets(world[i], w2c)
            zt = pc[..., 2]
            zs = zt.clamp_min(1e-6)
            u = fx * pc[..., 0] / zs + cx
            v = fy * pc[..., 1] / zs + cy
            in_img = (u >= -0.5) & (u <= w - 0.5) & (v >= -0.5) \
                & (v <= h - 0.5)
            valid = valid_depth[i] & (zt > 0) & in_img
            depth_lu = _lookup(d, u, v)
            err = (zt - depth_lu).abs()
            assoc = thres + rel * zt + temp_term
            ok = valid & (err < assoc) & (depth_lu > 0)
            count = ok.sum(dim=(1, 2)).float()
            if denominator_mode == "valid_target_depth":
                out[i] = (count / n_valid).clamp(0.0, 1.0)
            else:
                out[i] = count / (h * w)
    return out.cpu().numpy()


def compute_depth_consistency_confidence(
    depths: np.ndarray,
    intrinsics: np.ndarray,
    cam2world: np.ndarray,
    target_size: int = 360,
    depth_assoc_error_thres: float = 0.02,
    depth_assoc_rel_error_thres: float = 0.02,
    overlap: "np.ndarray | None" = None,
    device=None,
) -> np.ndarray:
    """Per-pixel depth-consistency confidence in [0, 1] for every frame.

    Each frame's depth unprojects to world points, reprojects into every
    frame, and each pixel scores inliers / (inliers + outliers) of the
    association test err < abs + rel * expected
    (depth_consistency_confidence_mvsa.yaml defaults).

    Args:
        depths: (F, H, W) z-depth, 0 = invalid.
        intrinsics: (F, 3, 3); cam2world: (F, 4, 4) OpenCV.
        target_size: long-side working resolution (yaml: 360).
        overlap: optional (F, F) bool gate, the reference's frustum
            intersection check; None tests every pair (self included, as
            the reference's ungated ov_inds).
        device: where the maps are computed; the card when None.

    Returns:
        (F, h, w) confidence maps at the working resolution.
    """
    device = resolve_device(device)
    d, K, c2w = _inputs(depths, intrinsics, cam2world, target_size, device)
    f, h, w = d.shape
    ov = (torch.ones((f, f), dtype=torch.bool, device=device)
          if overlap is None
          else torch.from_numpy(np.asarray(overlap, bool)).to(device))
    abs_t = float(np.float32(depth_assoc_error_thres))
    rel = float(np.float32(depth_assoc_rel_error_thres))
    fx, fy = K[:, 0, 0][:, None, None], K[:, 1, 1][:, None, None]
    cx, cy = K[:, 0, 2][:, None, None], K[:, 1, 2][:, None, None]
    out = torch.empty((f, h, w), dtype=torch.float32, device=device)
    with full_fp32():
        w2c = torch.linalg.inv(c2w)
        world = _unproject_world(d, K, c2w)
        valid_depth = d > 0
        for i in range(f):
            pc = _to_targets(world[i], w2c)
            zt = pc[..., 2]
            zsafe = torch.where(zt > 0.04, zt, torch.ones_like(zt))
            u = fx * pc[..., 0] / zsafe + cx
            v = fy * pc[..., 1] / zsafe + cy
            # the reference's in_image (m_ops.py: coords >= 0 and strictly
            # < size, z > 0.04), gated by the source's valid depth
            valid = (valid_depth[i] & (zt > 0.04)
                     & (u >= 0) & (v >= 0) & (u < w) & (v < h)
                     & ov[i][:, None, None])
            err = (zt - _lookup(d, u, v)).abs()
            thr = abs_t + rel * zt
            # strict < and >: a projection onto an invalid (0-depth) target
            # pixel reads err == zt > thr and counts as an outlier, as in
            # the reference (its valid mask never checks the target depth)
            ni = (valid & (err < thr)).sum(dim=0).float()
            no = (valid & (err > thr)).sum(dim=0).float()
            out[i] = ni / (ni + no + 1e-10)
    return out.cpu().numpy()
