"""Multi-frame 2D point tracking by coarse-to-fine NCC, in torch on the
device of its inputs; counterpart of mapanything_tpu/utils/tracking.py.

The tracker stands in for the reference's VGGSfM track predictor (any
tracker may supply the tracks of the COLMAP demo's bundle adjustment):

  * a grayscale pyramid by 2x average pooling;
  * per level, a (K, K) patch around each query in the query frame is
    correlated against a (K + 2R, K + 2R) window around the current
    estimate in the target frame, at every integer shift;
  * argmax, a quadratic subpixel fit, and the estimate carried to the next
    finer level; the visibility score is the finest level's NCC peak.

The points are a tensor dimension and the frames a loop, so the candidate
stack of one frame, (points, (2R + 1)^2, K, K), bounds the memory; no step
returns to the host.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch


def to_gray(images: torch.Tensor) -> torch.Tensor:
    """(..., 3) images in [0, 1] -> (...) luma."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=images.dtype,
                     device=images.device)
    return torch.einsum("...c,c->...", images, w)


def build_pyramid(gray: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """(N, H, W) -> [(N, H/2^l, W/2^l)] for l = 0..levels-1, fine first."""
    pyr = [gray]
    x = gray
    for _ in range(levels - 1):
        n, h, w = x.shape
        x = x[:, :h // 2 * 2, :w // 2 * 2]
        x = x.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
        pyr.append(x)
    return pyr


def _extract_patch(img: torch.Tensor, centers: torch.Tensor,
                   size: int) -> torch.Tensor:
    """(P, size, size) bilinear patches of img (H, W) around centers (P, 2)
    (y, x). The top-left corner of each sample is clamped to the image
    first and the fractions to [0, 1] after, as the JAX package does."""
    h, w = img.shape
    d = torch.arange(size, dtype=torch.float32, device=img.device) \
        - (size - 1) / 2.0
    yy = centers[:, :1] + d  # (P, size)
    xx = centers[:, 1:] + d
    y0 = torch.floor(yy).to(torch.int64).clamp(0, h - 2)
    x0 = torch.floor(xx).to(torch.int64).clamp(0, w - 2)
    fy = (yy - y0).clamp(0.0, 1.0)[:, :, None]
    fx = (xx - x0).clamp(0.0, 1.0)[:, None, :]
    ys, xs = y0[:, :, None], x0[:, None, :]
    p00 = img[ys, xs]
    p01 = img[ys, xs + 1]
    p10 = img[ys + 1, xs]
    p11 = img[ys + 1, xs + 1]
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def _ncc_search(ref_patch: torch.Tensor, win: torch.Tensor, radius: int):
    """NCC of each ref_patch (P, K, K) against every integer shift of its
    window (P, K + 2R, K + 2R). Returns the best (dy, dx) with a subpixel
    fit and the NCC there, each (P,)."""
    p, k = ref_patch.shape[:2]
    n = 2 * radius + 1
    rp = ref_patch - ref_patch.mean(dim=(1, 2), keepdim=True)
    rn = torch.sqrt((rp * rp).sum(dim=(1, 2)) + 1e-8)
    # (P, n*n, K, K), shift (dy, dx) at dy * n + dx
    cands = win.unfold(1, k, 1).unfold(2, k, 1).reshape(p, n * n, k, k)
    cz = cands - cands.mean(dim=(2, 3), keepdim=True)
    cn = torch.sqrt((cz * cz).sum(dim=(2, 3)) + 1e-8)
    ncc = (cz * rp[:, None]).sum(dim=(2, 3)) / (cn * rn[:, None])
    grid = ncc.reshape(p, n, n)
    idx = torch.argmax(ncc, dim=1)  # the first maximum
    iy = (idx // n).clamp(1, n - 2)
    ix = (idx % n).clamp(1, n - 2)
    rows = torch.arange(p, device=win.device)

    def at(dy, dx):
        return grid[rows, iy + dy, ix + dx]

    c = at(0, 0)
    dyp, dym, dxp, dxm = at(1, 0), at(-1, 0), at(0, 1), at(0, -1)
    denom_y = dym - 2 * c + dyp
    denom_x = dxm - 2 * c + dxp
    sub_y = torch.where(denom_y.abs() > 1e-6,
                        0.5 * (dym - dyp) / denom_y, 0.0).clamp(-1.0, 1.0)
    sub_x = torch.where(denom_x.abs() > 1e-6,
                        0.5 * (dxm - dxp) / denom_x, 0.0).clamp(-1.0, 1.0)
    best_dy = iy.to(torch.float32) + sub_y - radius
    best_dx = ix.to(torch.float32) + sub_x - radius
    return best_dy, best_dx, c


@torch.no_grad()
def track_points(images: torch.Tensor, query_yx: torch.Tensor,
                 query_frame: int = 0, patch: int = 11, radius: int = 4,
                 levels: int = 3):
    """Track query points from one frame into every frame.

    Args:
        images: (F, H, W, 3) in [0, 1].
        query_yx: (P, 2) float (y, x) pixels in the query frame.
        query_frame: the frame the queries live in.
        patch: the NCC patch size (odd).
        radius: the search radius of each level, in that level's pixels.
        levels: pyramid levels.

    Returns:
        tracks_yx (F, P, 2) and vis (F, P), the NCC peak in [-1, 1], on the
        device of `images`.
    """
    pyr = build_pyramid(to_gray(images.to(torch.float32)), levels)
    query_yx = query_yx.to(device=images.device, dtype=torch.float32)
    # the query frame's patches do not depend on the target frame
    refs = [_extract_patch(pyr[lvl][query_frame], query_yx / 2 ** lvl, patch)
            for lvl in range(levels)]
    tracks, vis = [], []
    for f in range(images.shape[0]):
        est = query_yx / 2 ** (levels - 1)
        for lvl in range(levels - 1, -1, -1):
            win = _extract_patch(pyr[lvl][f], est, patch + 2 * radius)
            dy, dx, score = _ncc_search(refs[lvl], win, radius)
            est = est + torch.stack([dy, dx], dim=-1)
            if lvl > 0:
                est = est * 2.0
        tracks.append(est)
        vis.append(score)
    return torch.stack(tracks), torch.stack(vis)


@torch.no_grad()
def select_query_points(conf: torch.Tensor, gray: torch.Tensor,
                        num_points: int, border: int = 8, cell: int = 16):
    """Confidence x gradient-magnitude corner selection on a grid: the best
    pixel of each (cell x cell) bucket, the `num_points` best buckets kept.

    Args:
        conf: (H, W) confidence.
        gray: (H, W) luma.

    Returns:
        (n, 2) float (y, x) and their (n,) scores, n = min(num_points,
        buckets), best first.
    """
    h, w = gray.shape
    gy = torch.diff(gray, dim=0, prepend=gray[:1]).abs()
    gx = torch.diff(gray, dim=1, prepend=gray[:, :1]).abs()
    score = conf * (gy + gx)
    inner = torch.zeros((h, w), dtype=torch.bool, device=gray.device)
    inner[border:-border, border:-border] = True
    score = torch.where(inner, score, 0.0)

    gh, gw = h // cell, w // cell
    sc = score[:gh * cell, :gw * cell].reshape(gh, cell, gw, cell)
    sc = sc.permute(0, 2, 1, 3).reshape(gh, gw, cell * cell)
    best_val = sc.amax(dim=-1)
    best = torch.argmax(sc, dim=-1)  # the first maximum, as jnp.argmax
    rows = torch.arange(gh, device=gray.device)[:, None] * cell
    cols = torch.arange(gw, device=gray.device)[None, :] * cell
    ys = (rows + best // cell).reshape(-1)
    xs = (cols + best % cell).reshape(-1)
    vals = best_val.reshape(-1)
    top = torch.argsort(-vals, stable=True)[:num_points]
    pts = torch.stack([ys[top], xs[top]], dim=-1).to(torch.float32)
    return pts, vals[top]


def rank_query_frames(frame_feats, num_frames: int) -> List[int]:
    """Rank frames for multi-query tracking: the most central first (the
    highest total cosine similarity), then farthest-point sampling over the
    distance 100 - similarity, as the reference's DINO frame ranking does.

    Args:
        frame_feats: (F, D) per-frame descriptors (numpy or a tensor).
        num_frames: how many frames to select.

    Returns:
        min(num_frames, F) frame indices.
    """
    if isinstance(frame_feats, torch.Tensor):
        frame_feats = frame_feats.detach().cpu().numpy()
    f = np.asarray(frame_feats, np.float32)
    f = f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-8)
    sim = f @ f.T
    dist = 100.0 - sim
    np.fill_diagonal(sim, -100.0)
    selected = [int(np.argmax(sim.sum(axis=1)))]
    num = min(num_frames, len(f))
    while len(selected) < num:
        d = dist[:, selected].min(axis=1)
        d[selected] = -np.inf
        selected.append(int(np.argmax(d)))
    return selected


@torch.no_grad()
def frame_features_from_encoder(
        encoder_apply: Callable[[torch.Tensor], torch.Tensor],
        images: torch.Tensor, batch: int = 8) -> torch.Tensor:
    """Mean-pooled, L2-normalised encoder patch tokens per frame.

    `encoder_apply` maps (F', H, W, 3) to patch tokens, (F', N, D) or the
    grid (F', gh, gw, D) that DinoViT returns; the frames go through it
    `batch` at a time. Returns (F, D) fp32.
    """
    feats = []
    for i in range(0, images.shape[0], batch):
        tok = encoder_apply(images[i:i + batch])
        tok = tok.reshape(tok.shape[0], -1, tok.shape[-1])
        feats.append(tok.float().mean(dim=1))
    f = torch.cat(feats)
    return f / (torch.linalg.norm(f, dim=-1, keepdim=True) + 1e-8)
