"""The port's NCC tracker (utils/tracking.py) against the JAX package's, on
the CPU, on smooth seeded textures shifted by fractional amounts, with
query points up to and past the image border.

Tolerances: tracks within 1e-4 px and NCC scores within 1e-5 (fp32, the
sums taken in another order); the query points, their scores and the
ranked frames are equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu.utils import tracking as JT
from mapanything_tpu_torch.utils import tracking as PT

H, W = 72, 96


def _smooth(x, it=3):
    for _ in range(it):
        x = (x + np.roll(x, 1, 0) + np.roll(x, -1, 0)
             + np.roll(x, 1, 1) + np.roll(x, -1, 1)) / 5.0
    return x


def _frames(seed, shifts, h=H, w=W):
    """(F, h, w, 3) frames of one smooth texture, frame f shifted by
    shifts[f] = (dy, dx) pixels with bilinear sampling."""
    rng = np.random.default_rng(seed)
    base = _smooth(rng.uniform(0, 1, (h + 16, w + 16)).astype(np.float32))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for dy, dx in shifts:
        y, x = yy + dy + 8.0, xx + dx + 8.0
        y0, x0 = np.floor(y).astype(int), np.floor(x).astype(int)
        fy, fx = y - y0, x - x0
        out.append(base[y0, x0] * (1 - fy) * (1 - fx)
                   + base[y0 + 1, x0] * fy * (1 - fx)
                   + base[y0, x0 + 1] * (1 - fy) * fx
                   + base[y0 + 1, x0 + 1] * fy * fx)
    return np.stack(out)[..., None].repeat(3, axis=-1).astype(np.float32)


SHIFTS = [(0.0, 0.0), (0.3, -0.7), (1.6, 2.4), (-2.5, 0.5), (3.2, -3.9)]
# interior points, points within 8 px of each border, and on / past it
QUERIES = np.array([[36.0, 48.0], [20.5, 70.25], [50.0, 25.0], [3.0, 40.0],
                    [68.5, 60.0], [30.0, 2.5], [40.0, 93.0], [0.0, 0.0],
                    [71.0, 95.0], [-2.0, 50.0], [35.0, 99.0], [7.9, 88.1]],
                   np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_gray_and_pyramid():
    frames = _frames(0, SHIFTS[:2])
    gray = PT.to_gray(_t(frames))
    np.testing.assert_allclose(gray.numpy(), np.asarray(JT.to_gray(
        jnp.asarray(frames))), rtol=0, atol=1e-6)
    for ours, ref in zip(PT.build_pyramid(gray, 3),
                         JT.build_pyramid(jnp.asarray(gray.numpy()), 3)):
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("size", [11, 19])
def test_extract_patch(size):
    img = _frames(1, [(0.0, 0.0)])[0, ..., 0]
    ours = PT._extract_patch(_t(img), _t(QUERIES), size)
    ref = jax.vmap(lambda c: JT._extract_patch(jnp.asarray(img), c, size))(
        jnp.asarray(QUERIES))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_ncc_search():
    frames = _frames(2, [(0.0, 0.0), (1.3, -2.6)])
    gray = frames[..., 0]
    ref_patch = PT._extract_patch(_t(gray[0]), _t(QUERIES), 11)
    win = PT._extract_patch(_t(gray[1]), _t(QUERIES), 19)
    dy, dx, score = PT._ncc_search(ref_patch, win, 4)
    jdy, jdx, jscore = jax.vmap(lambda r, w: JT._ncc_search(r, w, 4))(
        jnp.asarray(ref_patch.numpy()), jnp.asarray(win.numpy()))
    np.testing.assert_allclose(dy.numpy(), np.asarray(jdy), atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-4)
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), atol=1e-5)


@pytest.mark.parametrize("query_frame,levels", [(0, 2), (2, 3)])
def test_track_points(query_frame, levels):
    frames = _frames(3, SHIFTS)
    tracks, vis = PT.track_points(_t(frames), _t(QUERIES),
                                  query_frame=query_frame, levels=levels)
    jt, jv = JT.track_points(jnp.asarray(frames), jnp.asarray(QUERIES),
                             query_frame=query_frame, levels=levels)
    assert tracks.shape == (len(SHIFTS), len(QUERIES), 2)
    np.testing.assert_allclose(tracks.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(vis.numpy(), np.asarray(jv), atol=1e-5)
    # the interior queries land on the shifted texture
    q0 = np.array(SHIFTS[query_frame])
    for f, shift in enumerate(SHIFTS):
        want = QUERIES[:3] + q0 - np.array(shift)
        assert np.abs(tracks[f, :3].numpy() - want).max() < 0.5


def test_select_query_points():
    rng = np.random.default_rng(4)
    gray = _frames(4, [(0.0, 0.0)])[0, ..., 0]
    conf = rng.uniform(0.5, 2.0, gray.shape).astype(np.float32)
    conf[:, :40] = 1.0  # ties inside the cells
    for num, border, cell in ((12, 8, 16), (40, 4, 8), (500, 8, 16)):
        pts, vals = PT.select_query_points(_t(conf), _t(gray), num, border,
                                           cell)
        jp, jv = JT.select_query_points(jnp.asarray(conf), jnp.asarray(gray),
                                        num, border, cell)
        np.testing.assert_array_equal(pts.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_rank_query_frames_and_features():
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((9, 16)).astype(np.float32)
    for num in (1, 3, 9, 12):
        assert (PT.rank_query_frames(_t(feats), num)
                == JT.rank_query_frames(jnp.asarray(feats), num))

    tokens = rng.standard_normal((7, 3, 4, 6)).astype(np.float32)
    images = np.arange(7, dtype=np.float32)[:, None, None, None] * np.ones(
        (7, 8, 8, 3), np.float32)

    def encoder(x):  # the frame index picks its grid of tokens
        return x[:, 0, 0, 0].long()

    ours = PT.frame_features_from_encoder(
        lambda x: _t(tokens)[encoder(x)], _t(images), batch=3)
    ref = JT.frame_features_from_encoder(
        lambda x: jnp.asarray(tokens)[np.asarray(x[:, 0, 0, 0]).astype(int)],
        jnp.asarray(images), batch=3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
    assert PT.rank_query_frames(ours, 4) == JT.rank_query_frames(ref, 4)
