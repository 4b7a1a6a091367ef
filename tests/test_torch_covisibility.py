"""The port's covisibility, depth-consistency confidence and mesh ray cast
(mapanything_tpu_torch/data/{covisibility,rendering}.py) against the JAX
package's, on the CPU, and against closed-form geometry.

Both packages run in fp32 and differ by rounding: a reprojected pixel can
round to its neighbour and a ray on an edge can flip between triangles, so
nothing here is bitwise; the limits are tests/torch_offline_scenes.py's
(covisibility COVIS_PIXELS / (h w); confidence: at most CONF_SHARE of the
pixels differ; rendered depth RENDER_RTOL where both hit, the hit masks
differing on at most HIT_SHARE; ANALYTIC_RTOL against the closed form).
"""

import numpy as np
import pytest
import torch

import jax

from mapanything_tpu.data import covisibility as JC
from mapanything_tpu.data import rendering as JR
from mapanything_tpu_torch.data import covisibility as PC
from mapanything_tpu_torch.data import rendering as PR

from torch_offline_scenes import (
    ANALYTIC_RTOL,
    CONF_SHARE,
    COVIS_PIXELS,
    assert_render_close,
    room_cameras,
    room_depth,
    room_mesh,
)

H, W = 48, 64
K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
FRAMES = 6


@pytest.fixture(scope="module")
def room():
    """A 12 x 6^2-triangle room, 6 cameras inside (frame k + 3 faces away
    from frame k), their closed-form depth with a band of invalid pixels."""
    verts, faces, _ = room_mesh(cells=6)
    poses = room_cameras(FRAMES)
    depths = np.stack([room_depth(K, p, (H, W)) for p in poses])
    depths = depths.astype(np.float32)
    depths[:, :, :3] = 0  # invalid pixels count in neither package
    Ks = np.tile(K.astype(np.float32), (FRAMES, 1, 1))
    return dict(verts=verts, faces=faces, poses=poses, depths=depths, Ks=Ks)


def jax_call(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return np.asarray(fn(*args, **kw))


@pytest.mark.parametrize("mode,target", [("valid_target_depth", 224),
                                         ("full", 224),
                                         ("valid_target_depth", 40)])
def test_covisibility_matches_jax(room, mode, target):
    args = (room["depths"], room["Ks"], room["poses"].astype(np.float32))
    want = jax_call(JC.compute_pairwise_covisibility, *args,
                    target_size=target, denominator_mode=mode)
    got = PC.compute_pairwise_covisibility(*args, target_size=target,
                                           denominator_mode=mode,
                                           device="cpu")
    h, w = JC._downsample(room["depths"], room["Ks"], target)[0].shape[1:]
    assert got.shape == (FRAMES, FRAMES) and got.dtype == np.float32
    assert np.abs(got - want).max() <= COVIS_PIXELS / (h * w)
    assert want.max() > 0.5  # the limit is not met by two empty matrices


def test_covisibility_known_geometry(room):
    """Each frame covers itself fully; a frame facing away sees nothing of
    the other's points."""
    covis = PC.compute_pairwise_covisibility(
        room["depths"], room["Ks"], room["poses"], device="cpu")
    np.testing.assert_allclose(np.diag(covis), 1.0, atol=1e-6)
    half = FRAMES // 2
    for k in range(FRAMES):
        assert covis[k, (k + half) % FRAMES] == 0.0


@pytest.mark.parametrize("gated", [False, True])
def test_confidence_matches_jax(room, gated):
    rng = np.random.default_rng(4)
    depths = room["depths"] * rng.uniform(
        0.97, 1.03, size=room["depths"].shape).astype(np.float32)
    overlap = (rng.uniform(size=(FRAMES, FRAMES)) > 0.3) if gated else None
    args = (depths, room["Ks"], room["poses"].astype(np.float32))
    want = jax_call(JC.compute_depth_consistency_confidence, *args,
                    target_size=40, overlap=overlap)
    got = PC.compute_depth_consistency_confidence(
        *args, target_size=40, overlap=overlap, device="cpu")
    assert got.shape == want.shape == (FRAMES, 30, 40)
    assert (np.abs(got - want) > 1e-6).mean() <= CONF_SHARE
    assert 0.2 < want.mean() < 0.95  # the noise makes inliers and outliers


def test_device_stages_default_to_the_card(room):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    args = (room["depths"], room["Ks"], room["poses"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PC.compute_pairwise_covisibility(*args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PC.compute_depth_consistency_confidence(*args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PR.render_mesh_depth(room["verts"], room["faces"], K,
                             room["poses"][0], (H, W))


def _render_pair(verts, faces, poses, hw, **kw):
    Ks = np.tile(K, (len(poses), 1, 1))
    want = jax_call(JR.render_scene_depths, verts, faces, Ks, poses, hw,
                    pixel_chunk=1024, tri_chunk=64)
    got = PR.render_scene_depths(verts, faces, Ks, poses, hw, device="cpu",
                                 **kw)
    return want, got


def test_room_render_matches_jax_and_closed_form(room):
    want, got = _render_pair(room["verts"], room["faces"], room["poses"],
                             (H, W))
    assert got.shape == (FRAMES, H, W) and got.dtype == np.float32
    assert_render_close(want, got)
    assert (got > 0).all()  # a closed room: every ray hits a wall
    exact = np.stack([room_depth(K, p, (H, W)) for p in room["poses"]])
    np.testing.assert_allclose(got, exact, rtol=ANALYTIC_RTOL)


def test_render_chunking_is_invisible(room):
    """Ragged pixel and triangle chunks give the default chunking's depth
    (the per-pair arithmetic does not depend on the chunk)."""
    pose = room["poses"][1]
    one = PR.render_mesh_depth(room["verts"], room["faces"], K, pose, (H, W),
                               device="cpu")
    small = PR.render_mesh_depth(room["verts"], room["faces"], K, pose,
                                 (H, W), pixel_chunk=1000, tri_chunk=77,
                                 device="cpu")
    np.testing.assert_allclose(small, one, rtol=1e-6)


def quad(z, span=50.0, x_hi=None):
    x1 = span if x_hi is None else x_hi
    verts = np.array([[-span, -span, z], [x1, -span, z], [x1, span, z],
                      [-span, span, z]], np.float32)
    return verts, np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def tilted_quad():
    n = np.array([0.3, -0.2, 1.0])
    p0 = np.array([0.0, 0.0, 2.0])
    b1 = np.cross(n, [1.0, 0, 0])
    b1 /= np.linalg.norm(b1)
    b2 = np.cross(n, b1)
    b2 /= np.linalg.norm(b2)
    s = 50.0
    verts = np.stack([p0 - s * b1 - s * b2, p0 + s * b1 - s * b2,
                      p0 + s * b1 + s * b2, p0 - s * b1 + s * b2])
    return verts.astype(np.float32), np.array([[0, 1, 2], [0, 2, 3]],
                                              np.int32)


def occluders():
    v1, f1 = quad(3.0)
    v2, f2 = quad(1.5)
    return np.concatenate([v1, v2]), np.concatenate([f1, f2 + 4])


@pytest.mark.parametrize("scene", ["frontal", "tilted", "occluded",
                                   "half_covered", "behind", "empty"])
def test_plane_scenes_match_jax(scene):
    """The JAX package's own rendering scenes (tests/test_rendering.py),
    each through both packages; `empty` has no triangle at all."""
    verts, faces = {
        "frontal": lambda: quad(2.0), "tilted": tilted_quad,
        "occluded": occluders, "half_covered": lambda: quad(2.0, x_hi=0.0),
        "behind": lambda: quad(-2.0),
        "empty": lambda: (np.zeros((3, 3), np.float32),
                          np.zeros((0, 3), np.int32)),
    }[scene]()
    poses = np.stack([np.eye(4), np.eye(4)])
    poses[1, :3, 3] = [0.05, -0.02, -1.0]
    if scene == "empty":  # JAX's scan cannot take zero triangles
        got = PR.render_scene_depths(verts, faces, np.tile(K, (2, 1, 1)),
                                     poses, (24, 32), device="cpu")
        assert (got == 0).all()
        return
    want, got = _render_pair(verts, faces, poses, (24, 32), tri_chunk=1)
    assert_render_close(want, got)
    if scene in ("behind",):
        assert (got == 0).all()
    else:
        assert (got > 0).mean() > 0.4
