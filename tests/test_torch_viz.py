"""The port's GLB writers (utils/viz.py) against the JAX package's: the same
bytes from the same arrays, and the same refusal of an empty cloud."""

import json
import struct

import numpy as np
import pytest

from mapanything_tpu.utils import viz as JV
from mapanything_tpu_torch.utils import viz as PV


def _cloud(seed, n=500, uint8=False):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    cols = (rng.integers(0, 256, (n, 3), dtype=np.uint8) if uint8
            else rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32))
    return pts, cols


def _cameras(seed, v=3):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4), (v, 1, 1))
    q, _ = np.linalg.qr(rng.standard_normal((v, 3, 3)))
    poses[:, :3, :3] = q
    poses[:, :3, 3] = rng.standard_normal((v, 3))
    ks = np.tile(np.array([[300.0, 0, 259], [0, 310.0, 196], [0, 0, 1]]),
                 (v, 1, 1))
    return poses.astype(np.float32), ks.astype(np.float32)


def _glb_json(path):
    raw = open(path, "rb").read()
    magic, version, total = struct.unpack("<4sII", raw[:12])
    length, kind = struct.unpack("<I4s", raw[12:20])
    assert (magic, version, total, kind) == (b"glTF", 2, len(raw), b"JSON")
    return json.loads(raw[20:20 + length])


@pytest.mark.parametrize("uint8", [False, True])
def test_pointcloud_bytes_equal_jax(tmp_path, uint8):
    pts, cols = _cloud(0, uint8=uint8)
    PV.write_glb_pointcloud(str(tmp_path / "p.glb"), pts, cols)
    JV.write_glb_pointcloud(str(tmp_path / "j.glb"), pts, cols)
    assert (tmp_path / "p.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()
    assert _glb_json(tmp_path / "p.glb")["accessors"][0]["count"] == len(pts)


def test_predictions_to_glb_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    preds = [{"pts3d": rng.standard_normal((1, 12, 16, 3)).astype(np.float32),
              "img_no_norm": rng.random((1, 12, 16, 3)).astype(np.float32),
              "mask": rng.random((1, 12, 16, 1)) > 0.3} for _ in range(3)]
    n = PV.predictions_to_glb(str(tmp_path / "p.glb"), preds, max_points=300)
    m = JV.predictions_to_glb(str(tmp_path / "j.glb"), preds, max_points=300)
    assert n == m == 300
    assert (tmp_path / "p.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()


@pytest.mark.parametrize("n", [400, 0])
def test_scene_bytes_equal_jax(tmp_path, n):
    pts, cols = _cloud(2, n=n)
    poses, ks = _cameras(3)
    PV.write_glb_scene(str(tmp_path / "p.glb"), pts, cols, poses, ks,
                       (518, 392))
    JV.write_glb_scene(str(tmp_path / "j.glb"), pts, cols, poses, ks,
                       (518, 392))
    assert (tmp_path / "p.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()
    gltf = _glb_json(tmp_path / "p.glb")
    assert gltf["accessors"][0]["count"] == n
    assert gltf["accessors"][2]["count"] == 3 * 8 * 2  # 8 segments a camera
    np.testing.assert_array_equal(
        PV._frustum_segments(poses[0], ks[0], (518, 392), 0.5),
        JV._frustum_segments(poses[0], ks[0], (518, 392), 0.5))


def test_empty_cloud_raises_as_jax(tmp_path):
    empty = np.zeros((0, 3), np.float32)
    for writer in (PV.write_glb_pointcloud, JV.write_glb_pointcloud):
        with pytest.raises(ValueError, match="no points to export"):
            writer(str(tmp_path / "e.glb"), empty, empty)
