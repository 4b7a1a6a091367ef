"""The port's COLMAP export (utils/colmap_io.py, demo_colmap.py) against the
JAX package's writers, on the CPU: byte-equal files from the same arrays,
a write and read-back round trip, and the demo's export of `infer`'s
outputs."""

import os

import numpy as np
import pytest
import torch

from mapanything_tpu.data.base_dataset import rotation_matrix_to_quaternion_np
from mapanything_tpu.utils import colmap_io as JC
from mapanything_tpu_torch import demo_colmap
from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.utils import colmap_io as PC
from mapanything_tpu_torch.utils.inference import InferencePipeline

V = 5


def _rotations(rng, n):
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    k = np.tile(np.array([[300.0, 0, 259], [0, 310.0, 200], [0, 0, 1]]),
                (V, 1, 1)) + rng.uniform(-2, 2, (V, 3, 3)) * [[1, 0, 1],
                                                             [0, 1, 1],
                                                             [0, 0, 0]]
    poses = np.tile(np.eye(4), (V, 1, 1))
    poses[:, :3, :3] = _rotations(rng, V)
    poses[:, :3, 3] = rng.standard_normal((V, 3))
    pts = rng.standard_normal((2000, 3)).astype(np.float32)
    cols = rng.random((2000, 3)).astype(np.float32)
    names = [f"view{i}.png" for i in range(V)]
    return k.astype(np.float32), poses.astype(np.float32), pts, cols, names


def test_writers_byte_equal_jax(tmp_path):
    k, poses, pts, cols, names = _scene()
    sizes = [(518, 392)] * V
    PC.export_colmap_reconstruction(str(tmp_path / "port"), k, poses, sizes,
                                    names, pts, cols)
    JC.export_colmap_reconstruction(str(tmp_path / "jax"), k, poses, sizes,
                                    names, pts, cols)
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        port = (tmp_path / "port" / f).read_bytes()
        assert port == (tmp_path / "jax" / f).read_bytes(), f
    # uint8 colors and explicit errors take the same bytes too
    c8 = (cols * 255).astype(np.uint8)
    err = np.linspace(0, 1, len(pts))
    PC.write_points3d_bin(str(tmp_path / "a.bin"), pts, c8, err)
    JC.write_points3d_bin(str(tmp_path / "b.bin"), pts, c8, err)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()


def test_round_trip(tmp_path):
    k, poses, pts, cols, names = _scene(1)
    out = PC.export_colmap_reconstruction(str(tmp_path), k, poses,
                                          [(518, 392)] * V, names, pts, cols)
    cams = PC.read_cameras_bin(os.path.join(out, "cameras.bin"))
    imgs = PC.read_images_bin(os.path.join(out, "images.bin"))
    p, c = PC.read_points3d_bin(os.path.join(out, "points3D.bin"))
    assert [c_["params"] for c_ in cams] == [
        [float(x) for x in (ki[0, 0], ki[1, 1], ki[0, 2], ki[1, 2])]
        for ki in k]
    assert [im["name"] for im in imgs] == names
    for im, pose in zip(imgs, poses):
        rot = PC.quaternion_wxyz_to_matrix_np(im["qvec"])  # world to camera
        np.testing.assert_allclose(rot.T, pose[:3, :3], atol=1e-5)
        np.testing.assert_allclose(-rot.T @ np.asarray(im["tvec"]),
                                   pose[:3, 3], atol=1e-5)
    np.testing.assert_array_equal(p, pts.astype(np.float64))
    np.testing.assert_array_equal(c, (np.clip(cols, 0, 1) * 255).astype(
        np.uint8))
    # the general reader (tracks present) agrees with JAX's
    jp, jc = JC.read_points3d_bin(os.path.join(out, "points3D.bin"))
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(c, jc)


def test_quaternion_helper_equals_jax():
    for rot in _rotations(np.random.default_rng(2), 32):
        np.testing.assert_array_equal(PC.rotation_matrix_to_quaternion_np(rot),
                                      rotation_matrix_to_quaternion_np(rot))


def test_demo_exports_infer_outputs(tmp_path):
    cfg = MapAnythingConfig(dtype=torch.float32, encoder_size="test",
                            trunk_dim=64, trunk_depth=2, trunk_num_heads=2,
                            trunk_indices=(0, 1), dpt_feature_dim=32,
                            dpt_out_channels=(32, 32, 32, 32),
                            dpt_hidden_dims=(16, 8), dense_head_chunk=2)
    # the model's own init (biases 0): the mask logits straddle 0, so
    # some pixels pass the mask
    model = MapAnything(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(3)
    views = [{"img": rng.standard_normal((1, 42, 56, 3)).astype(np.float32),
              "data_norm_type": ["dinov2"], "instance": [f"/x/im{i}.jpg"]}
             for i in range(3)]
    preds = InferencePipeline(model).infer(
        views, memory_efficient_inference=True, apply_confidence_mask=True)
    res = demo_colmap.export_predictions(preds, demo_colmap.view_names(views),
                                         str(tmp_path), max_points=500)
    kept = sum(int(p["mask"].sum()) for p in preds)
    assert res["cameras"] == 3 and res["points"] == min(kept, 500) > 0
    imgs = PC.read_images_bin(os.path.join(res["sparse_dir"], "images.bin"))
    assert [im["name"] for im in imgs] == ["im0.jpg", "im1.jpg", "im2.jpg"]
    for im in imgs:
        rot = PC.quaternion_wxyz_to_matrix_np(im["qvec"])
        np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-6)
    pts, _ = PC.read_points3d_bin(os.path.join(res["sparse_dir"],
                                               "points3D.bin"))
    assert len(pts) == res["points"] and np.isfinite(pts).all()


def test_demo_refuses_bundle_adjustment(tmp_path):
    with pytest.raises(NotImplementedError, match="queue A item 15"):
        demo_colmap.main(["--image_folder", str(tmp_path), "--ba"])
