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


def test_demo_runs_bundle_adjustment(tmp_path):
    """--ba from frame 0 alone (no ranking): sparse_ba holds every view and
    the tracked points."""
    import PIL.Image

    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(6)
    for i in range(2):
        PIL.Image.fromarray(rng.integers(0, 255, (100, 310, 3),
                                         dtype=np.uint8)).save(
            folder / f"im{i}.png")
    assert demo_colmap.main(["--image_folder", str(folder), "--output_dir",
                             str(tmp_path / "out"), "--tiny", "--device",
                             "cpu", "--ba", "--num_query_frames", "1",
                             "--max_query_pts", "40", "--ba_iters", "2"]) == 0
    sparse = tmp_path / "out" / "sparse_ba"
    imgs = PC.read_images_bin(str(sparse / "images.bin"))
    assert [im["name"] for im in imgs] == ["im0.png", "im1.png"]
    pts, _ = PC.read_points3d_bin(str(sparse / "points3D.bin"))
    assert len(pts) == 40 and np.isfinite(pts).all()


def test_demo_runs_the_saved_checkpoint(tmp_path):
    """--checkpoint runs the saved model: the CLI's export is byte for byte
    the export of that model loaded and called directly, and not the
    export of the seeded random weights the demo runs without it."""
    import PIL.Image

    from mapanything_tpu_torch.data.image import load_images
    from mapanything_tpu_torch.models.pretrained import from_pretrained
    from mapanything_tpu_torch.train import save_params

    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(5)
    for i in range(2):  # 310 x 100: the smallest bucket, 518 x 168
        PIL.Image.fromarray(rng.integers(0, 255, (100, 310, 3),
                                         dtype=np.uint8)).save(
            folder / f"im{i}.png")
    model = MapAnything(MapAnythingConfig(**demo_colmap.TINY_CONFIG),
                        device="cpu",
                        generator=torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "params.pt")
    save_params(ckpt, model)
    args = ["--image_folder", str(folder), "--tiny", "--device", "cpu"]
    assert demo_colmap.main(args + ["--output_dir", str(tmp_path / "cli"),
                                    "--checkpoint", ckpt]) == 0

    loaded = from_pretrained(ckpt, torch.bfloat16, demo_colmap.TINY_CONFIG,
                             "cpu")
    for (name, got), want in zip(loaded.state_dict().items(),
                                 model.state_dict().values()):
        assert torch.equal(got, want), name
    views = load_images(str(folder))
    preds = InferencePipeline(loaded).infer(
        views, apply_confidence_mask=True, confidence_percentile=10.0)
    demo_colmap.export_predictions(preds, demo_colmap.view_names(views),
                                   str(tmp_path / "direct"))
    files = ("cameras.bin", "images.bin", "points3D.bin")
    for f in files:
        cli = (tmp_path / "cli" / "sparse" / f).read_bytes()
        assert cli == (tmp_path / "direct" / "sparse" / f).read_bytes(), f

    assert demo_colmap.main(args + ["--output_dir",
                                    str(tmp_path / "random")]) == 0
    random = (tmp_path / "random" / "sparse" / "points3D.bin").read_bytes()
    assert random != (tmp_path / "cli" / "sparse" / "points3D.bin"
                      ).read_bytes()
