"""The port's image preprocessing (mapanything_tpu_torch/data/image.py)
against the JAX package's (mapanything_tpu/data/image.py), on the CPU.

Both are numpy and PIL, so the same raw inputs, made from seeded numpy
generators, must give bit-equal images (the same PIL calls), intrinsics
within 1e-6 and the same depth values: JAX resizes depth with
cv2.INTER_NEAREST, the port with a numpy rewrite of its index rule, which is
also held against cv2 directly. Every bucket of both resolution sets is
covered, from raw sizes on both sides of its aspect ratio, with and without
intrinsics and z-depth.
"""

import cv2
import numpy as np
import PIL.Image
import pytest

from mapanything_tpu.data import image as JI
from mapanything_tpu_torch.data import image as PI

BUCKETS = [(rs, w, h) for rs in (518, 512)
           for w, h in PI.RESOLUTION_MAPPINGS[rs].values()]


def test_bucket_tables_equal_jax():
    assert PI.RESOLUTION_MAPPINGS == JI.RESOLUTION_MAPPINGS


def _raw(rng, w, h, side):
    """A raw (W, H) whose aspect ratio lies 2% to `side` of w / h, the
    height 0.6-2.5x the bucket's (so both the Lanczos and the bicubic
    branch run)."""
    rh = int(h * rng.uniform(0.6, 2.5))
    return int(round(rh * w / h * (1.0 + 0.02 * side))), rh


def _intrinsics(rng, rw, rh):
    """A pinhole with its principal point off the centre, so that the crop
    moves it."""
    f = rng.uniform(0.6, 1.2) * max(rw, rh)
    cx, cy = rw * rng.uniform(0.4, 0.6), rh * rng.uniform(0.4, 0.6)
    return np.array([[f, 0, cx], [0, f * rng.uniform(0.95, 1.05), cy],
                     [0, 0, 1]], np.float32)


def _assert_same(port, ref):
    port = port if isinstance(port, tuple) else (port,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(port) == len(ref)
    np.testing.assert_array_equal(np.asarray(port[0]), np.asarray(ref[0]))
    for p, r in zip(port[1:], ref[1:]):
        assert p.shape == r.shape and p.dtype == r.dtype
        if r.shape == (3, 3):
            np.testing.assert_allclose(p, r, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("rs,w,h", BUCKETS)
def test_crop_resize_matches_jax(rs, w, h):
    rng = np.random.default_rng(rs + 7 * w + h)
    for side in (-1, 1):
        rw, rh = _raw(rng, w, h, side)
        assert JI.find_closest_aspect_ratio(rw / rh, rs) == (w, h)
        img = PIL.Image.fromarray(
            rng.integers(0, 256, (rh, rw, 3), dtype=np.uint8))
        depth = rng.uniform(0.5, 9.0, (rh, rw)).astype(np.float32)
        K = _intrinsics(rng, rw, rh)
        for kw in ({}, {"intrinsics": K}, {"depthmap": depth},
                   {"depthmap": depth, "intrinsics": K}):
            port = PI.crop_resize_if_necessary(img, (w, h), **kw)
            ref = JI.crop_resize_if_necessary(img, (w, h), **kw)
            _assert_same(port, ref)
            first = port[0] if isinstance(port, tuple) else port
            assert first.size == (w, h)
        # the crop keeps the principal point's offset from the centre of
        # the scaled image
        _, K2 = PI.crop_resize_if_necessary(img, (w, h), intrinsics=K)
        scale = max(w / rw, h / rh) + 1e-8
        scaled = np.floor(np.array([rw, rh]) * scale)
        off = (K[:2, 2] + 0.5) * scale - 0.5 - scaled / 2
        assert np.all(np.abs(K2[:2, 2] - np.array([w, h]) / 2 - off) <= 1.0)


@pytest.mark.parametrize("size,target", [
    ((480, 640), (518, 388)), ((480, 640), (294, 220)), ((37, 53), (518, 392)),
    ((1000, 750), (1, 1)), ((518, 518), (518, 518)), ((7, 3), (1500, 900))])
def test_resize_nearest_matches_cv2(size, target):
    rng = np.random.default_rng(sum(size) + sum(target))
    for dtype in (np.float32, np.uint8):
        arr = (rng.uniform(0, 255, size)).astype(dtype)
        np.testing.assert_array_equal(
            PI.resize_nearest(arr, target),
            cv2.resize(arr, target, interpolation=cv2.INTER_NEAREST))


def test_camera_matrix_of_crop_refuses_a_crop_larger_than_the_image():
    with pytest.raises(ValueError, match="crop larger"):
        PI.camera_matrix_of_crop(np.eye(3, dtype=np.float32), (100, 100),
                                 (120, 80))


def _scene(rng, sizes, priors):
    views = []
    for rw, rh in sizes:
        view = {"img": rng.integers(0, 256, (rh, rw, 3), dtype=np.uint8)}
        if "float" in priors:
            view["img"] = view["img"].astype(np.float32) / 255.0
        if "intrinsics" in priors:
            view["intrinsics"] = _intrinsics(rng, rw, rh)
        if "depth_z" in priors:
            view["depth_z"] = rng.uniform(0.5, 9.0, (rh, rw, 1)).astype(
                np.float32)
        if "camera_poses" in priors:
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = rng.normal(size=3)
            view["camera_poses"] = pose
            view["is_metric_scale"] = True
        views.append(view)
    return views


@pytest.mark.parametrize("rs", [518, 512])
@pytest.mark.parametrize("priors", [
    (), ("float",), ("intrinsics",), ("depth_z", "intrinsics"),
    ("depth_z", "intrinsics", "camera_poses")])
def test_preprocess_inputs_matches_jax(rs, priors):
    rng = np.random.default_rng(rs + len(priors))
    # mixed raw sizes: the average aspect ratio picks one bucket for all
    sizes = [(640, 480), (600, 470), (700, 500)]
    raw = _scene(rng, sizes, priors)
    port = PI.preprocess_inputs(raw, resolution_set=rs)
    ref = JI.preprocess_inputs(raw, resolution_set=rs)
    assert len(port) == len(ref) == len(sizes)
    for p, r in zip(port, ref):
        assert set(p) == set(r)
        for key in r:
            if isinstance(r[key], list):
                assert p[key] == r[key], key
            elif key == "intrinsics":
                np.testing.assert_allclose(p[key], r[key], rtol=0, atol=1e-6)
            else:
                assert p[key].dtype == r[key].dtype, key
                np.testing.assert_array_equal(p[key], r[key], err_msg=key)
        assert p["img"].shape == (1,) + r["true_shape"][0] + (3,)


def test_load_images_mixed_aspect_ratios_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    for i, (w, h) in enumerate([(640, 480), (480, 640), (900, 300),
                                (512, 512), (300, 200)]):
        PIL.Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                            ).save(tmp_path / f"im{i}.png")
    port = PI.load_images(str(tmp_path))
    ref = JI.load_images(str(tmp_path))
    assert len(port) == len(ref) == 5
    for p, r in zip(port, ref):
        assert set(p) == set(r)
        np.testing.assert_array_equal(p["img"], r["img"])
        for key in ("true_shape", "idx", "instance", "data_norm_type"):
            assert p[key] == r[key]
