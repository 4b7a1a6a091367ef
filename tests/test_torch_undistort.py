"""The port's undistortion stage (mapanything_tpu_torch/data/undistort.py)
against the JAX package's and against cv2, on the CPU.

Both packages run the same float64 numpy, so the port is held to JAX's
results exactly; against cv2 with the JAX tests' own limits
(tests/test_undistort.py).
"""

import numpy as np
import pytest

from mapanything_tpu.data import undistort as JU
from mapanything_tpu_torch.data import undistort as PU

cv2 = pytest.importorskip("cv2")

W, H = 64, 48
K = np.array([[50.0, 0, 33.0], [0, 52.0, 22.0], [0, 0, 1]])
DIST = {"OPENCV": np.array([-0.25, 0.06, 0.001, -0.002, 0.01]),
        "OPENCV_FISHEYE": np.array([-0.05, 0.02, -0.01, 0.003])}


@pytest.mark.parametrize("model", sorted(DIST))
@pytest.mark.parametrize("balance,centred", [(0.0, True), (1.0, True),
                                             (0.0, False), (0.5, False)])
def test_intrinsics_and_maps_match_jax(model, balance, centred):
    d = DIST[model]
    want_K = JU.estimate_new_intrinsics(K, d, model, (W, H), balance,
                                        centred)
    got_K = PU.estimate_new_intrinsics(K, d, model, (W, H), balance,
                                       centred)
    np.testing.assert_array_equal(got_K, want_K)
    want = JU.undistort_rectify_maps(K, d, model, (W, H), want_K)
    got = PU.undistort_rectify_maps(K, d, model, (W, H), got_K)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("model", sorted(DIST))
def test_maps_match_cv2(model):
    mx, my = PU.undistort_rectify_maps(K, DIST[model], model, (W, H))
    init = (cv2.initUndistortRectifyMap if model == "OPENCV"
            else cv2.fisheye.initUndistortRectifyMap)
    cx, cy = init(K, DIST[model], np.eye(3), K, (W, H), cv2.CV_32FC1)
    np.testing.assert_allclose(mx, cx, atol=1e-3)
    np.testing.assert_allclose(my, cy, atol=1e-3)


@pytest.mark.parametrize("model", sorted(DIST))
def test_point_inverse_matches_jax_and_cv2(model):
    rng = np.random.default_rng(0)
    pts = rng.uniform([5, 5], [W - 5, H - 5], size=(60, 2))
    xyd = (pts - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
    got = PU.undistort_points_normalized(xyd, DIST[model], model)
    np.testing.assert_array_equal(
        got, JU.undistort_points_normalized(xyd, DIST[model], model))
    if model == "OPENCV":
        # cv2's own default stops after 5 fixed-point steps; iterate it to
        # convergence, as the port does
        ref = cv2.undistortPoints(
            pts.reshape(-1, 1, 2), K, DIST[model],
            criteria=(cv2.TERM_CRITERIA_COUNT, 100, 0.0))
    else:
        ref = cv2.fisheye.undistortPoints(
            xyd.reshape(-1, 1, 2), np.eye(3), DIST[model].reshape(4, 1))
    np.testing.assert_allclose(got, ref.reshape(-1, 2), atol=1e-7)


REMAPS = [("linear", "constant", 0.0), ("linear", "reflect101", 0.0),
          ("nearest", "constant", 7.0), ("nearest", "reflect101", 0.0)]
CV_INTERP = {"linear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST}
CV_BORDER = {"constant": cv2.BORDER_CONSTANT,
             "reflect101": cv2.BORDER_REFLECT_101}


@pytest.mark.parametrize("interp,border,fill", REMAPS)
@pytest.mark.parametrize("dtype", ["uint8", "float32", "bool"])
def test_remap_matches_jax_and_cv2(interp, border, fill, dtype):
    rng = np.random.default_rng(2)
    img = {"uint8": lambda: rng.integers(0, 255, (H, W, 3), np.uint8),
           "float32": lambda: rng.uniform(-9, 9, (H, W)).astype(np.float32),
           "bool": lambda: rng.uniform(size=(H, W)) > 0.4}[dtype]()
    mx, my = PU.undistort_rectify_maps(K, DIST["OPENCV"], "OPENCV", (W, H))
    got = PU.remap(img, mx, my, interp, border, fill)
    want = JU.remap(img, mx, my, interp, border, fill)
    assert got.dtype == want.dtype == img.dtype
    np.testing.assert_array_equal(got, want)
    if dtype == "bool":  # cv2.remap rejects bool
        return
    ref = cv2.remap(img, mx, my, interpolation=CV_INTERP[interp],
                    borderMode=CV_BORDER[border], borderValue=fill)
    if interp == "linear":
        np.testing.assert_allclose(got.astype(np.float64), ref, atol=1.0)
    else:  # cv2 rounds some .5 ties the other way (tests/test_undistort.py)
        assert np.isclose(got.astype(np.float64), ref).mean() > 0.995


@pytest.mark.parametrize("model", sorted(DIST))
def test_undistort_frame_matches_jax(model):
    rng = np.random.default_rng(3)
    d = DIST[model]
    keys = (("k1", "k2", "k3", "k4") if model == "OPENCV_FISHEYE"
            else ("k1", "k2", "p1", "p2", "k3"))
    meta = {"w": W, "h": H, "fl_x": K[0, 0], "fl_y": K[1, 1],
            "cx": K[0, 2], "cy": K[1, 2], "camera_model": model,
            **dict(zip(keys, d))}
    mods = {"image": rng.integers(0, 255, (H, W, 3), np.uint8),
            "depth": rng.uniform(0.5, 3, (H, W)).astype(np.float32),
            "anon_mask": rng.uniform(size=(H, W)) > 0.1}
    got, got_meta = PU.undistort_frame(mods, meta)
    want, want_meta = JU.undistort_frame(mods, meta)
    assert got_meta == want_meta and got_meta["camera_model"] == "PINHOLE"
    assert sorted(got) == sorted(want)
    for name in got:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
    with pytest.raises(NotImplementedError):
        PU.undistort_frame({}, dict(meta, camera_model="PANORAMA"))
