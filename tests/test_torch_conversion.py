"""The port's generic COLMAP -> WAI converter
(mapanything_tpu_torch/data/conversion.py) and the three helper modules
(geometry/camera.py, geometry/windows.py, utils/misc.py) against the JAX
package's, on the CPU; and the offline slice's modules import no JAX.

The COLMAP scene is the JAX test's (tests/test_conversion.py::scene),
exported through the port's own COLMAP writers. Trees compare file by
file (tests/torch_offline_scenes.py::assert_trees_equal); the inline
covisibility within tests/test_torch_covisibility.py's limit.
"""

import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapanything_tpu.data import conversion as JCV
from mapanything_tpu.geometry import camera as JCam
from mapanything_tpu.geometry import windows as JW
from mapanything_tpu.utils import misc as JM
from mapanything_tpu_torch.data import conversion as PCV
from mapanything_tpu_torch.geometry import camera as PCam
from mapanything_tpu_torch.geometry import windows as PW
from mapanything_tpu_torch.utils import misc as PM

from test_conversion import scene  # noqa: F401  (the module fixture)
from torch_offline_scenes import (
    COVIS_PIXELS,
    assert_trees_equal,
)

REPO = Path(__file__).resolve().parent.parent


def test_sparse_depth_matches_jax(scene):  # noqa: F811
    for i in range(len(scene["c2w"])):
        args = (scene["pts_world"], scene["K"], scene["c2w"][i], 40, 56)
        np.testing.assert_array_equal(PCV.sparse_depth_from_points(*args),
                                      JCV.sparse_depth_from_points(*args))


@pytest.mark.parametrize("depth_source,fmt", [("points", "npy"),
                                              ("points", "exr"),
                                              ("none", "npy")])
def test_colmap_to_wai_matches_jax(scene, tmp_path, depth_source,  # noqa
                                   fmt):
    kw = dict(depth_source=depth_source, depth_format=fmt)
    want = JCV.colmap_to_wai(scene["sparse"], scene["img_dir"],
                             tmp_path / "jax" / "s", **kw)
    got = PCV.colmap_to_wai(scene["sparse"], scene["img_dir"],
                            tmp_path / "port" / "s", **kw)
    assert assert_trees_equal(want, got) >= 4


def test_inline_covisibility_matches_jax(scene, tmp_path):  # noqa: F811
    ext = {n: scene["depths"][i] for i, n in enumerate(scene["names"])}
    kw = dict(depth_source="external", external_depths=ext,
              covisibility=True)
    with jax.default_matmul_precision("highest"):
        want = JCV.colmap_to_wai(scene["sparse"], scene["img_dir"],
                                 tmp_path / "jax" / "s", **kw)
    got = PCV.colmap_to_wai(scene["sparse"], scene["img_dir"],
                            tmp_path / "port" / "s", device="cpu", **kw)
    h, w = scene["depths"].shape[1:]

    def covis_close(ref, out):
        assert np.abs(out - ref).max() <= COVIS_PIXELS / (h * w)

    assert_trees_equal(want, got, compare={"covisibility/": covis_close})
    if not torch.cuda.is_available():  # the card by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PCV.colmap_to_wai(scene["sparse"], scene["img_dir"],
                              tmp_path / "card" / "s", **kw)


def test_cli_matches_jax(scene, tmp_path, capsys):  # noqa: F811
    argv = [str(scene["sparse"]), str(scene["img_dir"])]
    JCV.main(argv + [str(tmp_path / "jax" / "s"), "--depth-format", "png"])
    PCV.main(argv + [str(tmp_path / "port" / "s"), "--depth-format", "png"])
    assert capsys.readouterr().out.count("(3 frames)") == 2
    assert_trees_equal(tmp_path / "jax", tmp_path / "port")
    run = subprocess.run(
        [sys.executable, "-m", "mapanything_tpu_torch.data.conversion",
         *argv, str(tmp_path / "m"), "--depth-source", "none"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and "(3 frames)" in run.stdout, run.stderr


# ---------------------------------------------------------------------------
# geometry/camera.py


@pytest.mark.parametrize("k", [0, 1, 2, 3, 5])
def test_camera_rotation_helpers_match_jax(k):
    params = [50.0, 55.0, 17.0, 11.0, 0.1]
    assert (PCam.adjust_camera_params_for_rotation(params, (32, 24), k)
            == JCam.adjust_camera_params_for_rotation(params, (32, 24), k))
    pose = np.linalg.qr(np.random.default_rng(k).normal(size=(4, 4)))[0]
    np.testing.assert_array_equal(PCam.adjust_pose_for_rotation(pose, k),
                                  JCam.adjust_pose_for_rotation(pose, k))


@pytest.mark.parametrize("hw,ratio", [((24, 48), 1.5), ((40, 30), 1.5),
                                      ((20, 30), 1.5)])
def test_crop_to_aspect_ratio_matches_jax(hw, ratio):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, hw + (3,), np.uint8)
    depth = rng.uniform(size=hw).astype(np.float32)
    params = [30.0, 31.0, hw[1] / 2, hw[0] / 2]
    got = PCam.crop_to_aspect_ratio(img, depth, params, ratio)
    want = JCam.crop_to_aspect_ratio(img, depth, params, ratio)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


# ---------------------------------------------------------------------------
# geometry/windows.py


def _both(seed=0, shape=(2, 11, 13), dtype=np.float32):
    x = np.random.default_rng(seed).normal(size=shape).astype(dtype)
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.mark.parametrize("window,stride,axis", [(3, 1, -1), (3, 2, 1),
                                                (4, 3, 2), (2, 1, 0)])
def test_sliding_window_1d_matches_jax(window, stride, axis):
    t, j = _both()
    np.testing.assert_array_equal(
        PW.sliding_window_1d(t, window, stride, axis).numpy(),
        np.asarray(JW.sliding_window_1d(j, window, stride, axis)))


def test_sliding_windows_nd_and_2d_match_jax():
    t, j = _both()
    np.testing.assert_array_equal(
        PW.sliding_window_nd(t, (3, 2), (2, 1), (1, 2)).numpy(),
        np.asarray(JW.sliding_window_nd(j, (3, 2), (2, 1), (1, 2))))
    np.testing.assert_array_equal(
        PW.sliding_window_2d(t, 3, 2).numpy(),
        np.asarray(JW.sliding_window_2d(j, 3, 2)))


@pytest.mark.parametrize("kernel,stride,padding,axis,dtype", [
    (3, 1, 1, -1, np.float32), (3, 2, 0, 1, np.float32),
    (5, 2, 2, 2, np.float32), (3, 3, 1, 1, np.int32)])
def test_max_pool_1d_matches_jax(kernel, stride, padding, axis, dtype):
    t, j = _both(2, dtype=np.float32)
    if dtype == np.int32:
        t, j = (t * 10).to(torch.int32), (j * 10).astype(jnp.int32)
    np.testing.assert_array_equal(
        PW.max_pool_1d(t, kernel, stride, padding, axis).numpy(),
        np.asarray(JW.max_pool_1d(j, kernel, stride, padding, axis)))


def test_max_pool_nd_matches_jax():
    t, j = _both(3)
    np.testing.assert_array_equal(
        PW.max_pool_nd(t, (3, 2), (1, 2), (1, 0), (1, 2)).numpy(),
        np.asarray(JW.max_pool_nd(j, (3, 2), (1, 2), (1, 0), (1, 2))))


@pytest.mark.parametrize("atol,rtol,masked", [(0.1, None, False),
                                              (None, 0.05, False),
                                              (0.1, 0.05, True)])
def test_depth_aliasing_matches_jax(atol, rtol, masked):
    rng = np.random.default_rng(4)
    # two planes with a ramp between them: the ramp's pixels alias
    ramp = np.clip(np.arange(20) - 8.0, 0, 3) / 3
    depth = (2.0 + 2.0 * ramp + 0.01 * rng.normal(size=(2, 16, 20))
             ).astype(np.float32)
    mask = rng.uniform(size=depth.shape) > 0.1 if masked else None
    got = PW.depth_aliasing(torch.from_numpy(depth), atol, rtol,
                            mask=None if mask is None
                            else torch.from_numpy(mask))
    want = JW.depth_aliasing(jnp.asarray(depth), atol, rtol,
                             mask=None if mask is None else jnp.asarray(mask))
    assert got.dtype == torch.bool and got.any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# utils/misc.py


def test_seed_everything_seeds_python_numpy_and_torch():
    import random

    draws = []
    for _ in range(2):
        PM.seed_everything(7)
        draws.append((random.random(), np.random.rand(), float(torch.rand(1))))
    assert draws[0] == draws[1]
    JM.seed_everything(7)
    assert (random.random(), np.random.rand()) == draws[0][:2]


@pytest.mark.parametrize("masked,ndim", [(True, 999), (True, 3),
                                         (False, 999), (False, 2)])
def test_invalid_masking_matches_jax(masked, ndim):
    rng = np.random.default_rng(5)
    arr = rng.normal(size=(2, 3, 4, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 3, 4)) > 0.3 if masked else None
    pm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    np.testing.assert_array_equal(
        PM.invalid_to_nans(torch.from_numpy(arr), pm, ndim).numpy(),
        np.asarray(JM.invalid_to_nans(jnp.asarray(arr), jm, ndim)))
    got, got_n = PM.invalid_to_zeros(torch.from_numpy(arr), pm, ndim)
    want, want_n = JM.invalid_to_zeros(jnp.asarray(arr), jm, ndim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got_n), np.asarray(want_n))


def test_pooled_maps_stream_logger_and_to_host(caplog):
    items = list(range(6))
    assert (PM.thread_map(abs, items, 3) == JM.thread_map(abs, items, 3)
            == items)
    logger = logging.getLogger("torch_offline_misc")
    stream = PM.StreamToLogger(logger, logging.WARNING)
    with caplog.at_level(logging.WARNING, "torch_offline_misc"):
        stream.write("one\ntwo")
        stream.flush()
    assert [r.getMessage() for r in caplog.records] == ["one", "two"]
    tree = {"a": torch.ones(2, dtype=torch.bfloat16),
            "b": [torch.arange(3), "x"], "c": (np.zeros(1),)}
    host = PM.to_host(tree)
    assert host["a"].dtype == np.float32 and host["b"][1] == "x"
    np.testing.assert_array_equal(host["b"][0], np.arange(3))
    assert isinstance(host["c"], tuple)


def test_offline_modules_import_no_jax():
    """The slice's modules and CLI import neither JAX nor the JAX package
    (the check of tests/test_torch_flash_probes.py); a process pool forks
    safely from such a process."""
    mods = ["mapanything_tpu_torch.convert_dataset",
            "mapanything_tpu_torch.data.conversion",
            "mapanything_tpu_torch.data.converters",
            "mapanything_tpu_torch.data.converters_corpus",
            "mapanything_tpu_torch.data.covisibility",
            "mapanything_tpu_torch.data.pseudo_depth",
            "mapanything_tpu_torch.data.rendering",
            "mapanything_tpu_torch.data.undistort",
            "mapanything_tpu_torch.geometry.camera",
            "mapanything_tpu_torch.geometry.windows",
            "mapanything_tpu_torch.utils.misc"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'mapanything_tpu' "
            "or m.startswith('mapanything_tpu.')]\n"
            "print(bad)\n"
            "from mapanything_tpu_torch.utils.misc import process_map\n"
            "assert process_map(abs, [-1, 2], 2) == [1, 2]\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip() == "[]"
