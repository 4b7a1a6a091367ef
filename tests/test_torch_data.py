"""The port's WAI data layer (mapanything_tpu_torch/data) against the JAX
package's, on the CPU.

Both packages read the same trees, written with the port's `write_scene`
(the fixtures follow tests/test_datasets.py). Both run numpy on the host,
so the port must be bitwise equal from the same seed: EXR files either way,
every key of every view under the "imgnorm" and "colorjitter" transforms
and under each dataset's quirks, the native walk and normalisation (the
same C++ source, built by each package), the samplers at 1, 2 and 4 ranks,
the combinators, the collated batches and both loaders. Two tolerances:
the "gaublur" transform within 1e-6 (the port's numpy blur against
cv2.GaussianBlur, both held directly too), and `interpolate_extrinsics`
within 1e-6 (float64 numpy against JAX's float32).
"""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from mapanything_tpu import native as JN
from mapanything_tpu.data import base_dataset as JB
from mapanything_tpu.data import combinators as JC
from mapanything_tpu.data import exr as JE
from mapanything_tpu.data import image as JI
from mapanything_tpu.data import loader as JL
from mapanything_tpu.data import samplers as JS
from mapanything_tpu.data import splits as JSP
from mapanything_tpu.data import wai as JW
from mapanything_tpu.data import wai_datasets as JD
from mapanything_tpu.train.loop import build_dataset_mix as jax_mix
from mapanything_tpu_torch.data import base_dataset as PB
from mapanything_tpu_torch.data import combinators as PC
from mapanything_tpu_torch.data import exr as PE
from mapanything_tpu_torch.data import image as PI
from mapanything_tpu_torch.data import loader as PL
from mapanything_tpu_torch.data import native as PN
from mapanything_tpu_torch.data import samplers as PS
from mapanything_tpu_torch.data import splits as PSP
from mapanything_tpu_torch.data import wai as PW
from mapanything_tpu_torch.data import wai_datasets as PD
from mapanything_tpu_torch.train.loop import build_dataset_mix

H, W = 64, 80
RES = [(56, 42), (56, 28)]  # two aspect-ratio buckets
K = dict(fx=60.0, fy=60.0, cx=W / 2, cy=H / 2, w=W, h=H)


def banded(n: int, width: int = 2) -> np.ndarray:
    """Covisibility falling off with the frame distance: the walk has a
    choice of neighbours at every step."""
    d = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    return np.clip(1.0 - d / (width + 1), 0.0, 1.0).astype(np.float32)


def pose(i: int) -> np.ndarray:
    p = np.eye(4)
    p[:3, 3] = [0.1 * i, 0.02 * i, 0.0]
    return p


@pytest.fixture(scope="module")
def wai_root(tmp_path_factory):
    """Two scenes of six frames, depth in npy for one and EXR for the
    other, written by the port's write_scene."""
    root = tmp_path_factory.mktemp("wai")
    rng = np.random.default_rng(0)
    for scene, fmt in (("scene_a", "npy"), ("scene_b", "exr")):
        frames = [{
            "frame_name": f"f{i}",
            "image": rng.integers(0, 255, (H, W, 3), dtype=np.uint8),
            "depth": rng.uniform(1.0, 4.0, (H, W)).astype(np.float32),
            "transform_matrix": pose(i),
        } for i in range(6)]
        PW.write_scene(root / scene, frames, K, banded(6), depth_format=fmt)
    return str(root)


@pytest.fixture(scope="module")
def quirk_root(tmp_path_factory):
    """One scene with every quirk modality (tests/test_datasets.py's
    quirk fixture): moge2 and sky masks, rendered depth, MVS depth at half
    resolution and its confidence."""
    root = tmp_path_factory.mktemp("wai_quirks")
    rng = np.random.default_rng(1)
    frames, extra = [], []
    for i in range(4):
        depth = rng.uniform(1.0, 4.0, (H, W)).astype(np.float32)
        depth[:4, :4] = 100.0  # horizon outliers for the percentile quirk
        depth[-2:, :] = 0.0  # sky / ambiguous zeros
        moge = np.ones((H, W), bool)
        moge[:, :8] = False
        sky = np.zeros((H, W), bool)
        sky[:6, :] = True
        conf = np.full((H // 2, W // 2), 0.9, np.float32)
        conf[:, :W // 4] = 0.1
        frames.append({
            "frame_name": f"f{i}",
            "image": rng.integers(0, 255, (H, W, 3), dtype=np.uint8),
            "depth": depth, "transform_matrix": pose(i),
            "masks": {"pred_mask/moge2": moge, "skymask": sky},
        })
        extra.append({"pred_depth/mvsanywhere": depth[::2, ::2],
                      "depth_confidence/mvsanywhere": conf,
                      "rendered_depth": depth * 1.01})
    scene = PW.write_scene(root / "scene_q", frames, K, banded(4, 3))
    meta = PW.load_data(scene / "scene_meta.json")
    for i, arrays in enumerate(extra):
        rec = dict(meta["frames"][i])
        for name, arr in arrays.items():
            rel = f"{name}/f{i}.npy"
            PW.store_data(scene / rel, arr, "depth")
            rec[name] = rel
            meta["frame_modalities"][name] = {"frame_key": name,
                                              "format": "depth"}
        PW.set_frame(meta, f"f{i}", rec)
    PW.store_data(scene / "scene_meta.json", meta, "readable")
    return str(root)


def pair(root, **kw):
    """The same WAIDataset in both packages."""
    args = dict(ROOT=root, spec="eth3d", num_views=3, covisibility_thres=0.25,
                resolution=RES, data_norm_type="dinov2", seed=7)
    args.update(kw)
    return PD.WAIDataset(**args), JD.WAIDataset(**args)


def assert_equal(got, want, path="", atol=0.0, close=()):
    """Nested views, arrays and scalars equal (arrays of the keys in
    `close` within `atol`, the rest bitwise, dtypes equal)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            assert_equal(got[key], want[key], f"{path}.{key}", atol, close)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal(g, w, f"{path}[{i}]", atol, close)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if path.rsplit(".", 1)[-1] in close:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# -- EXR and scene IO --------------------------------------------------------


@pytest.mark.parametrize("shape", [(17, 23), (40, 33)])
def test_exr_each_reads_the_others_file(tmp_path, shape):
    img = np.random.default_rng(2).uniform(0, 50, shape).astype(np.float32)
    PE.write_exr(tmp_path / "port.exr", img)
    JE.write_exr(tmp_path / "jax.exr", img)
    assert ((tmp_path / "port.exr").read_bytes()
            == (tmp_path / "jax.exr").read_bytes())
    for path in ("port.exr", "jax.exr"):
        np.testing.assert_array_equal(PE.read_exr(tmp_path / path), img)
        np.testing.assert_array_equal(JE.read_exr(tmp_path / path), img)


@pytest.mark.parametrize("fmt", ["npy", "exr", "png"])
def test_write_scene_reads_back_as_jax_reads_it(tmp_path, fmt):
    rng = np.random.default_rng(3)
    frames = [{"frame_name": f"f{i}",
               "image": rng.integers(0, 255, (H, W, 3), dtype=np.uint8),
               "depth": rng.uniform(0.5, 9.0, (H, W)).astype(np.float32),
               "transform_matrix": pose(i),
               "masks": {"skymask": rng.random((H, W)) < 0.3}}
              for i in range(3)]
    root = PW.write_scene(tmp_path / "s", frames, K, banded(3),
                          depth_format=fmt)
    meta = PW.load_scene_meta(root / "scene_meta.json")
    assert_equal(meta, JW.load_scene_meta(root / "scene_meta.json"))
    np.testing.assert_array_equal(PW.load_covisibility_mmap(root),
                                  JW.load_covisibility_mmap(root))
    for name in ("f0", 2):
        got = PW.load_frame(root, name, ["image", "depth", "skymask"])
        assert_equal(got, JW.load_frame(root, name,
                                        ["image", "depth", "skymask"]))
    np.testing.assert_array_equal(got["image"], frames[2]["image"])
    np.testing.assert_array_equal(got["skymask"], frames[2]["masks"]["skymask"])
    if fmt != "png":  # png16 keeps millimetres
        np.testing.assert_array_equal(got["depth"], frames[2]["depth"])
    for kind in ("readable", "numpy", "mmap", "image", "depth", "binary"):
        path = {"readable": root / "scene_meta.json",
                "numpy": root / "covisibility/v0/covis.npy",
                "mmap": root / "covisibility/v0/covis.npy",
                "image": root / "images/f1.png",
                "depth": root / f"depth/f1.{fmt}",
                "binary": root / "skymask/f1.png"}[kind]
        assert_equal(np.asarray(PW.load_data(path, kind))
                     if kind == "mmap" else PW.load_data(path, kind),
                     np.asarray(JW.load_data(path, kind))
                     if kind == "mmap" else JW.load_data(path, kind))


def test_frame_accessors_and_interpolation_match_jax(wai_root):
    meta = PW.load_scene_meta(f"{wai_root}/scene_a/scene_meta.json")
    for key in ("f2", 3, 4.0, 1.25):
        assert PW.get_frame_index(meta, key) == JW.get_frame_index(meta, key)
    for key in ("f1", 2, 0.5, 3.75):
        got, want = PW.get_frame(meta, key), JW.get_frame(meta, key)
        np.testing.assert_allclose(np.asarray(got.pop("transform_matrix")),
                                   np.asarray(want.pop("transform_matrix")),
                                   rtol=0, atol=1e-6)
        assert got == want
        np.testing.assert_allclose(PW.get_extrinsics(meta, key),
                                   JW.get_extrinsics(meta, key), rtol=0,
                                   atol=1e-6)
    for bad in (-0.5, 5.5):
        with pytest.raises(IndexError):
            PW.get_frame(meta, bad)
    mods = {"depth": {"frame_key": "pred_depth", "format": "depth"}}
    assert PW.nest_modality(mods, "depth") == JW.nest_modality(mods, "depth")
    f1, f2 = dict(fx=10.0, cx=3.0), dict(fx=20.0, cx=5.0, cy=1.0)
    assert (PW.interpolate_intrinsics(f1, f2, 0.3)
            == JW.interpolate_intrinsics(f1, f2, 0.3))


def _rotation(rng):
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.5, 1.0])
def test_interpolate_extrinsics_within_1e6_of_jax(alpha):
    rng = np.random.default_rng(4)
    for _ in range(8):
        m1, m2 = np.eye(4), np.eye(4)
        m1[:3, :3], m2[:3, :3] = _rotation(rng), _rotation(rng)
        m1[:3, 3], m2[:3, 3] = rng.standard_normal(3), rng.standard_normal(3)
        got = PW.interpolate_extrinsics(m1, m2, alpha)
        np.testing.assert_allclose(
            got, JW.interpolate_extrinsics(m1, m2, alpha), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[:3, :3] @ got[:3, :3].T, np.eye(3),
                                   atol=1e-12)
    # nearly parallel rotations take the normalised-lerp branch
    np.testing.assert_allclose(PW.interpolate_extrinsics(m1, m1, alpha), m1,
                               atol=1e-6)


def test_crop_additional_quantities_equal_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    depth = rng.uniform(1, 3, (H, W)).astype(np.float32)
    kmat = np.array([[60.0, 0, 37.0], [0, 61.0, 30.0], [0, 0, 1]], np.float32)
    extras = [rng.integers(0, 2, (H, W)).astype(np.int32),
              rng.random((H, W)).astype(np.float32)]
    for res in [(56, 42), (42, 56), (96, 72)]:
        got = PI.crop_resize_if_necessary(img, res, depth, kmat,
                                          additional_quantities=extras)
        want = JI.crop_resize_if_necessary(img, res, depth, kmat,
                                           additional_quantities=extras)
        assert len(got) == len(want) == 4
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
        assert_equal(list(got[1:]), list(want[1:]))
        assert [q.shape for q in got[3]] == [got[1].shape] * 2


# -- the native host ops -----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**62 + 7])
def test_native_walk_and_normalise_equal_jax(seed):
    rng = np.random.default_rng(seed % 1000)
    covis = rng.random((25, 25)).astype(np.float32)
    covis = covis * (covis > 0.6) + np.eye(25, dtype=np.float32)
    for n, thres, bidir in ((5, 0.25, True), (9, 0.5, False), (25, 0.1, True)):
        got = PN.covis_random_walk(covis, n, thres, seed, 4, bidir)
        want = JN.covis_random_walk(covis, n, thres, seed=seed,
                                    max_retries=4, bidirectional=bidir)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    img = rng.integers(0, 255, (31, 17, 3), dtype=np.uint8)
    mean, std = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])
    np.testing.assert_array_equal(PN.normalize_u8(img, mean, std),
                                  JN.normalize_u8(img, mean, std))


def _walker(module, seed):
    ds = module.BaseDataset.__new__(module.BaseDataset)
    ds.covisibility_thres = 0.25
    ds._rng = np.random.default_rng(seed)
    return ds


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_walk_equals_jax_python_walk(seed):
    covis = banded(30, 3)
    covis[10:12] = 0  # a cut the walk must respect
    covis[:, 10:12] = 0
    for n in (4, 8, 30):
        got = _walker(PB, seed)._random_walk_sampling_py(covis, n)
        want = _walker(JB, seed)._random_walk_sampling_py(covis, n)
        np.testing.assert_array_equal(got, want)


def test_host_ops_raise_without_a_compiler(tmp_path, monkeypatch):
    """No silent fallback: without g++ the host ops raise, naming it."""
    monkeypatch.setattr(PN, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(PN.shutil, "which", lambda name: None)
    PN.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            PN.normalize_u8(np.zeros((2, 2, 3), np.uint8), np.zeros(3),
                            np.ones(3))
        ds = _walker(PB, 0)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            ds._random_walk_sampling(banded(6), 3)
    finally:
        PN.load_library.cache_clear()


# -- datasets ----------------------------------------------------------------


@pytest.mark.parametrize("transform", ["imgnorm", "colorjitter"])
@pytest.mark.parametrize("idx,epoch", [((0, 0), 0), ((1, 1), 0),
                                       ((1, 0), 3)])
def test_views_bitwise_equal_jax(wai_root, transform, idx, epoch):
    port, ref = pair(wai_root, transform=transform)
    port.set_epoch(epoch)
    ref.set_epoch(epoch)
    assert len(port) == len(ref) == 2
    got, want = port[idx], ref[idx]
    assert_equal(got, want)
    assert got[0]["img"].shape == (RES[idx[1]][1], RES[idx[1]][0], 3)


def test_gaublur_transform_within_1e6_of_jax(wai_root, monkeypatch):
    """The third transform blurs 5% of the views: enough samples that some
    are blurred, each view within 1e-6 of JAX's (cv2's blur)."""
    blurred = []
    blur = PB.gaussian_blur
    monkeypatch.setattr(PB, "gaussian_blur",
                        lambda img, rng: blurred.append(1) or blur(img, rng))
    port, ref = pair(wai_root, transform="colorjitter+grayscale+gaublur",
                     num_views=4)
    for i in range(24):
        port.set_epoch(i)
        ref.set_epoch(i)
        assert_equal(port[(i % 2, i % 2)], ref[(i % 2, i % 2)], atol=1e-6,
                     close=("img",))
    assert blurred, "no view was blurred"


@pytest.mark.parametrize("sigma", [0.1, 0.37, 1.0])
@pytest.mark.parametrize("shape", [(42, 56, 3), (5, 7, 3), (392, 518, 3)])
def test_numpy_blur_within_1e6_of_cv2(sigma, shape):
    import cv2

    img = np.random.default_rng(6).random(shape).astype(np.float32)
    got = PB.blur_separable(img, PB.gaussian_kernel(5, sigma))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, cv2.GaussianBlur(img, (5, 5), sigma),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        PB.gaussian_kernel(5, sigma),
        cv2.getGaussianKernel(5, sigma, cv2.CV_32F)[:, 0])


@pytest.mark.parametrize("spec", sorted(PD.WAI_DATASET_SPECS))
def test_each_spec_bitwise_equal_jax(quirk_root, spec):
    port, ref = pair(quirk_root, spec=spec, num_views=2, seed=3,
                     resolution=(56, 42), max_num_retries=0)
    assert port.is_metric_scale == ref.is_metric_scale
    for idx in (0, (0, 0)):
        got, want = port[idx], ref[idx]
        assert_equal(got, want)
    assert got[0]["dataset"] == spec


def test_variable_views_and_retry_equal_jax(wai_root, capsys):
    port, ref = pair(wai_root, num_views=4, variable_num_views=True)
    assert port.num_views == ref.num_views == [2, 3, 4]
    assert_equal(port[(1, 0, 1)], ref[(1, 0, 1)])
    # a scene that fails to load: the retry's replacement comes from
    # numpy's global RNG, as in the JAX package
    for ds in (port, ref):
        ds.scenes = ["missing_scene"] + ds.scenes
        ds.num_of_scenes = len(ds.scenes)
    np.random.seed(11)
    got = port[(0, 1, 0)]
    np.random.seed(11)
    assert_equal(got, ref[(0, 1, 0)])
    assert "retry 1" in capsys.readouterr().out


def test_combinators_equal_jax(wai_root):
    port, ref = pair(wai_root)
    for p, j in ((3 * port, 3 * ref), (5 @ port, 5 @ ref),
                 (port + 2 * port, ref + 2 * ref)):
        p.set_epoch(1)
        j.set_epoch(1)
        assert len(p) == len(j)
        assert p.num_views == j.num_views == 3
        for idx in ((0, 1), (len(p) - 1, 0)):
            assert_equal(p[idx], j[idx])


@pytest.mark.parametrize("kind", ["random", "multi", "dynamic"])
@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("epoch", [0, 1])
def test_samplers_equal_jax(kind, world, epoch):
    dataset = range(37)
    for rank in range(world):
        made = []
        for mod in (PS, JS):
            if kind == "random":
                s = mod.BatchedRandomSampler(dataset, 2, 2, world, rank)
            elif kind == "multi":
                s = mod.BatchedMultiFeatureRandomSampler(dataset, 2, [2, 3],
                                                         world, rank)
            else:
                s = mod.DynamicBatchedMultiFeatureRandomSampler(
                    dataset, [2, 3], scaling_feature_idx=1,
                    feature_to_batch_size_map={0: 6, 1: 4, 2: 3},
                    world_size=world, rank=rank)
            s.set_epoch(epoch)
            made.append((len(s), [np.asarray(b).tolist() for b in s]))
        assert made[0] == made[1]
        assert made[0][1], "an empty split"
    assert PS.round_by(37, 8) == JS.round_by(37, 8) == 32
    assert PS.round_by(37, 8, up=True) == JS.round_by(37, 8, up=True)


def test_make_sampler_equal_jax(wai_root):
    port, ref = pair(wai_root, num_views=4, variable_num_views=True)
    for kw in (dict(max_num_of_images_per_gpu=12),
               dict(batch_size=2, use_dynamic_sampler=False, world_size=2,
                    rank=1)):
        got = (16 @ port).make_sampler(**kw)
        want = (16 @ ref).make_sampler(**kw)
        got.set_epoch(2)
        want.set_epoch(2)
        assert type(got).__name__ == type(want).__name__
        assert [np.asarray(b).tolist() for b in got] == [
            np.asarray(b).tolist() for b in want]


def test_collate_equal_jax_and_its_contract(wai_root):
    port, ref = pair(wai_root)
    got = PL.collate_views([port[(0, 0)], port[(1, 0)]])
    assert_equal(got, JL.collate_views([ref[(0, 0)], ref[(1, 0)]]))
    assert got["views"]["img"].shape == (2, 3, 42, 56, 3)
    assert got["gt"]["valid_mask"].dtype == bool
    assert got["gt"]["is_metric_scale"].shape == (2,)


@pytest.mark.parametrize("epoch", [0, 1])
def test_train_loader_batches_equal_jax(wai_root, epoch):
    """Two buckets and 2-4 views: the sampler draws (bucket, views) per
    batch and sizes it 12 // views."""
    port, ref = pair(wai_root, num_views=4, variable_num_views=True)
    # JAX's threads share one RNG (see test_threads_draw_from_their_own_rng)
    loaders = [mod.get_train_data_loader(16 @ ds, max_num_of_imgs_per_gpu=12,
                                         num_workers=workers)
               for mod, ds, workers in ((PL, port, 3), (JL, ref, 0))]
    for loader in loaders:
        loader.set_epoch(epoch)
    got, want = (list(loader) for loader in loaders)
    assert len(got) == len(want) > 0
    assert_equal(got, want)
    assert {b["views"]["img"].shape[2] for b in got} == {42, 28}
    assert all(b["views"]["img"].shape[0] == 12 // b["views"]["img"].shape[1]
               for b in got)


def test_fixed_views_in_every_bucket():
    """Repair: with a fixed view count every bucket has the batch size
    max_imgs // views. The JAX package maps bucket 0 alone and raises
    KeyError on a batch drawn in bucket 1; the port draws what JAX's
    sampler draws given the complete map."""

    class Views:  # what make_sampler reads of a dataset
        num_views = 4
        _resolutions = RES

        def __len__(self):
            return 24

    class PortViews(Views, PC.EasyDataset):
        pass

    class JaxViews(Views, JC.EasyDataset):
        pass

    got = PortViews().make_sampler(max_num_of_images_per_gpu=8)
    assert got.feature_to_batch_size_map == {0: 2, 1: 2}
    want = JS.DynamicBatchedMultiFeatureRandomSampler(
        Views(), [2], feature_to_batch_size_map={0: 2, 1: 2})
    broken = JaxViews().make_sampler(max_num_of_images_per_gpu=8)
    got.set_epoch(0)
    want.set_epoch(0)
    broken.set_epoch(0)
    batches = [np.asarray(b).tolist() for b in got]
    assert batches == [np.asarray(b).tolist() for b in want]
    assert {b[0][1] for b in batches} == {0, 1} and len(batches) == 12
    with pytest.raises(KeyError):
        list(broken)


def test_threads_draw_from_their_own_rng(wai_root):
    """Repair: samples loaded by many threads at once equal the samples
    loaded one after another (in the JAX package the threads share one
    `_rng`, so they draw from each other's generators)."""
    port, ref = pair(wai_root, transform="colorjitter")
    idxs = [(i % 2, i % 2) for i in range(16)]
    want = [ref[idx] for idx in idxs]
    for ds in (port, ref):
        ds.set_epoch(0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(port.__getitem__, idxs))
    finally:
        sys.setswitchinterval(switch)
    assert_equal(got, want)


def test_test_loader_batches_equal_jax(wai_root):
    port, ref = pair(wai_root)
    made = []
    for mod, ds, workers in ((PL, port, 3), (JL, ref, 0)):
        loader = mod.get_test_data_loader(8 @ ds, batch_size=2,
                                          num_workers=workers)
        loader.set_epoch(0)
        made.append(list(loader))
    assert len(made[0]) == 4
    assert_equal(*made)


# -- the loader's threads ----------------------------------------------------


class _Slow:
    """Items that take a random time, one of them failing."""

    def __init__(self, fail_at=None):
        self.fail_at = fail_at

    def __getitem__(self, i):
        time.sleep(0.02 * ((i * 7) % 3))
        if i == self.fail_at:
            raise ValueError(f"item {i}")
        return [{"i": i}]


def _ids(samples):
    return [views[0]["i"] for views in samples]


def test_loader_keeps_order_and_reraises_worker_errors():
    batches = [[i, i + 1] for i in range(0, 20, 2)]
    loader = PL.DataLoader(_Slow(), batches, num_workers=3, collate_fn=_ids)
    assert list(loader) == batches
    loader = PL.DataLoader(_Slow(fail_at=7), batches, num_workers=3,
                           collate_fn=_ids)
    with pytest.raises(ValueError, match="item 7"):
        list(loader)


def test_abandoned_iterator_tears_down_workers(wai_root):
    port, _ = pair(wai_root, num_views=2)
    loader = PL.get_train_data_loader(16 @ port, max_num_of_imgs_per_gpu=4,
                                      num_workers=2)
    loader.set_epoch(0)
    before = threading.active_count()
    it = iter(loader)
    assert next(it)["views"]["img"].ndim == 5
    it.close()
    deadline = time.time() + 10.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "loader threads leaked"


# -- splits, the DSL, the inspector ------------------------------------------

SCENES = ["0123456789abcdef00000000000000a0", "00000001000000000000000000000005",
          "HongKong", "PolarSciFi", "Abandoned", "0015_0", "0099_1", "0013",
          "scene_a", "1c7a683c92", "0e900bcc5c", "deadbeef", "xyz"]


def test_splits_equal_jax(tmp_path):
    for dataset in ("blendedmvs", "tav2_wb", "megadepth", "spring", "mpsd",
                    "eth3d", "scannetpp", "unlisted"):
        for scene in SCENES:
            assert (PSP.assign_split(dataset, scene)
                    == JSP.assign_split(dataset, scene)), (dataset, scene)
        for out, mod in ((tmp_path / "port", PSP), (tmp_path / "jax", JSP)):
            mod.build_scene_lists(dataset, SCENES, str(out))
        for split in PSP.SPLITS:
            got = sorted((tmp_path / "port").glob(f"{split}/{dataset}_*"))
            want = sorted((tmp_path / "jax").glob(f"{split}/{dataset}_*"))
            assert [p.name for p in got] == [p.name for p in want]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(np.load(g), np.load(w))
    with pytest.raises(LookupError):
        PSP.assign_split("dl3dv", "x", for_benchmark=True)
    csv = tmp_path / "benchmark-meta.csv"
    csv.write_text("hash,name\nabc,one\n, \ndeadbeef,two\n")
    assert PSP.dl3dv_benchmark_rule(str(csv)) == PSP.SplitRule(
        val_scenes=("abc", "deadbeef"))
    assert (PSP.dl3dv_benchmark_rule(str(csv)).val_scenes
            == JSP.dl3dv_benchmark_rule(str(csv)).val_scenes)


def test_build_dataset_mix_three_terms_equal_jax(wai_root):
    spec = ("3 @ WAIDataset(ROOT=wai_root, spec='eth3d', num_views=2, "
            "covisibility_thres=0.25, resolution=(56, 42), seed=1) "
            "+ 2 * make_wai_dataset('eth3d', ROOT=wai_root, num_views=2, "
            "covisibility_thres=0.25, resolution=(56, 42), seed=2) "
            "+ WAIDataset(ROOT=wai_root, spec='ase', num_views=2, "
            "covisibility_thres=0.25, resolution=(56, 42), seed=3)")
    port = build_dataset_mix(spec, wai_root=wai_root)
    ref = jax_mix(spec, wai_root=wai_root)
    port.set_epoch(0)
    ref.set_epoch(0)
    assert len(port) == len(ref) == 3 + 4 + 2
    for idx in range(len(port)):
        assert_equal(port[(idx, 0)], ref[(idx, 0)])
    assert port[(8, 0)][0]["is_synthetic"]  # the third term: ase
    with pytest.raises(NameError):  # no builtins in the namespace
        build_dataset_mix("open('x')", wai_root=wai_root)


@pytest.mark.parametrize("other", [
    "resolution=[(56, 42), (56, 28)], num_views=2",
    "resolution=(56, 42), num_views=3"])
def test_dataset_mix_refuses_terms_that_differ(wai_root, other):
    """The sampler draws one bucket and view count a batch from the first
    term's lists, so a term with other lists would fail mid-epoch."""
    spec = ("WAIDataset(ROOT=wai_root, spec='eth3d', num_views=2, "
            "covisibility_thres=0.25, resolution=(56, 42), seed=1) + "
            f"2 @ WAIDataset(ROOT=wai_root, spec='eth3d', {other}, "
            "covisibility_thres=0.25, seed=2)")
    with pytest.raises(ValueError, match="terms of a dataset mix differ"):
        build_dataset_mix(spec, wai_root=wai_root)


def test_inspector_prints_and_writes_viz(wai_root, capsys, tmp_path,
                                        monkeypatch):
    """--viz writes the first sample's valid points as sample.glb, in the
    bytes of the JAX inspector's branch (wai_datasets.py's __main__) on
    JAX's dataset."""
    from mapanything_tpu.utils.viz import write_glb_pointcloud

    args = ["--root", wai_root, "--num_views", "2", "--resolution", "56",
            "42", "--num_samples", "2"]
    monkeypatch.chdir(tmp_path)
    PD.main(args)
    out = capsys.readouterr().out
    assert "eth3d: 2 scenes" in out and "sample 1: 2 views" in out
    assert not (tmp_path / "sample.glb").exists()
    PD.main(args + ["--viz"])
    assert "wrote sample.glb" in capsys.readouterr().out
    views = JD.WAIDataset(ROOT=wai_root, spec="eth3d", num_views=2,
                          covisibility_thres=0.25, resolution=(56, 42),
                          data_norm_type="dinov2", seed=0)[0]
    valid = [np.asarray(v["valid_mask"], bool) for v in views]
    mean, std = JI.IMAGE_NORMALIZATION_DICT["dinov2"]
    write_glb_pointcloud(
        str(tmp_path / "jax.glb"),
        np.concatenate([v["pts3d"][m] for v, m in zip(views, valid)]),
        np.concatenate([np.clip(np.asarray(v["img"]) * std + mean, 0, 1)[m]
                        for v, m in zip(views, valid)]))
    assert ((tmp_path / "sample.glb").read_bytes()
            == (tmp_path / "jax.glb").read_bytes())
