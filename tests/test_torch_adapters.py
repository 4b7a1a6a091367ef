"""The external-model adapters (mapanything_tpu_torch/models/adapters.py)
and the last public helpers against the JAX package's, on the CPU.

No foreign checkpoint or pip package is in the repository, so every
adapter runs over an interface fake of tests/torch_adapter_fakes.py; the
same fake goes to both packages' adapters (the torch stand-ins as one
module instance, the host callables as one function), with the same
seeded make_synthetic_batch inputs at 28x42 (both packages draw them from
one numpy stream). Every returned key agrees within 1e-5 absolute and
relative, fp32; the GT-exact fakes also reproduce the synthetic ground
truth within the JAX tests' tolerances (tests/test_adapters.py). Pow3R's
gates admit the same priors as JAX's on each call, the priors' arrays
within 1e-6. The helpers agree within 1e-6 (resize_normalize_u8, the same
C++ source, and nearest_resize, a gather, bitwise).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapanything_tpu import native as JN
from mapanything_tpu.data import image as JI
from mapanything_tpu.data.synthetic import make_synthetic_batch as jax_batch
from mapanything_tpu.models import GeometricInputConfig as JaxGeomCfg
from mapanything_tpu.models import adapters as JA
from mapanything_tpu.nn import adaptors as JAD
from mapanything_tpu.ops import resize as JR
from mapanything_tpu.utils import flops as JF
from mapanything_tpu_torch.benchmarks.calibration import (
    run_calibration_benchmark,
)
from mapanything_tpu_torch.benchmarks.dense_n_view import (
    model_device,
    run_dense_n_view_benchmark,
)
from mapanything_tpu_torch.benchmarks.rmvd import (
    RMVDAdaptor,
    evaluate_mvs_depth,
)
from mapanything_tpu_torch.data import image as PI
from mapanything_tpu_torch.data import native as PN
from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.models import GeometricInputConfig
from mapanything_tpu_torch.models import adapters as PA
from mapanything_tpu_torch.nn import adaptors as PAD
from mapanything_tpu_torch.ops import resize as PR
from mapanything_tpu_torch.utils import flops as PF

import torch_adapter_fakes as FK
from torch_eval_oracles import ListLoader

H, W = 28, 42
TOL = 1e-5
PRIOR_TOL = 1e-6


def batches(b, v, seed):
    """The same seeded synthetic batch from each package."""
    jb = jax_batch(b, v, H, W, seed=seed)
    pb = make_synthetic_batch(b, v, H, W, seed=seed, device="cpu")
    np.testing.assert_array_equal(np.asarray(jb["views"]["img"]),
                                  pb["views"]["img"].numpy())
    return jb, pb


def assert_matches_jax(port: dict, ref: dict, keys=PA.FACTORED_PRED_KEYS):
    assert set(keys) <= set(port), sorted(set(keys) - set(port))
    for key in keys:
        got, want = port[key].cpu().numpy(), np.asarray(ref[key])
        assert got.shape == want.shape, (key, got.shape, want.shape)
        if want.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            assert got.dtype == np.float32, (key, got.dtype)
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                       err_msg=key)


def one_batch_loader(pb):
    return ListLoader([{group: {k: v.numpy() for k, v in pb[group].items()}
                        for group in ("views", "gt")}])


# ---------------------------------------------------------------------------
# The torch-module adapters: VGGT, Pi3, MoGe


MODULES = {
    "vggt": (FK.VGGTStandIn, JA.VGGTAdapter, PA.VGGTAdapter),
    "pi3": (FK.Pi3StandIn, JA.Pi3Adapter, PA.Pi3Adapter),
    "moge": (FK.MoGeStandIn, JA.MoGeAdapter, PA.MoGeAdapter),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_adapter_matches_jax(name):
    make, jax_adapter, port_adapter = MODULES[name]
    jb, pb = batches(1, 2, seed=4)
    fake = make()
    ref = jax_adapter(fake).apply({}, jb["views"])
    adapter = port_adapter(fake)
    assert model_device(adapter) == torch.device("cpu")
    preds = adapter(pb["views"])
    assert_matches_jax(preds, ref)
    assert preds["pts3d"].shape == (1, 2, H, W, 3)
    assert all(torch.isfinite(preds[k]).all() for k in preds
               if preds[k].is_floating_point())
    np.testing.assert_allclose(
        torch.linalg.vector_norm(preds["ray_directions"], dim=-1), 1.0,
        atol=1e-5)
    np.testing.assert_allclose(preds["ray_directions"]
                               * preds["depth_along_ray"],
                               preds["pts3d_cam"], rtol=1e-4, atol=1e-5)
    assert not fake.training  # the adapter ran the module in eval()
    if name == "moge":  # one infer per view, per package
        assert fake.num_tokens_seen == [6] * 4  # max(2 * 3, 4)
        assert torch.equal(preds["pts3d"], preds["pts3d_cam"])
        assert not preds["non_ambiguous_mask"][..., :2].any()
        assert preds["non_ambiguous_mask"][..., 2:].all()


def test_moge_without_mask_head_and_one_view():
    jb, pb = batches(2, 1, seed=5)
    fake = FK.MoGeStandIn(with_mask=False)
    ref = JA.MoGeAdapter(fake).apply({}, jb["views"])
    preds = PA.MoGeAdapter(fake)(pb["views"])
    assert_matches_jax(preds, ref)
    assert preds["non_ambiguous_mask"].all()


def test_module_adapters_through_the_harnesses(tmp_path):
    """VGGT, Pi3 and MoGe through the port's unmodified dense N-view
    benchmark and RMVD evaluation, inside their inference mode."""
    _, pb = batches(1, 2, seed=6)
    for make, _, port_adapter in MODULES.values():
        adapter = port_adapter(make())
        out = run_dense_n_view_benchmark(
            adapter, one_batch_loader(pb), None,
            output_json=str(tmp_path / "dense.json"))
        assert out["num_sets"] == 1 and np.isfinite(out["pointmaps_abs_rel"])
    rmvd = RMVDAdaptor(PA.MoGeAdapter(FK.MoGeStandIn()),
                       inference_conditioning="image",
                       evaluate_single_view=True)
    imgs01 = PI.rgb(pb["views"]["img"][0].numpy())
    sample = {"images": [im.transpose(2, 0, 1)[None] for im in imgs01],
              "keyview_idx": 0,
              "gt_depth": pb["gt"]["pts3d_cam"][0, 0, ..., 2].numpy()}
    metrics = evaluate_mvs_depth(rmvd, [sample])
    assert metrics["num_samples"] == 1
    assert np.isfinite(metrics["depth_abs_rel"])


# ---------------------------------------------------------------------------
# The host-callable adapters: DUSt3R / MASt3R, MUSt3R, Pow3R, AnyCalib


def test_posed_depth_matches_jax_and_gt():
    jb, pb = batches(1, 3, seed=7)
    calls = []
    scene_fn = FK.posed_depth_scene_fn(pb, calls)
    ref = JA.DUSt3RAdapter(scene_fn).apply({}, jb["views"])
    adapter = PA.DUSt3RAdapter(scene_fn, device="cpu")
    assert adapter.device == torch.device("cpu")
    assert model_device(adapter) == torch.device("cpu")
    preds = adapter(pb["views"])
    assert calls == [(1, 3, H, W, 3)] * 2
    assert_matches_jax(preds, ref)
    gt = pb["gt"]
    # the conversion reproduces the GT scene (tests/test_adapters.py)
    np.testing.assert_allclose(preds["pts3d"], gt["pts3d"], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(preds["pts3d_cam"], gt["pts3d_cam"],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(preds["cam_trans"], gt["camera_pose_trans"],
                               atol=1e-4)


def test_mast3r_through_the_dense_benchmark(tmp_path):
    jb, pb = batches(1, 2, seed=8)
    scene_fn = FK.posed_depth_scene_fn(pb)
    assert_matches_jax(PA.MASt3RAdapter(scene_fn, device="cpu")(pb["views"]),
                       JA.MASt3RAdapter(scene_fn).apply({}, jb["views"]))
    out = run_dense_n_view_benchmark(
        PA.MASt3RAdapter(scene_fn, device="cpu"), one_batch_loader(pb), None,
        output_json=str(tmp_path / "mast3r.json"))
    assert out["pointmaps_abs_rel"] < 1e-2


def test_alignment_under_enable_grad_inside_inference_mode(tmp_path):
    """A scene pipeline that fits a scale with Adam under enable_grad, as
    DUSt3R's and MASt3R's global alignments do, through the port's dense
    benchmark, whose forwards run under torch.inference_mode."""
    jb, pb = batches(1, 2, seed=8)
    fitted = []
    adapter = PA.DUSt3RAdapter(FK.aligning_scene_fn(pb, fitted=fitted),
                               device="cpu")
    out = run_dense_n_view_benchmark(adapter, one_batch_loader(pb), None,
                                     output_json=str(tmp_path / "ga.json"))
    assert len(fitted) == 1 and fitted[0] > 1.5  # Adam moved it from 1
    # the benchmark's joint normalisation takes out the global scale
    assert out["pointmaps_abs_rel"] < 1e-2
    ref = JA.DUSt3RAdapter(FK.aligning_scene_fn(pb)).apply({}, jb["views"])
    with torch.inference_mode():
        assert_matches_jax(adapter(pb["views"]), ref)


def test_must3r_matches_jax_and_gt(tmp_path):
    jb, pb = batches(1, 3, seed=9)
    scene_fn = FK.must3r_scene_fn(pb)
    adapter = PA.MUSt3RAdapter(scene_fn, device="cpu")
    preds = adapter(pb["views"])
    assert_matches_jax(preds, JA.MUSt3RAdapter(scene_fn).apply({},
                                                               jb["views"]))
    np.testing.assert_allclose(preds["depth_along_ray"],
                               pb["gt"]["depth_along_ray"], rtol=1e-4,
                               atol=1e-5)
    out = run_dense_n_view_benchmark(adapter, one_batch_loader(pb), None,
                                     output_json=str(tmp_path / "m.json"))
    assert out["pointmaps_abs_rel"] < 1e-2


@pytest.mark.parametrize("priors", [True, False])
def test_pow3r_matches_jax_and_recovers_the_scale(priors):
    jb, pb = batches(1, 2, seed=10)
    seen = []
    pair_fn, w2c0, c2w = FK.pow3r_pair_fn(pb, calls=seen)
    prob = 1.0 if priors else 0.0
    kw = dict(overall_prob=prob, ray_dirs_prob=1.0, depth_prob=1.0,
              cam_prob=1.0)
    ref = JA.Pow3RAdapter(pair_fn, geom_cfg=JaxGeomCfg(**kw)).apply(
        {}, jb["views"])
    adapter = PA.Pow3RAdapter(pair_fn, geom_cfg=GeometricInputConfig(**kw),
                              device="cpu")
    preds = adapter(pb["views"])
    assert_matches_jax(preds, ref)
    jax_views, port_views = seen
    assert set(port_views[0]) == set(jax_views[0])
    if not priors:
        assert set(port_views[0]) == set(port_views[1]) == {"img"}
        return
    assert {"camera_intrinsics", "depthmap", "camera_pose"} <= set(
        port_views[0])
    np.testing.assert_allclose(port_views[0]["camera_intrinsics"][:, 0, 0],
                               0.8 * W, rtol=5e-2)
    np.testing.assert_allclose(port_views[0]["depthmap"][..., 0],
                               pb["gt"]["pts3d_cam"][:, 0, ..., 2],
                               rtol=1e-3, atol=1e-4)
    # the 0.5-scaled own-frame points recovered onto the GT scene
    want = (np.einsum("bij,bhwj->bhwi", w2c0[:, :3, :3],
                      pb["gt"]["pts3d"][:, 1].numpy())
            + w2c0[:, None, None, :3, 3])
    np.testing.assert_allclose(preds["pts3d"][:, 1], want, rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(preds["cam_trans"][:, 1],
                               (w2c0 @ c2w[:, 1])[:, :3, 3], atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pow3r_gates_admit_jax_priors(seed):
    """At probabilities 0.5 the two packages' gates, seeded alike, admit
    the same priors on each of 8 calls."""
    jb, pb = batches(1, 2, seed=11)
    half = dict(overall_prob=0.5, ray_dirs_prob=0.5, depth_prob=0.5,
                cam_prob=0.5)
    jax_seen, port_seen = [], []
    jax_adapter = JA.Pow3RAdapter(FK.pow3r_pair_fn(pb, calls=jax_seen)[0],
                                  geom_cfg=JaxGeomCfg(**half), seed=seed)
    port_adapter = PA.Pow3RAdapter(FK.pow3r_pair_fn(pb, calls=port_seen)[0],
                                   geom_cfg=GeometricInputConfig(**half),
                                   seed=seed, device="cpu")
    for _ in range(8):
        jax_adapter.apply({}, jb["views"])
        port_adapter(pb["views"])
    admitted = set()
    for jax_call, port_call in zip(jax_seen, port_seen, strict=True):
        for want, got in zip(jax_call, port_call):
            assert set(got) == set(want)
            admitted |= set(got)
            for key in set(got) - {"img"}:
                np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                           rtol=PRIOR_TOL, atol=PRIOR_TOL,
                                           err_msg=key)
    assert len(port_seen) == 8 and len(admitted) > 1


def test_pow3r_call_config_replaces_the_adapters():
    _, pb = batches(1, 2, seed=12)
    seen = []
    adapter = PA.Pow3RAdapter(FK.pow3r_pair_fn(pb, calls=seen)[0],
                              device="cpu")
    off = GeometricInputConfig(overall_prob=0.0)
    adapter(pb["views"], geom_cfg=off)
    adapter(pb["views"])  # the replaced config holds for later calls
    assert adapter.geom_cfg is off
    assert all(set(view) == {"img"} for call in seen for view in call)
    with pytest.raises(ValueError, match="2-view"):
        adapter({"img": pb["views"]["img"].repeat(1, 2, 1, 1, 1)})


def test_anycalib_matches_jax_and_the_calibration_benchmark(tmp_path):
    jb, pb = batches(2, 2, seed=12)
    calib_fn = FK.anycalib_calib_fn(H, W)
    adapter = PA.AnyCalibAdapter(calib_fn, device="cpu")
    preds = adapter(pb["views"])
    assert_matches_jax(preds, JA.AnyCalibAdapter(calib_fn).apply(
        {}, jb["views"]), keys=("ray_directions", "intrinsics"))
    assert preds["ray_directions"].shape == (2, 1, H, W, 3)
    assert preds["intrinsics"].shape == (2, 1, 3, 3)
    np.testing.assert_allclose(preds["ray_directions"],
                               pb["gt"]["ray_directions_cam"][:, :1],
                               rtol=1e-4, atol=1e-5)
    summary = run_calibration_benchmark(
        adapter, one_batch_loader(pb), None,
        output_json=str(tmp_path / "anycalib.json"))
    assert summary["num_images"] == 2
    assert summary["ray_angular_error_deg_mean"] < 1e-2


BUILDERS = [
    ("dust3r", lambda: PA.DUSt3RAdapter.from_pip("ckpt.pth", device="cpu")),
    ("mast3r", lambda: PA.MASt3RAdapter.from_pip("ckpt.pth", "cache",
                                                 device="cpu")),
    ("must3r", lambda: PA.MUSt3RAdapter.from_pip("ckpt.pth", device="cpu")),
    ("anycalib", lambda: PA.AnyCalibAdapter.from_pip(device="cpu")),
]


@pytest.mark.parametrize("package,build", BUILDERS,
                         ids=[name for name, _ in BUILDERS])
def test_from_pip_names_its_package(package, build):
    with pytest.raises(ImportError, match=package):
        build()


def test_callable_adapters_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for cls in (PA.DUSt3RAdapter, PA.MUSt3RAdapter, PA.Pow3RAdapter,
                PA.AnyCalibAdapter):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(lambda *a: None)


# ---------------------------------------------------------------------------
# The last public helpers


def _raw(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("ray_dirs_adaptor", ()),
    ("dense_adaptor_raydirs_depth_conf_mask", ()),
    ("dense_adaptor_pointmap", (False, False)),
    ("dense_adaptor_pointmap", (True, False)),
    ("dense_adaptor_pointmap", (True, True)),
])
def test_adaptors_match_jax(name, args):
    x = _raw((2, 5, 7, 3 if name == "ray_dirs_adaptor" else 6))
    ref = getattr(JAD, name)(jnp.asarray(x), *args)
    out = getattr(PAD, name)(torch.from_numpy(x), *args)
    if not isinstance(ref, dict):
        ref, out = {"out": ref}, {"out": out}
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=PRIOR_TOL, atol=PRIOR_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("out_hw", [(7, 11), (28, 42), (37, 19), (64, 90)])
def test_nearest_resize_matches_jax(out_hw):
    x = _raw((2, 28, 42, 3), seed=1)
    ref = np.asarray(JR.nearest_resize(jnp.asarray(x), out_hw))
    np.testing.assert_array_equal(
        PR.nearest_resize(torch.from_numpy(x), out_hw).numpy(), ref)


@pytest.mark.parametrize("layout", ["hwc", "nhwc", "chw", "nchw", "uint8"])
def test_rgb_matches_jax(layout):
    x = _raw((2, 9, 13, 3), seed=2)
    x = {"hwc": x[0], "nhwc": x, "chw": x[0].transpose(2, 0, 1),
         "nchw": x.transpose(0, 3, 1, 2),
         "uint8": np.random.default_rng(3).integers(
             0, 256, (9, 13, 3), dtype=np.uint8)}[layout]
    for norm in ("dinov2", "croco"):
        out, ref = PI.rgb(x, norm), JI.rgb(x, norm)
        assert out.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n,dim", [(1370, 1024), (2739, 1024), (1, 64)])
def test_attention_matmul_flops_matches_jax(n, dim):
    assert PF.attention_matmul_flops(n, dim) == JF.attention_matmul_flops(
        n, dim)


@pytest.mark.parametrize("src,dst", [((20, 30), (7, 11)),
                                     ((392, 518), (518, 518)),
                                     ((5, 4), (5, 4))])
def test_resize_normalize_u8_is_jax_bitwise(src, dst):
    img = np.random.default_rng(4).integers(0, 256, (*src, 3),
                                            dtype=np.uint8)
    mean, std = JI.IMAGE_NORMALIZATION_DICT["dinov2"]
    ref = JN.resize_normalize_u8(img, dst, mean, std)
    assert ref is not None, "the JAX package's native library did not build"
    np.testing.assert_array_equal(
        PN.resize_normalize_u8(img, dst, mean, std), ref)
    with pytest.raises(ValueError):
        PN.resize_normalize_u8(img[..., :2], dst, mean, std)
