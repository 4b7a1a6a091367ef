"""The port's benchmark harnesses (benchmarks/) against the JAX package's,
on the CPU.

The same seeded numpy batches go to both packages; models share JAX's
init carried across by utils/weights.py::load_jax_params (a tiny
MapAnything, fp32, the JAX side under jax.default_matmul_precision
("highest")). Tolerances, stated per test: `_normalize_for_metrics`
within 1e-5 of the reference's largest magnitude per output and
`compute_metrics_for_batch` within 1e-5 relative; the harnesses' summary
and per-set JSON through the tiny model within 1e-4 relative; the RMVD
adaptor's views within 1e-6 and its depth within 1e-4. A ground-truth
oracle (tests/torch_eval_oracles.py) must score zero error.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapanything_tpu.benchmarks import calibration as JCal
from mapanything_tpu.benchmarks import dense_n_view as JDense
from mapanything_tpu.benchmarks import rmvd as JRmvd
from mapanything_tpu.data.synthetic import make_synthetic_batch as jax_batch
from mapanything_tpu.models import GeometricInputConfig as JaxGeomCfg
from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.models import images_only_config as jax_images_only
from mapanything_tpu_torch.benchmarks import calibration as PCal
from mapanything_tpu_torch.benchmarks import dense_n_view as PDense
from mapanything_tpu_torch.benchmarks import rmvd as PRmvd
from mapanything_tpu_torch.models import (
    GeometricInputConfig,
    MapAnything,
    MapAnythingConfig,
    images_only_config,
)
from mapanything_tpu_torch.models.adapters import MapAnythingAdapter
from mapanything_tpu_torch.utils.device import to_device
from mapanything_tpu_torch.utils.weights import load_jax_params
from torch_eval_oracles import GroundTruthOracle, ListLoader, RecordingLoader
from torch_jax_init import init_params

HIGHEST = "highest"
H, W = 28, 42  # 2 x 3 patches of 14
TINY = dict(encoder_size="test", trunk_dim=64, trunk_depth=2,
            trunk_num_heads=2, trunk_indices=(0, 1), dpt_feature_dim=32,
            dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
NORM_TOL = 1e-5
METRIC_TOL = 1e-5
HARNESS_TOL = 1e-4


def numpy_batch(b, v, seed):
    """JAX's synthetic batch as writable numpy arrays, as a loader gives."""
    return jax.tree_util.tree_map(np.array, jax_batch(b, v, H, W, seed=seed))


def fake_preds(gt, seed):
    """Predictions near the GT: noisy points, perturbed poses, a metric
    scale away from 1 (numpy, the factored keys the harness reads)."""
    rng = np.random.default_rng(seed)
    b, v = gt["pts3d"].shape[:2]
    s = rng.uniform(0.5, 2.0, (b,)).astype(np.float32)

    def noisy(x, scale):
        return (x * (1 + scale * rng.standard_normal(x.shape))).astype(
            np.float32)

    quats = gt["camera_pose_quats"] + 0.05 * rng.standard_normal(
        gt["camera_pose_quats"].shape)
    quats = (quats / np.linalg.norm(quats, axis=-1, keepdims=True)).astype(
        np.float32)
    return {
        "pts3d": noisy(gt["pts3d"], 0.05) * s[:, None, None, None, None],
        "pts3d_cam": (noisy(gt["pts3d_cam"], 0.05)
                      * s[:, None, None, None, None]),
        "cam_quats": quats,
        "cam_trans": noisy(gt["camera_pose_trans"], 0.1) * s[:, None, None],
        "metric_scaling_factor": s,
    }


def rel_max(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def close_dicts(got, ref, tol):
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=tol, atol=tol,
                                   err_msg=key)


def test_normalize_for_metrics_matches_jax():
    batch = numpy_batch(2, 3, seed=1)
    gt, preds = batch["gt"], fake_preds(batch["gt"], 2)
    with jax.default_matmul_precision(HIGHEST):
        ref = JDense._normalize_for_metrics(
            jax.tree_util.tree_map(jnp.asarray, gt),
            jax.tree_util.tree_map(jnp.asarray, preds))
    got = PDense._normalize_for_metrics(to_device(gt, "cpu"),
                                        to_device(preds, "cpu"))
    assert set(got) == set(ref)
    for key in ref:
        assert tuple(got[key].shape) == ref[key].shape, key
        if key == "valid":
            assert np.array_equal(got[key].numpy(), np.asarray(ref[key]))
        else:
            assert rel_max(got[key], ref[key]) <= NORM_TOL, key


def near_threshold_share(q, i, gt_key, pr_key, thresh=1.03, eps=1e-4):
    """The share of set i's valid points whose ratio max(gt/pr, pr/gt) lies
    within eps (relative) of the inlier threshold: points whose inlier
    decision fp32 rounding of the normalisation may flip."""
    v = q["valid"].shape[1]
    valid = np.asarray(q["valid"][i]).reshape(v, -1)
    g = np.linalg.norm(np.asarray(q[gt_key][i]).reshape(v, valid.shape[1],
                                                        -1), axis=-1)
    p = np.linalg.norm(np.asarray(q[pr_key][i]).reshape(v, valid.shape[1],
                                                        -1), axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.maximum(g / p, p / g)
    near = np.abs(ratio - thresh) <= eps * thresh
    return float((near & valid & (g > 0)).sum() / max(valid.sum(), 1))


def test_compute_metrics_for_batch_matches_jax():
    """Within 1e-5 relative, but for the inlier ratios, which may differ
    by the share of points whose ratio lies within fp32 rounding of the
    1.03 threshold (counted on the reference's normalised arrays)."""
    batch = numpy_batch(3, 4, seed=3)
    gt, preds = batch["gt"], fake_preds(batch["gt"], 4)
    jgt = jax.tree_util.tree_map(jnp.asarray, gt)
    jpreds = jax.tree_util.tree_map(jnp.asarray, preds)
    with jax.default_matmul_precision(HIGHEST):
        ref = JDense.compute_metrics_for_batch(jgt, jpreds)
        q = JDense._normalize_for_metrics(jgt, jpreds)
    got = PDense.compute_metrics_for_batch(to_device(gt, "cpu"),
                                           to_device(preds, "cpu"))
    assert len(got) == len(ref) == 3
    inliers = {"pointmaps_inlier_thres_103": ("gt_pts", "pr_pts"),
               "depth_inlier_thres_103": ("gt_depth_z", "pr_depth_z")}
    for i, (g, r) in enumerate(zip(got, ref)):
        assert set(g) == set(r)
        close_dicts({k: g[k] for k in g if k not in inliers},
                    {k: r[k] for k in r if k not in inliers}, METRIC_TOL)
        for key, (gk, pk) in inliers.items():
            assert abs(g[key] - r[key]) <= (
                near_threshold_share(q, i, gk, pk) + METRIC_TOL), key


@pytest.fixture(scope="module")
def tiny_models():
    """The JAX MapAnything at a tiny size, its perturbed params (holding
    every prior encoder), and the port's model with them."""
    jmodel = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **TINY))
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(
            np.shape(x))).astype(np.float32), init_params(jmodel, H, W))
    pmodel = load_jax_params(
        MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY),
                    device="cpu"), params).eval()
    return jmodel, params, pmodel


@pytest.mark.parametrize("task", ["images_only", "all_priors"])
def test_dense_n_view_benchmark_matches_jax(tiny_models, task, tmp_path):
    jmodel, params, pmodel = tiny_models
    batches = [numpy_batch(2, 2, seed=6), numpy_batch(2, 2, seed=7)]
    jcfg, pcfg = ((jax_images_only(), images_only_config())
                  if task == "images_only"
                  else (JaxGeomCfg(), GeometricInputConfig()))
    with jax.default_matmul_precision(HIGHEST):
        ref = JDense.run_dense_n_view_benchmark(
            jmodel, params, ListLoader(batches), jcfg,
            output_json=str(tmp_path / "jax.json"))
    got = PDense.run_dense_n_view_benchmark(
        pmodel, ListLoader(batches), pcfg, output_json=str(tmp_path / "p.json"))
    assert got["num_sets"] == ref["num_sets"] == 4
    close_dicts(got, ref, HARNESS_TOL)
    got_json = json.loads((tmp_path / "p.json").read_text())
    ref_json = json.loads((tmp_path / "jax.json").read_text())
    assert set(got_json) == set(ref_json) == {"summary", "per_set"}
    for g, r in zip(got_json["per_set"], ref_json["per_set"],
                    strict=True):
        close_dicts(g, r, HARNESS_TOL)


def test_dense_n_view_through_the_adapter_seam(tiny_models):
    """MapAnythingAdapter gives what the model gives, geom_cfg None being
    the model's default (images only)."""
    pmodel = tiny_models[2]
    batches = [numpy_batch(2, 2, seed=8)]
    direct = PDense.run_dense_n_view_benchmark(pmodel, ListLoader(batches),
                                               images_only_config())
    seam = PDense.run_dense_n_view_benchmark(MapAnythingAdapter(pmodel),
                                             ListLoader(batches), None)
    assert seam == direct


def test_calibration_benchmark_matches_jax(tiny_models, tmp_path):
    jmodel, params, pmodel = tiny_models
    batches = [numpy_batch(3, 2, seed=9)]
    with jax.default_matmul_precision(HIGHEST):
        ref = JCal.run_calibration_benchmark(
            jmodel, params, ListLoader(batches), jax_images_only(),
            output_json=str(tmp_path / "jax.json"))
    got = PCal.run_calibration_benchmark(
        pmodel, ListLoader(batches), images_only_config(),
        output_json=str(tmp_path / "p.json"))
    assert got["num_images"] == ref["num_images"] == 3
    close_dicts(got, ref, HARNESS_TOL)
    np.testing.assert_allclose(
        json.loads((tmp_path / "p.json").read_text())["per_image"],
        json.loads((tmp_path / "jax.json").read_text())["per_image"],
        rtol=HARNESS_TOL)


def test_ray_angular_error_matches_jax():
    rng = np.random.default_rng(10)
    a = rng.normal(size=(2, 1, 5, 6, 3)).astype(np.float32)
    b = a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
    ref = np.asarray(JCal.ray_angular_error_deg(jnp.asarray(a),
                                                jnp.asarray(b)))
    got = PCal.ray_angular_error_deg(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_ground_truth_oracle_scores_zero_error():
    loader = RecordingLoader(ListLoader([numpy_batch(2, 4, seed=11),
                                     numpy_batch(2, 4, seed=12)]))
    summary = PDense.run_dense_n_view_benchmark(
        GroundTruthOracle(loader, "cpu"), loader, None)
    assert summary["num_sets"] == 4
    assert summary["pointmaps_abs_rel"] <= 1e-5
    assert summary["depth_abs_rel"] <= 1e-5
    assert summary["pointmaps_inlier_thres_103"] == 1.0
    assert summary["depth_inlier_thres_103"] == 1.0
    assert summary["pose_ate_rmse"] <= 1e-4
    assert summary["pose_auc_5"] == 1.0
    assert summary["scale_abs_rel"] <= 1e-5


@pytest.mark.parametrize("degrees", [0.0, 1.0])
def test_calibration_oracle(degrees):
    loader = RecordingLoader(ListLoader([numpy_batch(3, 2, seed=13)]))
    summary = PCal.run_calibration_benchmark(
        GroundTruthOracle(loader, "cpu", ray_rotation_deg=degrees), loader,
        None)
    assert summary["num_images"] == 3
    assert abs(summary["ray_angular_error_deg_mean"] - degrees) <= 1e-3


# --- RMVD -------------------------------------------------------------------


def rmvd_sample(seed, views=3, keyview=1, h=H, w=W, uint8=True):
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 255, size=(1, 3, h, w)).astype(np.uint8)
              if uint8 else rng.uniform(0, 1, (1, 3, h, w)).astype(np.float32)
              for _ in range(views)]
    ks, poses = [], []
    for i in range(views):
        f = w * (0.8 + 0.1 * i)
        ks.append(np.array([[[f, 0, w / 2 + i], [0, f, h / 2 - i],
                             [0, 0, 1]]], np.float32))
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = q * np.sign(np.linalg.det(q))
        pose[:3, 3] = rng.normal(size=3)
        if i == keyview:
            pose = np.eye(4, dtype=np.float32)
        poses.append(pose[None])
    return {"images": images, "keyview_idx": keyview, "intrinsics": ks,
            "poses": poses,
            "gt_depth": rng.uniform(1, 4, size=(h, w)).astype(np.float32)}


CONDITIONINGS = ["image", "image+intrinsics", "image+intrinsics+pose"]


@pytest.mark.parametrize("conditioning", CONDITIONINGS)
@pytest.mark.parametrize("single_view", [False, True])
@pytest.mark.parametrize("uint8", [True, False])
def test_rmvd_input_adapter_matches_jax(tiny_models, conditioning,
                                        single_view, uint8):
    jmodel, params, pmodel = tiny_models
    s = rmvd_sample(14, uint8=uint8)
    jad = JRmvd.RMVDAdaptor(jmodel, params,
                            inference_conditioning=conditioning,
                            evaluate_single_view=single_view)
    pad = PRmvd.RMVDAdaptor(pmodel, inference_conditioning=conditioning,
                            evaluate_single_view=single_view)
    args = (s["images"], s["keyview_idx"], s["poses"], s["intrinsics"])
    ref = jad.input_adapter(*args)
    got = pad.input_adapter(*args)
    assert set(got) == set(ref)
    for key in ref:
        assert tuple(got[key].shape) == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-6, err_msg=key)
    assert got["img"].shape[1] == (1 if single_view else 3)
    # the key view first: its image is view 0
    np.testing.assert_allclose(
        got["img"][0, 0].numpy(),
        ((s["images"][1][0].transpose(1, 2, 0) / (255.0 if uint8 else 1.0))
         - np.array([0.485, 0.456, 0.406])) / np.array([0.229, 0.224, 0.225]),
        atol=1e-5)


def test_rmvd_call_and_output_adapter_match_jax(tiny_models):
    jmodel, params, pmodel = tiny_models
    s = rmvd_sample(15)
    conditioning = "image+intrinsics+pose"
    jad = JRmvd.RMVDAdaptor(jmodel, params,
                            inference_conditioning=conditioning)
    pad = PRmvd.RMVDAdaptor(pmodel, inference_conditioning=conditioning)
    args = (s["images"], s["keyview_idx"], s["poses"], s["intrinsics"])
    with jax.default_matmul_precision(HIGHEST):
        ref, ref_aux = jad.output_adapter(jad(jad.input_adapter(*args)))
    got, aux = pad.output_adapter(pad(pad.input_adapter(*args)))
    assert aux == ref_aux == {}
    assert set(got) == set(ref) == {"depth", "depth_uncertainty"}
    for key in ref:
        assert got[key].shape == ref[key].shape == (1, 1, H, W)
        assert rel_max(got[key], ref[key]) <= HARNESS_TOL, key


@pytest.mark.parametrize("align_scale", [True, False])
def test_evaluate_mvs_depth_matches_jax(tiny_models, align_scale):
    jmodel, params, pmodel = tiny_models
    samples = [rmvd_sample(16), rmvd_sample(17, keyview=0)]
    samples.append(dict(rmvd_sample(18), gt_depth=np.zeros((H, W),
                                                           np.float32)))
    jad = JRmvd.RMVDAdaptor(jmodel, params,
                            inference_conditioning="image+intrinsics")
    pad = PRmvd.RMVDAdaptor(pmodel, inference_conditioning="image+intrinsics")
    with jax.default_matmul_precision(HIGHEST):
        ref = JRmvd.evaluate_mvs_depth(jad, samples, align_scale)
    got = PRmvd.evaluate_mvs_depth(pad, samples, align_scale)
    assert got["num_samples"] == ref["num_samples"] == 2  # no valid GT: out
    close_dicts(got, ref, HARNESS_TOL)


def test_rmvd_adaptor_refuses_unknown_conditioning(tiny_models):
    with pytest.raises(ValueError, match="conditioning"):
        PRmvd.RMVDAdaptor(tiny_models[2], inference_conditioning="depth")
