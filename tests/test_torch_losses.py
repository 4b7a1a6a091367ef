"""The port's training losses and their geometry against the JAX package.

Every check feeds the same seeded numpy inputs to the JAX function and to its
port, at fp32; the JAX side runs under jax.default_matmul_precision
("highest"). Tolerances: rtol 1e-5 with atol 1e-6 of the array's largest
magnitude (elements that cancel to near zero) for the geometry, the
synthetic batch, every criterion's total and every entry of its details;
gradients 1e-4 of the reference's max-abs per tensor. Both sides compute
the same fp32 formulas and differ in summation order only.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu import geometry as JG
from mapanything_tpu.data.synthetic import make_synthetic_batch as jax_batch
from mapanything_tpu.train import criteria as JC
from mapanything_tpu.train import losses as JL
from mapanything_tpu_torch import geometry as PG
from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.train import criteria as PC
from mapanything_tpu_torch.train import losses as PL

HIGHEST = "highest"
RTOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(out, ref, name=""):
    ref = _np(ref)
    atol = 1e-6 * float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(_np(out), ref, rtol=RTOL, atol=atol,
                               err_msg=name)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _quats(rng, *lead):
    q = _rand(rng, *lead, 4) * np.float32([0.3, 0.3, 0.3, 1.0])
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# --- geometry -------------------------------------------------------------------


def _geometry_cases():
    rng = np.random.default_rng(0)
    pts = _rand(rng, 2, 3, 5, 6, 3)
    valid = rng.random((2, 3, 5, 6)) > 0.3
    pts[~valid] = 0  # masked pixels are exact zeros
    k = np.tile(np.float32([[30, 0, 10], [0, 28, 7], [0, 0, 1]]), (2, 3, 1, 1))
    depth = np.abs(_rand(rng, 2, 3, 5, 6)) + 0.5
    pose = np.asarray(JG.pose_quats_trans_to_matrix(
        jnp.asarray(_quats(rng, 2, 3)), jnp.asarray(_rand(rng, 2, 3, 3))))
    cases = {
        "safe_norm": ("safe_norm", (pts,), {}),
        "apply_log_to_norm": ("apply_log_to_norm", (pts,), {}),
        "quaternion_inverse": ("quaternion_inverse", (_quats(rng, 4),), {}),
        "quaternion_multiply": ("quaternion_multiply",
                                (_quats(rng, 4), _quats(rng, 4)), {}),
        "transform_pose": ("transform_pose_using_quats_and_trans_2_to_1",
                           (_quats(rng, 4), _rand(rng, 4, 3),
                            _quats(rng, 4), _rand(rng, 4, 3)), {}),
        "angle_diff_vec3": ("angle_diff_vec3",
                            (_rand(rng, 7, 3), _rand(rng, 7, 3)), {}),
        "depthmap_to_camera_frame": ("depthmap_to_camera_frame", (depth, k),
                                     {}),
        "depthmap_to_world_frame": ("depthmap_to_world_frame",
                                    (depth, k, pose), {}),
        "get_rays_in_camera_frame": ("get_rays_in_camera_frame", (k, 5, 6),
                                     {"normalize_to_unit_sphere": True}),
    }
    for mode in ("avg_dis", "avg_log1p", "avg_warp-log1p"):
        cases[f"normalize_{mode}"] = ("normalize_multiple_pointclouds",
                                      (pts, valid, mode),
                                      {"ret_factor": True})
    return cases


_GEOMETRY = _geometry_cases()


@pytest.mark.parametrize("case", sorted(_GEOMETRY))
def test_geometry_matches_jax(case):
    name, args, kw = _GEOMETRY[case]
    with jax.default_matmul_precision(HIGHEST):
        ref = getattr(JG, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                  else a for a in args], **kw)
    out = getattr(PG, name)(*[torch.tensor(a)
                              if isinstance(a, np.ndarray) else a
                              for a in args], **kw)
    if not isinstance(ref, tuple):
        ref, out = (ref,), (out,)
    for o, r in zip(out, ref):
        _close(o, r, case)


def test_safe_norm_gradient_at_zero_matches_jax():
    """A masked pixel is an exact zero vector: both give gradient 0 there."""
    x = np.float32([[0.0, 0.0, 0.0], [3.0, -4.0, 12.0]])
    ref = jax.grad(lambda a: JG.safe_norm(a).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    PG.safe_norm(xt).sum().backward()
    assert np.isfinite(_np(xt.grad)).all()
    assert not xt.grad[0].any()
    _close(xt.grad, ref)


# --- synthetic batch --------------------------------------------------------------


def test_synthetic_batch_matches_jax():
    with jax.default_matmul_precision(HIGHEST):
        ref = jax_batch(2, 3, 14, 21, seed=5)
    out = make_synthetic_batch(2, 3, 14, 21, seed=5)
    for part in ("views", "gt"):
        assert set(out[part]) == set(ref[part])
        for key in ref[part]:
            r = np.asarray(ref[part][key])
            o = _np(out[part][key])
            assert o.shape == r.shape and o.dtype == r.dtype, (part, key)
            _close(o, r, f"{part}/{key}")


# --- criteria ---------------------------------------------------------------------

B, V, H, W = 2, 3, 14, 21


def _loss_inputs(synthetic, seed=0):
    """A GT batch from make_synthetic_batch with random invalid pixels, view
    2 of sample 0 without any valid pixel, sample 1 non-metric; predictions
    near the GT (scaled by the predicted metric factor)."""
    with jax.default_matmul_precision(HIGHEST):
        gt = {k: np.asarray(v)
              for k, v in jax_batch(B, V, H, W, seed=seed)["gt"].items()}
    rng = np.random.default_rng(seed + 100)
    gt["valid_mask"] = gt["valid_mask"] & (rng.random((B, V, H, W)) > 0.2)
    gt["valid_mask"][0, 2] = False
    gt["non_ambiguous_mask"] = rng.random((B, V, H, W)) > 0.3
    gt["is_metric_scale"] = np.array([True, False])
    gt["is_synthetic"] = np.array(synthetic)

    s = np.float32([1.3, 0.7])
    preds = {
        "metric_scaling_factor": s,
        "pts3d": (gt["pts3d"] + _rand(rng, B, V, H, W, 3, scale=0.1))
        * s[:, None, None, None, None],
        "pts3d_cam": (gt["pts3d_cam"] + _rand(rng, B, V, H, W, 3, scale=0.1))
        * s[:, None, None, None, None],
        "depth_along_ray": (gt["depth_along_ray"]
                            + _rand(rng, B, V, H, W, 1, scale=0.1))
        * s[:, None, None, None, None],
        "ray_directions": gt["ray_directions_cam"]
        + _rand(rng, B, V, H, W, 3, scale=0.05),
        "cam_trans": (gt["camera_pose_trans"] + _rand(rng, B, V, 3, scale=0.1))
        * s[:, None, None],
        "cam_quats": _quats(rng, B, V),
        "conf": 1 + np.exp(_rand(rng, B, V, H, W)),
        "non_ambiguous_mask_logits": _rand(rng, B, V, H, W, scale=2.0),
    }
    return gt, preds


def _crit(name, C):
    crit = C.RobustRegressionLoss(alpha=0.5, scaling_c=0.05)
    scale = C.FactoredGeometryScaleRegr3D(crit)
    return {
        "factored_regr3d": lambda: C.FactoredGeometryRegr3D(crit),
        "factored_scale_regr3d": lambda: scale,
        "plus_normal_gm": lambda: C.FactoredGeometryScaleRegr3DPlusNormalGMLoss(
            crit, normal_loss_weight=3.0, gm_loss_weight=3.0),
        "conf": lambda: C.ConfLoss(scale, alpha=0.2),
        "exclude_top_n": lambda: C.ExcludeTopNPercentPixelLoss(
            scale, top_n_percent=5, loss_set_indices=[1, 2]),
        "conf_and_exclude": lambda: C.ConfAndExcludeTopNPercentPixelLoss(
            scale, conf_alpha=0.2, top_n_percent=5,
            conf_loss_set_indices=[0], exclude_loss_set_indices=[1, 2]),
        "non_ambiguous_mask": lambda: 0.3 * C.NonAmbiguousMaskLoss(
            C.BCELoss()),
        "released": C.released_criterion,
    }[name]()


_SYNTHETIC = {"real": [False, False], "synthetic": [True, True],
              "mixed": [True, False]}
_CRITERIA = ["factored_regr3d", "factored_scale_regr3d", "plus_normal_gm",
             "conf", "exclude_top_n", "conf_and_exclude",
             "non_ambiguous_mask", "released"]


def _loss_config(name, L):
    """The options of overall_loss's configs, set away from the defaults."""
    fc = L.FactoredGeometryConfig
    return {
        "pairwise_pose": L.OverallLossConfig(
            factored=fc(compute_pairwise_relative_pose_loss=True)),
        "z_depth_no_log": L.OverallLossConfig(
            factored=fc(depth_type_for_loss="z", loss_in_log=False)),
        "unnormed_predictions": L.OverallLossConfig(
            factored=fc(norm_predictions=False)),
        "warp_log1p": L.OverallLossConfig(
            factored=fc(norm_mode="avg_warp-log1p")),
        "no_world_points_weighted": L.OverallLossConfig(
            factored=fc(compute_world_frame_points_loss=False,
                        weights=(1.0, 0.5, 2.0, 1.5, 0.7, 1.2, 0.4))),
        "no_normal_gm": L.OverallLossConfig(
            use_normal_gm=False, conf_alpha=0.5, top_n_percent=10.0,
            mask_loss_weight=0.1, criterion_alpha=1.0,
            criterion_scaling_c=0.1),
    }[name]


_LOSS_CONFIGS = ["pairwise_pose", "z_depth_no_log", "unnormed_predictions",
                 "warp_log1p", "no_world_points_weighted", "no_normal_gm"]


def _to_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _to_torch(d):
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def _check_details(out, ref):
    (loss, det), (rloss, rdet) = out, ref
    _close(loss, rloss, "total")
    assert set(det) == set(rdet)
    for key in rdet:
        _close(det[key], rdet[key], key)


@pytest.mark.parametrize("data", ["real", "mixed"])
@pytest.mark.parametrize("name", _CRITERIA)
def test_criterion_matches_jax(name, data):
    gt, preds = _loss_inputs(_SYNTHETIC[data])
    with jax.default_matmul_precision(HIGHEST):
        ref = _crit(name, JC)(_to_jax(gt), _to_jax(preds))
    _check_details(_crit(name, PC)(_to_torch(gt), _to_torch(preds)), ref)


@pytest.mark.parametrize("data", sorted(_SYNTHETIC))
def test_overall_loss_matches_jax(data):
    gt, preds = _loss_inputs(_SYNTHETIC[data], seed=1)
    with jax.default_matmul_precision(HIGHEST):
        ref = JL.overall_loss(_to_jax(gt), _to_jax(preds))
    out = PL.overall_loss(_to_torch(gt), _to_torch(preds))
    _check_details(out, ref)
    assert "total" in out[1]


@pytest.mark.parametrize("data", ["real", "mixed"])
@pytest.mark.parametrize("config", _LOSS_CONFIGS)
def test_overall_loss_config_matches_jax(config, data):
    gt, preds = _loss_inputs(_SYNTHETIC[data], seed=3)
    with jax.default_matmul_precision(HIGHEST):
        ref = JL.overall_loss(_to_jax(gt), _to_jax(preds),
                              _loss_config(config, JL))
    _check_details(PL.overall_loss(_to_torch(gt), _to_torch(preds),
                                   _loss_config(config, PL)), ref)


def test_overall_loss_gradient_matches_jax():
    """d overall_loss / d preds, every float prediction."""
    gt, preds = _loss_inputs(_SYNTHETIC["mixed"], seed=2)
    keys = [k for k, v in preds.items() if v.dtype == np.float32]

    def jax_loss(p):
        return JL.overall_loss(_to_jax(gt), {**_to_jax(preds), **p})[0]

    with jax.default_matmul_precision(HIGHEST):
        ref = jax.jit(jax.grad(jax_loss))(
            {k: jnp.asarray(preds[k]) for k in keys})
    leaves = {k: torch.from_numpy(preds[k]).requires_grad_() for k in keys}
    PL.overall_loss(_to_torch(gt), {**_to_torch(preds), **leaves})[0].backward()
    for k in keys:
        r = np.asarray(ref[k])
        o = _np(leaves[k].grad)
        assert np.isfinite(o).all(), k
        err = np.abs(o - r).max()
        assert err <= 1e-4 * np.abs(r).max(), f"d{k}: {err:.3g}"


def test_keep_bottom_n_ties_follow_stable_order():
    """Equal losses: the earlier pixel ranks first, as in JAX's stable
    argsort."""
    loss = np.float32([[1.0, 2.0, 2.0, 2.0, 0.5, 2.0, 3.0, 2.0, 2.0, 2.0]])
    valid = np.ones_like(loss, bool)
    valid[0, 1] = False
    ref = JC._keep_bottom_n_mask(jnp.asarray(loss), jnp.asarray(valid), 60.0)
    out = PC._keep_bottom_n_mask(torch.from_numpy(loss),
                                 torch.from_numpy(valid), 60.0)
    np.testing.assert_array_equal(_np(out), np.asarray(ref))
