"""The criteria outside the released recipe, and the rest of losses.py,
against the JAX package; and the composed criteria trained on their scene
representations.

Each criterion gets the same seeded inputs on both sides: the GT batch and
the predictions of tests/test_torch_losses.py::_loss_inputs (invalid and
ambiguous pixels, a view with no valid pixel, one metric and one non-metric
sample), on mixed data (a synthetic metric sample beside a real non-metric
one), and where synthetic samples take another path also on real and
synthetic data. Every option of the JAX constructors is set away from its
default in some case. Limits, as tests/test_torch_losses.py: the total and
every entry of the details within rtol 1e-5 and atol 1e-6 of the largest
magnitude, at fp32; the gradient with respect to the predictions within
1e-4 of the reference's max-abs per tensor, JAX's in fp64 (as
tests/test_torch_seq_parallel.py's), the port's at fp32.

One case runs both packages in fp64: the confidence-weighted set of the
disentangled loss, loss * conf - alpha * log(conf), cancels to about a sixth
of its parts, and each package's fp32 rounding of the recombined pointmaps
leaves its parts ~5e-6 off the fp64 value (in opposite directions), which
that cancellation lifts past rtol 1e-5; in fp64 the two agree to ~1e-11.

The composed steps (chip_smoke.py's 16b: forward, criterion, backward) train
ConfLoss(Regr3D) on a pointmap model and ConfLoss(PointsPlusScaleRegr3D) on
a raymap+depth model, each plus the mask loss, against JAX's at
tests/test_torch_train_variants.py's limits; the disentangled criterion's
step is there, on the model it shares with a variant.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapanything_tpu.data.synthetic import make_synthetic_batch as jax_batch
from mapanything_tpu.train import criteria as JC
from mapanything_tpu.train import losses as JL
from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.models import dense_dim_for
from mapanything_tpu_torch.train import criteria as PC
from mapanything_tpu_torch.train import losses as PL
from test_torch_losses import (
    _SYNTHETIC,
    _check_details,
    _close,
    _loss_inputs,
    _np,
    _rand,
    _to_jax,
    _to_torch,
)
from test_torch_train_variants import (
    check_step,
    composed,
    jax_reference,
    model_pair,
    port_loss_and_grads,
)

HIGHEST = "highest"
# below every GT distance: the metric sample becomes non-metric
MAX_METRIC = 1e-3


def _criterion(name, C):
    robust = C.RobustRegressionLoss(alpha=0.5, scaling_c=0.05)
    mask = 0.3 * C.NonAmbiguousMaskLoss(C.BCELoss())
    disentangled_gm = (
        C.DisentangledFactoredGeometryScaleRegr3DPlusNormalGMLoss(
            robust, normal_loss_weight=3.0, gm_loss_weight=3.0))
    return {
        "regr3d": lambda: C.Regr3D(robust),
        "regr3d_norm_all_l2": lambda: C.Regr3D(C.L2Loss(),
                                               norm_mode="avg_dis"),
        "regr3d_gt_scale": lambda: C.Regr3D(robust, gt_scale=True),
        "regr3d_ambiguous_max_metric": lambda: C.Regr3D(
            C.L1Loss(), ambiguous_loss_value=2.0,
            max_metric_scale=MAX_METRIC, loss_in_log=False),
        "points_plus_scale": lambda: C.PointsPlusScaleRegr3D(robust),
        "points_plus_scale_options": lambda: C.PointsPlusScaleRegr3D(
            C.GenericLLoss("l1"), norm_predictions=False,
            ambiguous_loss_value=1.5, flatten_across_image_only=True,
            world_frame_points_loss_weight=0.5, scale_loss_weight=2.0),
        "factored_norm_all": lambda: C.FactoredGeometryRegr3D(
            robust, norm_mode="avg_dis"),
        "factored_gt_scale": lambda: C.FactoredGeometryRegr3D(
            C.FactoredLLoss(), gt_scale=True),
        "factored_ambiguous_max_metric": lambda: C.FactoredGeometryRegr3D(
            robust, ambiguous_loss_value=1.0, max_metric_scale=MAX_METRIC,
            flatten_across_image_only=True),
        "factored_log1p_pairwise": lambda: C.FactoredGeometryRegr3D(
            C.GenericLLoss("l2"), norm_mode="?avg_log1p",
            compute_pairwise_relative_pose_loss=True),
        "factored_scale_factored_l": lambda: C.FactoredGeometryScaleRegr3D(
            C.FactoredLLoss(), norm_mode="avg_dis"),
        "factored_scale_ambiguous": lambda: C.FactoredGeometryScaleRegr3D(
            robust, ambiguous_loss_value=0.5),
        "plus_normal_gm_every_sample": lambda: (
            C.FactoredGeometryScaleRegr3DPlusNormalGMLoss(
                robust,
                apply_normal_and_gm_loss_to_synthetic_data_only=False)),
        "disentangled": lambda: C.DisentangledFactoredGeometryScaleRegr3D(
            robust),
        "disentangled_options": lambda: (
            C.DisentangledFactoredGeometryScaleRegr3D(
                C.FactoredLLoss(), norm_predictions=False, loss_in_log=False,
                depth_loss_weight=0.5, ray_directions_loss_weight=2.0,
                pose_quats_loss_weight=0.7, pose_trans_loss_weight=1.3,
                scale_loss_weight=2.0)),
        "disentangled_normal_gm": lambda: disentangled_gm,
        "conf_regr3d_mask": lambda: C.ConfLoss(C.Regr3D(robust),
                                               alpha=0.2) + mask,
        "exclude_every_sample": lambda: C.ExcludeTopNPercentPixelLoss(
            C.PointsPlusScaleRegr3D(robust), top_n_percent=10,
            apply_to_real_data_only=False, loss_set_indices=[0]),
        "conf_exclude_disentangled": lambda: (
            C.ConfAndExcludeTopNPercentPixelLoss(
                disentangled_gm, conf_alpha=0.2, top_n_percent=5,
                conf_loss_set_indices=[0], exclude_loss_set_indices=[1, 3])
            + mask),
        "weighted_sum": lambda: (
            0.5 * C.Regr3D(C.L2Loss())
            + 2.0 * C.DisentangledFactoredGeometryScaleRegr3D(robust)),
    }[name]()


_CRITERIA = ["regr3d", "regr3d_norm_all_l2", "regr3d_gt_scale",
             "regr3d_ambiguous_max_metric", "points_plus_scale",
             "points_plus_scale_options", "factored_norm_all",
             "factored_gt_scale", "factored_ambiguous_max_metric",
             "factored_log1p_pairwise", "factored_scale_factored_l",
             "factored_scale_ambiguous", "plus_normal_gm_every_sample",
             "disentangled", "disentangled_options",
             "disentangled_normal_gm", "conf_regr3d_mask",
             "exclude_every_sample", "conf_exclude_disentangled",
             "weighted_sum"]
# the criteria whose synthetic samples take another path
_SYNTHETIC_PATHS = ["plus_normal_gm_every_sample", "disentangled_normal_gm",
                    "exclude_every_sample", "conf_exclude_disentangled"]


_FP64 = ["conf_exclude_disentangled"]


def _f64(d):
    return {k: np.asarray(v, np.float64) if np.asarray(v).dtype ==
            np.float32 else np.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("data,name", [("mixed", name) for name in _CRITERIA]
                         + [(data, name) for name in _SYNTHETIC_PATHS
                            for data in ("real", "synthetic")])
def test_criterion_matches_jax(name, data):
    gt, preds = _loss_inputs(_SYNTHETIC[data], seed=4)
    if name in _FP64:
        gt, preds = _f64(gt), _f64(preds)
    crit = _criterion(name, JC)
    with jax.default_matmul_precision(HIGHEST), jax.enable_x64(name in _FP64):
        # jitted in fp64: eager fp64 would compile each op anew
        ref = (jax.jit(lambda g, p: crit(g, p)) if name in _FP64 else crit)(
            _to_jax(gt), _to_jax(preds))
    _check_details(_criterion(name, PC)(_to_torch(gt), _to_torch(preds)),
                   ref)


@pytest.mark.parametrize("name", ["regr3d", "points_plus_scale",
                                  "disentangled", "disentangled_normal_gm"])
def test_criterion_gradient_matches_jax(name):
    """d loss / d preds, every float prediction, on mixed data."""
    gt, preds = _loss_inputs(_SYNTHETIC["mixed"], seed=5)
    keys = [k for k, v in preds.items() if v.dtype == np.float32]
    crit = _criterion(name, JC)
    with jax.default_matmul_precision(HIGHEST), jax.enable_x64(True):
        gt64, preds64 = _f64(gt), _f64(preds)

        def jax_loss(p):
            return crit(_to_jax(gt64), {**_to_jax(preds64), **p})[0]

        ref = jax.jit(jax.grad(jax_loss))(
            {k: jnp.asarray(preds64[k]) for k in keys})
    leaves = {k: torch.from_numpy(preds[k]).requires_grad_() for k in keys}
    _criterion(name, PC)(_to_torch(gt),
                         {**_to_torch(preds), **leaves})[0].backward()
    for k in keys:
        r = np.asarray(ref[k])
        o = (np.zeros_like(r) if leaves[k].grad is None
             else _np(leaves[k].grad))
        assert np.isfinite(o).all(), k
        err = np.abs(o - r).max()
        assert err <= 1e-4 * np.abs(r).max(), f"d{k}: {err:.3g}"


def test_base_criteria_match_jax():
    """The distances and FactoredLLoss's choice per factor."""
    rng = np.random.default_rng(6)
    a, b = _rand(rng, 4, 5, 3), _rand(rng, 4, 5, 3)
    b[0, 0] = a[0, 0]  # equal vectors: L2's zero subgradient
    for C, ref_mod in ((PC, JC), (PL, JL)):
        for cls in ("L1Loss", "L2Loss"):
            _close(getattr(C, cls)()(torch.tensor(a), torch.tensor(b)),
                   getattr(ref_mod, cls)()(jnp.asarray(a), jnp.asarray(b)),
                   cls)
    for kind in ("l1", "l2"):
        _close(PC.GenericLLoss(kind)(torch.tensor(a), torch.tensor(b)),
               JC.GenericLLoss(kind)(jnp.asarray(a), jnp.asarray(b)), kind)
    with pytest.raises(ValueError):
        PC.GenericLLoss("l3")(torch.tensor(a), torch.tensor(b))
    fl = dict(points_loss_type="l1", depth_loss_type="l2",
              scale_loss_type="l2")
    for factor in ("points", "depth", "ray_directions", "pose_quats",
                   "pose_trans", "scale", None):
        _close(PC.FactoredLLoss(**fl)(torch.tensor(a), torch.tensor(b),
                                      factor=factor),
               JC.FactoredLLoss(**fl)(jnp.asarray(a), jnp.asarray(b),
                                      factor=factor), str(factor))
    _close(PL.l1_distance(torch.tensor(a), torch.tensor(b)),
           JL.l1_distance(jnp.asarray(a), jnp.asarray(b)))
    _close(PL.l2_distance(torch.tensor(a), torch.tensor(b)),
           JL.l2_distance(jnp.asarray(a), jnp.asarray(b)))


def _factored_config(name, L):
    fc = L.FactoredGeometryConfig
    return {
        "default": fc(),
        "pairwise": fc(compute_pairwise_relative_pose_loss=True),
        "unnormed_z_no_log": fc(norm_predictions=False,
                                depth_type_for_loss="z", loss_in_log=False),
        "no_world_points_weighted": fc(
            compute_world_frame_points_loss=False,
            weights=(1.0, 0.5, 2.0, 1.5, 0.7, 1.2, 0.4)),
    }[name]


@pytest.mark.parametrize("config", ["default", "pairwise",
                                    "unnormed_z_no_log",
                                    "no_world_points_weighted"])
def test_factored_geometry_scale_regr3d_sets_match_jax(config):
    """The function's ordered sets, set for set: loss, mask and type, and
    the normalised camera points."""
    gt, preds = _loss_inputs(_SYNTHETIC["mixed"], seed=7)
    with jax.default_matmul_precision(HIGHEST):
        ref, ref_aux = JL.factored_geometry_scale_regr3d(
            _to_jax(gt), _to_jax(preds), cfg=_factored_config(config, JL),
            return_normalized=True)
    out, aux = PL.factored_geometry_scale_regr3d(
        _to_torch(gt), _to_torch(preds), cfg=_factored_config(config, PL),
        return_normalized=True)
    assert list(out) == list(ref)
    for name, r in ref.items():
        o = out[name]
        assert o["type"] == r["type"], name
        _close(o["loss"], r["loss"], name)
        assert (o["mask"] is None) == (r["mask"] is None), name
        if r["mask"] is not None:
            np.testing.assert_array_equal(
                _np(o["mask"]), np.broadcast_to(np.asarray(r["mask"]),
                                                o["mask"].shape), name)
    for key in ref_aux:
        _close(aux[key], ref_aux[key], key)


def test_other_loss_functions_match_jax():
    """exclude_top_n_percent (with and without keep_all), normal_gm_loss
    (synthetic samples only and every sample) and
    non_ambiguous_mask_loss."""
    gt, preds = _loss_inputs(_SYNTHETIC["mixed"], seed=8)
    rng = np.random.default_rng(9)
    loss = np.abs(_rand(rng, 2, 3, 40))
    loss[0, 1, :10] = loss[0, 1, 10]  # ties
    valid = rng.random((2, 3, 40)) > 0.3
    for keep_all in (None, np.array([True, False])):
        ref = JL.exclude_top_n_percent(
            jnp.asarray(loss), jnp.asarray(valid), 10.0,
            None if keep_all is None else jnp.asarray(keep_all))
        out = PL.exclude_top_n_percent(
            torch.tensor(loss), torch.tensor(valid), 10.0,
            None if keep_all is None else torch.tensor(keep_all))
        np.testing.assert_array_equal(_np(out), np.asarray(ref))
    pr, gtp = preds["pts3d_cam"], gt["pts3d_cam"]
    for syn_only in (True, False):
        with jax.default_matmul_precision(HIGHEST):
            ref = JL.normal_gm_loss(jnp.asarray(pr), jnp.asarray(gtp),
                                    jnp.asarray(gt["valid_mask"]),
                                    jnp.asarray(gt["is_synthetic"]),
                                    apply_to_synthetic_only=syn_only)
        out = PL.normal_gm_loss(torch.tensor(pr), torch.tensor(gtp),
                                torch.tensor(gt["valid_mask"]),
                                torch.tensor(gt["is_synthetic"]),
                                apply_to_synthetic_only=syn_only)
        _close(out[0], ref[0], "normal_gm")
        for key in ref[1]:
            _close(out[1][key], ref[1][key], key)
    _close(PL.non_ambiguous_mask_loss(
        torch.tensor(preds["non_ambiguous_mask_logits"]),
        torch.tensor(gt["non_ambiguous_mask"])),
        JL.non_ambiguous_mask_loss(
            jnp.asarray(preds["non_ambiguous_mask_logits"]),
            jnp.asarray(gt["non_ambiguous_mask"])))


@pytest.mark.parametrize("name", ["regr3d", "points_plus_scale"])
def test_composed_step_matches_jax(name):
    """Forward, criterion, backward on the family the criterion takes."""
    srt, criterion = composed(PC)[name]
    kw = dict(scene_rep_type=srt, dense_output_dim=dense_dim_for(srt))
    jax_model, tree, port, h, w = model_pair(kw, seed=22)
    with jax.default_matmul_precision(HIGHEST):
        jbatch = jax_batch(1, 2, h, w, seed=1)
    batch = make_synthetic_batch(1, 2, h, w, seed=1, device="cpu")
    ref = jax_reference(jax_model, tree, {"img": jbatch["views"]["img"]},
                        jbatch["gt"], [name])[name]
    *got, launched = port_loss_and_grads(port, batch, criterion)
    assert launched == 4
    check_step(port, got, ref)
