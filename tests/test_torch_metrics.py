"""The port's copy of the benchmark metrics (utils/metrics.py) against the
JAX package's, on the same seeded numpy inputs: every function bitwise
(both are numpy), including the all-invalid NaN case and the zero-norm
translation angle."""

import numpy as np
import pytest

from mapanything_tpu.utils import metrics as JM
from mapanything_tpu_torch.utils import metrics as PM


def same(got, ref):
    """Bitwise equal: values, NaNs in place, shapes and dtypes."""
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for g, r in zip(got, ref):
            same(g, r)
        return
    if isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype and got.shape == ref.shape
    assert type(got) is type(ref)
    np.testing.assert_array_equal(got, ref)


def points(seed, n=200, noise=0.05):
    rng = np.random.default_rng(seed)
    gt = rng.normal(size=(3, n, 3)).astype(np.float32)
    pred = (gt * (1 + noise * rng.standard_normal((3, n, 1)))).astype(
        np.float32)
    pred[0, :5] = 0.0  # zero-norm predictions
    gt[1, :7] = 0.0  # invalid GT
    mask = rng.uniform(size=(3, n)) > 0.2
    return gt, pred, mask


def poses(seed, n=5):
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        out[i, :3, :3] = q * np.sign(np.linalg.det(q))
        out[i, :3, 3] = rng.normal(size=3)
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_valid_mean(masked):
    arr = np.random.default_rng(0).normal(size=(4, 50)).astype(np.float32)
    mask = arr > 0.3 if masked else np.ones_like(arr, bool)
    same(PM.valid_mean(arr, mask), JM.valid_mean(arr, mask))
    empty = np.zeros_like(mask)
    same(PM.valid_mean(arr, empty), JM.valid_mean(arr, empty))


@pytest.mark.parametrize("fn", ["thresh_inliers", "m_rel_ae"])
@pytest.mark.parametrize("masked", [False, True])
def test_dense_metrics(fn, masked):
    gt, pred, mask = points(1)
    kw = {"mask": mask if masked else None, "output_scaling_factor": 100.0}
    same(getattr(PM, fn)(gt, pred, **kw), getattr(JM, fn)(gt, pred, **kw))
    z_gt, z_pred = gt[..., 2:], pred[..., 2:]
    same(getattr(PM, fn)(z_gt, z_pred, mask=mask),
         getattr(JM, fn)(z_gt, z_pred, mask=mask))


@pytest.mark.parametrize("fn", ["thresh_inliers", "m_rel_ae"])
def test_dense_metrics_all_invalid_is_nan(fn):
    gt, pred, _ = points(2)
    nothing = np.zeros(gt.shape[:-1], bool)
    got = getattr(PM, fn)(gt, pred, mask=nothing)
    assert np.isnan(got)
    same(got, getattr(JM, fn)(gt, pred, mask=nothing))
    zero_gt = np.zeros_like(gt)
    assert np.isnan(getattr(PM, fn)(zero_gt, pred))


def test_align_and_evaluate_ate():
    rng = np.random.default_rng(3)
    model = rng.normal(size=(3, 12))
    data = model + 0.01 * rng.normal(size=(3, 12))
    same(PM.align(model, data), JM.align(model, data))
    gt, est = poses(4), poses(5)
    same(PM.evaluate_ate(list(gt), list(est)),
         JM.evaluate_ate(list(gt), list(est)))


def test_closed_form_inverse_se3():
    se3 = poses(6, 7)
    got = PM.closed_form_inverse_se3(se3)
    same(got, JM.closed_form_inverse_se3(se3))
    np.testing.assert_allclose(got @ se3, np.tile(np.eye(4), (7, 1, 1)),
                               atol=1e-12)


def test_rotation_and_translation_angles():
    a, b = poses(7, 6), poses(8, 6)
    same(PM.rotation_angle(a[:, :3, :3], b[:, :3, :3]),
         JM.rotation_angle(a[:, :3, :3], b[:, :3, :3]))
    t_gt, t_pr = a[:, :3, 3], b[:, :3, 3]
    t_gt[0] = 0.0  # a pure-rotation pair: 90 degrees, not NaN
    got = PM.translation_angle(t_gt, t_pr)
    same(got, JM.translation_angle(t_gt, t_pr))
    assert got[0] == 90.0


@pytest.mark.parametrize("n", [2, 5])
def test_relative_pose_error_and_auc(n):
    gt, pred = poses(9, n), poses(10, n)
    pred[:2] = gt[:2]  # an exact pair
    pred[-1, :3, 3] += 0.3
    same(PM.build_pair_index(n), JM.build_pair_index(n))
    r, t = PM.se3_to_relative_pose_error(pred, gt, n)
    same((r, t), JM.se3_to_relative_pose_error(pred, gt, n))
    for thr in (5, 30):
        same(PM.calculate_auc_np(r, t, thr), JM.calculate_auc_np(r, t, thr))
