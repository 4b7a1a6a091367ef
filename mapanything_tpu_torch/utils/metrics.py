"""Benchmark metrics; the port's own copy of mapanything_tpu/utils/metrics.py
(the reference's mapanything/utils/metrics.py), numpy on the host.

The benchmarks reduce the dense tensors on the device and copy the reduced
arrays to the host once a batch; these functions score them there and give
the JAX package's numbers bit for bit. The port imports nothing of the JAX
package, so it keeps this copy.

Key functions and their reference anchors:
  thresh_inliers:82, m_rel_ae:126, align (Horn/Umeyama):158, evaluate_ate:193,
  rotation/translation angular errors + calculate_auc_np:405,
  se3_to_relative_pose_error:478.
"""

from __future__ import annotations

from itertools import combinations
from typing import Optional, Tuple

import numpy as np


def valid_mean(arr: np.ndarray, mask: np.ndarray) -> Tuple[float, bool]:
    """Mean over mask; (nan, False) when no valid entries. Ref metrics.py:29."""
    mask = mask.astype(bool)
    n = int(mask.sum())
    if n == 0:
        return float("nan"), False
    return float(arr[mask].mean()), True


def thresh_inliers(
    gt: np.ndarray,
    pred: np.ndarray,
    thresh: float = 1.03,
    mask: Optional[np.ndarray] = None,
    output_scaling_factor: float = 1.0,
) -> float:
    """Inlier ratio: max(gt/pred, pred/gt) < thresh. Ref metrics.py:82."""
    gt_norm = np.linalg.norm(gt, axis=-1)
    pred_norm = np.linalg.norm(pred, axis=-1)
    gt_valid = gt_norm > 0
    combined = gt_valid if mask is None else (mask.astype(bool) & gt_valid)

    with np.errstate(divide="ignore", invalid="ignore"):
        rel_1 = np.nan_to_num(
            gt_norm / pred_norm, nan=thresh + 1, posinf=thresh + 1, neginf=thresh + 1
        )
        rel_2 = np.nan_to_num(pred_norm / gt_norm, nan=0, posinf=0, neginf=0)
    max_rel = np.maximum(rel_1, rel_2)
    inliers = ((0 < max_rel) & (max_rel < thresh)).astype(np.float32)
    val, ok = valid_mean(inliers, combined)
    return val * output_scaling_factor if ok else float("nan")


def m_rel_ae(
    gt: np.ndarray,
    pred: np.ndarray,
    mask: Optional[np.ndarray] = None,
    output_scaling_factor: float = 1.0,
) -> float:
    """Mean relative absolute error ||pred-gt||/||gt||. Ref metrics.py:126."""
    error_norm = np.linalg.norm(pred - gt, axis=-1)
    gt_norm = np.linalg.norm(gt, axis=-1)
    gt_valid = gt_norm > 0
    combined = gt_valid if mask is None else (mask.astype(bool) & gt_valid)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.nan_to_num(error_norm / gt_norm, nan=0, posinf=0, neginf=0)
    val, ok = valid_mean(rel, combined)
    return val * output_scaling_factor if ok else float("nan")


def align(model: np.ndarray, data: np.ndarray):
    """Horn closed-form alignment of two (3, N) trajectories.

    Returns (rot 3x3, trans 3x1, per-point translational error). Ref
    metrics.py:158 (matrix-class free rewrite)."""
    model_zc = model - model.mean(1, keepdims=True)
    data_zc = data - data.mean(1, keepdims=True)
    W = model_zc @ data_zc.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    aligned = rot @ model + trans
    err = aligned - data
    trans_error = np.sqrt(np.sum(err * err, axis=0))
    return rot, trans, trans_error


def evaluate_ate(gt_traj, est_traj) -> float:
    """ATE RMSE-style mean translational error after Horn alignment of camera
    centers. Ref metrics.py:193."""
    gt_pts = np.stack([np.asarray(p)[:3, 3] for p in gt_traj]).T
    est_pts = np.stack([np.asarray(p)[:3, 3] for p in est_traj]).T
    _, _, trans_error = align(gt_pts, est_pts)
    return float(trans_error.mean())


def closed_form_inverse_se3(se3: np.ndarray) -> np.ndarray:
    """Batch SE3 inverse [R^T, -R^T t]. Ref metrics.py:435."""
    R = se3[:, :3, :3]
    T = se3[:, :3, 3:]
    Rt = np.transpose(R, (0, 2, 1))
    out = np.tile(np.eye(4), (len(se3), 1, 1))
    out[:, :3, :3] = Rt
    out[:, :3, 3:] = -Rt @ T
    return out


def rotation_angle(rot_gt: np.ndarray, rot_pred: np.ndarray) -> np.ndarray:
    """Relative rotation angle in degrees between (N,3,3) batches.

    Ref metrics.py rotation_angle (quaternion-based); computed via the trace
    formula, numerically clamped."""
    rel = np.matmul(np.transpose(rot_gt, (0, 2, 1)), rot_pred)
    tr = np.trace(rel, axis1=1, axis2=2)
    cos = np.clip((tr - 1) / 2, -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def translation_angle(t_gt: np.ndarray, t_pred: np.ndarray,
                      default_err: float = 1e6) -> np.ndarray:
    """Angular error between translation directions (degrees), symmetric to
    sign ambiguity. Ref metrics.py translation_angle/compare_translation."""
    # eps-guarded normalization as the reference does
    # (compare_translation_by_angle, metrics.py:392-398): a zero-norm
    # translation (pure-rotation pair) yields cos=0 -> 90 deg, not NaN ->
    # default_err
    eps = 1e-15
    n_gt = np.linalg.norm(t_gt, axis=-1, keepdims=True)
    n_pr = np.linalg.norm(t_pred, axis=-1, keepdims=True)
    cos = np.sum((t_gt / (n_gt + eps)) * (t_pred / (n_pr + eps)), axis=-1)
    ang = np.degrees(np.arccos(np.clip(np.abs(cos), -1.0, 1.0)))
    ang = np.where(np.isnan(ang) | np.isinf(ang), default_err, ang)
    return ang


def build_pair_index(n: int):
    """All unordered frame pairs. Ref metrics.py:222."""
    pairs = np.asarray(list(combinations(range(n), 2)), dtype=np.int64)
    return pairs[:, 0], pairs[:, 1]


def se3_to_relative_pose_error(
    pred_se3: np.ndarray, gt_se3: np.ndarray, num_frames: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pairwise relative rotation/translation angular errors (degrees).

    Ref metrics.py:478."""
    i1, i2 = build_pair_index(num_frames)
    rel_gt = closed_form_inverse_se3(gt_se3[i1]) @ gt_se3[i2]
    rel_pred = closed_form_inverse_se3(pred_se3[i1]) @ pred_se3[i2]
    r_err = rotation_angle(rel_gt[:, :3, :3], rel_pred[:, :3, :3])
    t_err = translation_angle(rel_gt[:, :3, 3], rel_pred[:, :3, 3])
    return r_err, t_err


def calculate_auc_np(
    r_error: np.ndarray, t_error: np.ndarray, max_threshold: int = 30
) -> Tuple[float, np.ndarray]:
    """AUC of max(r, t) error below increasing degree thresholds.

    Ref metrics.py:405."""
    errors = np.maximum(r_error, t_error)
    bins = np.arange(max_threshold + 1)
    histogram, _ = np.histogram(errors, bins=bins)
    normalized = histogram.astype(float) / float(len(errors))
    return float(np.mean(np.cumsum(normalized))), normalized
