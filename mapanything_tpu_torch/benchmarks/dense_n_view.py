"""Dense N-view benchmark; counterpart of
mapanything_tpu/benchmarks/dense_n_view.py (the reference's
benchmarking/dense_n_view/benchmark.py).

Protocol (reference :45-560, SURVEY.md section 3.4): for each multi-view
set, put the GT and the predictions in view 0's frame, divide the
predictions by the predicted metric scale, normalise both jointly by their
average distance, then report per set:
    pointmaps_abs_rel, pointmaps_inlier_thres_103,
    depth_abs_rel, depth_inlier_thres_103   (z-depth),
    pose_ate_rmse, pose_auc_5               (Horn-aligned ATE / rel-pose AUC),
    scale_abs_rel                           (metric norm factor ratio).

The normalisation runs in torch on the model's device, its fp32 products
without TF32; the reduced arrays then cross to the host in one copy and
utils/metrics.py scores them in numpy.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import geometry as G
from ..utils import metrics as M
from ..utils.device import full_fp32, to_device


def model_device(model) -> torch.device:
    """The device of `model`'s parameters; a model without any names its
    own with a `device` attribute."""
    params = getattr(model, "parameters", None)
    first = next(iter(params()), None) if params else None
    if first is not None:
        return first.device
    if getattr(model, "device", None) is None:
        raise ValueError("the model holds no parameters and names no "
                         "device")
    return torch.device(model.device)


def _to_frame0(quats, trans, pts):
    """Poses (B, V, 4/3) and points (B, V, H, W, 3) in view 0's frame."""
    q0, t0 = quats[:, :1].expand_as(quats), trans[:, :1].expand_as(trans)
    q, t = G.transform_pose_using_quats_and_trans_2_to_1(q0, t0, quats, trans)
    r0_inv = G.quaternion_to_rotation_matrix(G.quaternion_inverse(quats[:, 0]))
    t0_inv = -torch.einsum("bij,bj->bi", r0_inv, trans[:, 0])
    pts = (torch.einsum("bij,bvhwj->bvhwi", r0_inv, pts)
           + t0_inv[:, None, None, None, :])
    return q, t, pts


def _normalize_for_metrics(gt: Dict[str, torch.Tensor],
                           preds: Dict[str, torch.Tensor]):
    """View-0 frame, scale removed, avg-dis normalised: the normalised
    pointmaps, z-depths, 4x4 poses, the valid mask and the metric norm
    factors (the loss's get_all_info quantities, for evaluation)."""
    with full_fp32():
        gt_q, gt_t, gt_pts_v0 = _to_frame0(
            gt["camera_pose_quats"], gt["camera_pose_trans"], gt["pts3d"])
        pr_q, pr_t, pr_pts_v0 = _to_frame0(
            preds["cam_quats"], preds["cam_trans"], preds["pts3d"])

    msf = preds["metric_scaling_factor"]
    s = msf[:, None, None, None, None]
    pr_pts_nos = pr_pts_v0 / s
    pr_pts_cam_nos = preds["pts3d_cam"] / s
    pr_t_nos = pr_t / msf[:, None, None]

    valid = gt["valid_mask"]
    gt_pts_n, gt_f = G.normalize_multiple_pointclouds(gt_pts_v0, valid,
                                                      ret_factor=True)
    pr_pts_n, pr_f = G.normalize_multiple_pointclouds(pr_pts_nos, valid,
                                                      ret_factor=True)
    gt_cam_n = gt["pts3d_cam"] / gt_f
    pr_cam_n = pr_pts_cam_nos / pr_f
    gt_t_n = gt_t / gt_f[:, :, 0, 0, :]
    pr_t_n = pr_t_nos / pr_f[:, :, 0, 0, :]
    return {
        "gt_pts": gt_pts_n, "pr_pts": pr_pts_n,
        "gt_depth_z": gt_cam_n[..., 2:], "pr_depth_z": pr_cam_n[..., 2:],
        "gt_poses": G.pose_quats_trans_to_matrix(gt_q, gt_t_n),
        "pr_poses": G.pose_quats_trans_to_matrix(pr_q, pr_t_n),
        "valid": valid,
        # predicted metric points = scale-free points * s
        "gt_metric_f": gt_f[:, 0, 0, 0, 0],
        "pr_metric_f": pr_f[:, 0, 0, 0, 0] * msf,
    }


def compute_metrics_for_batch(gt, preds) -> List[Dict[str, float]]:
    """Per-sample (multi-view set) metric dicts for one batch of tensors on
    one device."""
    q = _normalize_for_metrics(gt, preds)
    q = {k: v.cpu().numpy() for k, v in q.items()}
    b, v = q["valid"].shape[:2]
    out = []
    for i in range(b):
        valid = q["valid"][i].reshape(v, -1)
        gt_pts = q["gt_pts"][i].reshape(v, -1, 3)
        pr_pts = q["pr_pts"][i].reshape(v, -1, 3)
        gt_z = q["gt_depth_z"][i].reshape(v, -1, 1)
        pr_z = q["pr_depth_z"][i].reshape(v, -1, 1)

        pose_ate = M.evaluate_ate(list(q["gt_poses"][i]),
                                  list(q["pr_poses"][i]))
        r_err, t_err = M.se3_to_relative_pose_error(
            q["pr_poses"][i], q["gt_poses"][i], v)
        auc5, _ = M.calculate_auc_np(r_err, t_err, max_threshold=5)

        scale_abs_rel = float(
            np.abs(q["pr_metric_f"][i] - q["gt_metric_f"][i])
            / max(q["gt_metric_f"][i], 1e-8))
        out.append({
            "pointmaps_abs_rel": M.m_rel_ae(gt_pts, pr_pts, valid),
            "pointmaps_inlier_thres_103": M.thresh_inliers(
                gt_pts, pr_pts, 1.03, valid),
            "depth_abs_rel": M.m_rel_ae(gt_z, pr_z, valid),
            "depth_inlier_thres_103": M.thresh_inliers(gt_z, pr_z, 1.03,
                                                       valid),
            "pose_ate_rmse": pose_ate,
            "pose_auc_5": auc5,
            "scale_abs_rel": scale_abs_rel,
        })
    return out


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def run_dense_n_view_benchmark(model, loader, geom_cfg,
                               output_json: Optional[str] = None,
                               memory_efficient: bool = False
                               ) -> Dict[str, float]:
    """Evaluate `model` over a test loader; returns the dataset-mean
    metrics and writes the per-set JSON (the reference's output contract)
    to `output_json`.

    `model` is called as model(views, geom_cfg=geom_cfg,
    memory_efficient=memory_efficient) and returns the factored keys
    (models/adapters.py): MapAnything, or an adapter. The batches go to
    the model's device (model_device), and the forwards run under
    torch.inference_mode.
    """
    device = model_device(model)
    per_set: List[Dict[str, float]] = []
    loader.set_epoch(0)
    with torch.inference_mode():
        for batch in loader:
            batch = to_device(batch, device)
            preds = model(batch["views"], geom_cfg=geom_cfg,
                          memory_efficient=memory_efficient)
            per_set.extend(compute_metrics_for_batch(batch["gt"], preds))

    keys = per_set[0].keys() if per_set else []
    summary = {k: float(np.nanmean([s[k] for s in per_set])) for k in keys}
    summary["num_sets"] = len(per_set)
    if output_json:
        write_json(output_json, {"summary": summary, "per_set": per_set})
    return summary
