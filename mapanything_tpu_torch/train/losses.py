"""Training losses; counterpart of mapanything_tpu/train/losses.py.

The released training criterion (configs/loss/overall_loss.yaml):

    ConfAndExcludeTopNPercentPixelLoss(
        FactoredGeometryScaleRegr3DPlusNormalGMLoss(
            RobustRegressionLoss(alpha=0.5, c=0.05), norm_mode='avg_dis',
            loss_in_log=True, compute_world_frame_points_loss=True),
        conf_alpha=0.2, top_n_percent=5, apply_to_real_data_only=True,
        conf_loss_set_indices=[0], exclude_loss_set_indices=[1, 2])
    + 0.3 * NonAmbiguousMaskLoss(BCELoss())

:func:`overall_loss` builds it from the composable criteria of
train/criteria.py. This module holds the elementwise pieces those criteria
share. Views are stacked on axis 1 of every tensor, (B, V, ...).

Each batch reduction takes an optional data group (`batch_ratio`): with
one, the batch's rows are split over the group's ranks and the reduction
is that of the whole batch (train/criteria.py::Reduction).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..geometry import angle_diff_vec3, apply_log_to_norm
from ..ops.ring_attention import all_reduce


def l1_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().sum(-1)


def l2_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a - b, dim=-1)


@dataclasses.dataclass(frozen=True)
class L1Loss:
    """The L1 distance over the last axis; `factor` is ignored."""

    def __call__(self, a, b, factor=None):
        return l1_distance(a, b)


@dataclasses.dataclass(frozen=True)
class L2Loss:
    """The Euclidean distance over the last axis; `factor` is ignored."""

    def __call__(self, a, b, factor=None):
        return l2_distance(a, b)


@dataclasses.dataclass(frozen=True)
class RobustRegressionLoss:
    """Barron's general robust loss (arXiv:1701.03077) over the last axis.
    `factor` names the loss set; this criterion ignores it."""

    alpha: float = 0.5
    scaling_c: float = 0.25

    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 factor=None) -> torch.Tensor:
        error_scaled = (((a - b) / self.scaling_c) ** 2).sum(-1)
        am2 = abs(self.alpha - 2)
        return (am2 / self.alpha) * (
            torch.pow(error_scaled / am2 + 1.0, self.alpha / 2) - 1.0)


def batch_ratio(num: torch.Tensor, count: torch.Tensor,
                group=None) -> torch.Tensor:
    """num / max(count, 1) for a batch sum and its count; with a data
    group, both summed over the group's ranks first, in one all_reduce:
    the numerator differentiably (its backward sums the cotangents over
    the ranks, ops/ring_attention.py::all_reduce), the count without a
    gradient."""
    if group is not None and dist.get_world_size(group) > 1:
        both = all_reduce(torch.stack([num, count.to(num.dtype)]), group)
        num, count = both[0], both[1].detach()
    return num / count.clamp_min(1.0)


def bce_with_logits(logits: torch.Tensor,
                    target: torch.Tensor) -> torch.Tensor:
    """Elementwise, numerically stable binary cross-entropy on logits."""
    target = target.to(logits.dtype)
    return (logits.clamp_min(0) - logits * target
            + torch.log1p(torch.exp(-logits.abs())))


def exclude_top_n_percent(pixel_loss: torch.Tensor, valid: torch.Tensor,
                          top_n_percent: float,
                          keep_all: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The (B, V, HW) mask that keeps, per image, the valid pixels whose
    loss is at most the one at rank valid - floor(valid * N / 100) of the
    image's ascending valid losses (every valid pixel where that floor is
    0, and in the samples where `keep_all` (B,) is True)."""
    hw = pixel_loss.shape[-1]
    masked = torch.where(valid, pixel_loss, -torch.inf)
    sorted_loss = torch.sort(masked, dim=-1).values  # valid ones on top
    n_excl = (valid.sum(-1) * top_n_percent / 100.0).to(torch.int64)
    idx = (hw - n_excl - 1).clamp(0, hw - 1)
    thresh = torch.take_along_dim(sorted_loss, idx[..., None], dim=-1)
    keep = (valid & (pixel_loss <= thresh)) | ((n_excl[..., None] == 0)
                                               & valid)
    if keep_all is not None:
        keep = torch.where(keep_all[:, None, None], valid, keep)
    return keep


def _smooth(err: torch.Tensor, beta: float) -> torch.Tensor:
    """Smooth-L1 shaping of angular errors."""
    if beta == 0:
        return err
    return torch.where(err < beta, 0.5 * err * err / beta, err - 0.5 * beta)


def compute_normal_loss(points: torch.Tensor, gt_points: torch.Tensor,
                        mask: torch.Tensor, group=None) -> torch.Tensor:
    """Normal consistency from the four cross products of each pixel quad.

    points, gt_points (B, H, W, 3), mask (B, H, W) bool. Returns the summed
    smoothed angle errors over (valid quads * 4 * max(H, W)), 0 without a
    valid quad; both sums over the data group's rows with `group`.
    """
    h, w = points.shape[-3:-1]

    def quads(p):
        lu, ru = p[..., :-1, :-1, :], p[..., :-1, 1:, :]
        ld, rd = p[..., 1:, :-1, :], p[..., 1:, 1:, :]
        cross = torch.linalg.cross
        return (cross(ru - rd, ld - rd, dim=-1),
                cross(lu - ru, rd - ru, dim=-1),
                cross(ld - lu, ru - lu, dim=-1),
                cross(rd - ld, lu - ld, dim=-1))

    m_lu, m_ru = mask[..., :-1, :-1], mask[..., :-1, 1:]
    m_ld, m_rd = mask[..., 1:, :-1], mask[..., 1:, 1:]
    ms = (m_ru & m_ld & m_rd, m_lu & m_rd & m_ru,
          m_ld & m_ru & m_lu, m_rd & m_lu & m_ld)
    min_a, max_a, beta = math.radians(1), math.radians(90), math.radians(3)
    loss = 0.0
    for p, g, m in zip(quads(points), quads(gt_points), ms):
        ang = angle_diff_vec3(p, g).clamp(min_a, max_a)
        loss = loss + m * _smooth(ang, beta)
    total_valid = (ms[0] | ms[1] | ms[2] | ms[3]).sum().to(points.dtype)
    return batch_ratio(loss.sum(), total_valid * (4 * max(h, w)), group)


def compute_gradient_matching_loss(prediction: torch.Tensor,
                                   gt_target: torch.Tensor,
                                   mask: torch.Tensor,
                                   scales: int = 4,
                                   group=None) -> torch.Tensor:
    """Multi-scale gradient matching (MiDaS eq. 11) on (B, H, W, C) maps
    under a (B, H, W) mask; each scale's sums over the data group's rows
    with `group`."""

    def one_scale(pred, gt, m):
        m = m[..., None].expand(pred.shape)
        diff = (pred - gt) * m
        gx = ((diff[:, :, 1:] - diff[:, :, :-1]).abs()
              * (m[:, :, 1:] * m[:, :, :-1])).clamp(max=100.0)
        gy = ((diff[:, 1:, :] - diff[:, :-1, :]).abs()
              * (m[:, 1:, :] * m[:, :-1, :])).clamp(max=100.0)
        return batch_ratio(gx.sum() + gy.sum(), m.sum(), group)

    mask = mask.to(prediction.dtype)
    total = 0.0
    for s in range(scales):
        step = 2 ** s
        total = total + one_scale(prediction[:, ::step, ::step],
                                  gt_target[:, ::step, ::step],
                                  mask[:, ::step, ::step])
    return total


def normal_gm_loss(pr_pts_cam_n: torch.Tensor, gt_pts_cam_n: torch.Tensor,
                   valid: torch.Tensor,
                   is_synthetic: Optional[torch.Tensor] = None,
                   apply_to_synthetic_only: bool = True,
                   normal_loss_weight: float = 3.0,
                   gm_loss_weight: float = 3.0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The normal-consistency and gradient-matching terms of the released
    pixel criterion, summed over the views: normals on the normalised
    camera points (B, V, H, W, 3), gradient matching on their log z, under
    `valid` (B, V, H, W) and, with `apply_to_synthetic_only`, only in the
    samples `is_synthetic` (B,) marks. Returns (the weighted sum,
    {"normal_loss", "gm_loss"})."""
    b, v = valid.shape[:2]
    mask = valid
    if apply_to_synthetic_only:
        syn = (is_synthetic if is_synthetic is not None else torch.zeros(
            b, dtype=torch.bool, device=valid.device))
        mask = mask & syn[:, None, None, None]
    normal_total = gm_total = 0.0
    for i in range(v):
        normal_total = normal_total + compute_normal_loss(
            pr_pts_cam_n[:, i], gt_pts_cam_n[:, i], mask[:, i])
        gm_total = gm_total + compute_gradient_matching_loss(
            apply_log_to_norm(pr_pts_cam_n[:, i, ..., 2:]),
            apply_log_to_norm(gt_pts_cam_n[:, i, ..., 2:]), mask[:, i])
    normal, gm = normal_loss_weight * normal_total, gm_loss_weight * gm_total
    return normal + gm, {"normal_loss": normal, "gm_loss": gm}


def non_ambiguous_mask_loss(logits: torch.Tensor,
                            gt_non_ambiguous: torch.Tensor) -> torch.Tensor:
    """NonAmbiguousMaskLoss(BCELoss()) over (B, V, H, W): the mean BCE."""
    return bce_with_logits(logits, gt_non_ambiguous).mean()


@dataclasses.dataclass(frozen=True)
class FactoredGeometryConfig:
    norm_predictions: bool = True
    norm_mode: str = "avg_dis"
    loss_in_log: bool = True
    depth_type_for_loss: str = "depth_along_ray"
    compute_world_frame_points_loss: bool = True
    compute_pairwise_relative_pose_loss: bool = False
    weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class OverallLossConfig:
    conf_alpha: float = 0.2
    top_n_percent: float = 5.0
    mask_loss_weight: float = 0.3
    criterion_alpha: float = 0.5
    criterion_scaling_c: float = 0.05
    # normal + gradient-matching terms: on, weight 3, synthetic data only
    use_normal_gm: bool = True
    normal_loss_weight: float = 3.0
    gm_loss_weight: float = 3.0
    factored: FactoredGeometryConfig = FactoredGeometryConfig()


_SET_TYPES = {"pose_quats": "view", "pose_trans": "view", "scale": "sample"}


def factored_geometry_scale_regr3d(
        gt: Dict[str, torch.Tensor], preds: Dict[str, torch.Tensor],
        criterion=RobustRegressionLoss(alpha=0.5, scaling_c=0.05),
        cfg: FactoredGeometryConfig = FactoredGeometryConfig(),
        return_normalized: bool = False):
    """The ordered loss sets of FactoredGeometryScaleRegr3D, as the JAX
    package's function of that name returns them:
    {name: {"loss", "mask", "type"}} with name in the set order
    [pts3d] cam_pts3d <depth type> ray_directions pose_quats pose_trans
    scale and type "pixel" (B, V, HW), "view" (B, V) or, with the pairwise
    arm, (B, V, V), or "sample" (B,); the masks alike (None: every
    element). The sets are the criterion's per-view terms
    (train/criteria.py), stacked along the view axis. With
    return_normalized, also {"pr_pts_cam_n", "gt_pts_cam_n"}.

    As the JAX function, and unlike the criterion, the scale set of
    `norm_predictions=False` compares the predicted metric scale itself
    (a prediction factor of 1) with the GT factor.
    """
    from .criteria import FactoredGeometryScaleRegr3D, _log

    w = cfg.weights
    crit = FactoredGeometryScaleRegr3D(
        criterion, norm_predictions=cfg.norm_predictions,
        norm_mode=cfg.norm_mode, loss_in_log=cfg.loss_in_log,
        depth_type_for_loss=cfg.depth_type_for_loss,
        compute_pairwise_relative_pose_loss=(
            cfg.compute_pairwise_relative_pose_loss),
        compute_world_frame_points_loss=cfg.compute_world_frame_points_loss,
        world_frame_points_loss_weight=w[0],
        cam_frame_points_loss_weight=w[1], depth_loss_weight=w[2],
        ray_directions_loss_weight=w[3], pose_quats_loss_weight=w[4],
        pose_trans_loss_weight=w[5], scale_loss_weight=w[6])
    terms, _, (gt_n, pr_n, gt_factor) = crit._sets(gt, preds)
    grouped: Dict[str, list] = {}
    for t in terms:
        grouped.setdefault(t.rep_type, []).append(t)
    losses = {}
    for name, ts in grouped.items():
        kind = _SET_TYPES.get(name, "pixel")
        if kind == "sample":
            (t,) = ts
            loss, mask = t.loss, t.mask
        else:
            loss = torch.stack([t.loss for t in ts], dim=1)
            mask = (None if ts[0].mask is None
                    else torch.stack([t.mask for t in ts], dim=1))
        losses[name] = {"loss": loss, "mask": mask, "type": kind}
    if not cfg.norm_predictions:
        s = preds["metric_scaling_factor"][:, None]
        losses["scale"]["loss"] = criterion(
            _log(s, cfg.loss_in_log),
            _log(gt_factor[:, 0, 0, 0, :], cfg.loss_in_log)) * w[6]
    if return_normalized:
        return losses, {"pr_pts_cam_n": pr_n["pts3d_cam"],
                        "gt_pts_cam_n": gt_n["pts3d_cam"]}
    return losses


def overall_loss(gt: Dict[str, torch.Tensor], preds: Dict[str, torch.Tensor],
                 cfg: OverallLossConfig = OverallLossConfig(), red=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The released train criterion, scaled by 2 / n_views above two views
    (training.py:474-477 of the reference). Returns (total, details).

    `red`, a criteria.Reduction over a data and/or a view group: `gt` and
    `preds` hold this rank's rows and views; `total` (no gradient) is the
    loss of the whole batch, the same on every rank, and
    ``details["_share"]`` this rank's share of it, the scalar to
    backpropagate: the shares of all ranks add up to the total, and
    summing each rank's parameter gradients over the ranks gives the
    total's. The details are the criterion's, of this rank's views."""
    from .criteria import Reduction, released_criterion  # they import us

    red = Reduction() if red is None else red
    value, details = released_criterion(cfg)(gt, preds, red)
    n_views = red.n_views(gt["pts3d"].shape[1])
    if n_views > 2:
        value = value * (2.0 / n_views)
    if red.local:
        details["total"] = value
        return value, details
    total = value.detach().clone()
    if red.view_group is not None:
        dist.all_reduce(total, group=red.view_group)
    details["total"] = total
    details["_share"] = value / red.n_data
    return total, details
