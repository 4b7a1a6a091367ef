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
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ..geometry import angle_diff_vec3
from ..ops.ring_attention import all_reduce


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
