"""Composable training criteria; counterpart of
mapanything_tpu/train/criteria.py.

Semantics follow the JAX package (and through it the reference losses.py):

  * every criterion emits an ordered flat list of per-view loss terms: set i
    takes flat slots [i*V, (i+1)*V), trailing single-entry sets (scale)
    follow, then the per-view normal and gradient-matching terms;
  * a term reduces to the mean over its valid elements, and the total is
    the sum of the reduced terms;
  * the exclude-top-N% wrapper keeps exactly floor(valid * (100-N) / 100)
    lowest-loss valid pixels per image, ranked by a stable sort.

Terms keep full-shape tensors with masks instead of gathered vectors. The
criteria take every option of the JAX package's constructors, the
reference's quirks included (for one, with gt_scale=True in a batch that
mixes metric and non-metric samples the metric samples' predictions stay
zero, as the reference leaves them). `flatten_across_image_only` is kept
and read by nothing, as in the JAX package.

  * base criteria: L1Loss, L2Loss, GenericLLoss, FactoredLLoss (the
    distance chosen per loss set by `factor=`), RobustRegressionLoss,
    BCELoss;
  * set criteria: Regr3D, PointsPlusScaleRegr3D, FactoredGeometryRegr3D,
    FactoredGeometryScaleRegr3D and their PlusNormalGMLoss forms,
    DisentangledFactoredGeometryScaleRegr3D and its PlusNormalGMLoss form;
  * wrappers: ConfLoss, ExcludeTopNPercentPixelLoss,
    ConfAndExcludeTopNPercentPixelLoss, NonAmbiguousMaskLoss, and MultiLoss
    arithmetic (`a + 0.3 * b`) over all of them.

Every reduction that crosses processes goes through one seam, a
:class:`Reduction` passed to the criteria:

  * a DATA group (the batch's rows split over its ranks): every masked mean
    sums its numerator (differentiably) and its count over the group before
    it divides (:func:`masked_mean`), and the double cover takes its
    minimum after that, so the loss is that of the whole batch, as JAX's
    GSPMD step computes it on any mesh;
  * a VIEW group (the views split over its ranks, train/seq_parallel.py):
    the per-view terms stay local, the reference pose is global view 0's
    (rank 0's first view), the joint normalisation sums over the ranks, the
    pairwise pose arm gathers every view, and the terms that every rank
    computes alike (the scale set, the pairwise arm) enter the rank's share
    at 1/p.

The default Reduction() is one process: every reduction local.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..geometry import (
    apply_log_to_norm,
    convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap,
    normalize_multiple_pointclouds,
    quaternion_inverse,
    quaternion_to_rotation_matrix,
    safe_norm,
    transform_pose_using_quats_and_trans_2_to_1,
)
from ..geometry.quats import rotate, unit_w
from ..ops.ring_attention import all_gather, all_reduce
from .losses import (
    OverallLossConfig,
    RobustRegressionLoss,
    batch_ratio,
    bce_with_logits,
    compute_gradient_matching_loss,
    compute_normal_loss,
)

Tensor = torch.Tensor


class BaseCriterion:
    """Distance function (..., C) x (..., C) -> (...); `factor` names the
    loss set being computed."""

    def __call__(self, a, b, factor: Optional[str] = None):
        raise NotImplementedError


def _l1(a: Tensor, b: Tensor) -> Tensor:
    return (a - b).abs().sum(-1)


def _l2(a: Tensor, b: Tensor) -> Tensor:
    return safe_norm(a - b)


@dataclasses.dataclass(frozen=True)
class L1Loss(BaseCriterion):
    def __call__(self, a, b, factor=None):
        return _l1(a, b)


@dataclasses.dataclass(frozen=True)
class L2Loss(BaseCriterion):
    """The Euclidean distance, with a zero subgradient where a == b."""

    def __call__(self, a, b, factor=None):
        return _l2(a, b)


@dataclasses.dataclass(frozen=True)
class GenericLLoss(BaseCriterion):
    """The L-norm named by `loss_type`, "l1" or "l2"."""

    loss_type: str = "l2"

    def __call__(self, a, b, factor=None):
        if self.loss_type == "l1":
            return _l1(a, b)
        if self.loss_type == "l2":
            return _l2(a, b)
        raise ValueError(f"unsupported loss_type {self.loss_type}")


@dataclasses.dataclass(frozen=True)
class FactoredLLoss(BaseCriterion):
    """The L-norm of each loss set, chosen by the `factor` the set criterion
    passes ("points", "depth", "ray_directions", "pose_quats",
    "pose_trans", "scale"); L2 for any other factor."""

    points_loss_type: str = "l2"
    depth_loss_type: str = "l1"
    ray_directions_loss_type: str = "l1"
    pose_quats_loss_type: str = "l1"
    pose_trans_loss_type: str = "l1"
    scale_loss_type: str = "l1"

    def __call__(self, a, b, factor=None):
        kind = {
            "points": self.points_loss_type,
            "depth": self.depth_loss_type,
            "ray_directions": self.ray_directions_loss_type,
            "pose_quats": self.pose_quats_loss_type,
            "pose_trans": self.pose_trans_loss_type,
            "scale": self.scale_loss_type,
        }.get(factor, "l2")
        return _l1(a, b) if kind == "l1" else _l2(a, b)


@dataclasses.dataclass(frozen=True)
class BCELoss(BaseCriterion):
    """Elementwise binary cross-entropy on logits."""

    def __call__(self, logits, target, factor=None):
        return bce_with_logits(logits, target)


# --- loss terms and their reduction -------------------------------------------


@dataclasses.dataclass
class LossTerm:
    """One flat entry of the reference's Sum(...) list: the full-shape loss,
    the mask of the elements that count, and the representation type.

    `double_cover` holds the (+gt, -gt) quaternion losses: reduced bare, the
    term is the minimum of the two means (the elementwise minimum is already
    in `loss` for the wrappers). `reduced`: `loss` is the term's value
    already, reduced over the batch (the normal and gradient-matching
    terms). `replicated`: every rank of a view group computes the same
    value (the scale set, the pairwise pose arm)."""

    loss: Tensor
    mask: Optional[Tensor]
    rep_type: str
    double_cover: Optional[Tuple[Tensor, Tensor]] = None
    reduced: bool = False
    replicated: bool = False


def masked_mean(x: Tensor, mask: Optional[Tensor] = None,
                group=None) -> Tensor:
    """Mean over the valid elements; 0 when none is valid. With a data
    group, over the valid elements of every rank's rows
    (losses.py::batch_ratio)."""
    if group is None and mask is None:
        return x.mean()
    m = torch.ones_like(x) if mask is None else mask.to(x.dtype)
    return batch_ratio((x * m).sum(), m.sum(), group)


def _gather_views(x: Tensor, group) -> Tensor:
    """(B, V_local, ...) -> (B, V_global, ...) in global view order. The
    backward sums every rank's cotangent of a slot and keeps its own."""
    g = all_gather(x, group)  # (p, B, V_local, ...)
    g = g.movedim(0, 1)  # (B, p, V_local, ...)
    return g.reshape(g.shape[0], -1, *g.shape[3:])


class Reduction:
    """The criteria's reductions over the ranks of a data group and of a
    view group (the module docstring); neither: one process."""

    def __init__(self, data_group=None, view_group=None, record=False):
        self.data_group = data_group
        self.view_group = view_group
        # with `record`: term name -> (the sum of its values over this
        # rank's views, whether every view rank computes it alike)
        self.recorded: Optional[Dict[str, Tuple[Tensor, bool]]] = (
            {} if record else None)
        self.n_data = 1 if data_group is None else dist.get_world_size(
            data_group)
        self.n_view_ranks, self.view_rank = (
            (1, 0) if view_group is None else
            (dist.get_world_size(view_group), dist.get_rank(view_group)))

    @property
    def local(self) -> bool:
        return self.data_group is None and self.view_group is None

    def mean(self, t: LossTerm) -> Tensor:
        """The term's value: its masked mean over the batch."""
        return t.loss if t.reduced else masked_mean(t.loss, t.mask,
                                                    self.data_group)

    def record(self, name: str, value: Tensor,
               replicated: bool = False) -> None:
        """Adds a term's value, without its gradient, to `recorded[name]`
        when recording."""
        if self.recorded is not None:
            prev = self.recorded.get(name, (0.0, replicated))[0]
            self.recorded[name] = (prev + value.detach(), replicated)

    def share(self, t: LossTerm) -> float:
        """The weight of the term in this rank's share of the total."""
        return 1.0 / self.n_view_ranks if t.replicated else 1.0

    def n_views(self, local_views: int) -> int:
        return local_views * self.n_view_ranks

    def first_view(self, x: Tensor) -> Tensor:
        """(B, V_local, ...) -> (B, ...): global view 0's entry."""
        if self.view_group is None:
            return x[:, 0]
        return _gather_views(x[:, :1], self.view_group)[:, 0]

    def is_first_view(self, v: int, device) -> Tensor:
        """(V_local,) bool: which local view is global view 0."""
        return (self.view_rank * v + torch.arange(v, device=device)) == 0

    def gather_views(self, x: Tensor) -> Tensor:
        return x if self.view_group is None else _gather_views(
            x, self.view_group)

    def all_rows(self, flag: Tensor) -> Tensor:
        """Whether the (B,) bool `flag` holds in every row of the batch:
        over every data rank's rows with a data group."""
        out = flag.all()
        if self.data_group is not None:
            out = out.to(torch.int32)
            dist.all_reduce(out, op=dist.ReduceOp.MIN, group=self.data_group)
            out = out.bool()
        return out

    def view_max(self, x: Tensor) -> Tensor:
        """(B,) maxima over this rank's views -> over every rank's views,
        without a gradient."""
        if self.view_group is None:
            return x
        x = x.detach().clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.view_group)
        return x

    def normalize(self, pts: Tensor, valid: Tensor, norm_mode: str):
        """normalize_multiple_pointclouds(..., ret_factor=True) over every
        rank's views: the distance sum reduced differentiably, the count of
        valid pixels without a gradient."""
        sums = None
        if self.view_group is not None:
            group = self.view_group

            def sums(num, nnz):
                nnz = nnz.to(num.dtype)
                dist.all_reduce(nnz, group=group)
                return all_reduce(num, group), nnz

        return normalize_multiple_pointclouds(pts, valid, norm_mode,
                                              ret_factor=True, sums=sums)


LOCAL = Reduction()


def reduce_terms(terms: Sequence[LossTerm],
                 red: Reduction = LOCAL) -> Tensor:
    """Sum of the per-term masked means (min of means for double cover),
    each weighted by its share."""
    total = 0.0
    for t in terms:
        if t.double_cover is not None:
            pos, neg = t.double_cover
            val = torch.minimum(masked_mean(pos, t.mask, red.data_group),
                                masked_mean(neg, t.mask, red.data_group))
        else:
            val = red.mean(t)
        red.record(t.rep_type, val, t.replicated)
        total = total + val * red.share(t)
    return total


def _keep_bottom_n_mask(loss: Tensor, valid: Tensor,
                        bottom_n_percent: float) -> Tensor:
    """Keep exactly floor(valid * bottom_n / 100) lowest-loss valid pixels
    per row of (B, N); ties ranked by a stable sort."""
    n = loss.shape[-1]
    num_keep = (valid.sum(-1) * bottom_n_percent / 100.0).to(torch.int32)
    masked = torch.where(valid, loss, torch.inf)
    order = torch.argsort(masked, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=loss.device).expand_as(order))
    return ranks < num_keep[:, None]


# --- MultiLoss arithmetic -----------------------------------------------------


class MultiLoss:
    """Combinable loss: `Loss1() + 0.1 * Loss2()`. `compute_loss(batch,
    preds, red)` returns a scalar or (scalar, details); calling the object
    evaluates the whole chain, its reductions through `red` (one process
    by default)."""

    _alpha: float = 1.0
    _loss2: Optional["MultiLoss"] = None

    def compute_loss(self, batch, preds, red: Reduction = LOCAL):
        raise NotImplementedError

    def get_name(self) -> str:
        return type(self).__name__

    def __mul__(self, alpha):
        assert isinstance(alpha, (int, float))
        res = copy.copy(self)
        res._alpha = alpha
        return res

    __rmul__ = __mul__

    def __add__(self, loss2):
        assert isinstance(loss2, MultiLoss)
        res = cur = copy.copy(self)
        while cur._loss2 is not None:
            nxt = copy.copy(cur._loss2)
            cur._loss2 = nxt
            cur = nxt
        cur._loss2 = loss2
        return res

    def __repr__(self):
        name = self.get_name()
        if self._alpha != 1:
            name = f"{self._alpha:g}*{name}"
        if self._loss2 is not None:
            name = f"{name} + {self._loss2!r}"
        return name

    def __call__(self, batch, preds, red: Reduction = LOCAL
                 ) -> Tuple[Tensor, Dict[str, Any]]:
        out = self.compute_loss(batch, preds, red)
        loss, details = out if isinstance(out, tuple) else (out, {})
        loss = loss * self._alpha
        if self._loss2 is not None:
            loss2, details2 = self._loss2(batch, preds, red)
            loss = loss + loss2
            details = {**details, **details2}
        return loss, details


class SetCriterion(MultiLoss):
    """A criterion that emits an ordered flat list of LossTerms through
    `loss_sets(batch, preds, red) -> (terms, details)`; bare use reduces
    them."""

    criterion: BaseCriterion

    def loss_sets(self, batch, preds, red: Reduction = LOCAL
                  ) -> Tuple[List[LossTerm], Dict[str, Any]]:
        raise NotImplementedError

    def compute_loss(self, batch, preds, red: Reduction = LOCAL):
        terms, details = self.loss_sets(batch, preds, red)
        return reduce_terms(terms, red), details

    def get_name(self):
        return f"{type(self).__name__}({type(self.criterion).__name__})"


# --- geometry helpers of the set criteria -------------------------------------


def _world_pts_in_view0(batch, red: Reduction) -> Tensor:
    """GT world points moved into view 0's camera frame."""
    r0_inv = quaternion_to_rotation_matrix(
        quaternion_inverse(red.first_view(batch["camera_pose_quats"])))
    t0_inv = -rotate(r0_inv, red.first_view(batch["camera_pose_trans"]))
    return (rotate(r0_inv[:, None, None, None], batch["pts3d"])
            + t0_inv[:, None, None, None, :])


def _gt_pose_in_view0(batch, red: Reduction) -> Tuple[Tensor, Tensor]:
    """GT camera poses relative to view 0; view 0 gets the exact identity."""
    quats, trans = batch["camera_pose_quats"], batch["camera_pose_trans"]
    rq, rt = transform_pose_using_quats_and_trans_2_to_1(
        red.first_view(quats)[:, None].expand_as(quats),
        red.first_view(trans)[:, None].expand_as(trans), quats, trans)
    first = red.is_first_view(quats.shape[1], quats.device)[None, :, None]
    rq = torch.where(first, unit_w(rq), rq)
    rt = torch.where(first, 0.0, rt)
    return rq, rt


def _unscale_preds(preds) -> Dict[str, Tensor]:
    """Predictions divided by the predicted metric scale."""
    out = dict(preds)
    if "metric_scaling_factor" in preds:
        s = preds["metric_scaling_factor"]
        s5 = s[:, None, None, None, None]
        out["pts3d"] = preds["pts3d"] / s5
        if "pts3d_cam" in preds:
            out["pts3d_cam"] = preds["pts3d_cam"] / s5
        if "depth_along_ray" in preds:
            out["depth_along_ray"] = preds["depth_along_ray"] / s5
        if "cam_trans" in preds:
            out["cam_trans"] = preds["cam_trans"] / s[:, None, None]
    return out


def _log(x: Tensor, enabled: bool) -> Tensor:
    return apply_log_to_norm(x) if enabled else x


def _div(x: Tensor, factor: Tensor, key: str) -> Tensor:
    """x over a (B, 1, 1, 1, 1) factor; the pose translation (B, V, 3)
    over its (B, 1, 1) form."""
    return x / (factor[:, :, 0, 0] if key == "pose_trans" else factor)


def _divide(quantities, factor: Tensor, **override) -> Dict[str, Tensor]:
    """The points, depth and pose translation of `quantities` divided by a
    (B, 1, 1, 1, 1) factor; `override` replaces entries outright."""
    out = dict(quantities)
    for key in ("pts3d", "pts3d_cam", "depth", "pose_trans"):
        out[key] = override[key] if key in override else _div(
            quantities[key], factor, key)
    return out


def _metric_rows(batch, gt_pts: Tensor, valid: Tensor, max_metric_scale,
                 red: Reduction) -> Tensor:
    """is_metric_scale (B,), and with `max_metric_scale` only where the
    farthest valid GT point lies nearer than it."""
    metric = batch["is_metric_scale"]
    if max_metric_scale:
        dis = torch.where(valid, torch.linalg.vector_norm(gt_pts, dim=-1),
                          0.0)
        farthest = red.view_max(dis.reshape(dis.shape[0], -1).amax(-1))
        metric = metric & (farthest < max_metric_scale)
    return metric


def _ambiguity(batch, valid: Tensor, value: float):
    """(the pixel mask, the ambiguous pixels): ambiguous pixels (not
    non-ambiguous and not valid) join the mask when `value` > 0, and their
    loss is then `value`."""
    amb = (~batch["non_ambiguous_mask"]) & (~valid)
    return (valid | amb if value > 0 else valid), amb


def _predicted_metric_factor(pr_factor: Tensor, preds) -> Tensor:
    """(B, 1): the detached prediction's norm factor, times the predicted
    metric scale where there is one."""
    s = preds.get("metric_scaling_factor")
    pr_metric = pr_factor.detach()[:, 0, 0, 0, :]
    return pr_metric if s is None else pr_metric * s[:, None]


def _scale_term(crit, pr_metric: Tensor, gt_factor: Tensor,
                metric: Tensor) -> LossTerm:
    """The metric-scale set: the predicted metric norm factor (B, 1)
    against the GT's, in log space with loss_in_log, on the metric samples
    whose GT factor is above 1e-8."""
    loss = crit.criterion(
        _log(pr_metric, crit.loss_in_log),
        _log(gt_factor[:, 0, 0, 0, :], crit.loss_in_log), factor="scale",
    ) * crit.scale_loss_weight
    return LossTerm(loss, metric & (gt_factor[:, 0, 0, 0, 0] > 1e-8),
                    "scale", replicated=True)
def _pixel_terms(loss_bvn, mask_bvn, rep_type) -> List[LossTerm]:
    """(B, V, N) stacked pixel loss -> V flat per-view terms."""
    return [LossTerm(loss_bvn[:, i],
                     None if mask_bvn is None else mask_bvn[:, i], rep_type)
            for i in range(loss_bvn.shape[1])]


def _details_for(terms: List[LossTerm], self_name: str,
                 red: Reduction) -> Dict[str, Any]:
    """Per-view means and their average per type, keyed like the reference
    (get_loss_terms_and_details)."""
    det: Dict[str, Any] = {}
    by_type: Dict[str, List[Tensor]] = {}
    for t in terms:
        vals = by_type.setdefault(t.rep_type, [])
        m = red.mean(t)
        vals.append(m)
        det[f"{self_name}_{t.rep_type}_view{len(vals)}"] = m
    for rep, vals in by_type.items():
        det[f"{self_name}_{rep}_avg"] = sum(vals) / len(vals)
    return det


# --- Regr3D, PointsPlusScaleRegr3D -------------------------------------------


def _norm_mode(norm_mode: str) -> Tuple[bool, str]:
    """(norm_all, mode) of a norm_mode: "?mode" normalises the non-metric
    samples' predictions only, "mode" every sample's."""
    return not norm_mode.startswith("?"), norm_mode.lstrip("?")


class Regr3D(SetCriterion):
    """World-frame pointmap regression in view 0's frame. Sets: pts3d x V.

    norm_mode "?avg_dis": the GT is normalised by its own factor; the
    non-metric samples' predictions by theirs, the metric samples' by the
    GT's. Without "?" (norm_all) every sample is treated as non-metric.
    gt_scale=True leaves the GT unnormalised and the metric samples'
    predictions as they are in an all-metric batch (zero in a mixed one,
    the reference's quirk)."""

    def __init__(self, criterion, norm_mode="?avg_dis", gt_scale=False,
                 ambiguous_loss_value=0.0, max_metric_scale=False,
                 loss_in_log=True, flatten_across_image_only=False):
        self.criterion = criterion
        self.norm_all, self.norm_mode = _norm_mode(norm_mode)
        self.gt_scale = gt_scale
        self.ambiguous_loss_value = ambiguous_loss_value
        self.max_metric_scale = max_metric_scale
        self.loss_in_log = loss_in_log
        self.flatten_across_image_only = flatten_across_image_only

    def loss_sets(self, batch, preds, red: Reduction = LOCAL):
        b, v, h, w, _ = batch["pts3d"].shape
        valid = batch["valid_mask"]
        gt_pts = _world_pts_in_view0(batch, red)
        pr_raw = preds["pts3d"]
        metric = _metric_rows(batch, gt_pts, valid, self.max_metric_scale,
                              red)
        non_metric = torch.ones_like(metric) if self.norm_all else ~metric
        pr_self = (red.normalize(pr_raw, valid, self.norm_mode)[0]
                   if self.norm_mode else pr_raw)
        if self.norm_mode and not self.gt_scale:
            gt_pts, gt_factor = red.normalize(gt_pts, valid, self.norm_mode)
            pr_metric = pr_raw / gt_factor
        else:
            pr_metric = torch.where(red.all_rows(~non_metric), pr_raw,
                                    torch.zeros_like(pr_raw))
        pr_pts = torch.where(non_metric[:, None, None, None, None], pr_self,
                             pr_metric)
        mask, amb = _ambiguity(batch, valid, self.ambiguous_loss_value)
        loss = self.criterion(_log(pr_pts, self.loss_in_log),
                              _log(gt_pts, self.loss_in_log),
                              factor="points")
        if self.ambiguous_loss_value > 0:
            loss = torch.where(amb, self.ambiguous_loss_value, loss)
        terms = _pixel_terms(loss.reshape(b, v, h * w),
                             mask.reshape(b, v, h * w), "pts3d")
        return terms, _details_for(terms, type(self).__name__, red)


class PointsPlusScaleRegr3D(SetCriterion):
    """World-frame pointmaps divided by the predicted metric scale, plus the
    metric-scale set. Sets: pts3d x V, scale."""

    def __init__(self, criterion, norm_predictions=True, norm_mode="avg_dis",
                 ambiguous_loss_value=0.0, loss_in_log=True,
                 flatten_across_image_only=False,
                 world_frame_points_loss_weight=1.0, scale_loss_weight=1.0):
        self.criterion = criterion
        self.norm_predictions = norm_predictions
        self.norm_mode = norm_mode
        self.ambiguous_loss_value = ambiguous_loss_value
        self.loss_in_log = loss_in_log
        self.flatten_across_image_only = flatten_across_image_only
        self.world_frame_points_loss_weight = world_frame_points_loss_weight
        self.scale_loss_weight = scale_loss_weight

    def loss_sets(self, batch, preds, red: Reduction = LOCAL):
        b, v, h, w, _ = batch["pts3d"].shape
        valid = batch["valid_mask"]
        gt_pts, gt_factor = red.normalize(_world_pts_in_view0(batch, red),
                                          valid, self.norm_mode)
        pr_pts = _unscale_preds(preds)["pts3d"]
        if self.norm_predictions:
            pr_pts, pr_factor = red.normalize(pr_pts, valid, self.norm_mode)
        else:
            pr_factor = torch.ones_like(gt_factor)
        mask, amb = _ambiguity(batch, valid, self.ambiguous_loss_value)
        loss = self.criterion(_log(pr_pts, self.loss_in_log),
                              _log(gt_pts, self.loss_in_log),
                              factor="points")
        if self.ambiguous_loss_value > 0:
            loss = torch.where(amb, self.ambiguous_loss_value, loss)
        loss = loss * self.world_frame_points_loss_weight
        terms = _pixel_terms(loss.reshape(b, v, h * w),
                             mask.reshape(b, v, h * w), "pts3d")
        terms.append(_scale_term(self, _predicted_metric_factor(pr_factor,
                                                                preds),
                                 gt_factor, batch["is_metric_scale"]))
        return terms, _details_for(terms, type(self).__name__, red)


# --- FactoredGeometry[Scale]Regr3D --------------------------------------------


class FactoredGeometryRegr3D(SetCriterion):
    """Factored geometry regression without the scale set. Set order:
    [pts3d?] cam_pts3d depth ray_dirs pose_quats pose_trans, each x V.
    norm_mode, gt_scale and max_metric_scale as in Regr3D, for the points,
    depth and pose translation alike."""

    _has_scale_set = False

    def __init__(self, criterion, norm_mode="?avg_dis", gt_scale=False,
                 ambiguous_loss_value=0.0, max_metric_scale=False,
                 loss_in_log=True, flatten_across_image_only=False,
                 depth_type_for_loss="depth_along_ray",
                 cam_frame_points_loss_weight=1.0, depth_loss_weight=1.0,
                 ray_directions_loss_weight=1.0, pose_quats_loss_weight=1.0,
                 pose_trans_loss_weight=1.0,
                 compute_pairwise_relative_pose_loss=False,
                 compute_world_frame_points_loss=True,
                 world_frame_points_loss_weight=1.0):
        self.criterion = criterion
        self.norm_all, self.norm_mode = _norm_mode(norm_mode)
        self.gt_scale = gt_scale
        self.ambiguous_loss_value = ambiguous_loss_value
        self.max_metric_scale = max_metric_scale
        self.loss_in_log = loss_in_log
        self.flatten_across_image_only = flatten_across_image_only
        self.depth_type_for_loss = depth_type_for_loss
        self.cam_frame_points_loss_weight = cam_frame_points_loss_weight
        self.depth_loss_weight = depth_loss_weight
        self.ray_directions_loss_weight = ray_directions_loss_weight
        self.pose_quats_loss_weight = pose_quats_loss_weight
        self.pose_trans_loss_weight = pose_trans_loss_weight
        self.compute_pairwise_relative_pose_loss = (
            compute_pairwise_relative_pose_loss)
        self.compute_world_frame_points_loss = compute_world_frame_points_loss
        self.world_frame_points_loss_weight = world_frame_points_loss_weight

    def _gather(self, batch, preds, red):
        gt = {
            "pts3d": _world_pts_in_view0(batch, red),
            "pts3d_cam": batch["pts3d_cam"],
            "ray_directions": batch["ray_directions_cam"],
        }
        gt["depth"] = (batch["depth_along_ray"]
                       if self.depth_type_for_loss == "depth_along_ray"
                       else batch["pts3d_cam"][..., 2:])
        gt["pose_quats"], gt["pose_trans"] = _gt_pose_in_view0(batch, red)

        up = _unscale_preds(preds) if self._has_scale_set else dict(preds)
        pr = {
            "pts3d": up["pts3d"],
            "pts3d_cam": up["pts3d_cam"],
            "ray_directions": preds["ray_directions"],
            "pose_quats": preds["cam_quats"],
            "pose_trans": up["cam_trans"],
        }
        pr["depth"] = (up["depth_along_ray"]
                       if self.depth_type_for_loss == "depth_along_ray"
                       else up["pts3d_cam"][..., 2:])
        return gt, pr

    def _normalize(self, gt, pr, batch, valid, red):
        """The GT divided by its own factor (none with gt_scale or without
        a norm mode); each non-metric sample's predictions by theirs, each
        metric sample's by the GT's (Regr3D's rules)."""
        metric = _metric_rows(batch, gt["pts3d"], valid,
                              self.max_metric_scale, red)
        non_metric = torch.ones_like(metric) if self.norm_all else ~metric
        nm = non_metric[:, None, None, None, None]
        pr_self, pr_factor = pr["pts3d"], None
        if self.norm_mode:
            pr_self, pr_factor = red.normalize(pr["pts3d"], valid,
                                               self.norm_mode)
        out_gt, gt_factor = dict(gt), None
        if self.norm_mode and not self.gt_scale:
            gt_norm, gt_factor = red.normalize(gt["pts3d"], valid,
                                               self.norm_mode)
            out_gt = _divide(gt, gt_factor, pts3d=gt_norm)
        all_metric = red.all_rows(~non_metric)

        def mix(key, own):
            x = pr[key]
            metric_x = (torch.where(all_metric, x, torch.zeros_like(x))
                        if gt_factor is None else _div(x, gt_factor, key))
            return torch.where(nm if key != "pose_trans" else nm[:, :, 0, 0],
                               own, metric_x)

        out_pr = dict(pr, pts3d=mix("pts3d", pr_self))
        for key in ("pts3d_cam", "depth", "pose_trans"):
            out_pr[key] = mix(key, pr[key] if pr_factor is None
                              else _div(pr[key], pr_factor, key))
        return out_gt, out_pr, gt_factor, pr_factor, metric

    def _pose_terms(self, gt, pr, view_has_valid, b, v, red):
        pairwise_arm = self.compute_pairwise_relative_pose_loss
        if pairwise_arm:
            # over every view: with a view group the per-view vectors are
            # gathered and the terms computed alike on every rank
            pr, gt = ({key: red.gather_views(d[key])
                       for key in ("pose_quats", "pose_trans")}
                      for d in (pr, gt))
            view_has_valid = red.gather_views(
                view_has_valid[..., None].to(torch.uint8))[..., 0].bool()
            v = view_has_valid.shape[1]

            def pairwise(quats, trans):
                rq, rt = transform_pose_using_quats_and_trans_2_to_1(
                    quats[:, :, None].expand(b, v, v, 4),
                    trans[:, :, None].expand(b, v, v, 3),
                    quats[:, None, :].expand(b, v, v, 4),
                    trans[:, None, :].expand(b, v, v, 3))
                return rq, rt

            pr_q, pr_t = pairwise(pr["pose_quats"], pr["pose_trans"])
            gt_q, gt_t = pairwise(gt["pose_quats"], gt["pose_trans"])
            off_diag = ~torch.eye(v, dtype=torch.bool,
                                  device=view_has_valid.device)[None]
            q_mask = [off_diag[:, i].expand(b, v) for i in range(v)]
            pair_valid = (view_has_valid[:, :, None]
                          & view_has_valid[:, None, :] & off_diag)
            t_mask = [pair_valid[:, i] for i in range(v)]
        else:
            pr_q, pr_t = pr["pose_quats"], pr["pose_trans"]
            gt_q, gt_t = gt["pose_quats"], gt["pose_trans"]
            q_mask = [None] * v
            t_mask = [view_has_valid[:, i] for i in range(v)]
        q_pos = self.criterion(pr_q, gt_q, factor="pose_quats")
        q_neg = self.criterion(pr_q, -gt_q, factor="pose_quats")
        quats_loss = torch.minimum(q_pos, q_neg) * self.pose_quats_loss_weight
        q_pos = q_pos * self.pose_quats_loss_weight
        q_neg = q_neg * self.pose_quats_loss_weight
        trans_loss = self.criterion(
            pr_t, gt_t, factor="pose_trans") * self.pose_trans_loss_weight
        quats_terms = [LossTerm(quats_loss[:, i], q_mask[i], "pose_quats",
                                double_cover=(q_pos[:, i], q_neg[:, i]),
                                replicated=pairwise_arm)
                       for i in range(v)]
        trans_terms = [LossTerm(trans_loss[:, i], t_mask[i], "pose_trans",
                                replicated=pairwise_arm)
                       for i in range(v)]
        return quats_terms, trans_terms

    def _pixel_sets(self, gt, pr, batch, valid, b, v, h, w):
        """pts3d? cam_pts3d depth ray_dirs pixel sets in the reference's
        order; the ambiguous pixels' loss is ambiguous_loss_value where it
        is set (not on the ray directions, which take every pixel)."""
        n = h * w
        mask, amb = _ambiguity(batch, valid, self.ambiguous_loss_value)
        mask_f = mask.reshape(b, v, n)

        def crit(key, log, weight, factor, rep_type, pixels=True):
            loss = self.criterion(_log(pr[key], log), _log(gt[key], log),
                                  factor=factor)
            if self.ambiguous_loss_value > 0 and pixels:
                loss = torch.where(amb, self.ambiguous_loss_value, loss)
            loss = (loss * weight).reshape(b, v, n)
            return _pixel_terms(loss, mask_f if pixels else None, rep_type)

        terms: List[LossTerm] = []
        if self.compute_world_frame_points_loss:
            terms += crit("pts3d", self.loss_in_log,
                          self.world_frame_points_loss_weight, "points",
                          "pts3d")
        terms += crit("pts3d_cam", self.loss_in_log,
                      self.cam_frame_points_loss_weight, "points",
                      "cam_pts3d")
        terms += crit("depth", self.loss_in_log, self.depth_loss_weight,
                      "depth", self.depth_type_for_loss)
        terms += crit("ray_directions", False,
                      self.ray_directions_loss_weight, "ray_directions",
                      "ray_directions", pixels=False)
        return terms

    def loss_sets(self, batch, preds, red: Reduction = LOCAL):
        terms, details, _ = self._sets(batch, preds, red)
        return terms, details

    def _sets(self, batch, preds, red=LOCAL):
        """(terms, details, (the normalised gt, pr, the GT factor)) of
        loss_sets."""
        b, v, h, w, _ = batch["pts3d"].shape
        valid = batch["valid_mask"]
        view_has_valid = valid.reshape(b, v, -1).sum(-1) > 0

        gt_raw, pr_raw = self._gather(batch, preds, red)
        gt, pr, gt_factor, pr_factor, metric = self._normalize(
            gt_raw, pr_raw, batch, valid, red)
        terms = self._pixel_sets(gt, pr, batch, valid, b, v, h, w)
        quats_terms, trans_terms = self._pose_terms(gt, pr, view_has_valid,
                                                    b, v, red)
        terms += quats_terms + trans_terms

        if self._has_scale_set:
            if pr_factor is None:
                # the metric factor is always that of the unscaled prediction
                _, pr_factor = red.normalize(pr_raw["pts3d"], valid,
                                             self.norm_mode)
            terms.append(_scale_term(
                self, _predicted_metric_factor(pr_factor, preds), gt_factor,
                metric))
        return (terms, _details_for(terms, type(self).__name__, red),
                (gt, pr, gt_factor))


class FactoredGeometryScaleRegr3D(FactoredGeometryRegr3D):
    """Factored geometry plus the metric-scale set. Predictions are divided
    by the predicted metric_scaling_factor, GT and (with norm_predictions)
    predictions are normalised by their own joint factor, and the scale set
    supervises the detached prediction's metric norm factor."""

    _has_scale_set = True

    def __init__(self, criterion, norm_predictions=True, norm_mode="avg_dis",
                 ambiguous_loss_value=0.0, loss_in_log=True,
                 flatten_across_image_only=False,
                 depth_type_for_loss="depth_along_ray",
                 cam_frame_points_loss_weight=1.0, depth_loss_weight=1.0,
                 ray_directions_loss_weight=1.0, pose_quats_loss_weight=1.0,
                 pose_trans_loss_weight=1.0, scale_loss_weight=1.0,
                 compute_pairwise_relative_pose_loss=False,
                 compute_world_frame_points_loss=True,
                 world_frame_points_loss_weight=1.0):
        super().__init__(
            criterion, norm_mode="avg_dis",
            ambiguous_loss_value=ambiguous_loss_value,
            loss_in_log=loss_in_log,
            flatten_across_image_only=flatten_across_image_only,
            depth_type_for_loss=depth_type_for_loss,
            cam_frame_points_loss_weight=cam_frame_points_loss_weight,
            depth_loss_weight=depth_loss_weight,
            ray_directions_loss_weight=ray_directions_loss_weight,
            pose_quats_loss_weight=pose_quats_loss_weight,
            pose_trans_loss_weight=pose_trans_loss_weight,
            compute_pairwise_relative_pose_loss=(
                compute_pairwise_relative_pose_loss),
            compute_world_frame_points_loss=compute_world_frame_points_loss,
            world_frame_points_loss_weight=world_frame_points_loss_weight)
        self.norm_predictions = norm_predictions
        self.norm_mode = norm_mode
        self.scale_loss_weight = scale_loss_weight

    def _normalize(self, gt, pr, batch, valid, red):
        gt_norm, gt_factor = red.normalize(gt["pts3d"], valid,
                                           self.norm_mode)
        out_gt = _divide(gt, gt_factor, pts3d=gt_norm)
        out_pr, pr_factor = dict(pr), None
        if self.norm_predictions:
            pr_norm, pr_factor = red.normalize(pr["pts3d"], valid,
                                               self.norm_mode)
            out_pr = _divide(pr, pr_factor, pts3d=pr_norm)
        return out_gt, out_pr, gt_factor, pr_factor, batch["is_metric_scale"]


class _NormalGM:
    """Adds per-view normal-consistency and gradient-matching terms after a
    set criterion's sets: normals on its normalised camera points, gradient
    matching on their log z, on synthetic samples only where
    apply_normal_and_gm_loss_to_synthetic_data_only."""

    def __init__(self, *args,
                 apply_normal_and_gm_loss_to_synthetic_data_only=True,
                 normal_loss_weight=1.0, gm_loss_weight=1.0, **kw):
        super().__init__(*args, **kw)
        self.apply_normal_and_gm_loss_to_synthetic_data_only = (
            apply_normal_and_gm_loss_to_synthetic_data_only)
        self.normal_loss_weight = normal_loss_weight
        self.gm_loss_weight = gm_loss_weight

    def _sets(self, batch, preds, red=LOCAL):
        terms, details, (gt, pr, gt_factor) = super()._sets(batch, preds,
                                                            red)
        b, v = batch["pts3d"].shape[:2]
        mask = batch["valid_mask"]
        if self.apply_normal_and_gm_loss_to_synthetic_data_only:
            syn = batch.get("is_synthetic")
            if syn is None:
                syn = torch.zeros(b, dtype=torch.bool, device=mask.device)
            mask = mask & syn[:, None, None, None]

        normal_terms, gm_terms = [], []
        group = red.data_group
        for i in range(v):
            pr_cam, gt_cam = pr["pts3d_cam"][:, i], gt["pts3d_cam"][:, i]
            nrm = compute_normal_loss(pr_cam, gt_cam, mask[:, i], group)
            gm = compute_gradient_matching_loss(
                apply_log_to_norm(pr_cam[..., 2:]),
                apply_log_to_norm(gt_cam[..., 2:]), mask[:, i], group=group)
            normal_terms.append(LossTerm(nrm * self.normal_loss_weight, None,
                                         "normal", reduced=True))
            gm_terms.append(LossTerm(gm * self.gm_loss_weight, None,
                                     "gradient_matching", reduced=True))
        terms += normal_terms + gm_terms
        details.update(_details_for(normal_terms + gm_terms,
                                    type(self).__name__, red))
        return terms, details, (gt, pr, gt_factor)


class FactoredGeometryRegr3DPlusNormalGMLoss(_NormalGM,
                                             FactoredGeometryScaleRegr3D):
    """FactoredGeometryScaleRegr3D with the normal and gradient-matching
    terms (as in the JAX package, on the scale criterion)."""


class FactoredGeometryScaleRegr3DPlusNormalGMLoss(
        FactoredGeometryRegr3DPlusNormalGMLoss):
    """The released recipe's pixel criterion."""


# --- DisentangledFactoredGeometryScaleRegr3D --------------------------------


class DisentangledFactoredGeometryScaleRegr3D(SetCriterion):
    """Disentangled factored loss: each factor is judged by the world-frame
    pointmap it gives when every other factor is the ground truth
    (Simonelli et al., ICCV 2019). Sets: depth_along_ray, ray_directions,
    pose_quats, pose_trans (pixel sets, x V each), scale."""

    def __init__(self, criterion, norm_predictions=True, norm_mode="avg_dis",
                 loss_in_log=True, flatten_across_image_only=False,
                 depth_type_for_loss="depth_along_ray",
                 depth_loss_weight=1.0, ray_directions_loss_weight=1.0,
                 pose_quats_loss_weight=1.0, pose_trans_loss_weight=1.0,
                 scale_loss_weight=1.0):
        if depth_type_for_loss != "depth_along_ray":
            raise ValueError("the disentangled loss takes depth_along_ray "
                             "only, as the reference")
        self.criterion = criterion
        self.norm_predictions = norm_predictions
        self.norm_mode = norm_mode
        self.loss_in_log = loss_in_log
        self.flatten_across_image_only = flatten_across_image_only
        self.depth_type_for_loss = depth_type_for_loss
        self.depth_loss_weight = depth_loss_weight
        self.ray_directions_loss_weight = ray_directions_loss_weight
        self.pose_quats_loss_weight = pose_quats_loss_weight
        self.pose_trans_loss_weight = pose_trans_loss_weight
        self.scale_loss_weight = scale_loss_weight

    def loss_sets(self, batch, preds, red: Reduction = LOCAL):
        terms, details, _ = self._sets(batch, preds, red)
        return terms, details

    def _sets(self, batch, preds, red=LOCAL):
        """(terms, details, ({"pts3d_cam"} of the GT and the prediction,
        normalised, the GT factor))."""
        b, v, h, w, _ = batch["pts3d"].shape
        valid = batch["valid_mask"]
        up = _unscale_preds(preds)
        gt_quats, gt_trans = _gt_pose_in_view0(batch, red)
        gt_rays = batch["ray_directions_cam"]
        gt_pts, gt_factor = red.normalize(_world_pts_in_view0(batch, red),
                                          valid, self.norm_mode)
        gt_depth = batch["depth_along_ray"] / gt_factor
        gt_trans = _div(gt_trans, gt_factor, "pose_trans")
        pr_depth, pr_trans = up["depth_along_ray"], up["cam_trans"]
        pr_cam = up["pts3d_cam"]
        if self.norm_predictions:
            _, pr_factor = red.normalize(up["pts3d"], valid, self.norm_mode)
            pr_depth = pr_depth / pr_factor
            pr_trans = _div(pr_trans, pr_factor, "pose_trans")
            pr_cam = pr_cam / pr_factor

        recombine = (
            convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap)
        per_factor = (  # the reference's set order
            ("depth_along_ray", self.depth_loss_weight,
             recombine(gt_rays, pr_depth, gt_trans, gt_quats)),
            ("ray_directions", self.ray_directions_loss_weight,
             recombine(preds["ray_directions"], gt_depth, gt_trans,
                       gt_quats)),
            ("pose_quats", self.pose_quats_loss_weight,
             recombine(gt_rays, gt_depth, gt_trans, preds["cam_quats"])),
            ("pose_trans", self.pose_trans_loss_weight,
             recombine(gt_rays, gt_depth, pr_trans, gt_quats)),
        )
        gt_l = _log(gt_pts, self.loss_in_log)
        mask_f = valid.reshape(b, v, h * w)
        terms: List[LossTerm] = []
        for name, weight, pts in per_factor:
            loss = self.criterion(_log(pts, self.loss_in_log), gt_l,
                                  factor="points") * weight
            terms += _pixel_terms(loss.reshape(b, v, h * w), mask_f, name)

        s = preds.get("metric_scaling_factor")
        if self.norm_predictions:
            # the factor of the detached metric-scaled prediction
            scaled = up["pts3d"].detach()
            if s is not None:
                scaled = scaled * s[:, None, None, None, None]
            pr_metric = red.normalize(scaled, valid,
                                      self.norm_mode)[1][:, 0, 0, 0, :]
        else:
            pr_metric = torch.ones_like(gt_factor)[:, 0, 0, 0, :]
            if s is not None:
                pr_metric = pr_metric * s[:, None]
        terms.append(_scale_term(self, pr_metric, gt_factor,
                                 batch["is_metric_scale"]))
        return (terms, _details_for(terms, type(self).__name__, red),
                ({"pts3d_cam": batch["pts3d_cam"] / gt_factor},
                 {"pts3d_cam": pr_cam}, gt_factor))


class DisentangledFactoredGeometryScaleRegr3DPlusNormalGMLoss(
        _NormalGM, DisentangledFactoredGeometryScaleRegr3D):
    """The disentangled loss with the normal and gradient-matching terms."""


# --- standalone wrappers ------------------------------------------------------


def _select_flat(terms: List[LossTerm], indices, n_views):
    """Set idx covers flat slots [idx*V, (idx+1)*V)."""
    selected, covered = [], set()
    for idx in indices:
        start, end = idx * n_views, min((idx + 1) * n_views, len(terms))
        selected.extend((k, terms[k]) for k in range(start, end))
        covered.update(range(start, end))
    return selected, covered


class NonAmbiguousMaskLoss(MultiLoss):
    """BCE on the non-ambiguous mask logits; one mean per view, summed."""

    def __init__(self, criterion=None):
        self.criterion = criterion if criterion is not None else BCELoss()

    def get_name(self):
        return f"NonAmbiguousMaskLoss({type(self.criterion).__name__})"

    def compute_loss(self, batch, preds, red: Reduction = LOCAL):
        logits = preds["non_ambiguous_mask_logits"]  # (B, V, H, W)
        gt = batch["non_ambiguous_mask"]
        v = logits.shape[1]
        total = 0.0
        details = {}
        for i in range(v):
            li = masked_mean(self.criterion(logits[:, i], gt[:, i]), None,
                             red.data_group)
            total = total + li
            red.record("mask_bce", li)
            details[f"NonAmbiguousMaskLoss_mask_view{i + 1}"] = li
        details["NonAmbiguousMaskLoss_mask_avg"] = total / v
        return total, details


class _SetWrapper(MultiLoss):
    """Shared plumbing of the set-selecting wrappers."""

    pixel_loss: SetCriterion

    def _n_views(self, batch):
        return batch["pts3d"].shape[1]

    def _reduce_rest(self, terms, covered, red):
        total = 0.0
        for k, t in enumerate(terms):
            if k not in covered:
                val = red.mean(t)
                red.record(t.rep_type, val, t.replicated)
                total = total + val * red.share(t)
        return total


class ConfLoss(_SetWrapper):
    """raw * conf - alpha * log(conf) on the selected pixel sets; every
    other set mean-reduced."""

    def __init__(self, pixel_loss, alpha=1.0, loss_set_indices=None):
        assert alpha > 0
        self.pixel_loss = pixel_loss
        self.alpha = alpha
        self.loss_set_indices = ([0] if loss_set_indices is None
                                 else list(loss_set_indices))

    def get_name(self):
        return f"ConfLoss({self.pixel_loss.get_name()})"

    def _conf_reduce(self, term, view_idx, preds, red):
        b = term.loss.shape[0]
        conf = preds["conf"][:, view_idx].reshape(b, -1)
        return masked_mean(term.loss * conf - self.alpha * torch.log(conf),
                           term.mask, red.data_group)

    def _conf_terms(self, selected, n_views, preds, details, red):
        total = 0.0
        for loss_idx, (_, term) in enumerate(selected):
            view_idx = loss_idx % n_views
            val = self._conf_reduce(term, view_idx, preds, red)
            total = total + val
            red.record(f"{term.rep_type}_conf", val)
            details[f"{term.rep_type}_conf_loss_view{view_idx + 1}"] = val
        return total

    def compute_loss(self, batch, preds, red: Reduction = LOCAL):
        n_views = self._n_views(batch)
        terms, details = self.pixel_loss.loss_sets(batch, preds, red)
        selected, covered = _select_flat(terms, self.loss_set_indices,
                                         n_views)
        total = self._conf_terms(selected, n_views, preds, details, red)
        return total + self._reduce_rest(terms, covered, red), details


class ExcludeTopNPercentPixelLoss(_SetWrapper):
    """Drops the top-N% highest per-pixel losses of each image on the
    selected sets; with apply_to_real_data_only, synthetic samples keep
    every valid pixel."""

    def __init__(self, pixel_loss, top_n_percent=5.0,
                 apply_to_real_data_only=True, loss_set_indices=None):
        self.pixel_loss = pixel_loss
        self.top_n_percent = top_n_percent
        self.bottom_n_percent = 100.0 - top_n_percent
        self.apply_to_real_data_only = apply_to_real_data_only
        self.loss_set_indices = ([1] if loss_set_indices is None
                                 else list(loss_set_indices))

    def get_name(self):
        return f"ExcludeTopNPercentPixelLoss({self.pixel_loss.get_name()})"

    def _exclude_reduce(self, term, batch, red):
        valid = (term.mask if term.mask is not None
                 else torch.ones(term.loss.shape, dtype=torch.bool,
                                 device=term.loss.device))
        keep = _keep_bottom_n_mask(term.loss, valid, self.bottom_n_percent)
        syn = batch.get("is_synthetic")
        if self.apply_to_real_data_only and syn is not None:
            keep = torch.where(syn[:, None], valid, keep)
        return masked_mean(term.loss, keep, red.data_group)

    def _exclude_terms(self, selected, n_views, batch, details, red):
        total = 0.0
        for loss_idx, (_, term) in enumerate(selected):
            view_idx = loss_idx % n_views
            val = self._exclude_reduce(term, batch, red)
            total = total + val
            red.record(term.rep_type, val)
            details[f"{term.rep_type}_bot{self.bottom_n_percent:g}%_view"
                    f"{view_idx + 1}"] = val
        return total

    def compute_loss(self, batch, preds, red: Reduction = LOCAL):
        n_views = self._n_views(batch)
        terms, details = self.pixel_loss.loss_sets(batch, preds, red)
        selected, covered = _select_flat(terms, self.loss_set_indices,
                                         n_views)
        total = self._exclude_terms(selected, n_views, batch, details, red)
        return total + self._reduce_rest(terms, covered, red), details


class ConfAndExcludeTopNPercentPixelLoss(ConfLoss,
                                         ExcludeTopNPercentPixelLoss):
    """ConfLoss on one index set and ExcludeTopNPercent on another: the
    released recipe's wrapper (conf on [0], exclude on [1, 2])."""

    def __init__(self, pixel_loss, conf_alpha=1.0, top_n_percent=5.0,
                 apply_to_real_data_only=True, conf_loss_set_indices=None,
                 exclude_loss_set_indices=None):
        assert conf_alpha > 0
        self.pixel_loss = pixel_loss
        self.alpha = conf_alpha
        self.top_n_percent = top_n_percent
        self.bottom_n_percent = 100.0 - top_n_percent
        self.apply_to_real_data_only = apply_to_real_data_only
        self.conf_loss_set_indices = ([0] if conf_loss_set_indices is None
                                      else list(conf_loss_set_indices))
        self.exclude_loss_set_indices = (
            [1] if exclude_loss_set_indices is None
            else list(exclude_loss_set_indices))

    def get_name(self):
        return ("ConfAndExcludeTopNPercentPixelLoss("
                f"{self.pixel_loss.get_name()})")

    def compute_loss(self, batch, preds, red: Reduction = LOCAL):
        n_views = self._n_views(batch)
        terms, details = self.pixel_loss.loss_sets(batch, preds, red)
        conf_sel, conf_cov = _select_flat(terms, self.conf_loss_set_indices,
                                          n_views)
        excl_sel, excl_cov = _select_flat(
            terms, self.exclude_loss_set_indices, n_views)
        total = (self._conf_terms(conf_sel, n_views, preds, details, red)
                 + self._exclude_terms(excl_sel, n_views, batch, details,
                                       red))
        return (total + self._reduce_rest(terms, conf_cov | excl_cov, red),
                details)


def released_criterion(cfg: OverallLossConfig = OverallLossConfig()
                       ) -> MultiLoss:
    """configs/loss/overall_loss.yaml's train criterion, with the options
    of `cfg` (see train/losses.py::overall_loss)."""
    fc = cfg.factored
    w = fc.weights
    kw = dict(
        norm_predictions=fc.norm_predictions,
        norm_mode=fc.norm_mode,
        loss_in_log=fc.loss_in_log,
        depth_type_for_loss=fc.depth_type_for_loss,
        compute_world_frame_points_loss=fc.compute_world_frame_points_loss,
        compute_pairwise_relative_pose_loss=(
            fc.compute_pairwise_relative_pose_loss),
        world_frame_points_loss_weight=w[0],
        cam_frame_points_loss_weight=w[1],
        depth_loss_weight=w[2],
        ray_directions_loss_weight=w[3],
        pose_quats_loss_weight=w[4],
        pose_trans_loss_weight=w[5],
        scale_loss_weight=w[6],
    )
    crit = RobustRegressionLoss(cfg.criterion_alpha, cfg.criterion_scaling_c)
    if cfg.use_normal_gm:
        pixel = FactoredGeometryScaleRegr3DPlusNormalGMLoss(
            crit, normal_loss_weight=cfg.normal_loss_weight,
            gm_loss_weight=cfg.gm_loss_weight, **kw)
    else:
        pixel = FactoredGeometryScaleRegr3D(crit, **kw)
    return ConfAndExcludeTopNPercentPixelLoss(
        pixel, conf_alpha=cfg.conf_alpha, top_n_percent=cfg.top_n_percent,
        conf_loss_set_indices=[0], exclude_loss_set_indices=[1, 2],
    ) + cfg.mask_loss_weight * NonAmbiguousMaskLoss(BCELoss())


__all__ = [
    "BCELoss",
    "BaseCriterion",
    "ConfAndExcludeTopNPercentPixelLoss",
    "ConfLoss",
    "DisentangledFactoredGeometryScaleRegr3D",
    "DisentangledFactoredGeometryScaleRegr3DPlusNormalGMLoss",
    "ExcludeTopNPercentPixelLoss",
    "FactoredGeometryRegr3D",
    "FactoredGeometryRegr3DPlusNormalGMLoss",
    "FactoredGeometryScaleRegr3D",
    "FactoredGeometryScaleRegr3DPlusNormalGMLoss",
    "FactoredLLoss",
    "GenericLLoss",
    "L1Loss",
    "L2Loss",
    "LossTerm",
    "MultiLoss",
    "NonAmbiguousMaskLoss",
    "PointsPlusScaleRegr3D",
    "Reduction",
    "Regr3D",
    "RobustRegressionLoss",
    "SetCriterion",
    "masked_mean",
    "reduce_terms",
    "released_criterion",
]
