"""Composable training criteria; counterpart of the part of
mapanything_tpu/train/criteria.py that the released criterion reaches.

Semantics follow the JAX package (and through it the reference losses.py):

  * every criterion emits an ordered flat list of per-view loss terms: set i
    takes flat slots [i*V, (i+1)*V), trailing single-entry sets (scale)
    follow, then the per-view normal and gradient-matching terms;
  * a term reduces to the mean over its valid elements, and the total is
    the sum of the reduced terms;
  * the exclude-top-N% wrapper keeps exactly floor(valid * (100-N) / 100)
    lowest-loss valid pixels per image, ranked by a stable sort.

Terms keep full-shape tensors with masks instead of gathered vectors. The
constructors take the options that train/losses.py's OverallLossConfig and
FactoredGeometryConfig set; the rest of the reference's surface is fixed at
the released recipe's values: the "?avg_dis" normalisation of
FactoredGeometryRegr3D (GT always normalised, predictions by their own
factor unless the sample is metric), no ambiguous-pixel loss, the
normal/gradient-matching terms on synthetic data only and the top-N%
exclusion on real data only. Regr3D, PointsPlusScaleRegr3D and the
Disentangled* family are not ported (ROADMAP queue A item 6).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..geometry import (
    apply_log_to_norm,
    normalize_multiple_pointclouds,
    quaternion_inverse,
    quaternion_to_rotation_matrix,
    transform_pose_using_quats_and_trans_2_to_1,
)
from ..geometry.quats import rotate
from .losses import (
    OverallLossConfig,
    RobustRegressionLoss,
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
    in `loss` for the wrappers)."""

    loss: Tensor
    mask: Optional[Tensor]
    rep_type: str
    double_cover: Optional[Tuple[Tensor, Tensor]] = None


def _masked_mean(x: Tensor, mask: Optional[Tensor]) -> Tensor:
    """Mean over the valid elements; 0 when none is valid."""
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def reduce_terms(terms: Sequence[LossTerm]) -> Tensor:
    """Sum of the per-term masked means (min of means for double cover)."""
    total = 0.0
    for t in terms:
        if t.double_cover is not None:
            pos, neg = t.double_cover
            total = total + torch.minimum(_masked_mean(pos, t.mask),
                                          _masked_mean(neg, t.mask))
        else:
            total = total + _masked_mean(t.loss, t.mask)
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
    preds)` returns a scalar or (scalar, details); calling the object
    evaluates the whole chain."""

    _alpha: float = 1.0
    _loss2: Optional["MultiLoss"] = None

    def compute_loss(self, batch, preds):
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

    def __call__(self, batch, preds) -> Tuple[Tensor, Dict[str, Any]]:
        out = self.compute_loss(batch, preds)
        loss, details = out if isinstance(out, tuple) else (out, {})
        loss = loss * self._alpha
        if self._loss2 is not None:
            loss2, details2 = self._loss2(batch, preds)
            loss = loss + loss2
            details = {**details, **details2}
        return loss, details


class SetCriterion(MultiLoss):
    """A criterion that emits an ordered flat list of LossTerms through
    `loss_sets(batch, preds) -> (terms, details)`; bare use reduces them."""

    criterion: BaseCriterion

    def loss_sets(self, batch, preds) -> Tuple[List[LossTerm], Dict[str, Any]]:
        raise NotImplementedError

    def compute_loss(self, batch, preds):
        terms, details = self.loss_sets(batch, preds)
        return reduce_terms(terms), details

    def get_name(self):
        return f"{type(self).__name__}({type(self.criterion).__name__})"


# --- geometry helpers of the set criteria -------------------------------------


def _world_pts_in_view0(batch) -> Tensor:
    """GT world points moved into view 0's camera frame."""
    r0_inv = quaternion_to_rotation_matrix(
        quaternion_inverse(batch["camera_pose_quats"][:, 0]))  # (B, 3, 3)
    t0_inv = -rotate(r0_inv, batch["camera_pose_trans"][:, 0])
    return (rotate(r0_inv[:, None, None, None], batch["pts3d"])
            + t0_inv[:, None, None, None, :])


def _gt_pose_in_view0(batch) -> Tuple[Tensor, Tensor]:
    """GT camera poses relative to view 0; view 0 gets the exact identity."""
    quats, trans = batch["camera_pose_quats"], batch["camera_pose_trans"]
    rq, rt = transform_pose_using_quats_and_trans_2_to_1(
        quats[:, :1].expand_as(quats), trans[:, :1].expand_as(trans),
        quats, trans)
    rq = torch.cat([rq.new_tensor([0.0, 0.0, 0.0, 1.0]).expand_as(rq[:, :1]),
                    rq[:, 1:]], dim=1)
    rt = torch.cat([torch.zeros_like(rt[:, :1]), rt[:, 1:]], dim=1)
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


def _divide(quantities, factor: Tensor, **override) -> Dict[str, Tensor]:
    """The points, depth and pose translation of `quantities` divided by a
    (B, 1, 1, 1, 1) factor; `override` replaces entries outright."""
    out = dict(quantities)
    for key in ("pts3d", "pts3d_cam", "depth", "pose_trans"):
        out[key] = override[key] if key in override else (
            quantities[key] / (factor[:, :, 0, 0] if key == "pose_trans"
                               else factor))
    return out


def _pixel_terms(loss_bvn, mask_bvn, rep_type) -> List[LossTerm]:
    """(B, V, N) stacked pixel loss -> V flat per-view terms."""
    return [LossTerm(loss_bvn[:, i],
                     None if mask_bvn is None else mask_bvn[:, i], rep_type)
            for i in range(loss_bvn.shape[1])]


def _details_for(terms: List[LossTerm], self_name: str) -> Dict[str, Any]:
    """Per-view means and their average per type, keyed like the reference
    (get_loss_terms_and_details)."""
    det: Dict[str, Any] = {}
    by_type: Dict[str, List[Tensor]] = {}
    for t in terms:
        vals = by_type.setdefault(t.rep_type, [])
        m = _masked_mean(t.loss, t.mask)
        vals.append(m)
        det[f"{self_name}_{t.rep_type}_view{len(vals)}"] = m
    for rep, vals in by_type.items():
        det[f"{self_name}_{rep}_avg"] = sum(vals) / len(vals)
    return det


# --- FactoredGeometry[Scale]Regr3D --------------------------------------------


class FactoredGeometryRegr3D(SetCriterion):
    """Factored geometry regression without the scale set. Set order:
    [pts3d?] cam_pts3d depth ray_dirs pose_quats pose_trans, each x V."""

    _has_scale_set = False
    norm_mode = "avg_dis"

    def __init__(self, criterion, loss_in_log=True,
                 depth_type_for_loss="depth_along_ray",
                 cam_frame_points_loss_weight=1.0, depth_loss_weight=1.0,
                 ray_directions_loss_weight=1.0, pose_quats_loss_weight=1.0,
                 pose_trans_loss_weight=1.0,
                 compute_pairwise_relative_pose_loss=False,
                 compute_world_frame_points_loss=True,
                 world_frame_points_loss_weight=1.0):
        self.criterion = criterion
        self.loss_in_log = loss_in_log
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

    def _gather(self, batch, preds):
        gt = {
            "pts3d": _world_pts_in_view0(batch),
            "pts3d_cam": batch["pts3d_cam"],
            "ray_directions": batch["ray_directions_cam"],
        }
        gt["depth"] = (batch["depth_along_ray"]
                       if self.depth_type_for_loss == "depth_along_ray"
                       else batch["pts3d_cam"][..., 2:])
        gt["pose_quats"], gt["pose_trans"] = _gt_pose_in_view0(batch)

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

    def _normalize(self, gt, pr, batch, valid):
        """'?avg_dis' semantics: the GT divided by its own factor;
        non-metric predictions by theirs, metric ones by the GT's."""
        metric = batch["is_metric_scale"]
        _, gt_factor = normalize_multiple_pointclouds(
            gt["pts3d"], valid, self.norm_mode, ret_factor=True)
        _, pr_factor = normalize_multiple_pointclouds(
            pr["pts3d"], valid, self.norm_mode, ret_factor=True)
        pr_div = torch.where(metric[:, None, None, None, None], gt_factor,
                             pr_factor)
        return (_divide(gt, gt_factor), _divide(pr, pr_div), gt_factor,
                pr_factor, metric)

    def _pose_terms(self, gt, pr, view_has_valid, b, v):
        if self.compute_pairwise_relative_pose_loss:
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
                                double_cover=(q_pos[:, i], q_neg[:, i]))
                       for i in range(v)]
        trans_terms = [LossTerm(trans_loss[:, i], t_mask[i], "pose_trans")
                       for i in range(v)]
        return quats_terms, trans_terms

    def _pixel_sets(self, gt, pr, valid, b, v, h, w):
        """pts3d? cam_pts3d depth ray_dirs pixel sets in the reference's
        order."""
        n = h * w
        mask_f = valid.reshape(b, v, n)

        def crit(key, log, weight, factor, use_mask, rep_type):
            loss = self.criterion(_log(pr[key], log), _log(gt[key], log),
                                  factor=factor)
            loss = (loss * weight).reshape(b, v, n)
            return _pixel_terms(loss, mask_f if use_mask else None, rep_type)

        terms: List[LossTerm] = []
        if self.compute_world_frame_points_loss:
            terms += crit("pts3d", self.loss_in_log,
                          self.world_frame_points_loss_weight, "points", True,
                          "pts3d")
        terms += crit("pts3d_cam", self.loss_in_log,
                      self.cam_frame_points_loss_weight, "points", True,
                      "cam_pts3d")
        terms += crit("depth", self.loss_in_log, self.depth_loss_weight,
                      "depth", True, self.depth_type_for_loss)
        terms += crit("ray_directions", False,
                      self.ray_directions_loss_weight, "ray_directions",
                      False, "ray_directions")
        return terms

    def loss_sets(self, batch, preds):
        b, v, h, w, _ = batch["pts3d"].shape
        valid = batch["valid_mask"]
        view_has_valid = valid.reshape(b, v, -1).sum(-1) > 0

        gt_raw, pr_raw = self._gather(batch, preds)
        gt, pr, gt_factor, pr_factor, metric = self._normalize(
            gt_raw, pr_raw, batch, valid)
        terms = self._pixel_sets(gt, pr, valid, b, v, h, w)
        quats_terms, trans_terms = self._pose_terms(gt, pr, view_has_valid,
                                                    b, v)
        terms += quats_terms + trans_terms

        if self._has_scale_set:
            s = preds.get("metric_scaling_factor")
            if pr_factor is None:
                # the metric factor is always that of the unscaled prediction
                _, pr_factor = normalize_multiple_pointclouds(
                    pr_raw["pts3d"], valid, self.norm_mode, ret_factor=True)
            pr_metric_factor = pr_factor.detach()[:, 0, 0, 0, :]
            if s is not None:
                pr_metric_factor = pr_metric_factor * s[:, None]
            gt_metric_factor = gt_factor[:, 0, 0, 0, :]
            scale_valid = metric & (gt_factor[:, 0, 0, 0, 0] > 1e-8)
            scale_loss = self.criterion(
                _log(pr_metric_factor, self.loss_in_log),
                _log(gt_metric_factor, self.loss_in_log), factor="scale",
            ) * self.scale_loss_weight
            terms.append(LossTerm(scale_loss, scale_valid, "scale"))
        return terms, _details_for(terms, type(self).__name__)


class FactoredGeometryScaleRegr3D(FactoredGeometryRegr3D):
    """Factored geometry plus the metric-scale set. Predictions are divided
    by the predicted metric_scaling_factor, GT and (with norm_predictions)
    predictions are normalised by their own joint factor, and the scale set
    supervises the detached prediction's metric norm factor."""

    _has_scale_set = True

    def __init__(self, criterion, norm_predictions=True, norm_mode="avg_dis",
                 loss_in_log=True, depth_type_for_loss="depth_along_ray",
                 cam_frame_points_loss_weight=1.0, depth_loss_weight=1.0,
                 ray_directions_loss_weight=1.0, pose_quats_loss_weight=1.0,
                 pose_trans_loss_weight=1.0, scale_loss_weight=1.0,
                 compute_pairwise_relative_pose_loss=False,
                 compute_world_frame_points_loss=True,
                 world_frame_points_loss_weight=1.0):
        super().__init__(
            criterion, loss_in_log=loss_in_log,
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

    def _normalize(self, gt, pr, batch, valid):
        gt_norm, gt_factor = normalize_multiple_pointclouds(
            gt["pts3d"], valid, self.norm_mode, ret_factor=True)
        out_gt = _divide(gt, gt_factor, pts3d=gt_norm)
        out_pr, pr_factor = dict(pr), None
        if self.norm_predictions:
            pr_norm, pr_factor = normalize_multiple_pointclouds(
                pr["pts3d"], valid, self.norm_mode, ret_factor=True)
            out_pr = _divide(pr, pr_factor, pts3d=pr_norm)
        return out_gt, out_pr, gt_factor, pr_factor, batch["is_metric_scale"]


class FactoredGeometryRegr3DPlusNormalGMLoss(FactoredGeometryScaleRegr3D):
    """Adds per-view normal-consistency and gradient-matching terms after
    the regression sets: normals on the normalised camera points, gradient
    matching on their log z, on synthetic samples only."""

    def __init__(self, *args, normal_loss_weight=1.0, gm_loss_weight=1.0,
                 **kw):
        super().__init__(*args, **kw)
        self.normal_loss_weight = normal_loss_weight
        self.gm_loss_weight = gm_loss_weight

    def loss_sets(self, batch, preds):
        terms, details = super().loss_sets(batch, preds)
        b, v = batch["pts3d"].shape[:2]
        valid = batch["valid_mask"]
        # the normalised camera points, recomputed as the parent made them
        gt_raw, pr_raw = self._gather(batch, preds)
        gt, pr, *_ = self._normalize(gt_raw, pr_raw, batch, valid)

        syn = batch.get("is_synthetic")
        if syn is None:
            syn = torch.zeros(b, dtype=torch.bool, device=valid.device)
        mask = valid & syn[:, None, None, None]

        normal_terms, gm_terms = [], []
        for i in range(v):
            nrm = compute_normal_loss(pr["pts3d_cam"][:, i],
                                      gt["pts3d_cam"][:, i], mask[:, i])
            gm = compute_gradient_matching_loss(
                apply_log_to_norm(pr["pts3d_cam"][:, i, ..., 2:]),
                apply_log_to_norm(gt["pts3d_cam"][:, i, ..., 2:]), mask[:, i])
            normal_terms.append(LossTerm(nrm * self.normal_loss_weight, None,
                                         "normal"))
            gm_terms.append(LossTerm(gm * self.gm_loss_weight, None,
                                     "gradient_matching"))
        terms += normal_terms + gm_terms
        details.update(_details_for(normal_terms + gm_terms,
                                    type(self).__name__))
        return terms, details


class FactoredGeometryScaleRegr3DPlusNormalGMLoss(
        FactoredGeometryRegr3DPlusNormalGMLoss):
    """The released recipe's pixel criterion."""


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

    def compute_loss(self, batch, preds):
        logits = preds["non_ambiguous_mask_logits"]  # (B, V, H, W)
        gt = batch["non_ambiguous_mask"]
        v = logits.shape[1]
        total = 0.0
        details = {}
        for i in range(v):
            li = self.criterion(logits[:, i], gt[:, i]).mean()
            total = total + li
            details[f"NonAmbiguousMaskLoss_mask_view{i + 1}"] = li
        details["NonAmbiguousMaskLoss_mask_avg"] = total / v
        return total, details


class _SetWrapper(MultiLoss):
    """Shared plumbing of the set-selecting wrappers."""

    pixel_loss: SetCriterion

    def _n_views(self, batch):
        return batch["pts3d"].shape[1]

    def _reduce_rest(self, terms, covered):
        total = 0.0
        for k, t in enumerate(terms):
            if k not in covered:
                total = total + _masked_mean(t.loss, t.mask)
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

    def _conf_reduce(self, term, view_idx, preds):
        b = term.loss.shape[0]
        conf = preds["conf"][:, view_idx].reshape(b, -1)
        return _masked_mean(term.loss * conf - self.alpha * torch.log(conf),
                            term.mask)

    def _conf_terms(self, selected, n_views, preds, details):
        total = 0.0
        for loss_idx, (_, term) in enumerate(selected):
            view_idx = loss_idx % n_views
            val = self._conf_reduce(term, view_idx, preds)
            total = total + val
            details[f"{term.rep_type}_conf_loss_view{view_idx + 1}"] = val
        return total

    def compute_loss(self, batch, preds):
        n_views = self._n_views(batch)
        terms, details = self.pixel_loss.loss_sets(batch, preds)
        selected, covered = _select_flat(terms, self.loss_set_indices,
                                         n_views)
        total = self._conf_terms(selected, n_views, preds, details)
        return total + self._reduce_rest(terms, covered), details


class ExcludeTopNPercentPixelLoss(_SetWrapper):
    """Drops the top-N% highest per-pixel losses of each image on the
    selected sets; synthetic samples keep every valid pixel."""

    def __init__(self, pixel_loss, top_n_percent=5.0, loss_set_indices=None):
        self.pixel_loss = pixel_loss
        self.top_n_percent = top_n_percent
        self.bottom_n_percent = 100.0 - top_n_percent
        self.loss_set_indices = ([1] if loss_set_indices is None
                                 else list(loss_set_indices))

    def get_name(self):
        return f"ExcludeTopNPercentPixelLoss({self.pixel_loss.get_name()})"

    def _exclude_reduce(self, term, batch):
        valid = (term.mask if term.mask is not None
                 else torch.ones(term.loss.shape, dtype=torch.bool,
                                 device=term.loss.device))
        keep = _keep_bottom_n_mask(term.loss, valid, self.bottom_n_percent)
        syn = batch.get("is_synthetic")
        if syn is not None:
            keep = torch.where(syn[:, None], valid, keep)
        return _masked_mean(term.loss, keep)

    def _exclude_terms(self, selected, n_views, batch, details):
        total = 0.0
        for loss_idx, (_, term) in enumerate(selected):
            view_idx = loss_idx % n_views
            val = self._exclude_reduce(term, batch)
            total = total + val
            details[f"{term.rep_type}_bot{self.bottom_n_percent:g}%_view"
                    f"{view_idx + 1}"] = val
        return total

    def compute_loss(self, batch, preds):
        n_views = self._n_views(batch)
        terms, details = self.pixel_loss.loss_sets(batch, preds)
        selected, covered = _select_flat(terms, self.loss_set_indices,
                                         n_views)
        total = self._exclude_terms(selected, n_views, batch, details)
        return total + self._reduce_rest(terms, covered), details


class ConfAndExcludeTopNPercentPixelLoss(ConfLoss,
                                         ExcludeTopNPercentPixelLoss):
    """ConfLoss on one index set and ExcludeTopNPercent on another: the
    released recipe's wrapper (conf on [0], exclude on [1, 2])."""

    def __init__(self, pixel_loss, conf_alpha=1.0, top_n_percent=5.0,
                 conf_loss_set_indices=None, exclude_loss_set_indices=None):
        assert conf_alpha > 0
        self.pixel_loss = pixel_loss
        self.alpha = conf_alpha
        self.top_n_percent = top_n_percent
        self.bottom_n_percent = 100.0 - top_n_percent
        self.conf_loss_set_indices = ([0] if conf_loss_set_indices is None
                                      else list(conf_loss_set_indices))
        self.exclude_loss_set_indices = (
            [1] if exclude_loss_set_indices is None
            else list(exclude_loss_set_indices))

    def get_name(self):
        return ("ConfAndExcludeTopNPercentPixelLoss("
                f"{self.pixel_loss.get_name()})")

    def compute_loss(self, batch, preds):
        n_views = self._n_views(batch)
        terms, details = self.pixel_loss.loss_sets(batch, preds)
        conf_sel, conf_cov = _select_flat(terms, self.conf_loss_set_indices,
                                          n_views)
        excl_sel, excl_cov = _select_flat(
            terms, self.exclude_loss_set_indices, n_views)
        total = (self._conf_terms(conf_sel, n_views, preds, details)
                 + self._exclude_terms(excl_sel, n_views, batch, details))
        return total + self._reduce_rest(terms, conf_cov | excl_cov), details


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
    "ExcludeTopNPercentPixelLoss",
    "FactoredGeometryRegr3D",
    "FactoredGeometryRegr3DPlusNormalGMLoss",
    "FactoredGeometryScaleRegr3D",
    "FactoredGeometryScaleRegr3DPlusNormalGMLoss",
    "LossTerm",
    "MultiLoss",
    "NonAmbiguousMaskLoss",
    "RobustRegressionLoss",
    "SetCriterion",
    "reduce_terms",
    "released_criterion",
]
