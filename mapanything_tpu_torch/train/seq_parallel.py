"""View-sharded (sequence-parallel) training: the loss and the train step;
counterpart of mapanything_tpu/train/seq_parallel.py.

The VIEW axis of a batch is sharded over the ranks of a torch.distributed
process group. Each rank runs its V/p views through the model with the
trunk's global layers on the ring (``MapAnything.forward(views,
seq_group=group)``, ops/ring_attention.py), so activation and gradient
memory per card are O(V/p).

The released criterion reduces per-view means and sums them over the
views, so nearly every term is view-local and the total is a sum over
ranks of local view sums. Three quantities cross views:

  * the GT reference pose, that of global view 0, gathered from rank 0;
  * the joint avg-dis normalisation factors: masked distance sums reduced
    over the ranks;
  * the pairwise relative-pose arm (off in the released recipe): the
    per-view pose vectors are gathered and the term computed on every
    rank alike.

Each rank's loss is its SHARE of the total: its local view sums plus the
replicated terms (the metric-scale set, the pairwise arm) at 1/p, so that
the shares add up to the total. Every collective on a differentiated
quantity sums the cotangents over the ranks in its backward
(``ops/ring_attention.py::all_gather`` and ``::all_reduce``, the JAX
package's ``all_gather_grad_correct`` and ``psum_grad_correct``), so
backpropagating each rank's share and summing the parameter gradients over
the ranks gives the gradient of the total.

Parity with the unsharded ``overall_loss`` and ``make_train_step`` is held
in tests/test_torch_seq_parallel.py on CPU ranks over gloo, and on the
card by chip_smoke.py and parallel/ring_check.py.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..geometry import (
    apply_log_to_norm,
    quaternion_inverse,
    quaternion_to_rotation_matrix,
    safe_norm,
    transform_pose_using_quats_and_trans_2_to_1,
)
from ..geometry.quats import rotate
from ..models import GeometricInputConfig, MapAnything
from ..ops.ring_attention import all_gather, all_reduce
from .criteria import _keep_bottom_n_mask, _masked_mean
from .losses import (
    OverallLossConfig,
    RobustRegressionLoss,
    bce_with_logits,
    compute_gradient_matching_loss,
    compute_normal_loss,
)
from .step import TrainState, check_released_scene_rep, global_norm

# parameter gradients are summed over the ranks in flat buckets of this many
# elements (one all_reduce each)
_BUCKET = 1 << 26


def _gather_views(x: torch.Tensor, group) -> torch.Tensor:
    """(B, V_local, ...) -> (B, V_global, ...) in global view order. The
    backward sums every rank's cotangent of a slot and keeps its own."""
    g = all_gather(x, group)  # (p, B, V_local, ...)
    g = g.movedim(0, 1)  # (B, p, V_local, ...)
    return g.reshape(g.shape[0], -1, *g.shape[3:])


def _normalize_factor_psum(pts: torch.Tensor, valid: torch.Tensor,
                           group) -> torch.Tensor:
    """The avg-dis joint normalisation factor (B, 1, 1, 1, 1) with the view
    axis sharded (geometry/norm.py::normalize_multiple_pointclouds): the
    masked distance sum is reduced over the ranks differentiably, the count
    of valid pixels without a gradient."""
    b = pts.shape[0]
    dis = safe_norm(pts * valid[..., None])  # (B, V_local, H, W)
    num = all_reduce((dis * valid).reshape(b, -1).sum(-1), group)
    nnz = valid.reshape(b, -1).sum(-1).to(num.dtype)
    dist.all_reduce(nnz, group=group)
    factor = (num / (nnz + 1e-8)).clamp_min(1e-8)
    return factor[:, None, None, None, None]


def view_sharded_overall_loss(
        gt: Dict[str, torch.Tensor], preds: Dict[str, torch.Tensor],
        cfg: OverallLossConfig = OverallLossConfig(), group=None):
    """train/losses.py::overall_loss with `gt` and `preds` holding this
    rank's views only ((B, V_local, ...); the per-sample entries and
    metric_scaling_factor replicated).

    Returns (total, details): `total` (no gradient) and the details are the
    same on every rank; ``details["_share"]`` is this rank's share of the
    total, the scalar to backpropagate. The details aggregate per set: the
    ``*_viewsum_local`` entries are per-view means summed over every rank's
    views, ``scale_loss`` and (with the pairwise arm) ``pose_quats_sum``
    and ``pose_trans_sum`` are replicated.
    """
    fc = cfg.factored
    assert fc.norm_mode == "avg_dis", "released recipe uses avg_dis"
    assert fc.depth_type_for_loss == "depth_along_ray"
    # the conf and exclusion sets below are chosen by name for the released
    # set order; without the world-points set the unsharded criterion's flat
    # indices would select other sets
    assert fc.compute_world_frame_points_loss, (
        "view_sharded_overall_loss implements the released recipe's set "
        "selection (conf on pts3d, exclusion on cam_pts3d and depth); with "
        "compute_world_frame_points_loss=False use the unsharded "
        "overall_loss")
    criterion = RobustRegressionLoss(cfg.criterion_alpha,
                                     cfg.criterion_scaling_c)
    b, v, h, w, _ = gt["pts3d"].shape
    ring = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n_views_global = v * ring

    def log(x):
        return apply_log_to_norm(x) if fc.loss_in_log else x

    # ---- the GT in the frame of GLOBAL view 0 -------------------------------
    q0 = _gather_views(gt["camera_pose_quats"][:, :1], group)[:, 0]
    t0 = _gather_views(gt["camera_pose_trans"][:, :1], group)[:, 0]
    r0_inv = quaternion_to_rotation_matrix(quaternion_inverse(q0))
    t0_inv = -rotate(r0_inv, t0)
    gt_pts_v0 = (rotate(r0_inv[:, None, None, None], gt["pts3d"])
                 + t0_inv[:, None, None, None, :])
    gt_pose_quats, gt_pose_trans = transform_pose_using_quats_and_trans_2_to_1(
        q0[:, None].expand(b, v, 4), t0[:, None].expand(b, v, 3),
        gt["camera_pose_quats"], gt["camera_pose_trans"])
    # global view 0 (the first view of rank 0) gets the exact identity
    is_global_v0 = (rank * v + torch.arange(v, device=q0.device)) == 0
    identity_q = q0.new_tensor([0.0, 0.0, 0.0, 1.0])
    gt_pose_quats = torch.where(is_global_v0[None, :, None], identity_q,
                                gt_pose_quats)
    gt_pose_trans = torch.where(is_global_v0[None, :, None], 0.0,
                                gt_pose_trans)

    valid = gt["valid_mask"]
    gt_depth = gt["depth_along_ray"]

    # ---- predictions over the metric scale (criteria._unscale_preds) -------
    s = preds["metric_scaling_factor"]
    s5 = s[:, None, None, None, None]
    pr_pts = preds["pts3d"] / s5
    pr_pts_cam = preds["pts3d_cam"] / s5
    pr_depth = preds["depth_along_ray"] / s5
    pr_pose_trans = preds["cam_trans"] / s[:, None, None]
    pr_pose_quats = preds["cam_quats"]

    # ---- joint avg-dis normalisation (sums over the ranks) -----------------
    gt_factor = _normalize_factor_psum(gt_pts_v0, valid, group)
    gt_pts_n = gt_pts_v0 / gt_factor
    gt_pts_cam_n = gt["pts3d_cam"] / gt_factor
    gt_depth_n = gt_depth / gt_factor
    gt_pose_trans_n = gt_pose_trans / gt_factor[:, :, 0, 0]

    pr_factor = _normalize_factor_psum(pr_pts, valid, group)
    if fc.norm_predictions:
        pr_pts_n = pr_pts / pr_factor
        pr_pts_cam_n = pr_pts_cam / pr_factor
        pr_depth_n = pr_depth / pr_factor
        pr_pose_trans_n = pr_pose_trans / pr_factor[:, :, 0, 0]
    else:
        pr_pts_n, pr_pts_cam_n = pr_pts, pr_pts_cam
        pr_depth_n, pr_pose_trans_n = pr_depth, pr_pose_trans

    # ---- the metric-scale set's inputs: replicated (B,) quantities ---------
    scale_valid = gt["is_metric_scale"] & (gt_factor[:, 0, 0, 0, 0] > 1e-8)
    pr_metric_factor = pr_factor.detach()[:, 0, 0, 0, :] * s[:, None]
    gt_metric_factor = gt_factor[:, 0, 0, 0, :]

    w0, w1, w2, w3, w4, w5, w6 = fc.weights
    mask_f = valid.reshape(b, v, h * w)
    is_syn = gt.get("is_synthetic")
    if is_syn is None:
        is_syn = torch.zeros((b,), dtype=torch.bool, device=valid.device)

    details: Dict[str, torch.Tensor] = {}

    def viewsum(per_view_vals, name):
        """The sum of per-view scalars over the local views, recorded."""
        val = sum(per_view_vals)
        details[f"{name}_viewsum_local"] = val
        return val

    local = 0.0

    # set 0 (confidence-weighted): world points
    conf_flat = preds["conf"].reshape(b, v, -1)
    log_conf = torch.log(conf_flat)
    loss0 = (criterion(log(pr_pts_n), log(gt_pts_n)) * w0).reshape(b, v,
                                                                     h * w)
    vals = []
    for i in range(v):
        cl = loss0[:, i] * conf_flat[:, i] - cfg.conf_alpha * log_conf[:, i]
        vals.append(_masked_mean(cl, mask_f[:, i]))
    local = local + viewsum(vals, "pts3d_conf")

    # sets 1-2 (top-N% excluded): camera-frame points, depth
    def excluded(loss_bvn, name):
        vals = []
        for i in range(v):
            keep = _keep_bottom_n_mask(loss_bvn[:, i], mask_f[:, i],
                                       100.0 - cfg.top_n_percent)
            keep = torch.where(is_syn[:, None], mask_f[:, i], keep)
            vals.append(_masked_mean(loss_bvn[:, i], keep))
        return viewsum(vals, name)

    loss1 = (criterion(log(pr_pts_cam_n), log(gt_pts_cam_n)) * w1
             ).reshape(b, v, h * w)
    local = local + excluded(loss1, "cam_pts3d")
    loss2 = (criterion(log(pr_depth_n), log(gt_depth_n)) * w2
             ).reshape(b, v, h * w)
    local = local + excluded(loss2, "depth_along_ray")

    # ray directions: plain per-view means (no mask)
    loss3 = (criterion(preds["ray_directions"], gt["ray_directions_cam"])
             * w3).reshape(b, v, h * w)
    local = local + viewsum([loss3[:, i].mean() for i in range(v)],
                            "ray_directions")

    view_has_valid = valid.reshape(b, v, -1).sum(-1) > 0
    replicated = 0.0
    if fc.compute_pairwise_relative_pose_loss:
        # pairwise over the GLOBAL views: the per-view vectors are tiny, so
        # they are gathered and the term computed alike on every rank
        pq_g = _gather_views(pr_pose_quats, group)
        pt_g = _gather_views(pr_pose_trans_n, group)
        gq_g = _gather_views(gt_pose_quats, group)
        gt_g = _gather_views(gt_pose_trans_n, group)
        hv_g = _gather_views(view_has_valid[..., None].to(torch.uint8),
                             group)[..., 0].bool()
        vg = n_views_global

        def pairwise(quats, trans):
            return transform_pose_using_quats_and_trans_2_to_1(
                quats[:, :, None].expand(b, vg, vg, 4),
                trans[:, :, None].expand(b, vg, vg, 3),
                quats[:, None, :].expand(b, vg, vg, 4),
                trans[:, None, :].expand(b, vg, vg, 3))

        pr_rq, pr_rt = pairwise(pq_g, pt_g)
        gt_rq, gt_rt = pairwise(gq_g, gt_g)
        off_diag = ~torch.eye(vg, dtype=torch.bool, device=valid.device)[None]
        # the elementwise double-cover minimum, as the wrapped criterion
        quats_loss = torch.minimum(criterion(pr_rq, gt_rq),
                                   criterion(pr_rq, -gt_rq)) * w4
        trans_loss = criterion(pr_rt, gt_rt) * w5
        pair_valid = (hv_g[:, :, None] & hv_g[:, None, :]) & off_diag
        od = off_diag.expand(b, vg, vg)
        quats_total = sum(_masked_mean(quats_loss[:, i], od[:, i])
                          for i in range(vg))
        trans_total = sum(_masked_mean(trans_loss[:, i], pair_valid[:, i])
                          for i in range(vg))
        details["pose_quats_sum"] = quats_total
        details["pose_trans_sum"] = trans_total
        replicated = replicated + quats_total + trans_total
    else:
        # per-view pose terms: the elementwise double-cover minimum, then
        # the mean
        quats_loss = torch.minimum(
            criterion(pr_pose_quats, gt_pose_quats),
            criterion(pr_pose_quats, -gt_pose_quats)) * w4
        trans_loss = criterion(pr_pose_trans_n, gt_pose_trans_n) * w5
        local = local + viewsum([quats_loss[:, i].mean() for i in range(v)],
                                "pose_quats")
        local = local + viewsum(
            [_masked_mean(trans_loss[:, i], view_has_valid[:, i])
             for i in range(v)], "pose_trans")

    # the metric-scale set: one term per sample, replicated
    scale_loss = criterion(log(pr_metric_factor), log(gt_metric_factor)) * w6
    scale_val = _masked_mean(scale_loss, scale_valid)
    details["scale_loss"] = scale_val
    replicated = replicated + scale_val

    # ---- normal and gradient-matching terms (per view, synthetic only) -----
    if cfg.use_normal_gm:
        ngm_mask = valid & is_syn[:, None, None, None]
        n_vals, g_vals = [], []
        for i in range(v):
            n_vals.append(compute_normal_loss(
                pr_pts_cam_n[:, i], gt_pts_cam_n[:, i], ngm_mask[:, i])
                * cfg.normal_loss_weight)
            pr_z = apply_log_to_norm(pr_pts_cam_n[:, i, ..., 2:])
            gt_z = apply_log_to_norm(gt_pts_cam_n[:, i, ..., 2:])
            g_vals.append(compute_gradient_matching_loss(
                pr_z, gt_z, ngm_mask[:, i]) * cfg.gm_loss_weight)
        local = local + viewsum(n_vals, "normal")
        local = local + viewsum(g_vals, "gradient_matching")

    # ---- the non-ambiguous mask's BCE: one mean per view, weighted ---------
    bce_vals = [bce_with_logits(preds["non_ambiguous_mask_logits"][:, i],
                                gt["non_ambiguous_mask"][:, i]).mean()
                for i in range(v)]
    local = local + cfg.mask_loss_weight * viewsum(bce_vals, "mask_bce")

    # the SHARE: the replicated terms are the same on every rank and enter
    # each share at 1/p, so that the shares add up to the total
    share = local + replicated / ring
    if n_views_global > 2:
        share = share * (2.0 / n_views_global)
    total = share.detach().clone()
    dist.all_reduce(total, group=group)
    out = {}
    for key, val in details.items():
        val = val.detach().clone()
        if key.endswith("_viewsum_local"):
            dist.all_reduce(val, group=group)
        out[key] = val
    out["total"] = total
    out["_share"] = share
    return total, out


def _all_reduce_grads(grads, group) -> None:
    """Sum every rank's gradients in place, in flat buckets of about
    _BUCKET elements per dtype (one all_reduce each)."""
    bucket, size = [], 0

    def flush():
        if not bucket:
            return
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        torch._foreach_copy_(bucket, [
            piece.view_as(g) for piece, g in zip(
                flat.split([g.numel() for g in bucket]), bucket)])
        bucket.clear()

    for g in grads:
        if bucket and (size + g.numel() > _BUCKET
                       or g.dtype != bucket[0].dtype):
            flush()
            size = 0
        bucket.append(g)
        size += g.numel()
    flush()


def shard_views(batch: Dict, group) -> tuple:
    """(local views, local GT) of this rank: its V/p consecutive views of
    every entry with a view axis (axis 1 of the entries with two or more
    dimensions: the images, the priors and their flags), the per-sample
    entries as they are."""
    p, rank = dist.get_world_size(group), dist.get_rank(group)
    v = batch["views"]["img"].shape[1]
    if v % p:
        raise ValueError(f"view count {v} must be a multiple of the group "
                         f"size {p}")
    lo, hi = rank * (v // p), (rank + 1) * (v // p)

    def local(entries):
        return {key: t[:, lo:hi] if t.dim() >= 2 else t
                for key, t in entries.items()}

    return local(batch["views"]), local(batch["gt"])


def make_view_sharded_train_step(
        model: MapAnything, geom_cfg: GeometricInputConfig,
        loss_cfg: OverallLossConfig = OverallLossConfig(),
        group=None) -> Callable:
    """Build train_step(state, batch, generator=None) -> (state, metrics)
    with the VIEW axis sharded over the ranks of `group`: make_train_step's
    semantics.

    Every rank holds the same model and optimizer state (a TrainState of
    train/step.py, its AdamW), the whole batch and a generator in the same
    state; it runs its V/p views (V a multiple of the group size) with
    their priors, backpropagates its share of the loss, sums the parameter
    gradients over the ranks and applies the same AdamW step, so the
    parameters stay identical. A stochastic `geom_cfg` draws the masks of
    all V views on every rank and keeps its own (draw_prior_masks), so the
    step computes what make_train_step computes with the same generator.
    metrics, the same on every rank: "loss", the details of
    :func:`view_sharded_overall_loss` and "grad_norm", the global norm
    before clipping. Runs where the model lives: the card, or the CPU with
    a gloo group.
    """

    check_released_scene_rep(model)

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None):
        params = state.optimizer.params
        views, gt = shard_views(batch, group)
        for prm in params:
            prm.grad = None
        preds = model(views, geom_cfg, generator, seq_group=group)
        total, details = view_sharded_overall_loss(gt, preds, loss_cfg,
                                                   group)
        details.pop("_share").backward()
        grads = [torch.zeros_like(prm) if prm.grad is None else prm.grad
                 for prm in params]
        _all_reduce_grads(grads, group)
        norm = global_norm(grads)
        metrics = {"loss": total, **details, "grad_norm": norm}
        state.apply_gradients(grads, norm)
        for prm in params:
            prm.grad = None  # free the gradients before the next forward
        return state, metrics

    return train_step


__all__ = [
    "make_view_sharded_train_step",
    "shard_views",
    "view_sharded_overall_loss",
]
