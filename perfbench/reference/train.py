"""Plain PyTorch reference of MapAnything's released training step.

One step: the prior masks of the task's mix drawn from a generator, the
forward with the geometric priors fused into the encoder features, the
released loss, the global gradient clip and AdamW with the released
schedule. Written from the MapAnything recipe (configs/loss/
overall_loss.yaml, configs/model/task/aug_training.yaml, the optimizer of
configs/train_params) in float32, its blocks recomputed in the backward so
that 2 x 4 views fit; the program's step is the one the benchmark times.

The loss (the recipe's criterion):

    ConfAndExcludeTopNPercentPixelLoss(
        FactoredGeometryScaleRegr3DPlusNormalGMLoss(
            RobustRegressionLoss(alpha=0.5, c=0.05), norm_mode="avg_dis",
            loss_in_log=True, compute_world_frame_points_loss=True),
        conf_alpha=0.2, top_n_percent=5, apply_to_real_data_only=True,
        conf_loss_set_indices=[0], exclude_loss_set_indices=[1, 2])
    + 0.3 * NonAmbiguousMaskLoss(BCELoss()),   times 2 / views above 2.

Its normal and gradient-matching terms apply to synthetic samples only;
the benchmark's batches are real data (is_synthetic False), where they are
0, so they are left out here.

The prior masks are drawn in the recipe's order, one `torch.rand` per
stochastic mask: overall (B, 1), kept views (B, V), rays, depth, camera
(B, 1), the sparse-depth gate (B, 1), depth and pose scale normalised
away (B, V), and the kept pixels of sparse depth (B, V, H, W, 1). A
probability of 0 or 1 draws nothing.

Imports nothing of the program under test.
"""

from __future__ import annotations

import math

import torch

from . import common as C
from . import mapanything as M

ADAM = dict(lr=2e-4, encoder_lr_scale=0.05, warmup_steps=1000,
            total_steps=100_000, min_lr=1e-6, weight_decay=0.05, b1=0.9,
            b2=0.95, grad_clip=1.0)


# --- small geometry --------------------------------------------------------------


def safe_norm(x, keepdim=False):
    """The L2 norm with a zero gradient where x is 0."""
    sq = (x * x).sum(-1, keepdim=keepdim)
    zero = sq == 0
    return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq)))


def log_norm(x):
    """Vectors rescaled to length log1p(|x|)."""
    d = safe_norm(x, keepdim=True)
    return x / d.clamp_min(1e-8) * torch.log1p(d)


def rotate(rot, v):
    return (rot * v[..., None, :]).sum(-1)


def quat_inverse(q):
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0]) / (q * q).sum(-1, True)


def quat_multiply(a, b):
    x1, y1, z1, w1 = a.unbind(-1)
    x2, y2, z2, w2 = b.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)


def relative_pose(q1, t1, q2, t2):
    """Pose 2 (camera to world) in pose 1's camera frame."""
    inv = quat_inverse(q1)
    r = M.quat_to_rotation(inv)
    return quat_multiply(inv, q2), rotate(r, t2) - rotate(r, t1)


# --- the forward with priors -------------------------------------------------------


def draw_masks(mix: dict, b: int, v: int, h: int, w: int, gen) -> dict:
    dev = gen.device

    def bern(p, shape):
        if p in (0.0, 1.0):
            return torch.full(shape, p == 1.0, dtype=torch.bool, device=dev)
        return torch.rand(shape, generator=gen, device=dev) < p

    m = {"overall": bern(mix["overall_prob"], (b, 1)),
         "keep": bern(1.0 - mix["dropout_prob"], (b, v)),
         "ray": bern(mix["ray_dirs_prob"], (b, 1)),
         "depth": bern(mix["depth_prob"], (b, 1)),
         "cam": bern(mix["cam_prob"], (b, 1)),
         "sparse": bern(mix["sparse_depth_prob"], (b, 1)),
         "depth_norm_all": bern(mix["depth_scale_norm_all_prob"], (b, v)),
         "pose_norm_all": bern(mix["pose_scale_norm_all_prob"], (b, v))}
    if mix["sparse_depth_prob"] > 0.0:
        m["keep_px"] = (torch.rand((b, v, h, w, 1), generator=gen, device=dev)
                        >= mix["sparsification_removal_percent"])
    return m


def _global_encoder(sd, name, x, precision):
    return C.linear(C.gelu(C.linear(x, sd, name + ".fc1", precision)), sd,
                    name + ".fc2", precision)


def _dense_encoder(sd, name, x, p, precision):
    """(B, V, H, W, C) -> (B, V, gh, gw, D): a patch-size convolution."""
    b, v = x.shape[:2]
    out = C.conv2d(x.reshape(b * v, *x.shape[2:]).permute(0, 3, 1, 2), sd,
                   name + ".proj", precision, stride=p)
    return out.permute(0, 2, 3, 1).reshape(b, v, *out.shape[-2:], -1)


def fuse_priors(sd, cfg, feats, views, masks, mix, precision):
    """The encoder features (B, V, gh, gw, C) plus each prior's encoding
    where its masks hold."""
    p = cfg["patch_size"]
    per_sample = masks["keep"] & masks["overall"]  # (B, V)
    metric_view = views["is_metric_scale"]
    if mix["ray_dirs_prob"] > 0.0:
        m = (masks["ray"] & per_sample)[..., None, None, None].float()
        feats = feats + _dense_encoder(sd, "ray_dirs_encoder",
                                       views["ray_directions_cam"] * m, p,
                                       precision) * m
    if mix["depth_prob"] > 0.0:
        mask = masks["depth"] & per_sample
        mf = mask[..., None, None, None].float()
        depth = views["depth_along_ray"] * mf
        if mix["sparse_depth_prob"] > 0.0:
            gate = masks["sparse"][:, :, None, None, None]
            depth = torch.where(gate, depth * masks["keep_px"], depth)
        valid = depth > 0
        norm = ((depth * valid).sum((-3, -2, -1))
                / (valid.sum((-3, -2, -1)) + 1e-8)).clamp_min(1e-8)
        scaled = depth / norm[..., None, None, None]
        feats = feats + _dense_encoder(sd, "depth_encoder", log_norm(scaled),
                                       p, precision) * mf
        metric = (mask & metric_view & ~masks["depth_norm_all"]).float()
        scale = _global_encoder(sd, "depth_scale_encoder",
                                torch.log(norm + 1e-8)[..., None], precision)
        feats = feats + (scale * metric[..., None])[:, :, None, None, :]
    if mix["cam_prob"] > 0.0:
        mask = (masks["cam"] & per_sample)[..., None]
        q, t = views["camera_pose_quats"], views["camera_pose_trans"]
        rq, rt = relative_pose(q[:, :1].expand_as(q), t[:, :1].expand_as(t),
                               q, t)
        rq = torch.where(mask, rq, rq.new_tensor([0.0, 0.0, 0.0, 1.0]))
        rt = torch.where(mask, rt, 0.0)
        dis = safe_norm(rt)  # (B, V)
        t_norm = (dis.sum(-1) / ((dis > 0).sum(-1) + 1e-8)).clamp_min(1e-8)
        scaled_t = rt / t_norm[:, None, None]
        metric = (metric_view & ~masks["pose_norm_all"])[..., None].float()
        log_t = torch.log(t_norm + 1e-8)[:, None, None].expand(*rt.shape[:2], 1)
        mf = mask.float()
        pose = (_global_encoder(sd, "cam_rot_encoder", rq, precision) * mf
                + _global_encoder(sd, "cam_trans_encoder", scaled_t,
                                  precision) * mf
                + _global_encoder(sd, "cam_trans_scale_encoder", log_t,
                                  precision) * mf * metric)
        feats = feats + pose[:, :, None, None, :]
    return feats


def forward(sd, cfg, views, masks, mix, precision="fp32") -> dict:
    """The outputs the loss reads, (B, V, ...) and the metric scale (B,)."""
    img = views["img"]
    b, v, h, w, _ = img.shape
    p = cfg["patch_size"]
    gh, gw = h // p, w // p
    feats = M.encoder(sd, cfg, img.reshape(b * v, h, w, 3), precision)
    feats = fuse_priors(sd, cfg, feats.reshape(b, v, gh, gw, -1), views,
                        masks, mix, precision)
    feats = C.layer_norm(feats, sd, "fusion_norm").reshape(b, v, gh * gw, -1)
    final, taps, tok = M.trunk(sd, cfg, feats, precision)

    def grid(x):
        return x.reshape(b * v, gh, gw, -1).permute(0, 3, 1, 2)

    hooks = [grid(x) for x in [feats] + taps + [final]]
    raw = M.dense_head(sd, cfg, hooks, (h, w), precision).reshape(b, v, h, w, -1)
    pose = M.pose_head(sd, cfg, hooks[-1], precision).reshape(b, v, 7)
    s_raw = C.linear(C.gelu(C.linear(tok[:, 0], sd, "scale_head.fc1",
                                     precision)), sd, "scale_head.fc2",
                     precision)
    scale = 1e-8 + torch.exp(s_raw[:, 0])
    trans = pose[..., :3]
    quats = pose[..., 3:7] / torch.linalg.vector_norm(
        pose[..., 3:7], dim=-1, keepdim=True).clamp_min(1e-8)
    dirs = raw[..., 0:3] / torch.linalg.vector_norm(
        raw[..., 0:3], dim=-1, keepdim=True).clamp_min(1e-8)
    depth = torch.exp(raw[..., 3:4])
    s = scale[:, None, None, None, None]
    local = depth * dirs
    rot = M.quat_to_rotation(quats)
    world = rotate(rot[:, :, None, None], local) + trans[:, :, None, None, :]
    return {"pts3d": world * s, "pts3d_cam": local * s,
            "depth_along_ray": depth * s, "ray_directions": dirs,
            "cam_trans": trans * scale[:, None, None], "cam_quats": quats,
            "conf": 1.0 + torch.exp(raw[..., 4]),
            "non_ambiguous_mask_logits": raw[..., 5],
            "metric_scaling_factor": scale}


# --- the released loss ----------------------------------------------------------


def robust(a, b, alpha=0.5, c=0.05):
    """Barron's general robust loss over the last axis."""
    err = (((a - b) / c) ** 2).sum(-1)
    am2 = abs(alpha - 2)
    return (am2 / alpha) * (torch.pow(err / am2 + 1.0, alpha / 2) - 1.0)


def masked_mean(x, mask=None):
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def normalise(pts, valid):
    """Points over their mean distance over the valid pixels of all views:
    (the points, the (B, 1, 1, 1, 1) factor)."""
    b = pts.shape[0]
    dis = safe_norm(pts * valid[..., None])
    total = (dis * valid).reshape(b, -1).sum(-1)
    factor = (total / (valid.reshape(b, -1).sum(-1) + 1e-8)).clamp_min(1e-8)
    factor = factor[:, None, None, None, None]
    return pts / factor, factor


def keep_bottom(loss, valid, percent):
    """The floor(valid * percent / 100) lowest-loss valid entries of each
    row of (B, N), ties by a stable sort."""
    n = loss.shape[-1]
    keep = (valid.sum(-1) * percent / 100.0).to(torch.int32)
    order = torch.argsort(torch.where(valid, loss, torch.inf), dim=-1,
                          stable=True)
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=loss.device).expand_as(order))
    return ranks < keep[:, None]


def released_loss(gt, pr) -> torch.Tensor:
    b, v, h, w, _ = gt["pts3d"].shape
    n = h * w
    valid = gt["valid_mask"]
    # the GT in view 0's frame
    q0, t0 = gt["camera_pose_quats"][:, 0], gt["camera_pose_trans"][:, 0]
    r0_inv = M.quat_to_rotation(quat_inverse(q0))
    gt_pts = (rotate(r0_inv[:, None, None, None], gt["pts3d"])
              - rotate(r0_inv, t0)[:, None, None, None, :])
    gq, gtr = relative_pose(q0[:, None].expand(b, v, 4),
                            t0[:, None].expand(b, v, 3),
                            gt["camera_pose_quats"], gt["camera_pose_trans"])
    first = (torch.arange(v, device=gq.device) == 0)[None, :, None]
    gq = torch.where(first, gq.new_tensor([0.0, 0.0, 0.0, 1.0]), gq)
    gtr = torch.where(first, 0.0, gtr)
    # the predictions without their metric scale
    s = pr["metric_scaling_factor"]
    s5 = s[:, None, None, None, None]
    pr_pts, pr_cam = pr["pts3d"] / s5, pr["pts3d_cam"] / s5
    pr_depth, pr_t = pr["depth_along_ray"] / s5, pr["cam_trans"] / s[:, None,
                                                                    None]
    gt_n, gf = normalise(gt_pts, valid)
    pr_n, pf = normalise(pr_pts, valid)
    sets = {
        "pts3d": robust(log_norm(pr_n), log_norm(gt_n)),
        "cam": robust(log_norm(pr_cam / pf), log_norm(gt["pts3d_cam"] / gf)),
        "depth": robust(log_norm(pr_depth / pf),
                        log_norm(gt["depth_along_ray"] / gf)),
        "rays": robust(pr["ray_directions"], gt["ray_directions_cam"]),
    }
    sets = {k: x.reshape(b, v, n) for k, x in sets.items()}
    vmask = valid.reshape(b, v, n)
    conf = pr["conf"].reshape(b, v, n)
    total = 0.0
    for i in range(v):
        # confidence on the world points (alpha 0.2)
        total = total + masked_mean(sets["pts3d"][:, i] * conf[:, i]
                                    - 0.2 * torch.log(conf[:, i]), vmask[:, i])
        # the top 5% excluded on camera points and depth (real data)
        for key in ("cam", "depth"):
            keep = keep_bottom(sets[key][:, i], vmask[:, i], 95.0)
            total = total + masked_mean(sets[key][:, i], keep)
        total = total + sets["rays"][:, i].mean()
    q_pos = robust(pr["cam_quats"], gq)
    q_neg = robust(pr["cam_quats"], -gq)
    t_loss = robust(pr_t / pf[:, :, 0, 0], gtr / gf[:, :, 0, 0])
    view_valid = vmask.sum(-1) > 0
    for i in range(v):
        # the quaternion's double cover: the nearer of q and -q per sample
        total = total + torch.minimum(q_pos[:, i], q_neg[:, i]).mean()
        total = total + masked_mean(t_loss[:, i], view_valid[:, i])
    # the metric scale: the prediction's detached norm factor times its
    # scale against the GT's factor, in log space
    pr_metric = pf.detach()[:, 0, 0, 0, :] * s[:, None]
    scale_loss = robust(log_norm(pr_metric), log_norm(gf[:, 0, 0, 0, :]))
    total = total + masked_mean(scale_loss, gt["is_metric_scale"]
                                & (gf[:, 0, 0, 0, 0] > 1e-8))
    # 0.3 x the non-ambiguous mask's BCE, one mean a view
    logits = pr["non_ambiguous_mask_logits"]
    target = gt["non_ambiguous_mask"].to(logits.dtype)
    bce = (logits.clamp_min(0) - logits * target
           + torch.log1p(torch.exp(-logits.abs())))
    total = total + 0.3 * sum(bce[:, i].mean() for i in range(v))
    return total * (2.0 / v) if v > 2 else total


# --- the optimizer ---------------------------------------------------------------


def learning_rate(count: int) -> float:
    a = ADAM
    if count < a["warmup_steps"]:
        return a["lr"] * count / a["warmup_steps"]
    decay = a["total_steps"] - a["warmup_steps"]
    t = min(count - a["warmup_steps"], decay)
    alpha = a["min_lr"] / a["lr"]
    return a["lr"] * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay))
                      + alpha)


@torch.no_grad()
def adamw(params: dict, grads: dict, state: dict) -> None:
    """Clip the global gradient norm to 1, then AdamW (eps after the root,
    decay on matrices, the encoder at 0.05 x the rate), in place."""
    a = ADAM
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    clip = 1.0 if norm < a["grad_clip"] else a["grad_clip"] / norm.item()
    count = state.setdefault("count", 0)
    lr = learning_rate(count)
    state["count"] = t = count + 1
    for name, p in params.items():
        g = grads[name] * clip
        mu = state.setdefault(("mu", name), torch.zeros_like(p))
        nu = state.setdefault(("nu", name), torch.zeros_like(p))
        mu.mul_(a["b1"]).add_(g, alpha=1 - a["b1"])
        nu.mul_(a["b2"]).addcmul_(g, g, value=1 - a["b2"])
        upd = (mu / (1 - a["b1"] ** t)) / (
            torch.sqrt(nu / (1 - a["b2"] ** t)) + 1e-8)
        if p.ndim > 1:
            upd = upd + a["weight_decay"] * p
        rate = lr * (a["encoder_lr_scale"] if name.startswith("encoder.")
                     else 1.0)
        p.sub_(upd * rate)


# --- three steps ------------------------------------------------------------------


def train_steps(sd: dict, cfg: dict, batches: list, mix: dict, gen,
                precision: str = "fp32") -> dict:
    """The released step on each batch in turn from the weights `sd` (not
    modified), the masks drawn from `gen`. Returns the losses, each
    parameter's first (clipped) gradient's norm, and each parameter's
    change after the last step."""
    params = {k: t.detach().clone().float() for k, t in sd.items()}
    state: dict = {}
    losses, first = [], None
    with C.fp32_matmuls():
        for batch in batches:
            views, gt = batch["views"], batch["gt"]
            b, v, h, w = gt["valid_mask"].shape
            masks = draw_masks(mix, b, v, h, w, gen)
            leaves = {k: p.requires_grad_(True) for k, p in params.items()}
            with torch.enable_grad():
                loss = released_loss(gt, forward(leaves, cfg, views, masks,
                                                 mix, precision))
                got = torch.autograd.grad(loss, list(leaves.values()),
                                          allow_unused=True)
            grads = {k: (torch.zeros_like(params[k]) if g is None else g)
                     for k, g in zip(leaves, got)}
            for p in params.values():
                p.requires_grad_(False)
            losses.append(float(loss.detach()))
            adamw(params, grads, state)
            if first is None:  # the clipped gradient the optimizer took
                first = {k: float(torch.linalg.vector_norm(
                    state[("mu", k)] / (1 - ADAM["b1"]))) for k in params}
            del grads, got, loss
    changes = {k: float(torch.linalg.vector_norm(params[k] - sd[k].float()))
               for k in params}
    return {"losses": losses, "grad": first, "change": changes}

