"""Plain PyTorch reference of MapAnything's images-only inference.

The released architecture (arXiv:2509.13414; facebook/map-anything): a
DINOv2 ViT encoder with LayerScale, the fusion LayerNorm, a learned
metric-scale token, the alternating trunk (even layers attend within a
view, odd layers over all views' patches and the scale token; the first
view marked by a learned reference embedding; taps through their own
LayerNorms), a DPT dense head over [encoder features, taps, final], a pose
head and a scale MLP, then the released adaptors ("raydirs + depth + pose
+ confidence + mask") and `infer`'s postprocess with its default mask
(mask logits > 0, minus pixels on both a depth and a normal edge).

Written from the published description in float32 (or the control's
precision, reference/common.py), views in blocks so that 64 of them fit.
Departures, all of which the configuration file lists under `assumed`:
the DPT residual unit adds relu(x) as its skip (the reference code's
in-place ReLU), and parameters follow the names and layouts of the
program's state dict, so that one state dict serves both.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import common as C

IMAGE_MEAN = (0.485, 0.456, 0.406)  # DINOv2's normalisation
IMAGE_STD = (0.229, 0.224, 0.225)


def param_spec(cfg: dict) -> dict:
    """{name: (shape, init)} of every parameter the model holds, the six
    geometric-prior encoders included (images-only calls leave them
    unused)."""
    s: dict = {}
    e, p = cfg["encoder_embed_dim"], cfg["patch_size"]
    g = cfg["encoder_pos_grid"]
    mlp_e = cfg["mlp_ratio"] * e
    C.spec_conv(s, "encoder.patch_embed", 3, e, p)
    s["encoder.cls_token"] = ((1, 1, e), "normal")
    s["encoder.pos_embed"] = ((1 + g * g, e), "normal")
    for i in range(cfg["encoder_depth"]):
        C.spec_vit_block(s, f"encoder.blocks.{i}", e, mlp_e, layerscale=True)
    C.spec_norm(s, "encoder.norm", e)
    C.spec_norm(s, "fusion_norm", e)
    s["scale_token"] = ((e,), "normal")
    d = cfg["trunk_dim"]
    C.spec_linear(s, "info_sharing.proj", e, d)
    s["info_sharing.ref_nonref_embed"] = ((2, d), "normal")
    for i in range(cfg["trunk_depth"]):
        C.spec_vit_block(s, f"info_sharing.layers.{i}", d,
                         cfg["mlp_ratio"] * d, layerscale=False)
    for i in cfg["trunk_taps"]:
        C.spec_norm(s, f"info_sharing.norm_intermediate_{i}", d)
    C.spec_norm(s, "info_sharing.norm", d)
    f, oc = cfg["dpt_feature_dim"], cfg["dpt_out_channels"]
    dpt = "dense_head.dpt_feature"
    for i, (c_in, c_out) in enumerate(zip([e, d, d, d], oc)):
        C.spec_conv(s, f"{dpt}.project_{i}", c_in, c_out, 1)
    C.spec_conv(s, f"{dpt}.resize_0", oc[0], oc[0], 4, transpose=True)
    C.spec_conv(s, f"{dpt}.resize_1", oc[1], oc[1], 2, transpose=True)
    C.spec_conv(s, f"{dpt}.resize_3", oc[3], oc[3], 3)
    for i, c in enumerate(oc):
        C.spec_conv(s, f"{dpt}.layer_rn_{i}", c, f, 3, bias=False)
    for r in (4, 3, 2, 1):
        units = (2,) if r == 4 else (1, 2)
        for u in units:
            for conv in ("conv1", "conv2"):
                C.spec_conv(s, f"{dpt}.refinenet{r}.res_conv_unit{u}.{conv}",
                            f, f, 3)
        C.spec_conv(s, f"{dpt}.refinenet{r}.out_conv", f, f, 1)
    h0, h1 = cfg["dpt_hidden_dims"]
    reg = "dense_head.dpt_regressor"
    C.spec_conv(s, f"{reg}.conv1", f, h0, 3)
    C.spec_conv(s, f"{reg}.conv2", h0, h1, 3)
    C.spec_conv(s, f"{reg}.conv_out", h1, cfg["dense_output_dim"], 1)
    hid = d // 2
    C.spec_conv(s, "pose_head.proj", d, hid, 1)
    for i in range(cfg["pose_num_resconv"]):
        C.spec_conv(s, f"pose_head.res_conv_{i}.conv1", hid, hid, 3)
        C.spec_conv(s, f"pose_head.res_conv_{i}.conv2", hid, hid, 3)
    C.spec_linear(s, "pose_head.fc1", hid, hid)
    C.spec_linear(s, "pose_head.fc_out", hid, 7)
    C.spec_linear(s, "scale_head.fc1", d, d // 2)
    C.spec_linear(s, "scale_head.fc2", d // 2, 1)
    C.spec_conv(s, "ray_dirs_encoder.proj", 3, e, p)
    C.spec_conv(s, "depth_encoder.proj", 1, e, p)
    for name, n_in in (("depth_scale_encoder", 1), ("cam_rot_encoder", 4),
                       ("cam_trans_encoder", 3),
                       ("cam_trans_scale_encoder", 1)):
        C.spec_linear(s, f"{name}.fc1", n_in, e)
        C.spec_linear(s, f"{name}.fc2", e, e)
    return s


# --- the network ---------------------------------------------------------------


def encoder(sd: dict, cfg: dict, img: torch.Tensor, precision: str
            ) -> torch.Tensor:
    """DINOv2: (N, H, W, 3) normalised images -> (N, gh, gw, C) patch tokens
    after the final norm."""
    n, h, w, _ = img.shape
    p, g = cfg["patch_size"], cfg["encoder_pos_grid"]
    gh, gw = h // p, w // p
    x = C.conv2d(img.permute(0, 3, 1, 2), sd, "encoder.patch_embed", precision,
                 stride=p)
    x = x.flatten(2).transpose(1, 2)  # (N, gh*gw, C)
    pos = sd["encoder.pos_embed"].float()
    patch_pos = pos[1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
    # DINOv2's interpolate_pos_encoding: bicubic by the scale factors
    # (gh + 0.1) / g and (gw + 0.1) / g
    patch_pos = F.interpolate(patch_pos, scale_factor=((gh + 0.1) / g,
                                                       (gw + 0.1) / g),
                              mode="bicubic", align_corners=False)
    assert patch_pos.shape[-2:] == (gh, gw)
    x = x + patch_pos.flatten(2).transpose(1, 2)
    cls = (sd["encoder.cls_token"].float() + pos[:1]).expand(n, 1, -1)
    x = torch.cat([cls, x], dim=1)
    for i in range(cfg["encoder_depth"]):
        x = C.vit_block(x, sd, f"encoder.blocks.{i}", cfg["encoder_num_heads"],
                        precision, layerscale=True)
    x = C.layer_norm(x, sd, "encoder.norm")
    return x[:, 1:].reshape(n, gh, gw, -1)


def trunk(sd: dict, cfg: dict, feats: torch.Tensor, precision: str):
    """The alternating trunk: feats (B, V, P, C) and the scale token ->
    (final (B, V, P, D), [taps], token (B, 1, D))."""
    b, v, p, _ = feats.shape
    d, heads = cfg["trunk_dim"], cfg["trunk_num_heads"]
    x = C.linear(feats, sd, "info_sharing.proj", precision)
    tok = C.linear(sd["scale_token"].float().expand(b, 1, -1), sd,
                   "info_sharing.proj", precision)
    emb = sd["info_sharing.ref_nonref_embed"].float()
    x = x + torch.where(torch.arange(v, device=x.device)[:, None, None] == 0,
                        emb[0], emb[1])
    taps = []
    for i in range(cfg["trunk_depth"]):
        name = f"info_sharing.layers.{i}"
        if i % 2 == 0:  # frame: each view alone
            x = C.vit_block(x.reshape(b * v, p, d), sd, name, heads, precision,
                            layerscale=False).reshape(b, v, p, d)
        else:  # global: every view's patches and the token
            y = C.vit_block(torch.cat([x.reshape(b, v * p, d), tok], dim=1),
                            sd, name, heads, precision, layerscale=False)
            x, tok = y[:, :v * p].reshape(b, v, p, d), y[:, v * p:]
        if i in cfg["trunk_taps"]:
            taps.append(C.layer_norm(
                x, sd, f"info_sharing.norm_intermediate_{i}"))
    return (C.layer_norm(x, sd, "info_sharing.norm"), taps,
            C.layer_norm(tok, sd, "info_sharing.norm"))


def _residual_unit(x, sd, name, precision):
    act = F.relu(x)
    h = C.conv2d(act, sd, name + ".conv1", precision, padding=1)
    return C.conv2d(F.relu(h), sd, name + ".conv2", precision, padding=1) + act


def _upsample(x, size):
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


def dense_head(sd: dict, cfg: dict, hooks: list, out_hw, precision: str
               ) -> torch.Tensor:
    """DPT: 4 maps (N, C_i, gh, gw) -> (N, H, W, dense_output_dim)."""
    dpt = "dense_head.dpt_feature"
    gh, gw = hooks[0].shape[-2:]
    lv = [C.conv2d(h, sd, f"{dpt}.project_{i}", precision)
          for i, h in enumerate(hooks)]
    lv[0] = C.conv_transpose2d(lv[0], sd, f"{dpt}.resize_0", precision, 4)
    lv[1] = C.conv_transpose2d(lv[1], sd, f"{dpt}.resize_1", precision, 2)
    lv[3] = C.conv2d(lv[3], sd, f"{dpt}.resize_3", precision, stride=2,
                     padding=1)
    rn = [C.conv2d(x, sd, f"{dpt}.layer_rn_{i}", precision, padding=1,
                   bias=False) for i, x in enumerate(lv)]
    sizes = [rn[2].shape[-2:], rn[1].shape[-2:], rn[0].shape[-2:],
             (gh * 8, gw * 8)]
    path = None
    for j, r in enumerate((4, 3, 2, 1)):
        name = f"{dpt}.refinenet{r}"
        if path is None:
            path = rn[3]
        else:
            path = path + _residual_unit(rn[r - 1], sd,
                                         name + ".res_conv_unit1", precision)
        path = _residual_unit(path, sd, name + ".res_conv_unit2", precision)
        # the 1x1 out_conv before the upsample: the two commute, and this
        # order does the fewer products
        path = _upsample(C.conv2d(path, sd, name + ".out_conv", precision),
                         sizes[j])
    reg = "dense_head.dpt_regressor"
    x = _upsample(C.conv2d(path, sd, f"{reg}.conv1", precision, padding=1),
                  out_hw)
    x = F.relu(C.conv2d(x, sd, f"{reg}.conv2", precision, padding=1))
    return C.conv2d(x, sd, f"{reg}.conv_out", precision).permute(0, 2, 3, 1)


def pose_head(sd: dict, cfg: dict, x: torch.Tensor, precision: str):
    """(N, D, gh, gw) -> (N, 7): translation 3, quaternion 4 (raw)."""
    x = C.conv2d(x, sd, "pose_head.proj", precision)
    for i in range(cfg["pose_num_resconv"]):
        x = _residual_unit(x, sd, f"pose_head.res_conv_{i}", precision)
    x = C.gelu(C.linear(x.mean(dim=(-2, -1)), sd, "pose_head.fc1", precision))
    return C.linear(x, sd, "pose_head.fc_out", precision)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-8)


def quat_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """Unit xyzw quaternions (..., 4) -> (..., 3, 3)."""
    x, y, z, w = _unit(q).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


# --- infer's default mask ------------------------------------------------------


def _windows(x: torch.Tensor, k: int, mode: str, value: float = 0.0):
    """(N, H, W) -> (N, H, W, k*k): each pixel's k x k window, padded."""
    pad = k // 2
    xp = F.pad(x[:, None].float(), (pad,) * 4, mode=mode,
               **({"value": value} if mode == "constant" else {}))[:, 0]
    h, w = x.shape[-2:]
    return torch.stack([xp[:, i:i + h, j:j + w] for i in range(k)
                        for j in range(k)], dim=-1)


def depth_edge(depth, mask, rtol: float, k: int = 3):
    """The window's depth range over valid pixels, relative to the pixel's
    depth, above rtol (utils3d.depth_edge)."""
    inf = torch.tensor(math.inf, device=depth.device)
    hi = _windows(torch.where(mask, depth, -inf), k, "constant", -math.inf)
    lo = _windows(torch.where(mask, -depth, -inf), k, "constant", -math.inf)
    diff = hi.amax(-1) + lo.amax(-1)
    return torch.nan_to_num(diff / depth) > rtol


def points_to_normals(pts, mask):
    """utils3d.points_to_normals: per pixel, the normalised sum of the unit
    normals of the four quads (up-left, left-down, down-right, right-up)
    whose three points are valid. pts (N, H, W, 3)."""
    h, w = pts.shape[1:3]
    pp = F.pad(pts.permute(0, 3, 1, 2), (1, 1, 1, 1)).permute(0, 2, 3, 1)
    mp = F.pad(mask[:, None].float(), (1, 1, 1, 1))[:, 0] > 0.5
    c = pp[:, 1:-1, 1:-1]
    up, left = pp[:, :-2, 1:-1] - c, pp[:, 1:-1, :-2] - c
    down, right = pp[:, 2:, 1:-1] - c, pp[:, 1:-1, 2:] - c
    m_c = mp[:, 1:-1, 1:-1]
    m_u, m_l, m_d, m_r = (mp[:, :-2, 1:-1], mp[:, 1:-1, :-2], mp[:, 2:, 1:-1],
                          mp[:, 1:-1, 2:])
    normal = torch.zeros_like(c)
    valid_any = torch.zeros_like(m_c)
    for a, b, m in ((up, left, m_u & m_l), (left, down, m_l & m_d),
                    (down, right, m_d & m_r), (right, up, m_r & m_u)):
        n = torch.linalg.cross(a, b, dim=-1)
        n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-12)
        valid = m & m_c
        normal = normal + n * valid[..., None]
        valid_any = valid_any | valid
    normal = normal / (torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
                       + 1e-12)
    return torch.where(valid_any[..., None], normal, 0.0), valid_any


def normals_edge(normals, mask, tol_deg: float, k: int = 3):
    """utils3d.normals_edge: the largest angle from a pixel's normal to a
    valid neighbour's in its window (edge padding), max-pooled over the
    window, above tol degrees."""
    normals = normals / (torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
                         + 1e-12)
    win = torch.stack([_windows(normals[..., i], k, "replicate")
                       for i in range(3)], dim=-1)  # (N, H, W, k*k, 3)
    mwin = _windows(mask.float(), k, "replicate") > 0.5
    cos = (normals[..., None, :] * win).sum(-1).clamp(-1.0, 1.0)
    angle = torch.where(mwin, torch.arccos(cos), 0.0).amax(-1)
    angle = F.max_pool2d(angle[:, None], k, stride=1, padding=k // 2)[:, 0]
    return angle > math.radians(tol_deg)


# --- the whole call -------------------------------------------------------------


@torch.no_grad()
def infer(sd: dict, cfg: dict, img: torch.Tensor, precision: str = "fp32",
          view_block: int = 8) -> dict:
    """img (B, V, H, W, 3) normalised images -> infer's outputs (B, V, ...):
    pts3d, ray_directions, depth_along_ray, conf, mask (B, V, H, W, 1)
    bool, non_ambiguous_mask_logits, cam_quats, cam_trans, and metric_scaling_factor (B,). Metric
    quantities are scaled; pts3d and depth_along_ray are zero outside the
    mask, as `infer` returns them."""
    with C.fp32_matmuls():
        return _infer(sd, cfg, img.float(), precision, view_block)


def _infer(sd, cfg, img, precision, view_block):
    b, v, h, w, _ = img.shape
    p = cfg["patch_size"]
    gh, gw = h // p, w // p
    flat = img.reshape(b * v, h, w, 3)
    feats = torch.cat([encoder(sd, cfg, flat[i:i + view_block], precision)
                       for i in range(0, b * v, view_block)])
    feats = C.layer_norm(feats, sd, "fusion_norm")
    final, taps, tok = trunk(sd, cfg, feats.reshape(b, v, gh * gw, -1),
                             precision)

    def grid(x):  # (B, V, P, C) -> (B*V, C, gh, gw)
        return x.reshape(b * v, gh, gw, -1).permute(0, 3, 1, 2)

    hooks = [grid(x) for x in [feats.reshape(b, v, gh * gw, -1)] + taps
             + [final]]
    raw = torch.cat([dense_head(sd, cfg, [x[i:i + view_block] for x in hooks],
                                (h, w), precision)
                     for i in range(0, b * v, view_block)])
    raw = raw.reshape(b, v, h, w, -1)
    pose = pose_head(sd, cfg, hooks[-1], precision).reshape(b, v, 7)
    s_raw = C.linear(C.gelu(C.linear(tok[:, 0], sd, "scale_head.fc1",
                                     precision)), sd, "scale_head.fc2",
                     precision)
    scale = 1e-8 + torch.exp(s_raw[:, 0])  # (B,)

    # the adaptors of "raydirs+depth+pose+confidence+mask"
    trans, quats = pose[..., :3], _unit(pose[..., 3:7])
    dirs = _unit(raw[..., 0:3])
    depth = torch.exp(raw[..., 3:4])
    conf = 1.0 + torch.exp(raw[..., 4])
    logits = raw[..., 5]
    s = scale[:, None, None, None, None]
    local = depth * dirs
    rot = quat_to_rotation(quats)  # (B, V, 3, 3)
    world = (rot[:, :, None, None] * local[..., None, :]).sum(-1)
    pts3d = (world + trans[:, :, None, None, :]) * s
    pts3d_cam = local * s

    # infer's default mask: non-ambiguous, and not on a depth and a normal
    # edge at once (edge_normal_threshold 5 degrees, edge_depth_threshold
    # 0.03)
    nonamb = (1.0 / (1.0 + torch.exp(-logits))) > 0.5
    m = nonamb.reshape(b * v, h, w)
    normals, nmask = points_to_normals(pts3d.reshape(b * v, h, w, 3), m)
    edges = (normals_edge(normals, nmask, 5.0)
             & depth_edge(pts3d_cam[..., 2].reshape(b * v, h, w), m, 0.03))
    mask = (m & ~edges).reshape(b, v, h, w)
    keep = mask[..., None].float()
    return {"pts3d": pts3d * keep, "ray_directions": dirs,
            "depth_along_ray": depth * s * keep, "conf": conf,
            "mask": mask[..., None], "non_ambiguous_mask_logits": logits,
            "cam_quats": quats,
            "cam_trans": trans * scale[:, None, None],
            "metric_scaling_factor": scale}


# --- FLOPs ---------------------------------------------------------------------


def flops(cfg: dict, batch: int, views: int, h: int, w: int) -> int:
    """The products of one images-only call, as :func:`infer` computes them
    (and the program: its padded rows and the prior encoders excluded)."""
    p = cfg["patch_size"]
    gh, gw = h // p, w // p
    pt = gh * gw
    n = batch * views
    e, d = cfg["encoder_embed_dim"], cfg["trunk_dim"]
    r = cfg["mlp_ratio"]
    total = C.conv_flops(n, gh, gw, 3, e, p)
    total += cfg["encoder_depth"] * C.vit_block_flops(
        n, pt + 1, e, r * e, cfg["encoder_num_heads"])
    total += C.linear_flops(n * pt + batch, e, d)  # patches and tokens
    half = cfg["trunk_depth"] // 2
    heads = cfg["trunk_num_heads"]
    total += (cfg["trunk_depth"] - half) * C.vit_block_flops(
        n, pt, d, r * d, heads)
    total += half * C.vit_block_flops(batch, views * pt + 1, d, r * d, heads)
    f, oc = cfg["dpt_feature_dim"], cfg["dpt_out_channels"]
    h0, h1 = cfg["dpt_hidden_dims"]
    g = [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw),
         ((gh - 1) // 2 + 1, (gw - 1) // 2 + 1)]
    for i, c_in in enumerate([e, d, d, d]):
        total += C.conv_flops(n, gh, gw, c_in, oc[i], 1)
    total += C.conv_flops(n, gh, gw, oc[0], oc[0], 4)  # transposed, k = s
    total += C.conv_flops(n, gh, gw, oc[1], oc[1], 2)
    total += C.conv_flops(n, *g[3], oc[3], oc[3], 3)
    for i in range(4):
        total += C.conv_flops(n, *g[i], oc[i], f, 3)
    rcu = 2 * C.conv_flops(n, 1, 1, f, f, 3)  # per pixel of its grid
    inputs = [g[3], g[2], g[1], g[0]]
    for j in range(4):
        hh, ww = inputs[j]
        total += rcu * hh * ww * (1 if j == 0 else 2)
        total += C.conv_flops(n, hh, ww, f, f, 1)
    total += C.conv_flops(n, 8 * gh, 8 * gw, f, h0, 3)
    total += C.conv_flops(n, h, w, h0, h1, 3)
    total += C.conv_flops(n, h, w, h1, cfg["dense_output_dim"], 1)
    hid = d // 2
    total += C.conv_flops(n, gh, gw, d, hid, 1)
    total += cfg["pose_num_resconv"] * 2 * C.conv_flops(n, gh, gw, hid, hid, 3)
    total += C.linear_flops(n, hid, hid) + C.linear_flops(n, hid, 7)
    total += C.linear_flops(batch, d, d // 2) + C.linear_flops(batch, d // 2, 1)
    return total


def attention_calls(cfg: dict, batch: int, views: int, h: int, w: int):
    """[(b, nq, nk, heads, head_dim, count)]: the attentions of one call at
    their real token counts (the roofline's shapes)."""
    p = cfg["patch_size"]
    pt = (h // p) * (w // p)
    n = batch * views
    eh, th = cfg["encoder_num_heads"], cfg["trunk_num_heads"]
    ed, td = cfg["encoder_embed_dim"] // eh, cfg["trunk_dim"] // th
    half = cfg["trunk_depth"] // 2
    g = views * pt + 1
    return [(n, pt + 1, pt + 1, eh, ed, cfg["encoder_depth"]),
            (n, pt, pt, th, td, cfg["trunk_depth"] - half),
            (batch, g, g, th, td, half)]
