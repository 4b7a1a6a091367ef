"""Plain PyTorch reference of ModularDUSt3R, the two-view DUSt3R.

DUSt3R (arXiv:2312.14132; DUSt3R_ViTLarge_BaseDecoder_512_linear) as the
MapAnything repository builds it (mapanything/models/mapanything/
modular_dust3r.py): a CroCo ViT encoder over both images (patch 16, no
class token), a linear map to the decoder width, two weight-separate
decoder branches whose blocks run self-attention, cross-attention to the
other branch's tokens of the layer before (normalised) and an MLP, a final
LayerNorm, and per branch a linear head giving 3 point and 1 confidence
channels a pixel: points through the "exp" activation (direction times
expm1 of the norm), confidence 1 + exp.

Float32 (or the control's precision, reference/common.py). Departures,
listed in the configuration file under `assumed`: the encoder adds a
fixed 2D sin-cos positional embedding (the row's [sin, cos], then the
column's) where the published model rotates q and k by RoPE100, and the
linear head's output channels are read as (row in patch, column in patch,
channel) where DUSt3R's pixel shuffle reads (channel, row, column); the
parameter names are the program's, so one state dict serves both.
"""

from __future__ import annotations

import torch

from . import common as C

IMAGE_MEAN = (0.5, 0.5, 0.5)
IMAGE_STD = (0.5, 0.5, 0.5)


def param_spec(cfg: dict) -> dict:
    s: dict = {}
    e, p = cfg["encoder_embed_dim"], cfg["patch_size"]
    d = cfg["decoder_dim"]
    r = cfg["mlp_ratio"]
    C.spec_conv(s, "encoder.patch_embed", 3, e, p)
    for i in range(cfg["encoder_depth"]):
        C.spec_vit_block(s, f"encoder.blocks.{i}", e, r * e, layerscale=False)
    C.spec_norm(s, "encoder.norm", e)
    C.spec_linear(s, "decoder_embed", e, d)
    for i in range(cfg["decoder_depth"]):
        for branch in (1, 2):
            name = f"dec{branch}_{i}"
            C.spec_norm(s, name + ".norm1", d)
            C.spec_linear(s, name + ".self_attn.qkv", d, 3 * d)
            C.spec_linear(s, name + ".self_attn.proj", d, d)
            C.spec_norm(s, name + ".norm2", d)
            C.spec_norm(s, name + ".norm_context", d)
            C.spec_linear(s, name + ".cross_attn.q", d, d)
            C.spec_linear(s, name + ".cross_attn.kv", d, 2 * d)
            C.spec_linear(s, name + ".cross_attn.proj", d, d)
            C.spec_norm(s, name + ".norm3", d)
            C.spec_linear(s, name + ".mlp.fc1", d, r * d)
            C.spec_linear(s, name + ".mlp.fc2", r * d, d)
    C.spec_norm(s, "dec_norm", d)
    for head in ("head1", "head2"):
        C.spec_linear(s, head + ".proj", d, 4 * p * p)
    return s


def sincos_2d(gh: int, gw: int, dim: int, device) -> torch.Tensor:
    """(gh*gw, dim): [sin, cos] of the row index, then [sin, cos] of the
    column index, at dim/4 frequencies 10000^(-i/(dim/4)) each."""
    d4 = dim // 4
    omega = 1.0 / 10000 ** (torch.arange(d4, dtype=torch.float64) / d4)
    oy = torch.arange(gh, dtype=torch.float64)[:, None] * omega
    ox = torch.arange(gw, dtype=torch.float64)[:, None] * omega
    ey = torch.cat([oy.sin(), oy.cos()], -1)[:, None].expand(gh, gw, 2 * d4)
    ex = torch.cat([ox.sin(), ox.cos()], -1)[None].expand(gh, gw, 2 * d4)
    return torch.cat([ey, ex], -1).reshape(gh * gw, dim).float().to(device)


def encoder(sd, cfg, img, precision):
    n, h, w, _ = img.shape
    p = cfg["patch_size"]
    gh, gw = h // p, w // p
    x = C.conv2d(img.permute(0, 3, 1, 2), sd, "encoder.patch_embed", precision,
                 stride=p).flatten(2).transpose(1, 2)
    x = x + sincos_2d(gh, gw, x.shape[-1], x.device)
    for i in range(cfg["encoder_depth"]):
        x = C.vit_block(x, sd, f"encoder.blocks.{i}", cfg["encoder_num_heads"],
                        precision, layerscale=False)
    return C.layer_norm(x, sd, "encoder.norm")


def cross_attention(x, ctx, sd, name, heads, precision):
    b, n, d = x.shape
    m = ctx.shape[1]
    q = C.linear(x, sd, name + ".q", precision).view(b, n, heads, d // heads)
    kv = C.linear(ctx, sd, name + ".kv", precision).view(b, m, 2, heads,
                                                         d // heads)
    k, v = kv.permute(2, 0, 3, 1, 4)
    out = C.attention(q.transpose(1, 2), k, v, precision)
    return C.linear(out.transpose(1, 2).reshape(b, n, d), sd, name + ".proj",
                    precision)


def decoder_block(x, ctx, sd, name, heads, precision):
    x = x + C.self_attention(C.layer_norm(x, sd, name + ".norm1"), sd,
                             name + ".self_attn", heads, precision)
    x = x + cross_attention(C.layer_norm(x, sd, name + ".norm2"),
                            C.layer_norm(ctx, sd, name + ".norm_context"), sd,
                            name + ".cross_attn", heads, precision)
    return x + C.mlp(C.layer_norm(x, sd, name + ".norm3"), sd, name + ".mlp",
                     precision)


def head(x, sd, name, gh, gw, p, precision):
    """(B, gh*gw, D) -> points (B, H, W, 3), confidence (B, H, W)."""
    b = x.shape[0]
    out = C.linear(x, sd, name + ".proj", precision)
    out = out.reshape(b, gh, gw, p, p, 4).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(b, gh * p, gw * p, 4)
    xyz = out[..., :3]
    norm = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    pts = xyz / norm.clamp_min(1e-8) * torch.expm1(norm)
    return pts, 1.0 + torch.exp(out[..., 3])


@torch.no_grad()
def forward(sd: dict, cfg: dict, img: torch.Tensor, precision: str = "fp32",
            pair_block: int = 8) -> dict:
    """img (B, 2, H, W, 3) normalised pairs -> pts3d (B, 2, H, W, 3), both
    in view 1's frame, and conf (B, 2, H, W)."""
    with C.fp32_matmuls():
        outs = [_forward(sd, cfg, img[i:i + pair_block].float(), precision)
                for i in range(0, img.shape[0], pair_block)]
    return {key: torch.cat([o[key] for o in outs]) for key in outs[0]}


def _forward(sd, cfg, img, precision):
    b, v, h, w, _ = img.shape
    p, heads = cfg["patch_size"], cfg["decoder_num_heads"]
    gh, gw = h // p, w // p
    feats = encoder(sd, cfg, img.reshape(b * v, h, w, 3), precision)
    feats = C.linear(feats, sd, "decoder_embed", precision)
    feats = feats.reshape(b, v, gh * gw, -1)
    x1, x2 = feats[:, 0], feats[:, 1]
    for i in range(cfg["decoder_depth"]):
        x1, x2 = (decoder_block(x1, x2, sd, f"dec1_{i}", heads, precision),
                  decoder_block(x2, x1, sd, f"dec2_{i}", heads, precision))
    pts1, conf1 = head(C.layer_norm(x1, sd, "dec_norm"), sd, "head1", gh, gw,
                       p, precision)
    pts2, conf2 = head(C.layer_norm(x2, sd, "dec_norm"), sd, "head2", gh, gw,
                       p, precision)
    return {"pts3d": torch.stack([pts1, pts2], 1),
            "conf": torch.stack([conf1, conf2], 1)}


def flops(cfg: dict, batch: int, views: int, h: int, w: int) -> int:
    p = cfg["patch_size"]
    gh, gw = h // p, w // p
    n = gh * gw
    e, d, r = cfg["encoder_embed_dim"], cfg["decoder_dim"], cfg["mlp_ratio"]
    heads = cfg["decoder_num_heads"]
    imgs = batch * views
    total = C.conv_flops(imgs, gh, gw, 3, e, p)
    total += cfg["encoder_depth"] * C.vit_block_flops(
        imgs, n, e, r * e, cfg["encoder_num_heads"])
    total += C.linear_flops(imgs * n, e, d)
    rows = imgs * n  # both branches
    block = (C.vit_block_flops(imgs, n, d, r * d, heads)
             + C.linear_flops(rows, d, d) + C.linear_flops(rows, d, 2 * d)
             + C.attention_flops(imgs, heads, n, n, d // heads)
             + C.linear_flops(rows, d, d))
    total += cfg["decoder_depth"] * block
    total += C.linear_flops(rows, d, 4 * p * p)
    return total


def attention_calls(cfg: dict, batch: int, views: int, h: int, w: int):
    p = cfg["patch_size"]
    n = (h // p) * (w // p)
    eh, dh = cfg["encoder_num_heads"], cfg["decoder_num_heads"]
    ed, dd = cfg["encoder_embed_dim"] // eh, cfg["decoder_dim"] // dh
    # encoder self-attention; each decoder layer's self- and
    # cross-attention in both branches
    return [(batch * views, n, n, eh, ed, cfg["encoder_depth"]),
            (batch * views, n, n, dh, dd, 2 * cfg["decoder_depth"])]

