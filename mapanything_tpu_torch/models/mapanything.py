"""MapAnything model, images-only; counterpart of
mapanything_tpu/models/mapanything.py.

The forward runs the released architecture on (B, V, H, W, 3) normalised
NHWC images:

  1. DINOv2 encoder over all B*V views;
  2. the fp32 fusion LayerNorm (no geometric priors in this slice);
  3. the metric-scale token;
  4. the alternating frame/global trunk;
  5. the DPT dense head on [fused encoder features, IFR taps, final];
  6. the pose head on the final features and the scale MLP on the token;
  7. the released adaptors and the factored recombination into pointmaps.

`MapAnythingConfig` has the JAX package's fields and defaults. Values the
slice does not run raise NotImplementedError naming their ROADMAP item.

With a process group, `forward(views, seq_group=group)` runs the rank's
share of the views sequence-parallel (the trunk's global layers as ring
attention); parallel/inference.py::view_sharded_forward drives it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..geometry import (
    convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap,
)
from ..nn.adaptors import (
    confidence_adaptor,
    depth_adaptor,
    mask_adaptor,
    normalize_to_unit_sphere,
    pose_adaptor,
    scale_adaptor,
)
from ..nn.dinov2 import DinoViT
from ..nn.dpt import DPTFeature, DPTRegressionProcessor
from ..nn.heads import MLPHead, PoseHead
from ..nn.layers import Attention, FusedLayerNorm, init_weights_
from ..nn.trunk import AlternatingAttentionTrunk
from ..utils.device import resolve_device

RELEASED_SCENE_REP = "raydirs+depth+pose+confidence+mask"

# view keys that carry geometric priors (inputs of _fuse_geometric_priors)
PRIOR_VIEW_KEYS = ("ray_directions_cam", "depth_along_ray",
                   "camera_pose_quats", "camera_pose_trans")


@dataclasses.dataclass(frozen=True)
class GeometricInputConfig:
    """Input-modality probabilities (same fields as the JAX package)."""

    overall_prob: float = 1.0
    dropout_prob: float = 0.0
    ray_dirs_prob: float = 1.0
    depth_prob: float = 1.0
    cam_prob: float = 1.0
    sparse_depth_prob: float = 0.0
    sparsification_removal_percent: float = 0.99
    depth_scale_norm_all_prob: float = 0.0
    pose_scale_norm_all_prob: float = 0.0

    def deterministic(self) -> bool:
        probs = (
            self.overall_prob, self.dropout_prob, self.ray_dirs_prob,
            self.depth_prob, self.cam_prob, self.sparse_depth_prob,
            self.depth_scale_norm_all_prob, self.pose_scale_norm_all_prob,
        )
        return all(p in (0.0, 1.0) for p in probs)


def images_only_config() -> GeometricInputConfig:
    """configs/model/task/images_only.yaml."""
    return GeometricInputConfig(
        overall_prob=0.0, dropout_prob=1.0, ray_dirs_prob=0.0, depth_prob=0.0,
        cam_prob=0.0, sparse_depth_prob=0.0,
        sparsification_removal_percent=0.0)


@dataclasses.dataclass(frozen=True)
class MapAnythingConfig:
    """Released default architecture: DINOv2-L/14 + 24-layer alternating
    IFR trunk (dim 1024, taps [11, 17]) + DPT(256) + pose head + scale MLP.
    Same fields and defaults as the JAX package's MapAnythingConfig."""

    encoder_type: str = "dinov2"
    encoder_size: str = "large"
    encoder_img_size: int = 1024
    patch_size: int = 14
    data_norm_type: str = "dinov2"
    encoder_gradient_checkpointing: bool = False
    fold_layerscale: bool = False
    encoder_pad_tokens_to: Optional[int] = 128
    trunk_pad_tokens_to: Optional[int] = 128
    scan_layers: bool = False
    trunk_dim: int = 1024
    trunk_depth: int = 24
    trunk_num_heads: int = 16
    trunk_indices: tuple = (11, 17)
    info_sharing_type: str = "alternating"
    distinguish_ref_and_non_ref_views: bool = True
    use_view_pe: bool = False
    trunk_gradient_checkpointing: bool = False
    trunk_seq_axis: Optional[str] = None
    use_scale_token: bool = True
    trunk_rope_freq: Optional[float] = None
    dpt_feature_dim: int = 256
    dpt_hidden_dims: tuple = (128, 64)
    dpt_out_channels: tuple = (256, 512, 1024, 1024)
    scene_rep_type: str = RELEASED_SCENE_REP
    dense_output_dim: int = 6
    use_factored_global_pointmaps: bool = True
    pose_num_resconv: int = 2
    dense_head_chunk: int = 4
    mlp_token_chunk: int = 16384
    dtype: Any = torch.bfloat16
    heads_dtype: str = "auto"  # "auto" | "float32" | "bfloat16"

    def resolved_heads_dtype(self) -> torch.dtype:
        if self.heads_dtype == "auto":
            return self.dtype
        return getattr(torch, self.heads_dtype)

    def check_supported(self) -> None:
        """Raise NotImplementedError for values outside this slice."""
        default = MapAnythingConfig()
        unsupported = {
            "encoder_type": "ROADMAP queue A item 10 (CroCo/RADIO encoders)",
            "info_sharing_type": "ROADMAP queue A item 10 (other trunks)",
            "use_view_pe": "ROADMAP queue A item 10 (view PE)",
            "trunk_rope_freq": "ROADMAP queue A item 10 (RoPE2D)",
            "use_scale_token": "ROADMAP queue A item 10 (ablations)",
            "scene_rep_type": "ROADMAP queue A item 4 (other scene reps)",
            "fold_layerscale": "ROADMAP queue A item 2 (fold_layerscale)",
            "encoder_gradient_checkpointing": (
                "ROADMAP queue A item 9 (gradient checkpointing)"),
            "trunk_gradient_checkpointing": (
                "ROADMAP queue A item 9 (gradient checkpointing)"),
        }
        for field, item in unsupported.items():
            if getattr(self, field) != getattr(default, field):
                raise NotImplementedError(
                    f"MapAnythingConfig.{field}={getattr(self, field)!r} is "
                    f"not ported yet: {item}")
        if self.trunk_seq_axis is not None:
            raise ValueError(
                "trunk_seq_axis names a JAX mesh axis; the port takes the "
                "torch.distributed process group at run time instead: "
                "MapAnything.forward(views, seq_group=...), "
                "view_sharded_forward(model, views, group) or "
                "InferencePipeline(model, view_shard_group=...)")
        if self.scan_layers:
            raise NotImplementedError(
                "scan_layers is an XLA compile-time tool; the port runs the "
                "layers as a plain loop (ROADMAP queue A, do-not-port list)")


class _DenseHead(nn.Module):
    """DPT feature + regression tail."""

    def __init__(self, cfg: MapAnythingConfig, enc_dim: int, device=None):
        super().__init__()
        hdt = cfg.resolved_heads_dtype()
        self.dtype = hdt
        self.dpt_feature = DPTFeature(
            input_feature_dims=(enc_dim,) + (cfg.trunk_dim,) * 3,
            feature_dim=cfg.dpt_feature_dim,
            out_channels=tuple(cfg.dpt_out_channels), dtype=hdt, device=device)
        self.dpt_regressor = DPTRegressionProcessor(
            input_feature_dim=cfg.dpt_feature_dim,
            output_dim=cfg.dense_output_dim,
            hidden_dims=tuple(cfg.dpt_hidden_dims), dtype=hdt, device=device)

    def forward(self, hooks, out_hw):
        feat = self.dpt_feature([h.to(self.dtype) for h in hooks])
        return self.dpt_regressor(feat, out_hw)


class MapAnything(nn.Module):
    """The multi-view metric 3D reconstruction model (images-only slice).

    Args:
        cfg: the architecture.
        device: where the parameters live: the card when None (raises
            without one), "cpu" when asked; "meta" builds shapes only.
        generator: random init of the parameters (N(0, 0.02^2) weights, see
            nn/layers.py::init_weights_). None leaves them uninitialised,
            for a caller that loads weights next (utils/weights.py).
    """

    def __init__(self, cfg: MapAnythingConfig = MapAnythingConfig(),
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg.check_supported()
        device = resolve_device(device)
        self.cfg = cfg
        dt = cfg.dtype
        self.encoder = DinoViT(
            size=cfg.encoder_size, patch_size=cfg.patch_size, dtype=dt,
            pad_tokens_to=cfg.encoder_pad_tokens_to,
            device=device)
        enc_dim = self.encoder.embed_dim
        self.fusion_norm = FusedLayerNorm(enc_dim, dtype=torch.float32,
                                          device=device)
        self.scale_token = nn.Parameter(torch.empty(enc_dim, device=device))
        self.info_sharing = AlternatingAttentionTrunk(
            input_embed_dim=enc_dim, dim=cfg.trunk_dim, depth=cfg.trunk_depth,
            num_heads=cfg.trunk_num_heads, indices=tuple(cfg.trunk_indices),
            distinguish_ref_and_non_ref_views=(
                cfg.distinguish_ref_and_non_ref_views),
            dtype=dt, pad_tokens_to=cfg.trunk_pad_tokens_to, device=device)
        self.dense_head = _DenseHead(cfg, enc_dim, device=device)
        self.pose_head = PoseHead(
            input_feature_dim=cfg.trunk_dim,
            num_resconv_block=cfg.pose_num_resconv,
            dtype=cfg.resolved_heads_dtype(), device=device)
        self.scale_head = MLPHead(input_feature_dim=cfg.trunk_dim,
                                  output_dim=1, dtype=torch.float32,
                                  device=device)
        if generator is not None:
            init_weights_(self, generator)

    def set_attn_impl(self, impl: str) -> None:
        """Switch every encoder and trunk attention to `impl`: "auto" |
        "flash" | "math" (ops/attention.py::sdpa)."""
        for mod in self.modules():
            if isinstance(mod, Attention):
                mod.attn_impl = impl

    def forward(self, views: Dict[str, torch.Tensor],
                seq_group=None) -> Dict[str, torch.Tensor]:
        """views["img"]: (B, V, H, W, 3) normalised images. Returns the
        released outputs, all (B, V, ...) but metric_scaling_factor (B,).

        With `seq_group`, views hold this rank's V/p views in global order
        and the outputs are this rank's; metric_scaling_factor is the same
        on every rank."""
        present = [k for k in PRIOR_VIEW_KEYS if k in views]
        if present:
            raise NotImplementedError(
                f"geometric priors {present} are not ported yet: ROADMAP "
                "queue A item 8 (multimodal priors)")
        cfg = self.cfg
        imgs = views["img"]
        b, v, h, w, _ = imgs.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size

        enc = self.encoder(imgs.reshape(b * v, h, w, 3))
        enc_dim = enc.shape[-1]
        fused = self.fusion_norm(enc.reshape(b, v, gh, gw, enc_dim).float())
        tok = self.scale_token[None, None, :].expand(b, 1, enc_dim)
        final, intermediates, tok_out = self.info_sharing(
            fused.to(cfg.dtype), tok, seq_group)

        # hook 0 is the fused, normed encoder features
        hooks = [fused.to(cfg.dtype)] + intermediates + [final]
        hooks = [x.reshape(b * v, gh, gw, x.shape[-1]) for x in hooks]
        raw_dense = self.dense_head(hooks, (h, w))  # (B*V, H, W, 6) fp32
        raw_pose = self.pose_head(hooks[-1])  # (B*V, 7) fp32
        raw_scale = self.scale_head(tok_out[:, 0, :].float())  # (B, 1)

        raw = raw_dense.reshape(b, v, h, w, cfg.dense_output_dim)
        metric_scale = scale_adaptor(raw_scale)[:, 0]  # (B,)
        s = metric_scale[:, None, None, None, None]
        pose = pose_adaptor(raw_pose.reshape(b, v, 7))
        ray_dirs = normalize_to_unit_sphere(raw[..., 0:3])
        depth_along_ray = depth_adaptor(raw[..., 3:4])
        pts3d = convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap(
            ray_dirs, depth_along_ray, pose["trans"], pose["quats"])
        mask = mask_adaptor(raw[..., 5:6])
        return {
            "metric_scaling_factor": metric_scale,
            "cam_trans": pose["trans"] * metric_scale[:, None, None],
            "cam_quats": pose["quats"],
            "pts3d": pts3d * s,
            "pts3d_cam": ray_dirs * depth_along_ray * s,
            "ray_directions": ray_dirs,
            "depth_along_ray": depth_along_ray * s,
            "conf": confidence_adaptor(raw[..., 4:5])[..., 0],
            "non_ambiguous_mask": mask["mask"][..., 0] > 0.5,
            "non_ambiguous_mask_logits": mask["logits"][..., 0],
        }
