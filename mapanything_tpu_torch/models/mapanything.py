"""MapAnything model; counterpart of mapanything_tpu/models/mapanything.py.

The forward runs the model family on (B, V, H, W, 3) normalised NHWC
images and the optional geometric priors:

  1. the image encoder over all B*V views: DINOv2 (released), CroCo or
     RADIO (`encoder_type`);
  2. the geometric priors fused into the encoder features in fp32
     (`fuse_geometric_priors`), then the fp32 fusion LayerNorm;
  3. the metric-scale token, unless `use_scale_token=False` (the
     ablations: no token, a metric scale of 1);
  4. the trunk (`info_sharing_type`): alternating frame/global (released,
     with the view PE, RoPE2D options), global, or cross-attention;
  5. the DPT dense head on [fused encoder features, IFR taps, final];
  6. the pose head on the final features (the `*pose` scene
     representations only) and the scale MLP on the token;
  7. the adaptors and the recombination of `scene_rep_type`: one of five
     families, each with or without confidence and mask (the reference's 20
     arms; `dense_dim_for` gives the dense head's width).

Input views (all but img optional):
  img                (B, V, H, W, 3)  normalised images
  ray_directions_cam (B, V, H, W, 3)  unit ray directions
  depth_along_ray    (B, V, H, W, 1)
  camera_pose_quats  (B, V, 4)        cam2world xyzw
  camera_pose_trans  (B, V, 3)
  is_metric_scale    (B, V) bool
  ray_dirs_valid / depth_valid / pose_valid  (B, V) bool, which samples
      provide each prior (all, when absent)

`MapAnythingConfig` has the JAX package's fields and defaults; the two the
port does not take (`trunk_seq_axis`, `scan_layers`) raise. With
`use_view_pe`, the view-PE rows are the view indices at inference; a
forward given a generator draws the non-reference views' rows from it, as
the JAX package draws them from its rng.
`encoder_/trunk_gradient_checkpointing` recompute each block's activations
in the backward (torch.utils.checkpoint).

A `GeometricInputConfig` with probabilities in {0, 1} folds to constant
masks; any other (the `aug_training` mix) draws its Bernoulli masks from
the torch.Generator passed to `forward` (`draw_prior_masks`), as does the
sparse-depth pixel draw.

`memory_efficient=True` runs the MLPs in `mlp_token_chunk`-row slices and
the dense head `dense_head_chunk` views at a time; `resolve_memory_policy`
picks those knobs from the shape and the card's memory before the call.

With a process group, `forward(views, seq_group=group)` runs the rank's
share of the views sequence-parallel (the trunk's global layers as ring
attention); parallel/inference.py::view_sharded_forward drives it. The
priors run there too: the view-0 pose is gathered from rank 0, the mean
translation norm reduced over the ranks, and every rank draws the masks of
all the views from the same generator state and keeps its own views', so
p ranks compute what one does with the same generator. Likewise a
data-parallel rank (`forward(views, batch_shard=(d, n))`, views holding
rows [d B, (d + 1) B) of a batch of n B) draws the masks of the whole
batch and keeps its rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..geometry import (
    apply_log_to_norm,
    convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap,
    normalize_depth_using_non_zero_pixels,
    normalize_pose_translations,
    safe_norm,
    transform_pose_using_quats_and_trans_2_to_1,
)
from ..geometry.quats import unit_w
from ..nn.adaptors import (
    confidence_adaptor,
    depth_adaptor,
    mask_adaptor,
    normalize_to_unit_sphere,
    pose_adaptor,
    scale_adaptor,
)
from ..nn.croco import CroCoViT, CrossAttention
from ..nn.dinov2 import DinoViT
from ..nn.dpt import DPTFeature, DPTRegressionProcessor
from ..nn.encoders import DenseRepEncoder, GlobalRepEncoder
from ..nn.heads import MLPHead, PoseHead
from ..nn.layers import Attention, FusedLayerNorm, init_weights_
from ..nn.radio import RadioViT
from ..nn.trunk import (AlternatingAttentionTrunk, CrossAttentionTrunk,
                        GlobalAttentionTrunk)
from ..ops.ring_attention import all_gather, all_reduce
from ..perf.timing import span
from ..utils.device import resolve_device

RELEASED_SCENE_REP = "raydirs+depth+pose+confidence+mask"

# scene-representation family -> dense channels before confidence and mask
_SCENE_REP_BASE_CHANNELS = {
    "pointmap": 3,
    "raymap+depth": 7,  # origins 3 + directions 3 + depth 1
    "raydirs+depth+pose": 4,
    "campointmap+pose": 3,
    "pointmap+raydirs+depth+pose": 7,  # pointmap 3 + directions 3 + depth 1
}
ENCODERS = {"dinov2": DinoViT, "croco": CroCoViT, "radio": RadioViT}
TRUNKS = {"alternating": AlternatingAttentionTrunk,
          "global": GlobalAttentionTrunk, "cross": CrossAttentionTrunk}


def scene_rep_family(scene_rep_type: str) -> str:
    """The family of a scene_rep_type: its name without the +confidence and
    +mask flags."""
    return scene_rep_type.replace("+confidence", "").replace("+mask", "")


def dense_dim_for(scene_rep_type: str) -> int:
    """The dense head's output channels for a scene_rep_type."""
    return (_SCENE_REP_BASE_CHANNELS[scene_rep_family(scene_rep_type)]
            + int("+confidence" in scene_rep_type)
            + int("+mask" in scene_rep_type))

# view keys that carry geometric priors (inputs of fuse_geometric_priors)
PRIOR_VIEW_KEYS = ("ray_directions_cam", "depth_along_ray",
                   "camera_pose_quats", "camera_pose_trans")
# the six prior encoders (the reference checkpoint's names)
PRIOR_ENCODERS = ("ray_dirs_encoder", "depth_encoder", "depth_scale_encoder",
                  "cam_rot_encoder", "cam_trans_encoder",
                  "cam_trans_scale_encoder")
# the masks of draw_prior_masks with a view axis (the rest are (B, 1))
PER_VIEW_MASKS = ("keep", "depth_norm_all", "pose_norm_all", "keep_px")


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
    from .tasks import task_config
    return task_config("images_only")


def aug_training_config() -> GeometricInputConfig:
    """configs/model/task/aug_training.yaml, the stochastic training mix."""
    from .tasks import task_config
    return task_config("aug_training")


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
        """Raise for the values the port does not take (`trunk_seq_axis`,
        `scan_layers`) and for an unknown encoder, trunk or scene
        representation, or a dense width the representation does not
        have (ValueError, as the JAX package's init)."""
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
        if self.encoder_type not in ENCODERS:
            raise ValueError(f"unknown encoder_type {self.encoder_type!r}; "
                             f"options: {sorted(ENCODERS)}")
        if self.info_sharing_type not in TRUNKS:
            raise ValueError(
                f"unknown info_sharing_type {self.info_sharing_type!r}; "
                f"options: {sorted(TRUNKS)}")
        family = scene_rep_family(self.scene_rep_type)
        if family not in _SCENE_REP_BASE_CHANNELS:
            raise ValueError(
                f"unknown scene_rep_type {self.scene_rep_type!r}; families: "
                f"{sorted(_SCENE_REP_BASE_CHANNELS)} (+confidence, +mask)")
        if self.dense_output_dim != dense_dim_for(self.scene_rep_type):
            raise ValueError(
                f"dense_output_dim={self.dense_output_dim} but "
                f"{self.scene_rep_type!r} needs "
                f"{dense_dim_for(self.scene_rep_type)}")

    def has_pose_head(self) -> bool:
        """The `*pose` scene representations predict camera poses."""
        return scene_rep_family(self.scene_rep_type).endswith("pose")


@dataclasses.dataclass(frozen=True)
class MemoryPolicy:
    """The memory knobs resolved for one (batch, views, resolution)."""

    memory_efficient: bool
    cfg: MapAnythingConfig
    # postprocess_outputs(view_chunk=...) of the same call
    post_view_chunk: Optional[int]


def resolve_memory_policy(cfg: MapAnythingConfig, batch: int,
                          num_views: int, height: int, width: int,
                          hbm_gb: float = 16.0) -> MemoryPolicy:
    """Choose the chunking from the shape and the device memory, before the
    call (the JAX package's thresholds). The images count in 518^2-pixel
    units, pro-rated to a 16 GB device: up to 48 such units run unchunked;
    up to 128 chunk the dense head (16 views) and the postprocess; beyond,
    the dense head by 8 views, the MLPs by `cfg.mlp_token_chunk` rows."""
    imgs = batch * num_views * (height * width) / float(518 * 518)
    budget = imgs * 16.0 / max(hbm_gb, 1e-6)
    if budget <= 48:
        return MemoryPolicy(False, cfg, None)
    if budget <= 128:
        new = dataclasses.replace(cfg, dense_head_chunk=16,
                                  mlp_token_chunk=None)
        return MemoryPolicy(True, new, 16)
    return MemoryPolicy(True, dataclasses.replace(cfg, dense_head_chunk=8), 8)


def check_generator(geom_cfg: GeometricInputConfig,
                    generator: Optional[torch.Generator],
                    device: torch.device) -> None:
    """Raise ValueError where `geom_cfg` draws at random and `generator`
    cannot: a stochastic config or a sparse-depth share without one (JAX
    raises without an rng), or one on another device than the model."""
    if generator is None:
        if not geom_cfg.deterministic():
            raise ValueError(
                "a stochastic GeometricInputConfig needs a torch.Generator "
                "on the model's device (forward(..., generator=...)): its "
                "masks are drawn from it")
        if geom_cfg.sparse_depth_prob > 0.0:
            raise ValueError(
                "sparse_depth_prob > 0 needs a torch.Generator: the pixels "
                "it drops are drawn at random even at probability 1.0")
    elif generator.device.type != torch.device(device).type:
        raise ValueError(
            f"the generator lives on {generator.device}, the model on "
            f"{device}: make it with torch.Generator(device=...)")


def draw_prior_masks(geom_cfg: GeometricInputConfig, batch: int, views: int,
                     device, generator: Optional[torch.Generator] = None,
                     pixels: Optional[tuple] = None,
                     rows: Optional[slice] = None
                     ) -> Dict[str, torch.Tensor]:
    """The Bernoulli masks of `fuse_geometric_priors` for `views` views,
    bool, in this order of draws from `generator`:

      overall (B, 1), keep (B, V) (not dropped, 1 - dropout_prob), ray,
      depth, cam (B, 1) (the modality masks), sparse (B, 1) (the
      sparse-depth gate), depth_norm_all, pose_norm_all (B, V), and with
      `pixels` = (H, W) and sparse_depth_prob > 0, keep_px (B, V, H, W, 1)
      (a pixel kept: its uniform draw >= sparsification_removal_percent).

    A probability of 0 or 1 is a constant mask and draws nothing, so a
    deterministic config draws only the pixels. With `rows`, the masks of
    those rows of the `batch` drawn (a data-parallel rank's share). The
    JAX package draws each mask from its own split of one key and its
    sparse gate once per batch; here one generator state fixes every
    draw, whatever the view or batch sharding (ROADMAP, pinned
    divergences)."""
    cfg = geom_cfg

    def bernoulli(p: float, shape) -> torch.Tensor:
        if p in (0.0, 1.0):
            return torch.full(shape, p == 1.0, dtype=torch.bool,
                              device=device)
        return torch.rand(shape, generator=generator, device=device) < p

    b, v = batch, views
    masks = {
        "overall": bernoulli(cfg.overall_prob, (b, 1)),
        "keep": bernoulli(1.0 - cfg.dropout_prob, (b, v)),
        "ray": bernoulli(cfg.ray_dirs_prob, (b, 1)),
        "depth": bernoulli(cfg.depth_prob, (b, 1)),
        "cam": bernoulli(cfg.cam_prob, (b, 1)),
        "sparse": bernoulli(cfg.sparse_depth_prob, (b, 1)),
        "depth_norm_all": bernoulli(cfg.depth_scale_norm_all_prob, (b, v)),
        "pose_norm_all": bernoulli(cfg.pose_scale_norm_all_prob, (b, v)),
    }
    if pixels is not None and cfg.sparse_depth_prob > 0.0:
        draw = torch.rand((b, v, *pixels, 1), generator=generator,
                          device=device)
        masks["keep_px"] = draw >= cfg.sparsification_removal_percent
    if rows is not None:
        masks = {key: m[rows] for key, m in masks.items()}
    return masks


def scene_rep_outputs(scene_rep_type: str, raw: torch.Tensor,
                      metric_scale: torch.Tensor, pose: Optional[dict],
                      use_factored_global_pointmaps: bool = True
                      ) -> Dict[str, torch.Tensor]:
    """The outputs of one scene representation from the dense head's raw
    channels (B, V, H, W, C) fp32, the metric scale (B,) and, for the
    `*pose` families, pose_adaptor's {"trans", "quats"} (B, V, ...): the
    JAX package's recombination of the five families, each with or
    without confidence and mask. Metric quantities are scaled."""
    family = scene_rep_family(scene_rep_type)
    c = _SCENE_REP_BASE_CHANNELS[family]
    s = metric_scale[:, None, None, None, None]
    out = {"metric_scaling_factor": metric_scale}
    if pose is not None:
        out["cam_trans"] = pose["trans"] * metric_scale[:, None, None]
        out["cam_quats"] = pose["quats"]

    def factored(ray_dirs, depth_along_ray, pts3d=None):
        if pts3d is None:
            pts3d = (convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap(
                ray_dirs, depth_along_ray, pose["trans"], pose["quats"]))
        out.update(pts3d=pts3d * s, pts3d_cam=ray_dirs * depth_along_ray * s,
                   ray_directions=ray_dirs,
                   depth_along_ray=depth_along_ray * s)

    if family == "pointmap":  # a world-frame pointmap
        out["pts3d"] = raw[..., 0:3] * s
    elif family == "raymap+depth":  # ray origins, directions and depth
        origins, ray_dirs = raw[..., 0:3], raw[..., 3:6]
        depth_along_ray = depth_adaptor(raw[..., 6:7])
        out.update(pts3d=(origins + ray_dirs * depth_along_ray) * s,
                   ray_origins=origins * s, ray_directions=ray_dirs,
                   depth_along_ray=depth_along_ray * s)
    elif family == "raydirs+depth+pose":  # the released factored form
        factored(normalize_to_unit_sphere(raw[..., 0:3]),
                 depth_adaptor(raw[..., 3:4]))
    elif family == "campointmap+pose":  # directions and depth from points
        pts3d_cam = raw[..., 0:3]
        depth_along_ray = torch.linalg.vector_norm(pts3d_cam, dim=-1,
                                                   keepdim=True)
        factored(pts3d_cam / depth_along_ray.clamp_min(1e-8),
                 depth_along_ray)
        out["pts3d_cam"] = pts3d_cam * s
    else:  # "pointmap+raydirs+depth+pose"
        factored(normalize_to_unit_sphere(raw[..., 3:6]),
                 depth_adaptor(raw[..., 6:7]),
                 None if use_factored_global_pointmaps else raw[..., 0:3])
    if "+confidence" in scene_rep_type:
        out["conf"] = confidence_adaptor(raw[..., c:c + 1])[..., 0]
        c += 1
    if "+mask" in scene_rep_type:
        mask = mask_adaptor(raw[..., c:c + 1])
        out["non_ambiguous_mask"] = mask["mask"][..., 0] > 0.5
        out["non_ambiguous_mask_logits"] = mask["logits"][..., 0]
    return out


def scene_rep_keys(scene_rep_type: str) -> frozenset:
    """The keys of the outputs a scene_rep_type gives (those of
    :func:`scene_rep_outputs`, read from a one-pixel call on the CPU)."""
    raw = torch.zeros(1, 1, 1, 1, dense_dim_for(scene_rep_type))
    pose = None
    if scene_rep_family(scene_rep_type).endswith("pose"):
        pose = {"trans": torch.zeros(1, 1, 3),
                "quats": torch.tensor([[[0.0, 0.0, 0.0, 1.0]]])}
    return frozenset(scene_rep_outputs(scene_rep_type, raw, torch.ones(1),
                                       pose))


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
    """The multi-view metric 3D reconstruction model.

    It always holds the six geometric-prior encoders, as the reference
    checkpoint does, whether or not a call feeds priors.

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
        enc_kw = dict(size=cfg.encoder_size, patch_size=cfg.patch_size,
                      dtype=dt, device=device)
        if cfg.encoder_type == "dinov2":
            enc_kw.update(pad_tokens_to=cfg.encoder_pad_tokens_to,
                          fold_layerscale=cfg.fold_layerscale)
        elif cfg.encoder_type == "radio":
            enc_kw.update(img_size=cfg.encoder_img_size)
        if cfg.encoder_type != "croco":
            enc_kw.update(gradient_checkpointing=(
                cfg.encoder_gradient_checkpointing))
        self.encoder = ENCODERS[cfg.encoder_type](**enc_kw)
        enc_dim = self.encoder.embed_dim
        self.fusion_norm = FusedLayerNorm(enc_dim, dtype=torch.float32,
                                          device=device)
        self.scale_token = (nn.Parameter(torch.empty(enc_dim, device=device))
                            if cfg.use_scale_token else None)
        trunk_kw = dict(input_embed_dim=enc_dim, dim=cfg.trunk_dim,
                        depth=cfg.trunk_depth, num_heads=cfg.trunk_num_heads,
                        indices=tuple(cfg.trunk_indices), dtype=dt,
                        device=device)
        if cfg.info_sharing_type != "cross":
            trunk_kw.update(
                distinguish_ref_and_non_ref_views=(
                    cfg.distinguish_ref_and_non_ref_views),
                pad_tokens_to=cfg.trunk_pad_tokens_to,
                gradient_checkpointing=cfg.trunk_gradient_checkpointing)
        if cfg.info_sharing_type == "alternating":
            trunk_kw.update(use_view_pe=cfg.use_view_pe,
                            rope_freq=cfg.trunk_rope_freq)
        self.info_sharing = TRUNKS[cfg.info_sharing_type](**trunk_kw)
        self.dense_head = _DenseHead(cfg, enc_dim, device=device)
        self.pose_head = (PoseHead(
            input_feature_dim=cfg.trunk_dim,
            num_resconv_block=cfg.pose_num_resconv,
            dtype=cfg.resolved_heads_dtype(), device=device)
            if cfg.has_pose_head() else None)
        self.scale_head = (MLPHead(input_feature_dim=cfg.trunk_dim,
                                   output_dim=1, dtype=torch.float32,
                                   device=device)
                           if cfg.use_scale_token else None)
        # the prior encoders, fp32, registered last: a seeded init draws the
        # other parameters as it did before they existed
        p = cfg.patch_size
        self.ray_dirs_encoder = DenseRepEncoder(3, enc_dim, p, device=device)
        self.depth_encoder = DenseRepEncoder(1, enc_dim, p, device=device)
        self.depth_scale_encoder = GlobalRepEncoder(1, enc_dim, device=device)
        self.cam_rot_encoder = GlobalRepEncoder(4, enc_dim, device=device)
        self.cam_trans_encoder = GlobalRepEncoder(3, enc_dim, device=device)
        self.cam_trans_scale_encoder = GlobalRepEncoder(1, enc_dim,
                                                        device=device)
        if generator is not None:
            init_weights_(self, generator)

    def set_attn_impl(self, impl: str) -> None:
        """Switch every encoder and trunk attention to `impl`: "auto" |
        "flash" | "math" (ops/attention.py::sdpa)."""
        for mod in self.modules():
            if isinstance(mod, (Attention, CrossAttention)):
                mod.attn_impl = impl

    def forward(self, views: Dict[str, torch.Tensor],
                geom_cfg: GeometricInputConfig = images_only_config(),
                generator: Optional[torch.Generator] = None,
                memory_efficient: bool = False, seq_group=None,
                chunking: Optional[MapAnythingConfig] = None,
                batch_shard: Optional[tuple] = None,
                ) -> Dict[str, torch.Tensor]:
        """views: see the module docstring. Returns the released outputs,
        all (B, V, ...) but metric_scaling_factor (B,).

        Args:
            geom_cfg: which priors the call uses, with what probability.
            generator: a torch.Generator on the model's device, which the
                masks of a stochastic config and the sparse-depth pixels
                are drawn from (draw_prior_masks); ValueError when such a
                config comes without one.
            memory_efficient: chunk the MLPs and the dense head.
            seq_group: a process group: views hold this rank's V/p views in
                global order and the outputs are this rank's;
                metric_scaling_factor is the same on every rank. Every rank
                passes a generator in the same state.
            chunking: the config whose dense_head_chunk and mlp_token_chunk
                a memory-efficient call reads (MemoryPolicy.cfg); the
                model's own by default.
            batch_shard: (d, n): views hold rows [d B, (d + 1) B) of a
                batch of n B rows (a data-parallel rank's); the random
                draws are those of the whole batch, these rows kept. Every
                rank passes a generator in the same state.
        """
        cfg = self.cfg
        if seq_group is not None and cfg.info_sharing_type != "alternating":
            raise ValueError(
                "a view-sharded forward (seq_group) runs the alternating "
                f"trunk only, not {cfg.info_sharing_type!r}")
        chunks = chunking or cfg
        mlp_chunk = chunks.mlp_token_chunk if memory_efficient else None
        imgs = views["img"]
        b, v, h, w, _ = imgs.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size

        with span("model.encoder"):
            enc = self.encoder(imgs.reshape(b * v, h, w, 3), mlp_chunk)
        enc_dim = enc.shape[-1]
        with span("model.fuse"):
            fused = self.fuse_geometric_priors(
                enc.reshape(b, v, gh, gw, enc_dim).float(), views, geom_cfg,
                generator, seq_group, batch_shard)
            fused = self.fusion_norm(fused)
            if self.scale_token is not None:
                tok = self.scale_token[None, None, :].expand(b, 1, enc_dim)
            else:  # the ablations: no extra token
                tok = fused.new_zeros((b, 0, enc_dim))
            trunk_in = fused.to(cfg.dtype)
        with span("model.trunk"):
            if cfg.info_sharing_type == "alternating":
                final, intermediates, tok_out = self.info_sharing(
                    trunk_in, tok, seq_group, mlp_chunk,
                    self.view_pe_indices(b, v, generator, seq_group,
                                         batch_shard))
            else:
                final, intermediates, tok_out = self.info_sharing(
                    trunk_in, tok, mlp_chunk)

        with span("model.dense_head"):
            # hook 0 is the fused, normed encoder features
            hooks = [fused.to(cfg.dtype)] + intermediates + [final]
            hooks = [x.reshape(b * v, gh, gw, x.shape[-1]) for x in hooks]
            n, chunk = b * v, chunks.dense_head_chunk
            if memory_efficient and n > chunk:
                # the same head `chunk` views at a time; the last chunk is
                # zero-padded to `chunk` views, its pad rows sliced off
                parts = []
                for i in range(0, n, chunk):
                    part = [x[i:i + chunk] for x in hooks]
                    m = part[0].shape[0]
                    part = [F.pad(x, (0, 0, 0, 0, 0, 0, 0, chunk - m))
                            for x in part]
                    parts.append(self.dense_head(part, (h, w))[:m])
                raw_dense = torch.cat(parts)
                del parts
            else:  # (B*V, H, W, C) fp32
                raw_dense = self.dense_head(hooks, (h, w))
            raw = raw_dense.reshape(b, v, h, w, cfg.dense_output_dim)
        with span("model.pose_scale"):
            if self.scale_head is not None:
                raw_scale = self.scale_head(tok_out[:, 0, :].float())  # (B, 1)
                metric_scale = scale_adaptor(raw_scale)[:, 0]  # (B,)
            else:
                metric_scale = torch.ones((b,), device=raw.device)
            pose = None
            if self.pose_head is not None:
                pose = pose_adaptor(self.pose_head(hooks[-1]).reshape(b, v, 7))
            return scene_rep_outputs(cfg.scene_rep_type, raw, metric_scale,
                                     pose, cfg.use_factored_global_pointmaps)

    def view_pe_indices(self, b: int, v: int,
                        generator: Optional[torch.Generator],
                        seq_group=None, batch_shard: Optional[tuple] = None
                        ) -> Optional[torch.Tensor]:
        """The view-PE rows of a call: None (the view indices) without a
        generator or without view PE; with one, (B, V) rows drawn uniformly
        from [1, max_views_for_pe) for every view but the global view 0,
        whose row is 0. A view-sharded call draws all the views' rows and
        keeps its own, so p ranks draw what one does; a data-parallel call
        (batch_shard) its rows of the whole batch's."""
        trunk = self.info_sharing
        if generator is None or getattr(trunk, "view_pe", None) is None:
            return None
        ranks, rank = ((1, 0) if seq_group is None else
                       (dist.get_world_size(seq_group),
                        dist.get_rank(seq_group)))
        d, n = (0, 1) if batch_shard is None else batch_shard
        idx = torch.randint(1, trunk.max_views_for_pe, (b * n, v * ranks),
                            generator=generator, device=generator.device)
        idx[:, 0] = 0
        return idx[d * b:(d + 1) * b, rank * v:(rank + 1) * v].to(
            trunk.view_pe.device)

    def fuse_geometric_priors(self, fused: torch.Tensor,
                              views: Dict[str, torch.Tensor],
                              geom_cfg: GeometricInputConfig,
                              generator: Optional[torch.Generator] = None,
                              seq_group=None,
                              batch_shard: Optional[tuple] = None
                              ) -> torch.Tensor:
        """The encoder features (B, V, gh, gw, C) fp32 plus each prior's
        encoding where its mask holds, in fp32 (the JAX package's
        _fuse_geometric_priors).

        A prior's key being absent, or its mask being constant 0 under
        `geom_cfg`, folds its branch away; otherwise its encoding is
        multiplied by its mask: the per-sample modality mask, the view not
        dropped, and its `*_valid` key (draw_prior_masks). Depth enters as
        log-normalised depth (sparsified where the gate holds) and, for
        metric samples not normalised away, its log scale; poses relative
        to view 0, the translations normalised by their mean norm and, for
        metric samples, that norm's log.

        With `seq_group`, views holds this rank's V/p views: view 0's pose
        comes from rank 0, the norm's sum and count are reduced over the
        ranks (differentiably), and the masks are drawn for all the views
        and sliced. With `batch_shard` (d, n), for all the batch's rows and
        sliced.
        """
        check_generator(geom_cfg, generator, fused.device)
        if not any(key in views for key in PRIOR_VIEW_KEYS):
            return fused  # images only: every branch folds away
        b, v = fused.shape[:2]
        h, w = views["img"].shape[2:4]
        dev = fused.device
        ranks, rank = ((1, 0) if seq_group is None else
                       (dist.get_world_size(seq_group),
                        dist.get_rank(seq_group)))
        d, n = (0, 1) if batch_shard is None else batch_shard
        masks = draw_prior_masks(
            geom_cfg, b * n, v * ranks, dev, generator,
            (h, w) if "depth_along_ray" in views else None,
            rows=slice(d * b, (d + 1) * b))
        masks = {key: m[:, rank * v:(rank + 1) * v] if key in PER_VIEW_MASKS
                 else m for key, m in masks.items()}

        def encode(encoder, x):  # (B, V, ...) -> (B, V, ...) per view
            out = encoder(x.reshape((b * v,) + x.shape[2:]))
            return out.reshape((b, v) + out.shape[1:])

        cfg = geom_cfg
        # a branch whose mask is 0 under every draw folds away
        on = cfg.overall_prob > 0.0 and cfg.dropout_prob < 1.0
        per_sample = masks["keep"] & masks["overall"]

        def mask_of(name, valid):
            mask = masks[name] & per_sample
            return mask & views[valid] if valid in views else mask

        is_metric = views.get("is_metric_scale")
        if is_metric is None:
            is_metric = torch.zeros((b, v), dtype=torch.bool, device=dev)

        if "ray_directions_cam" in views and on and cfg.ray_dirs_prob > 0.0:
            m = mask_of("ray", "ray_dirs_valid")[..., None, None, None]
            rays = views["ray_directions_cam"].float() * m
            fused = fused + encode(self.ray_dirs_encoder, rays) * m

        if "depth_along_ray" in views and on and cfg.depth_prob > 0.0:
            mask = mask_of("depth", "depth_valid")
            depth = views["depth_along_ray"].float() * mask[..., None, None,
                                                            None]
            if cfg.sparse_depth_prob > 0.0:
                gate = masks["sparse"][:, :, None, None, None]
                depth = torch.where(gate, depth * masks["keep_px"], depth)
            scaled, depth_norm = normalize_depth_using_non_zero_pixels(
                depth, return_norm_factor=True)  # (B, V, H, W, 1), (B, V)
            fused = fused + (encode(self.depth_encoder,
                                    apply_log_to_norm(scaled))
                             * mask[..., None, None, None])
            # the scale only for metric samples, unless normalised away
            metric = mask & is_metric & ~masks["depth_norm_all"]
            scale = encode(self.depth_scale_encoder,
                           torch.log(depth_norm + 1e-8)[..., None])
            fused = fused + (scale * metric[..., None])[:, :, None, None, :]

        if ("camera_pose_quats" in views and "camera_pose_trans" in views
                and on and cfg.cam_prob > 0.0):
            mask = mask_of("cam", "pose_valid")[..., None]
            quats = views["camera_pose_quats"].float()
            trans = views["camera_pose_trans"].float()
            q0, t0 = quats[:, :1], trans[:, :1]
            if seq_group is not None:  # global view 0 is rank 0's first
                q0 = all_gather(q0, seq_group)[0]
                t0 = all_gather(t0, seq_group)[0]
            rel_q, rel_t = transform_pose_using_quats_and_trans_2_to_1(
                q0.expand_as(quats), t0.expand_as(trans), quats, trans)
            rel_q = torch.where(mask, rel_q, unit_w(rel_q))
            rel_t = torch.where(mask, rel_t, 0.0)
            if seq_group is None:
                scaled_t, t_norm = normalize_pose_translations(
                    rel_t, return_norm_factor=True)  # (B, V, 3), (B,)
            else:  # the mean norm of the non-zero translations of all views
                dis = safe_norm(rel_t)  # (B, V_local)
                num = all_reduce(dis.sum(-1), seq_group)
                den = (dis > 0).sum(-1).to(num.dtype)
                dist.all_reduce(den, group=seq_group)
                t_norm = (num / (den + 1e-8)).clamp_min(1e-8)
                scaled_t = rel_t / t_norm[:, None, None]
            metric = is_metric & ~masks["pose_norm_all"]
            log_t = torch.log(t_norm + 1e-8)[:, None, None].expand(b, v, 1)
            pose_feat = (encode(self.cam_rot_encoder, rel_q) * mask
                         + encode(self.cam_trans_encoder, scaled_t) * mask
                         + encode(self.cam_trans_scale_encoder, log_t) * mask
                         * metric[..., None])
            fused = fused + pose_feat[:, :, None, None, :]
        return fused
