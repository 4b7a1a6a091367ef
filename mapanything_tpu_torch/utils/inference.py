"""User-facing inference: validation, preprocessing, postprocessing and
`InferencePipeline.infer`; counterpart of mapanything_tpu/utils/inference.py.

The user API is a list of per-view dicts; `preprocess_input_views_for_inference`
turns the geometric priors into the model's inputs (intrinsics into unit
rays, z-depth into depth along the ray, 4x4 poses into quaternion and
translation), `stack_views` batches them into (B, V, ...) tensors on the
model's device, zero-filled with a validity mask where a view lacks a prior,
and `unstack_views` turns the outputs back into one dict per view. The
memory policy (models/mapanything.py::resolve_memory_policy) is decided from
the shapes and the device's memory before the call; nothing retries a call
that ran out of memory. With a process group the forward runs view-sharded
(parallel/inference.py::view_sharded_forward), images only, and the
postprocess runs on the gathered outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import geometry as G
from ..data.image import IMAGE_NORMALIZATION_DICT
from ..models.mapanything import (
    GeometricInputConfig,
    MapAnything,
    resolve_memory_policy,
)
from ..models.tasks import task_config
from ..ops.quantile import quantile_threshold
from ..parallel.inference import view_sharded_forward
from ..perf.timing import span

ALLOWED_VIEW_KEYS = {
    "img", "data_norm_type", "depth_z", "ray_directions", "intrinsics",
    "camera_poses", "is_metric_scale", "true_shape", "idx", "instance",
}
REQUIRED_KEYS = {"img", "data_norm_type"}
CONFLICTING_KEYS = [("intrinsics", "ray_directions")]


def validate_input_views_for_inference(
    views: List[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Strict input validation (the JAX package's rules)."""
    if not isinstance(views, list) or len(views) == 0:
        raise ValueError("views must be a non-empty list of dicts")
    any_pose = any("camera_poses" in v for v in views)
    for i, view in enumerate(views):
        if not isinstance(view, dict):
            raise ValueError(f"view {i} must be a dict")
        unknown = set(view.keys()) - ALLOWED_VIEW_KEYS
        if unknown:
            raise ValueError(
                f"view {i}: unknown keys {sorted(unknown)}; "
                f"allowed: {sorted(ALLOWED_VIEW_KEYS)}")
        missing = REQUIRED_KEYS - set(view.keys())
        if missing:
            raise ValueError(f"view {i}: missing required keys {sorted(missing)}")
        for a, b in CONFLICTING_KEYS:
            if a in view and b in view:
                raise ValueError(f"view {i}: cannot provide both '{a}' and '{b}'")
        if "depth_z" in view and not ("intrinsics" in view
                                      or "ray_directions" in view):
            raise ValueError(
                f"view {i}: depth_z requires intrinsics or ray_directions")
    if any_pose and "camera_poses" not in views[0]:
        raise ValueError(
            "if any view has camera_poses, view 0 must also have camera_poses")
    return views


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def preprocess_input_views_for_inference(
    views: List[Dict[str, Any]], device=None,
) -> List[Dict[str, Any]]:
    """Canonicalise the optional inputs, each as fp32 on `device` (where
    the input lies when None): intrinsics -> unit rays, ray_directions
    normalised, depth_z -> depth_along_ray, camera_poses ((quats, trans)
    or (B, 4, 4)) -> camera_pose_quats + camera_pose_trans, rays renamed
    ray_directions_cam; is_metric_scale defaults to True per sample."""
    processed = []
    for i, view in enumerate(views):
        out = dict(view)
        shape = np.shape(view["img"])
        bsz = shape[0]
        if shape[1] == 3 and shape[-1] != 3:  # NCHW
            h, w = shape[-2], shape[-1]
        else:  # NHWC
            h, w = shape[-3], shape[-2]

        if "intrinsics" in view:
            _, out["ray_directions"] = G.get_rays_in_camera_frame(
                _f32(view["intrinsics"], device), h, w,
                normalize_to_unit_sphere=True)
            del out["intrinsics"]
        elif "ray_directions" in view:
            rays = _f32(view["ray_directions"], device)
            out["ray_directions"] = rays / (
                torch.linalg.vector_norm(rays, dim=-1, keepdim=True) + 1e-8)

        if "depth_z" in view:
            out["depth_along_ray"] = G.depth_along_ray_from_z_depth_and_rays(
                _f32(view["depth_z"], device), out["ray_directions"])
            del out["depth_z"]

        if "camera_poses" in view:
            poses = view["camera_poses"]
            if isinstance(poses, tuple) and len(poses) == 2:
                quats, trans = (_f32(p, device) for p in poses)
            else:
                poses = _f32(poses, device)
                if poses.shape[-2:] != (4, 4):
                    raise ValueError(f"view {i}: camera_poses must be "
                                     f"(quats, trans) or (B, 4, 4)")
                quats = G.rotation_matrix_to_quaternion(poses[:, :3, :3])
                trans = poses[:, :3, 3]
            out["camera_pose_quats"] = quats
            out["camera_pose_trans"] = trans
            del out["camera_poses"]

        ims = out.get("is_metric_scale", True)
        if isinstance(ims, bool):
            ims = np.full((bsz,), ims)
        out["is_metric_scale"] = np.asarray(ims, dtype=bool).reshape(bsz)
        if "ray_directions" in out:
            out["ray_directions_cam"] = out.pop("ray_directions")
        processed.append(out)
    return processed


def stack_views(views: List[Dict[str, Any]],
                device=None) -> Dict[str, torch.Tensor]:
    """Per-view dicts (each (B, ...)) -> batched (B, V, ...) tensors on
    `device`. Images may be NHWC or NCHW; they leave NHWC float32. A prior
    that some views lack is zero-filled there, with a False entry in its
    validity mask (ray_dirs_valid, depth_valid, pose_valid), and an
    identity quaternion where the pose is absent."""
    imgs = torch.stack([torch.as_tensor(np.asarray(v["img"]),
                                        dtype=torch.float32) for v in views],
                       dim=1)
    if imgs.shape[-1] != 3:  # NCHW input
        imgs = imgs.movedim(-3, -1)
    batched = {"img": imgs.to(device)}
    b, _, h, w, _ = imgs.shape

    def gather(key, shape, mask_key):
        if not any(key in v for v in views):
            return
        vals = [_f32(v[key], device) if key in v
                else torch.zeros((b,) + shape, device=device) for v in views]
        batched[key] = torch.stack(vals, dim=1)
        batched[mask_key] = torch.stack([
            torch.full((b,), key in v, dtype=torch.bool, device=device)
            for v in views], dim=1)

    gather("ray_directions_cam", (h, w, 3), "ray_dirs_valid")
    gather("depth_along_ray", (h, w, 1), "depth_valid")
    gather("camera_pose_quats", (4,), "pose_valid")
    if "camera_pose_quats" in batched:
        batched["camera_pose_trans"] = torch.stack([
            _f32(v["camera_pose_trans"], device) if "camera_pose_trans" in v
            else torch.zeros((b, 3), device=device) for v in views], dim=1)
        identity = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
        batched["camera_pose_quats"] = torch.where(
            batched["pose_valid"][..., None], batched["camera_pose_quats"],
            identity)
    if any("is_metric_scale" in v for v in views):
        batched["is_metric_scale"] = torch.stack([
            torch.as_tensor(np.asarray(v.get("is_metric_scale",
                                             np.ones((b,), bool)),
                                       dtype=bool).reshape(b))
            for v in views], dim=1).to(device)
    return batched


def unstack_views(batched: Dict[str, torch.Tensor],
                  num_views: int) -> List[Dict[str, torch.Tensor]]:
    """Batched (B, V, ...) outputs -> one dict per view."""
    return [
        {k: t[:, i] if t.dim() > 1 and t.shape[1] == num_views else t
         for k, t in batched.items()}
        for i in range(num_views)
    ]


def _largest_divisor_leq(n: int, target: int) -> int:
    for c in range(min(n, target), 0, -1):
        if n % c == 0:
            return c
    return 1


def postprocess_outputs(
    preds: Dict[str, torch.Tensor],
    imgs: torch.Tensor,
    data_norm_type: str = "dinov2",
    apply_mask: bool = True,
    mask_edges: bool = True,
    edge_normal_threshold: float = 5.0,
    edge_depth_threshold: float = 0.03,
    apply_confidence_mask: bool = False,
    confidence_percentile: float = 10.0,
    view_chunk: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Derived fields and the combined mask, on the device of `preds`:
    de-normalised images, depth_z, intrinsics recovered from the rays,
    camera pose matrices, the confidence-percentile and edge masks. Each
    is made where the scene representation gives its inputs: no pose
    matrices without cam_quats/cam_trans (the pose-less families), no
    depth_z and no edge mask without pts3d_cam (the pointmap and
    raymap+depth families, whose depth_z the JAX package's edge step
    reads and fails on); other keys, ray_origins among them, pass
    through.

    Every step is per view (the confidence quantile too), so `view_chunk`
    runs the views in chunks of the largest divisor of V not above it,
    bounding the fp32 intermediates to chunk width; each view's result is
    the same as without it."""
    kw = dict(data_norm_type=data_norm_type, apply_mask=apply_mask,
              mask_edges=mask_edges,
              edge_normal_threshold=edge_normal_threshold,
              edge_depth_threshold=edge_depth_threshold,
              apply_confidence_mask=apply_confidence_mask,
              confidence_percentile=confidence_percentile)
    b, v = imgs.shape[:2]
    c = v if view_chunk is None else _largest_divisor_leq(v, view_chunk)
    if c < v:
        per_view = [key for key, t in preds.items()
                    if t.dim() >= 2 and t.shape[:2] == (b, v)]
        out = {key: t for key, t in preds.items() if key not in per_view}
        for i in range(0, v, c):
            part = postprocess_outputs(
                {key: preds[key][:, i:i + c] for key in per_view},
                imgs[:, i:i + c], **kw)
            for key, t in part.items():
                if key not in out:
                    out[key] = t.new_empty((b, v) + t.shape[2:])
                out[key][:, i:i + c] = t
        return out

    out = dict(preds)
    mean, std = IMAGE_NORMALIZATION_DICT[data_norm_type]
    out["img_no_norm"] = (imgs * torch.as_tensor(std, dtype=imgs.dtype,
                                                 device=imgs.device)
                          + torch.as_tensor(mean, dtype=imgs.dtype,
                                            device=imgs.device))
    if "pts3d_cam" in out:
        out["depth_z"] = out["pts3d_cam"][..., 2:3]
    if "ray_directions" in out:
        out["intrinsics"] = G.recover_pinhole_intrinsics_from_ray_directions(
            out["ray_directions"])
    if "cam_trans" in out and "cam_quats" in out:
        out["camera_poses"] = G.pose_quats_trans_to_matrix(
            out["cam_quats"], out["cam_trans"])

    if apply_mask and "non_ambiguous_mask" in out:
        final_mask = out["non_ambiguous_mask"]  # (B, V, H, W) bool
        if apply_confidence_mask and "conf" in out:
            conf = out["conf"]
            thresh = quantile_threshold(conf.flatten(2),
                                        confidence_percentile / 100.0)
            final_mask = final_mask & (conf > thresh[..., None, None])
        if mask_edges and "depth_z" in out:  # a family with pts3d_cam
            normal_edges = G.points_normal_edges(
                out["pts3d"], tol=edge_normal_threshold, mask=final_mask)
            depth_edges = G.depth_edge(
                out["depth_z"][..., 0], rtol=edge_depth_threshold,
                mask=final_mask)
            final_mask = final_mask & ~(depth_edges & normal_edges)
        m = final_mask[..., None].to(out["pts3d"].dtype)
        for key in ("pts3d", "pts3d_cam", "depth_along_ray", "depth_z"):
            if key in out:
                out[key] = out[key] * m
        out["mask"] = final_mask[..., None]
    return out


def geometric_input_config(
    batched: Dict[str, torch.Tensor], task: Optional[str] = None,
    ignore_calibration_inputs: bool = False,
    ignore_depth_inputs: bool = False, ignore_pose_inputs: bool = False,
    ignore_depth_scale_inputs: bool = False,
    ignore_pose_scale_inputs: bool = False,
) -> GeometricInputConfig:
    """The geometric config of an `infer` call on `batched`: each prior
    present and not ignored at probability 1; with `task`, the preset
    intersected with the priors present (a stochastic preset raises
    ValueError)."""
    has_ray = ("ray_directions_cam" in batched
               and not ignore_calibration_inputs)
    has_depth = "depth_along_ray" in batched and not ignore_depth_inputs
    has_pose = "camera_pose_quats" in batched and not ignore_pose_inputs
    if task is not None:
        preset = task_config(task)
        geom_cfg = dataclasses.replace(
            preset,
            ray_dirs_prob=preset.ray_dirs_prob if has_ray else 0.0,
            depth_prob=preset.depth_prob if has_depth else 0.0,
            cam_prob=preset.cam_prob if has_pose else 0.0,
            sparse_depth_prob=(preset.sparse_depth_prob if has_depth
                               else 0.0))
        if not geom_cfg.deterministic():
            raise ValueError(
                f"task preset {task!r} is a stochastic training mix; "
                "inference needs probabilities in {0, 1}")
        return geom_cfg
    any_prior = has_ray or has_depth or has_pose
    return GeometricInputConfig(
        overall_prob=1.0 if any_prior else 0.0,
        dropout_prob=0.0 if any_prior else 1.0,
        ray_dirs_prob=1.0 if has_ray else 0.0,
        depth_prob=1.0 if has_depth else 0.0,
        cam_prob=1.0 if has_pose else 0.0,
        sparse_depth_prob=0.0,
        depth_scale_norm_all_prob=1.0 if ignore_depth_scale_inputs else 0.0,
        pose_scale_norm_all_prob=1.0 if ignore_pose_scale_inputs else 0.0)


def _device_memory_gb(device: torch.device) -> float:
    """The memory `resolve_memory_policy` plans for: the card's total
    memory in GiB; 16.0 (the JAX package's default) on the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 2**30
    return 16.0


class InferencePipeline:
    """Runs `MapAnything` behind the reference's `.infer()` API.

    Args:
        model: the model; the pipeline follows its device.
        view_shard_group: optional torch.distributed process group: every
            forward then runs view-sharded over its ranks (sequence-parallel
            ring attention, the priors sharded with their views), and every
            rank returns all views. The view count must be a multiple of
            the group size.
    """

    def __init__(self, model: MapAnything, view_shard_group=None):
        self.model = model
        self.view_shard_group = view_shard_group

    @torch.inference_mode()
    def infer(
        self,
        views: List[Dict[str, Any]],
        memory_efficient_inference: "bool | str" = "auto",
        apply_mask: bool = True,
        mask_edges: bool = True,
        edge_normal_threshold: float = 5.0,
        edge_depth_threshold: float = 0.03,
        apply_confidence_mask: bool = False,
        confidence_percentile: float = 10.0,
        ignore_calibration_inputs: bool = False,
        ignore_depth_inputs: bool = False,
        ignore_pose_inputs: bool = False,
        ignore_depth_scale_inputs: bool = False,
        ignore_pose_scale_inputs: bool = False,
        data_norm_type: str = "dinov2",
        task: Optional[str] = None,
    ) -> List[Dict[str, torch.Tensor]]:
        """Reference-compatible entry point.

        The geometric config follows the priors present and the `ignore_*`
        flags, or the `task` preset intersected with the priors present; a
        stochastic preset raises ValueError. The sparse presets draw their
        pixels from a torch.Generator seeded 0 on the model's device.
        `memory_efficient_inference`: "auto" resolves the memory policy
        for this shape and the device's memory; True chunks the model and
        the postprocess (8 views); False runs unchunked.
        """
        with span("infer.prepare"):
            views = validate_input_views_for_inference(views)
            device = next(self.model.parameters()).device
            views = preprocess_input_views_for_inference(views, device)
            batched = stack_views(views, device)

            geom_cfg = geometric_input_config(
                batched, task,
                ignore_calibration_inputs=ignore_calibration_inputs,
                ignore_depth_inputs=ignore_depth_inputs,
                ignore_pose_inputs=ignore_pose_inputs,
                ignore_depth_scale_inputs=ignore_depth_scale_inputs,
                ignore_pose_scale_inputs=ignore_pose_scale_inputs)

            bsz, nv, ih, iw = batched["img"].shape[:4]
            if memory_efficient_inference == "auto":
                pol = resolve_memory_policy(self.model.cfg, bsz, nv, ih, iw,
                                            hbm_gb=_device_memory_gb(device))
                mem_eff, post_chunk = (pol.memory_efficient,
                                       pol.post_view_chunk)
                chunking = pol.cfg
            else:
                mem_eff = bool(memory_efficient_inference)
                post_chunk = 8 if mem_eff else None
                chunking = None

            generator = (torch.Generator(device=device).manual_seed(0)
                         if geom_cfg.sparse_depth_prob > 0.0 else None)
        with span("infer.forward"):
            if self.view_shard_group is None:
                preds = self.model(batched, geom_cfg, generator, mem_eff,
                                   chunking=chunking)
            else:
                preds = view_sharded_forward(
                    self.model, batched, self.view_shard_group, geom_cfg,
                    generator, memory_efficient=mem_eff, chunking=chunking)
        with span("infer.postprocess"):
            out = postprocess_outputs(
                preds, batched["img"], data_norm_type=data_norm_type,
                apply_mask=apply_mask, mask_edges=mask_edges,
                edge_normal_threshold=edge_normal_threshold,
                edge_depth_threshold=edge_depth_threshold,
                apply_confidence_mask=apply_confidence_mask,
                confidence_percentile=confidence_percentile,
                view_chunk=post_chunk)
            return unstack_views(out, nv)
