"""User-facing inference: validation, preprocessing, postprocessing and
`InferencePipeline.infer`; counterpart of mapanything_tpu/utils/inference.py
for images-only input.

The user API is a list of per-view dicts; `stack_views` turns it into the
batched (B, V, ...) tensors the model takes, on the model's device, and
`unstack_views` turns the outputs back into one dict per view. With a
process group the forward runs view-sharded
(parallel/inference.py::view_sharded_forward) and the postprocess runs on
the gathered outputs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import geometry as G
from ..data.image import IMAGE_NORMALIZATION_DICT
from ..models.mapanything import MapAnything
from ..ops.quantile import quantile_threshold
from ..parallel.inference import view_sharded_forward

ALLOWED_VIEW_KEYS = {
    "img", "data_norm_type", "depth_z", "ray_directions", "intrinsics",
    "camera_poses", "is_metric_scale", "true_shape", "idx", "instance",
}
REQUIRED_KEYS = {"img", "data_norm_type"}
CONFLICTING_KEYS = [("intrinsics", "ray_directions")]

# user-facing prior inputs -> the flag of `infer` that ignores each
_PRIOR_KEYS = {
    "intrinsics": "ignore_calibration_inputs",
    "ray_directions": "ignore_calibration_inputs",
    "depth_z": "ignore_depth_inputs",
    "camera_poses": "ignore_pose_inputs",
}
_PRIORS_ITEM = "ROADMAP queue A item 8 (multimodal priors)"


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


def preprocess_input_views_for_inference(
    views: List[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Canonicalise the inputs: default is_metric_scale=True per sample.

    Geometric priors (intrinsics, ray_directions, depth_z, camera_poses) are
    not ported yet and raise NotImplementedError."""
    processed = []
    for i, view in enumerate(views):
        present = sorted(k for k in _PRIOR_KEYS if k in view)
        if present:
            raise NotImplementedError(
                f"view {i}: geometric priors {present} are not ported yet: "
                f"{_PRIORS_ITEM}")
        out = dict(view)
        bsz = np.shape(view["img"])[0]
        ims = out.get("is_metric_scale", True)
        if isinstance(ims, bool):
            ims = np.full((bsz,), ims)
        out["is_metric_scale"] = np.asarray(ims, dtype=bool).reshape(bsz)
        processed.append(out)
    return processed


def stack_views(views: List[Dict[str, Any]],
                device=None) -> Dict[str, torch.Tensor]:
    """Per-view dicts (each (B, ...)) -> batched (B, V, ...) tensors on
    `device`. Images may be NHWC or NCHW; they leave NHWC float32."""
    imgs = torch.stack([torch.as_tensor(np.asarray(v["img"]),
                                        dtype=torch.float32) for v in views],
                       dim=1)
    if imgs.shape[-1] != 3:  # NCHW input
        imgs = imgs.movedim(-3, -1)
    batched = {"img": imgs.to(device)}
    if any("is_metric_scale" in v for v in views):
        b = imgs.shape[0]
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
) -> Dict[str, torch.Tensor]:
    """Derived fields and the combined mask, on the device of `preds`:
    de-normalised images, depth_z, intrinsics recovered from the rays,
    camera pose matrices, the confidence-percentile and edge masks."""
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
        if mask_edges and "pts3d" in out:
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


class InferencePipeline:
    """Runs `MapAnything` behind the reference's `.infer()` API.

    Args:
        model: the model; the pipeline follows its device.
        view_shard_group: optional torch.distributed process group: every
            forward then runs view-sharded over its ranks (sequence-parallel
            ring attention), and every rank returns all views. The view
            count must be a multiple of the group size.
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
        """Reference-compatible entry point, images-only.

        Prior inputs whose `ignore_*` flag is set are dropped (the model
        then sees exactly what the JAX package feeds it with those priors
        masked out); any other prior, a task preset other than
        "images_only", and memory_efficient_inference=True raise
        NotImplementedError. "auto" runs the unchunked program.
        """
        if task not in (None, "images_only"):
            raise NotImplementedError(
                f"task preset {task!r} uses geometric priors: {_PRIORS_ITEM}")
        if memory_efficient_inference is True:
            raise NotImplementedError(
                "memory_efficient_inference=True: ROADMAP queue A item 7 "
                "(many-view memory path)")
        views = validate_input_views_for_inference(views)
        flags = dict(ignore_calibration_inputs=ignore_calibration_inputs,
                     ignore_depth_inputs=ignore_depth_inputs,
                     ignore_pose_inputs=ignore_pose_inputs)
        views = [{k: x for k, x in v.items()
                  if not flags.get(_PRIOR_KEYS.get(k), False)}
                 for v in views]
        views = preprocess_input_views_for_inference(views)
        device = next(self.model.parameters()).device
        batched = stack_views(views, device)
        if self.view_shard_group is None:
            preds = self.model(batched)
        else:
            preds = view_sharded_forward(self.model, batched,
                                         self.view_shard_group)
        out = postprocess_outputs(
            preds, batched["img"], data_norm_type=data_norm_type,
            apply_mask=apply_mask, mask_edges=mask_edges,
            edge_normal_threshold=edge_normal_threshold,
            edge_depth_threshold=edge_depth_threshold,
            apply_confidence_mask=apply_confidence_mask,
            confidence_percentile=confidence_percentile)
        return unstack_views(out, len(views))
