"""The adapter seam; the on-device half of mapanything_tpu/models/adapters.py
(the reference's section 2.9 wrapper contract).

Every model the benchmarks evaluate is called as

    model(views, geom_cfg=..., memory_efficient=...) -> preds

with `views` the stacked (B, V, ...) views on the model's device and
`preds` carrying the factored keys of FACTORED_PRED_KEYS. MapAnything
speaks it already; an adapter makes another model speak it, so a new model
needs no change to benchmarks/dense_n_view.py (tests/test_torch_dust3r.py
runs ModularDUSt3R through it).

The JAX package's host-side adapters of foreign models (VGGT, Pi3, MoGe,
the DUSt3R/MASt3R/MUSt3R/Pow3R pipelines, AnyCalib) wrap code that is not
in the repository and are not ported yet: ROADMAP queue A item 9.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..geometry import (
    rigid_points_registration,
    rotation_matrix_to_quaternion,
    safe_norm,
)

FACTORED_PRED_KEYS = (
    "pts3d",
    "pts3d_cam",
    "ray_directions",
    "depth_along_ray",
    "cam_quats",
    "cam_trans",
    "metric_scaling_factor",
    "conf",
    "non_ambiguous_mask",
    "non_ambiguous_mask_logits",
)


def _rays_depth_from_cam_points(pts_cam: torch.Tensor):
    """(..., H, W, 3) camera-frame points -> unit rays and depth along the
    ray (..., H, W, 1)."""
    depth = safe_norm(pts_cam, keepdim=True)
    return pts_cam / depth.clamp_min(1e-8), depth


class ModularDUSt3RAdapter(nn.Module):
    """ModularDUSt3R -> the factored contract, as the reference's
    DUSt3R-lineage wrappers derive it
    (models/external/dust3r/__init__.py:182-218):

      * view 1: its pointmap is its camera-frame pointmap (identity pose);
      * view 2: the swapped pair gives view 2's own camera-frame pointmap;
        its pose is the confidence-weighted rigid registration of that
        pointmap onto view 2's pointmap in view 1's frame, on the device;
      * rays and depth along the ray from the camera-frame pointmaps;
      * metric_scaling_factor 1 (DUSt3R's geometry has no metric scale).

    `model` is a ModularDUSt3R, or anything called as
    model({"img": (B, 2, H, W, 3)}) -> {"pts3d", "conf"}.
    """

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, views: Dict[str, torch.Tensor], geom_cfg=None,
                memory_efficient: bool = False) -> Dict[str, torch.Tensor]:
        del geom_cfg, memory_efficient  # an images-only, 2-view model
        imgs = views["img"]
        b, v, h, w, _ = imgs.shape
        if v != 2:
            raise ValueError(
                f"ModularDUSt3RAdapter adapts the 2-view model, got {v} views")
        fwd = self.model({"img": imgs})
        swapped = self.model({"img": imgs.flip(1)})

        pts_v1 = fwd["pts3d"]  # (B, 2, H, W, 3), both in view 1's frame
        conf = fwd["conf"]  # (B, 2, H, W)
        pts2_cam = swapped["pts3d"][:, 0]  # view 2 in its own frame
        # cam2world of view 2 (world = view 1's frame): the transform that
        # takes view 2's own pointmap onto its prediction in view 1's frame
        weights = (conf[:, 1] * swapped["conf"][:, 0]).reshape(b, h * w)
        r, t = rigid_points_registration(
            pts2_cam.reshape(b, h * w, 3), pts_v1[:, 1].reshape(b, h * w, 3),
            weights=weights)

        dt, dev = pts_v1.dtype, pts_v1.device
        identity_q = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dt,
                                  device=dev).expand(b, 4)
        pts_cam = torch.stack([pts_v1[:, 0], pts2_cam], dim=1)
        rays, depth = _rays_depth_from_cam_points(pts_cam)
        return {
            "pts3d": pts_v1,
            "pts3d_cam": pts_cam,
            "ray_directions": rays,
            "depth_along_ray": depth,
            "cam_quats": torch.stack(
                [identity_q, rotation_matrix_to_quaternion(r)], dim=1),
            "cam_trans": torch.stack(
                [torch.zeros((b, 3), dtype=dt, device=dev), t], dim=1),
            "metric_scaling_factor": torch.ones((b,), dtype=torch.float32,
                                                device=dev),
            "conf": conf,
            "non_ambiguous_mask": torch.ones((b, v, h, w), dtype=torch.bool,
                                             device=dev),
            "non_ambiguous_mask_logits": torch.full((b, v, h, w), 10.0,
                                                    device=dev),
        }


class MapAnythingAdapter(nn.Module):
    """MapAnything speaks the contract already; this wrapper lets tooling
    treat every model alike, and maps geom_cfg=None to the model's
    default."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, views, geom_cfg=None, memory_efficient: bool = False):
        kw = {} if geom_cfg is None else {"geom_cfg": geom_cfg}
        return self.model(views, memory_efficient=memory_efficient, **kw)


__all__ = [
    "FACTORED_PRED_KEYS",
    "MapAnythingAdapter",
    "ModularDUSt3RAdapter",
]
