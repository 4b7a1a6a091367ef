"""Robust-MVD (RMVD) multi-view depth benchmark adaptor; counterpart of
mapanything_tpu/benchmarks/rmvd.py (the reference's
benchmarking/rmvd_mvs_benchmark/adaptors.py:17, RMVD_MAPA_Wrapper).

  * `RMVDAdaptor` has the RMVD wrapper's surface: `input_adapter` (numpy
    views -> the model's views on its device), `__call__` and
    `output_adapter` (-> {"depth", "depth_uncertainty"} numpy), so the
    `rmvd` package's evaluation can drive it where that package is
    installed (benchmark_rmvd.py);
  * `evaluate_mvs_depth` is the RMVD depth metrics without the package
    (abs-rel and inlier ratio at 1.03, least-squares scale alignment for
    scale-ambiguous models), so the adaptor runs end to end anywhere.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.image import IMAGE_NORMALIZATION_DICT
from ..geometry import get_rays_in_camera_frame, rotation_matrix_to_quaternion
from ..models import GeometricInputConfig, images_only_config
from .dense_n_view import model_device

# the reference's geometric-input overrides per conditioning
# (adaptors.py:47-60)
CONDITIONING = {
    "image": images_only_config(),
    "image+intrinsics": GeometricInputConfig(
        overall_prob=1.0, dropout_prob=0.0, ray_dirs_prob=1.0,
        depth_prob=0.0, cam_prob=0.0),
    "image+intrinsics+pose": GeometricInputConfig(
        overall_prob=1.0, dropout_prob=0.0, ray_dirs_prob=1.0,
        depth_prob=0.0, cam_prob=1.0),
}


class RMVDAdaptor:
    """A factored-contract model (MapAnything or a models/adapters.py
    adapter) behind the RMVD evaluation interface.

    inference_conditioning: "image" | "image+intrinsics" |
        "image+intrinsics+pose" (CONDITIONING).
    The views go to the model's device (dense_n_view.model_device).
    """

    def __init__(self, model, data_norm_type: str = "dinov2",
                 inference_conditioning: str = "image",
                 evaluate_single_view: bool = False):
        if inference_conditioning not in CONDITIONING:
            raise ValueError(
                f"unknown inference_conditioning {inference_conditioning!r}")
        self.model = model
        self.data_norm_type = data_norm_type
        self.inference_conditioning = inference_conditioning
        self.geom_cfg = CONDITIONING[inference_conditioning]
        self.evaluate_single_view = evaluate_single_view
        self.device = model_device(model)

    # -- the RMVD wrapper surface -------------------------------------------
    def input_adapter(
        self,
        images: Sequence[np.ndarray],  # V x (1, 3, H, W) uint8/float RGB
        keyview_idx: int = 0,
        poses: Optional[Sequence[np.ndarray]] = None,  # V x (1, 4, 4) key_T_i
        intrinsics: Optional[Sequence[np.ndarray]] = None,  # V x (1, 3, 3)
        depth_range=None,
    ) -> Dict[str, torch.Tensor]:
        """An RMVD sample -> the model's (1, V, ...) views on the device,
        the key view moved to index 0 (the model's reference view)."""
        del depth_range
        order = [keyview_idx] + [i for i in range(len(images))
                                 if i != keyview_idx]
        if self.evaluate_single_view:
            order = order[:1]
        mean, std = (np.asarray(x, np.float32) for x in
                     IMAGE_NORMALIZATION_DICT[self.data_norm_type])
        dev = self.device

        imgs, rays, quats, trans = [], [], [], []
        for i in order:
            img = np.asarray(images[i], np.float32)
            if img.max() > 2.0:  # uint8-range input
                img = img / 255.0
            img = img[0].transpose(1, 2, 0)  # (H, W, 3)
            imgs.append((img - mean) / std)
            if intrinsics is not None:
                k = torch.as_tensor(np.asarray(intrinsics[i][0], np.float32),
                                    device=dev)
                rays.append(get_rays_in_camera_frame(
                    k, img.shape[0], img.shape[1],
                    normalize_to_unit_sphere=True)[1])
            if poses is not None:
                # rmvd's poses are key_T_i: invert to i_T_key (cam2key)
                p = np.linalg.inv(np.asarray(poses[i][0], np.float64))
                quats.append(rotation_matrix_to_quaternion(torch.as_tensor(
                    p[:3, :3].astype(np.float32), device=dev)))
                trans.append(torch.as_tensor(p[:3, 3].astype(np.float32),
                                             device=dev))

        views = {"img": torch.as_tensor(np.stack(imgs)[None], device=dev)}
        if rays and "intrinsics" in self.inference_conditioning:
            views["ray_directions_cam"] = torch.stack(rays)[None]
        if quats and "pose" in self.inference_conditioning:
            views["camera_pose_quats"] = torch.stack(quats)[None]
            views["camera_pose_trans"] = torch.stack(trans)[None]
            views["is_metric_scale"] = torch.ones((1, len(quats)),
                                                  dtype=torch.bool, device=dev)
        return views

    def __call__(self, views: Dict[str, torch.Tensor]):
        with torch.inference_mode():
            return self.model(views, geom_cfg=self.geom_cfg)

    def output_adapter(self, model_output) -> tuple:
        """Factored predictions -> the RMVD prediction of the key view
        (index 0): z-depth (1, 1, H, W) and 1/conf as its uncertainty
        (adaptors.py:171-183)."""
        z = model_output["pts3d_cam"][:, 0, ..., 2].float().cpu().numpy()
        conf = model_output.get("conf")
        conf = (np.ones_like(z) if conf is None
                else conf[:, 0].float().cpu().numpy())
        return {"depth": z[:, None],
                "depth_uncertainty": (1.0 / np.clip(conf, 1e-6, None))[:, None],
                }, {}


def evaluate_mvs_depth(adaptor: RMVDAdaptor, samples: Sequence[Dict],
                       align_scale: bool = True) -> Dict[str, float]:
    """The RMVD multi-view depth protocol without the rmvd package.

    Each sample: {"images": [...], "keyview_idx": int, "gt_depth": (H, W),
    optional "poses" / "intrinsics"}. Per sample, over the pixels with
    gt > 0: abs-rel and the inlier ratio at 1.03, after least-squares
    scale alignment when `align_scale` (rmvd's default for models without
    metric scale).
    """
    absrels: List[float] = []
    inliers: List[float] = []
    for s in samples:
        views = adaptor.input_adapter(s["images"], s.get("keyview_idx", 0),
                                      s.get("poses"), s.get("intrinsics"))
        pred, _ = adaptor.output_adapter(adaptor(views))
        depth = pred["depth"][0, 0]
        gt = np.asarray(s["gt_depth"], np.float32)
        valid = gt > 0
        if not valid.any():
            continue
        if align_scale:
            scale = float((gt[valid] * depth[valid]).sum()
                          / np.clip((depth[valid] ** 2).sum(), 1e-12, None))
            depth = depth * scale
        rel = np.abs(depth[valid] - gt[valid]) / gt[valid]
        absrels.append(float(rel.mean()))
        inliers.append(float(
            (np.maximum(depth[valid] / gt[valid],
                        gt[valid] / np.clip(depth[valid], 1e-12, None))
             < 1.03).mean()))
    return {
        "depth_abs_rel": float(np.mean(absrels)) if absrels else float("nan"),
        "depth_inlier_103": (float(np.mean(inliers)) if inliers
                             else float("nan")),
        "num_samples": len(absrels),
    }
