"""Single-view calibration benchmark; counterpart of
mapanything_tpu/benchmarks/calibration.py (the reference's
benchmarking/calibration/benchmark.py:25-235).

Metric: the angle, in degrees, between the predicted and the GT per-pixel
ray directions of view 0 alone, priors dropped.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..geometry import angle_diff_vec3
from ..utils.device import to_device
from .dense_n_view import model_device, write_json


def ray_angular_error_deg(pred_rays: torch.Tensor,
                          gt_rays: torch.Tensor) -> torch.Tensor:
    """Mean angular ray error per image in degrees; inputs (..., H, W, 3)."""
    return torch.rad2deg(angle_diff_vec3(pred_rays, gt_rays).mean((-2, -1)))


def run_calibration_benchmark(model, loader, geom_cfg,
                              output_json: Optional[str] = None
                              ) -> Dict[str, float]:
    """Evaluate `model`'s view-0 rays over a test loader (the model as
    benchmarks/dense_n_view.py::run_dense_n_view_benchmark takes it);
    returns the mean and median error and writes the per-image errors to
    `output_json`."""
    device = model_device(model)
    errors: List[float] = []
    loader.set_epoch(0)
    with torch.inference_mode():
        for batch in loader:
            batch = to_device(batch, device)
            # single-view calibration: view 0 only, no geometric priors
            views = {"img": batch["views"]["img"][:, :1]}
            pred = model(views, geom_cfg=geom_cfg)["ray_directions"]
            gt = batch["gt"]["ray_directions_cam"][:, :1]
            err = ray_angular_error_deg(pred, gt).cpu().numpy()
            errors.extend(err.reshape(-1).tolist())

    summary = {
        "ray_angular_error_deg_mean": float(np.mean(errors)),
        "ray_angular_error_deg_median": float(np.median(errors)),
        "num_images": len(errors),
    }
    if output_json:
        write_json(output_json, {"summary": summary, "per_image": errors})
    return summary
