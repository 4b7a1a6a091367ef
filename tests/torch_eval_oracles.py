"""A ground-truth oracle for the port's benchmark harnesses: a "model" that
predicts each batch's own GT, so the harness's metrics must read zero
error. It imports no JAX, so chip_smoke.py uses it on the card too.

    loader = RecordingLoader(loader)
    summary = run_dense_n_view_benchmark(GroundTruthOracle(loader, device),
                                         loader, geom_cfg)

`RecordingLoader` keeps the batch the harness is holding (`ListLoader`
hands out batches held in a list);
`GroundTruthOracle` returns that batch's GT in the factored keys
(models/adapters.py::FACTORED_PRED_KEYS) for the views it is given (the
calibration harness passes view 0 alone), with metric scale 1. With
`ray_rotation_deg`, every predicted ray is the GT ray turned by that angle
about an axis perpendicular to it, so each ray's angular error is exactly
that angle.
"""

import math

import torch

from mapanything_tpu_torch.utils.device import to_device


class ListLoader:
    """Batches held in a list, handed out as a test loader does."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)


class RecordingLoader:
    """A test loader whose current batch stays readable (`current`)."""

    def __init__(self, loader):
        self.loader = loader
        self.current = None

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for batch in self.loader:
            self.current = batch
            yield batch


def rotate_rays(rays: torch.Tensor, degrees: float) -> torch.Tensor:
    """Unit rays (..., 3) each turned by `degrees` about the axis
    rays x (1, 0, 0) (perpendicular to it; camera rays have z > 0)."""
    ex = torch.zeros_like(rays)
    ex[..., 0] = 1.0
    axis = torch.linalg.cross(rays, ex, dim=-1)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    theta = math.radians(degrees)
    return (rays * math.cos(theta)
            + torch.linalg.cross(axis, rays, dim=-1) * math.sin(theta))


class GroundTruthOracle:
    """Predicts the recorded batch's GT (module docstring)."""

    def __init__(self, loader: RecordingLoader, device,
                 ray_rotation_deg: float = 0.0):
        self.loader = loader
        self.device = torch.device(device)
        self.ray_rotation_deg = ray_rotation_deg

    def __call__(self, views, geom_cfg=None, memory_efficient=False):
        b, v, h, w = views["img"].shape[:4]
        gt = {k: x[:, :v] for k, x in
              to_device(self.loader.current["gt"], self.device).items()
              if x.dim() > 1}
        rays = gt["ray_directions_cam"]
        if self.ray_rotation_deg:
            rays = rotate_rays(rays, self.ray_rotation_deg)
        ones = torch.ones((b, v, h, w), device=self.device)
        return {
            "pts3d": gt["pts3d"],
            "pts3d_cam": gt["pts3d_cam"],
            "ray_directions": rays,
            "depth_along_ray": gt["depth_along_ray"],
            "cam_quats": gt["camera_pose_quats"],
            "cam_trans": gt["camera_pose_trans"],
            "metric_scaling_factor": torch.ones(b, device=self.device),
            "conf": ones,
            "non_ambiguous_mask": ones.bool(),
            "non_ambiguous_mask_logits": 10.0 * ones,
        }
