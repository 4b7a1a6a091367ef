"""Named task presets of the geometric inputs; counterpart of
mapanything_tpu/models/tasks.py.

One `GeometricInputConfig` per yaml stem of the reference's
configs/model/task/ tree, value for value: the eight input-modality
probabilities and the sparsification share.
"""

from __future__ import annotations

from .mapanything import GeometricInputConfig

# yaml stem -> (overall, dropout, ray_dirs, depth, cam, sparse_depth,
#               sparsification_removal_percent, depth_scale_norm_all,
#               pose_scale_norm_all)
_P = {
    "images_only":          (0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    "aug_training":         (0.9, 0.05, 0.5, 0.5, 0.5, 0.5, 0.9, 0.05, 0.05),
    "calibrated_sfm":       (1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    "depth_completion":     (1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.9, 0.0, 0.0),
    "mvs":                  (1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0),
    "mvs_non_metric":       (1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0),
    "mvs_training":         (1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.05),
    "non_metric_poses_metric_depth":
                            (1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 1.0),
    "non_metric_poses_metric_depth_sparse":
                            (1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.9, 0.0, 1.0),
    "non_metric_poses_non_metric_depth":
                            (1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 0.0, 1.0, 1.0),
    "non_metric_poses_non_metric_depth_sparse":
                            (1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.9, 1.0, 1.0),
    "pass_through":         (1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0),
    "posed_sfm":            (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0),
    "posed_sfm_non_metric": (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0),
    "registration":         (1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    "registration_sparse":  (1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 0.9, 0.0, 0.0),
    "registration_training":
                            (1.0, 0.0, 1.0, 1.0, 0.0, 0.5, 0.9, 0.05, 0.0),
}

TASK_NAMES = tuple(sorted(_P))


def task_config(name: str) -> GeometricInputConfig:
    """The `GeometricInputConfig` of a named preset ("mvs",
    "registration_sparse", "aug_training", ...)."""
    try:
        p = _P[name]
    except KeyError:
        raise ValueError(
            f"unknown task preset {name!r}; available: {', '.join(TASK_NAMES)}"
        ) from None
    return GeometricInputConfig(
        overall_prob=p[0], dropout_prob=p[1], ray_dirs_prob=p[2],
        depth_prob=p[3], cam_prob=p[4], sparse_depth_prob=p[5],
        sparsification_removal_percent=p[6], depth_scale_norm_all_prob=p[7],
        pose_scale_norm_all_prob=p[8])
