"""Geometry of the PyTorch port (the slice's main path only)."""

from .edges import depth_edge, max_pool_2d, points_normal_edges
from .pointmaps import (
    convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap,
)
from .quats import pose_quats_trans_to_matrix, quaternion_to_rotation_matrix
from .rays import recover_pinhole_intrinsics_from_ray_directions

__all__ = [
    "convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap",
    "depth_edge",
    "max_pool_2d",
    "points_normal_edges",
    "pose_quats_trans_to_matrix",
    "quaternion_to_rotation_matrix",
    "recover_pinhole_intrinsics_from_ray_directions",
]
