"""Geometry of the PyTorch port (the inference and training slices' paths)."""

from .edges import depth_edge, max_pool_2d, points_normal_edges
from .norm import apply_log_to_norm, normalize_multiple_pointclouds, safe_norm
from .pointmaps import (
    angle_diff_vec3,
    convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap,
)
from .quats import (
    pose_quats_trans_to_matrix,
    quaternion_inverse,
    quaternion_multiply,
    quaternion_to_rotation_matrix,
    transform_pose_using_quats_and_trans_2_to_1,
)
from .rays import (
    depthmap_to_camera_frame,
    depthmap_to_world_frame,
    get_rays_in_camera_frame,
    recover_pinhole_intrinsics_from_ray_directions,
)

__all__ = [
    "angle_diff_vec3",
    "apply_log_to_norm",
    "convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap",
    "depth_edge",
    "depthmap_to_camera_frame",
    "depthmap_to_world_frame",
    "get_rays_in_camera_frame",
    "max_pool_2d",
    "normalize_multiple_pointclouds",
    "points_normal_edges",
    "pose_quats_trans_to_matrix",
    "quaternion_inverse",
    "quaternion_multiply",
    "quaternion_to_rotation_matrix",
    "recover_pinhole_intrinsics_from_ray_directions",
    "safe_norm",
    "transform_pose_using_quats_and_trans_2_to_1",
]
