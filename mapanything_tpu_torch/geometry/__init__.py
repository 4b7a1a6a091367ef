"""Geometry of the PyTorch port (the inference and training slices' paths,
the geometric priors)."""

from .edges import depth_edge, max_pool_2d, points_normal_edges
from .norm import (
    apply_log_to_norm,
    normalize_depth_using_non_zero_pixels,
    normalize_multiple_pointclouds,
    normalize_pose_translations,
    safe_norm,
)
from .pointmaps import (
    angle_diff_vec3,
    convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap,
)
from .quats import (
    pose_quats_trans_to_matrix,
    quaternion_inverse,
    quaternion_multiply,
    quaternion_to_rotation_matrix,
    rotation_matrix_to_quaternion,
    standardize_quaternion,
    transform_pose_using_quats_and_trans_2_to_1,
)
from .rays import (
    depth_along_ray_from_z_depth_and_rays,
    depthmap_to_camera_frame,
    depthmap_to_world_frame,
    get_rays_in_camera_frame,
    recover_pinhole_intrinsics_from_ray_directions,
)

__all__ = [
    "angle_diff_vec3",
    "apply_log_to_norm",
    "convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap",
    "depth_along_ray_from_z_depth_and_rays",
    "depth_edge",
    "depthmap_to_camera_frame",
    "depthmap_to_world_frame",
    "get_rays_in_camera_frame",
    "max_pool_2d",
    "normalize_depth_using_non_zero_pixels",
    "normalize_multiple_pointclouds",
    "normalize_pose_translations",
    "points_normal_edges",
    "pose_quats_trans_to_matrix",
    "quaternion_inverse",
    "quaternion_multiply",
    "quaternion_to_rotation_matrix",
    "recover_pinhole_intrinsics_from_ray_directions",
    "rotation_matrix_to_quaternion",
    "safe_norm",
    "standardize_quaternion",
    "transform_pose_using_quats_and_trans_2_to_1",
]
