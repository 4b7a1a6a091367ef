"""Geometry of the PyTorch port (the inference and training slices' paths,
the geometric priors, the benchmarks' pose recovery)."""

from .camera import (
    adjust_camera_params_for_rotation,
    adjust_pose_for_rotation,
    crop_to_aspect_ratio,
)
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
    rigid_points_registration,
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
from .windows import (
    depth_aliasing,
    max_pool_1d,
    max_pool_nd,
    sliding_window_1d,
    sliding_window_2d,
    sliding_window_nd,
)

__all__ = [
    "adjust_camera_params_for_rotation",
    "adjust_pose_for_rotation",
    "angle_diff_vec3",
    "apply_log_to_norm",
    "convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap",
    "crop_to_aspect_ratio",
    "depth_aliasing",
    "depth_along_ray_from_z_depth_and_rays",
    "depth_edge",
    "depthmap_to_camera_frame",
    "depthmap_to_world_frame",
    "get_rays_in_camera_frame",
    "max_pool_1d",
    "max_pool_2d",
    "max_pool_nd",
    "normalize_depth_using_non_zero_pixels",
    "normalize_multiple_pointclouds",
    "normalize_pose_translations",
    "points_normal_edges",
    "pose_quats_trans_to_matrix",
    "quaternion_inverse",
    "quaternion_multiply",
    "quaternion_to_rotation_matrix",
    "recover_pinhole_intrinsics_from_ray_directions",
    "rigid_points_registration",
    "rotation_matrix_to_quaternion",
    "safe_norm",
    "sliding_window_1d",
    "sliding_window_2d",
    "sliding_window_nd",
    "standardize_quaternion",
    "transform_pose_using_quats_and_trans_2_to_1",
]
