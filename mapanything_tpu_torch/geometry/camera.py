"""Host-side camera-parameter adjustment helpers (data preprocessing); the
port's copy of mapanything_tpu/geometry/camera.py.

Numpy rebuilds of mapanything/utils/geometry.py's camera-augmentation tail
(adjust_camera_params_for_rotation:1370, adjust_pose_for_rotation:1404,
crop_to_aspect_ratio:1432). They run on the host in the data pipeline on
per-scene scalars and single images; images are HWC numpy arrays instead
of the reference's PIL objects.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def adjust_camera_params_for_rotation(
    camera_params: Sequence[float],
    original_size: Tuple[int, int],
    k: int,
) -> list:
    """Remap [fx, fy, cx, cy, ...] for k 90-degree CCW image rotations.

    Ref: geometry.py:1370."""
    fx, fy, cx, cy = camera_params[:4]
    width, height = original_size
    if k % 4 == 1:  # 90 CCW
        new = [fy, fx, height - cy, cx]
    elif k % 4 == 2:  # 180
        new = [fx, fy, width - cx, height - cy]
    elif k % 4 == 3:  # 90 CW
        new = [fy, fx, cy, width - cx]
    else:
        return list(camera_params)
    return new + list(camera_params[4:])


def adjust_pose_for_rotation(pose: np.ndarray, k: int) -> np.ndarray:
    """Right-multiply the cam2world rotation by the in-plane image rotation
    (OpenCV convention: X right, Y down, Z forward).

    Ref: geometry.py:1404."""
    if k % 4 == 1:  # 90 CCW
        rot = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=pose.dtype)
    elif k % 4 == 2:  # 180
        rot = np.array([[-1, 0, 0], [0, -1, 0], [0, 0, 1]], dtype=pose.dtype)
    elif k % 4 == 3:  # 90 CW
        rot = np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], dtype=pose.dtype)
    else:
        return pose
    out = pose.copy()
    out[:3, :3] = out[:3, :3] @ rot.T
    return out


def crop_to_aspect_ratio(
    image: np.ndarray,
    depth: np.ndarray,
    camera_params: Sequence[float],
    target_ratio: float = 1.5,
):
    """Crop image+depth to the largest window at `target_ratio` (keep the
    left edge when too wide, the bottom edge when too tall) and shift the
    principal point accordingly.

    Args:
        image: (H, W, C) array (the reference takes PIL; we take arrays)
        depth: (H, W) or (H, W, C) array
        camera_params: [fx, fy, cx, cy, ...]

    Returns:
        (cropped image, cropped depth, adjusted camera params)

    Ref: geometry.py:1432."""
    height, width = image.shape[:2]
    fx, fy, cx, cy = camera_params[:4]
    current_ratio = width / height
    if abs(current_ratio - target_ratio) < 1e-6:
        return image, depth, list(camera_params)

    if current_ratio > target_ratio:  # too wide: crop width, keep left
        new_width = int(height * target_ratio)
        image = image[:, :new_width]
        depth = depth[:, :new_width]
        params = [fx, fy, cx, cy] + list(camera_params[4:])  # left=0: cx same
    else:  # too tall: crop height, keep bottom
        new_height = int(width / target_ratio)
        top = max(0, height - new_height)
        image = image[top:]
        depth = depth[top:]
        params = [fx, fy, cx, cy - top] + list(camera_params[4:])
    return image, depth, params
