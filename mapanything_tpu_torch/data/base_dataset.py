"""Multi-view scene dataset base; counterpart of
mapanything_tpu/data/base_dataset.py (the reference's
datasets/base/base_dataset.py).

Samples N covisible views per scene by a covisibility random walk, derives
the full GT supervision set (pointmaps, rays, depth along the ray,
validity) on the host in numpy, and emits view dicts ready for (B, V, ...)
collation. The same seed gives the JAX package's samples bit for bit:

  * the per-index RNG (seed + offset + idx), which freezes validation sets
    across epochs, with its draws in the same order;
  * the walk and the uint8 normalisation run the same C++ source
    (data/native.py), which raises rather than fall back;
  * the Gaussian blur of the "gaublur" transform is numpy with OpenCV's
    kernel and border (cv2.GaussianBlur: not bitwise, within 1e-6);
  * the retry on a failed sample draws its replacement from numpy's global
    RNG, as the JAX package does.

One repair: the per-sample RNG is per thread. The loader's worker threads
load samples of one dataset at once, and in the JAX package they share one
`_rng` attribute, so a thread can draw from another sample's generator and
a threaded loader's batches depend on timing; here each thread has its own,
and the batches equal the JAX loader's without workers.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple, Union

import numpy as np
import PIL.Image

from . import native
from .combinators import EasyDataset
from .image import IMAGE_NORMALIZATION_DICT, crop_resize_if_necessary


# ---------------------------------------------------------------------------
# numpy GT derivation (the reference's geometry.py:24,186,1294 on the host)
# ---------------------------------------------------------------------------


def depthmap_to_camera_coordinates(depthmap: np.ndarray, K: np.ndarray):
    h, w = depthmap.shape
    x = np.arange(w, dtype=np.float32)[None, :]
    y = np.arange(h, dtype=np.float32)[:, None]
    xx = (x - K[0, 2]) * depthmap / K[0, 0]
    yy = (y - K[1, 2]) * depthmap / K[1, 1]
    pts = np.stack([xx, yy, depthmap], axis=-1)
    return pts, depthmap > 0


def get_absolute_pointmaps_and_rays_info(
    depthmap: np.ndarray, camera_intrinsics: np.ndarray,
    camera_pose: np.ndarray, **_ignored,
):
    """depth+K+pose -> (pts3d world, valid, ray origins/dirs world,
    depth along ray, ray dirs cam, pts cam). Ref geometry.py:1294."""
    pts_cam, valid = depthmap_to_camera_coordinates(depthmap, camera_intrinsics)
    depth_along_ray = np.linalg.norm(pts_cam, axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        ray_dirs_cam = np.where(
            depth_along_ray > 0, pts_cam / np.clip(depth_along_ray, 1e-12, None), 0
        )
    # unit-sphere rays from intrinsics for zero-depth pixels
    h, w = depthmap.shape
    x = np.arange(w, dtype=np.float32)[None, :].repeat(h, 0)
    y = np.arange(h, dtype=np.float32)[:, None].repeat(w, 1)
    dirs = np.stack(
        [(x - camera_intrinsics[0, 2]) / camera_intrinsics[0, 0],
         (y - camera_intrinsics[1, 2]) / camera_intrinsics[1, 1],
         np.ones_like(x)], axis=-1,
    )
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ray_dirs_cam = np.where(depth_along_ray > 0, ray_dirs_cam, dirs)

    rot, t = camera_pose[:3, :3], camera_pose[:3, 3]
    pts_world = pts_cam @ rot.T + t
    ray_dirs_world = ray_dirs_cam @ rot.T
    ray_origins_world = np.broadcast_to(t, pts_world.shape).copy()
    return (pts_world.astype(np.float32), valid,
            ray_origins_world.astype(np.float32),
            ray_dirs_world.astype(np.float32),
            depth_along_ray.astype(np.float32),
            ray_dirs_cam.astype(np.float32), pts_cam.astype(np.float32))


def rotation_matrix_to_quaternion_np(rot: np.ndarray) -> np.ndarray:
    """3x3 -> xyzw quaternion (scipy-free, standardized w >= 0)."""
    m = rot
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], dtype=np.float32)
    return -q if q[3] < 0 else q


# ---------------------------------------------------------------------------
# numpy colour augmentation (in place of torchvision's transforms)
# ---------------------------------------------------------------------------


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness=0.5, contrast=0.5, saturation=0.5, hue=0.1):
    """Random brightness/contrast/saturation/hue on a [0,1] float HWC image."""
    if brightness:
        img = img * rng.uniform(1 - brightness, 1 + brightness)
    if contrast:
        mean = img.mean()
        img = (img - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
    if saturation:
        gray = img.mean(axis=-1, keepdims=True)
        img = gray + (img - gray) * rng.uniform(1 - saturation, 1 + saturation)
    if hue:
        # cheap hue rotation: channel roll mix
        f = rng.uniform(-hue, hue)
        img = (1 - abs(f)) * img + abs(f) * np.roll(img, 1 if f > 0 else -1, axis=-1)
    return np.clip(img, 0.0, 1.0)


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma) for float32 images: the weights
    exp(-x^2 / (2 sigma^2)) at x = i - (ksize - 1) / 2, normalised to sum 1
    in float64, then rounded to float32."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    weights = np.exp((-0.5 / (sigma * sigma)) * x * x)
    return (weights * (1.0 / weights.sum())).astype(np.float32)


def blur_separable(img: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """A separable filter over the two spatial axes of a float32 (H, W, ...)
    image, rows first, with OpenCV's default border (BORDER_REFLECT_101,
    numpy's "reflect"), accumulated in float32."""
    r = len(weights) // 2
    out = img.astype(np.float32)
    for axis in (1, 0):
        width = [(0, 0)] * out.ndim
        width[axis] = (r, r)
        padded = np.pad(out, width, mode="reflect")
        n = out.shape[axis]
        acc = np.zeros_like(out)
        for i, w in enumerate(weights):
            acc += w * padded.take(np.arange(i, i + n), axis=axis)
        out = acc
    return out


def gaussian_blur(img: np.ndarray, rng: np.random.Generator,
                  kernel_size=5, sigma_range=(0.1, 1.0)):
    """cv2.GaussianBlur(img, (k, k), sigma) with sigma drawn from `rng`, in
    numpy: the same kernel and border, within 1e-6 of OpenCV on [0, 1]
    images."""
    sigma = float(rng.uniform(*sigma_range))
    return blur_separable(img, gaussian_kernel(kernel_size, sigma))


class BaseDataset(EasyDataset):
    """Multi-view dataset base. Subclasses implement
    `_get_views(idx, num_views, resolution) -> list of view dicts` with keys
    img (PIL or uint8 HWC), depthmap (H,W), camera_intrinsics (3,3),
    camera_pose (4,4 cam2world), optional non_ambiguous_mask / prior_depth_z.
    """

    is_metric_scale: bool = True
    is_synthetic: bool = False

    def __init__(
        self,
        num_views: int,
        variable_num_views: bool = False,
        split: Optional[str] = None,
        covisibility_thres: Optional[float] = None,
        resolution: Union[int, Tuple[int, int], List[Tuple[int, int]]] = None,
        principal_point_centered: bool = False,
        transform: Optional[str] = "imgnorm",
        data_norm_type: str = "dinov2",
        aug_crop: int = 0,
        seed: Optional[int] = None,
        max_num_retries: int = 5,
    ):
        self.num_views = num_views
        self.variable_num_views = variable_num_views
        self.num_views_min = 2
        self.split = split
        self.covisibility_thres = covisibility_thres
        self._set_resolutions(resolution)
        self.principal_point_centered = principal_point_centered
        if self.variable_num_views and self.num_views > self.num_views_min:
            self.num_views = list(range(self.num_views_min, self.num_views + 1))
        if data_norm_type not in IMAGE_NORMALIZATION_DICT:
            raise ValueError(f"unknown data_norm_type {data_norm_type}")
        self.data_norm_type = data_norm_type
        self.transform_name = transform or "imgnorm"
        self.aug_crop = aug_crop
        self.seed = seed
        self._seed_offset = 0
        self.max_num_retries = max_num_retries

    # -- the per-sample RNG, one per thread ---------------------------------
    def _thread_state(self) -> threading.local:
        # __dict__.setdefault is atomic: two threads get one local
        return self.__dict__.setdefault("_rng_of_thread", threading.local())

    @property
    def _rng(self) -> np.random.Generator:
        """The RNG of the sample this thread is loading (AttributeError
        before its first sample)."""
        return self._thread_state().rng

    @_rng.setter
    def _rng(self, rng: np.random.Generator) -> None:
        self._thread_state().rng = rng

    # -- resolutions ------------------------------------------------------
    def _set_resolutions(self, resolution):
        assert resolution is not None, "undefined resolution"
        if not isinstance(resolution, list):
            resolution = [resolution]
        out = []
        for res in resolution:
            if isinstance(res, int):
                res = (res, res)
            w, h = int(res[0]), int(res[1])
            out.append((w, h))
        self._resolutions = out

    # -- transforms --------------------------------------------------------
    def _apply_transform(self, img: PIL.Image.Image, rng) -> np.ndarray:
        name = self.transform_name
        if name == "imgnorm":  # no augmentation: the native normalise
            mean, std = IMAGE_NORMALIZATION_DICT[self.data_norm_type]
            return native.normalize_u8(np.asarray(img, np.uint8), mean, std)
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if name == "colorjitter":
            arr = color_jitter(arr, rng)
        elif name == "colorjitter+grayscale+gaublur":
            if rng.uniform() < 0.75:
                arr = color_jitter(arr, rng, 0.3, 0.4, 0.2, 0.1)
            if rng.uniform() < 0.05:
                arr = np.repeat(arr.mean(-1, keepdims=True), 3, axis=-1)
            if rng.uniform() < 0.05:
                arr = gaussian_blur(arr, rng)
        else:
            raise ValueError(f"unknown transform {name}")
        mean, std = IMAGE_NORMALIZATION_DICT[self.data_norm_type]
        return ((arr - mean) / std).astype(np.float32)

    # -- covisibility sampling (base_dataset.py:314-452) --------------------
    def _random_walk_sampling(self, covis, num_of_samples, max_retries=4,
                              use_bidirectional_covis=True):
        """The native walk (data/native.py), seeded from this sample's
        RNG."""
        return native.covis_random_walk(
            np.asarray(covis), num_of_samples, self.covisibility_thres,
            seed=int(self._rng.integers(2**63)), max_retries=max_retries,
            bidirectional=use_bidirectional_covis,
        )

    def _random_walk_sampling_py(self, covis, num_of_samples, max_retries=4,
                                 use_bidirectional_covis=True):
        """The walk's plain numpy version: the same graph rule, its draws
        from this sample's RNG itself (so other views than the native
        walk's from the same seed). The tests hold it against the JAX
        package's."""
        excluded = set()
        best_walk: list = []
        n = len(covis)
        for _ in range(max_retries):
            visited, walk, stack = set(), [], []
            available = list(set(range(n)) - excluded)
            if not available:
                break
            start = int(self._rng.choice(available))
            walk.append(start)
            visited.add(start)
            stack.append(start)
            while len(walk) < num_of_samples and stack:
                cur = stack[-1]
                if use_bidirectional_covis:
                    pc = (covis[cur, :] + covis[:, cur].T) / 2
                else:
                    pc = np.array(covis[cur, :])
                pc = pc / (pc[cur] + 1e-8)
                pc[cur] = 0
                neighbors = np.flatnonzero(pc > self.covisibility_thres)
                candidates = [i for i in neighbors if i not in visited]
                if candidates:
                    nxt = int(self._rng.choice(candidates))
                    walk.append(nxt)
                    visited.add(nxt)
                    stack.append(nxt)
                else:
                    stack.pop()
            if len(walk) > len(best_walk):
                best_walk = walk
            if len(walk) >= num_of_samples:
                return np.array(walk)
            excluded.update(visited)
        return np.array(best_walk)

    def _sample_view_indices(self, num_views_to_sample, num_views_in_scene,
                             covis, use_bidirectional_covis=True):
        if num_views_to_sample == num_views_in_scene:
            return self._rng.permutation(num_views_in_scene)
        if num_views_to_sample > num_views_in_scene:
            return self._rng.choice(num_views_in_scene,
                                    size=num_views_to_sample, replace=True)
        idxs = self._random_walk_sampling(
            covis, num_views_to_sample,
            use_bidirectional_covis=use_bidirectional_covis)
        if len(idxs) < num_views_to_sample:
            idxs = self._rng.choice(idxs, size=num_views_to_sample, replace=True)
        return idxs

    # -- crop/resize with aug ----------------------------------------------
    def _crop_resize_if_necessary(self, image, resolution, depthmap,
                                  intrinsics, additional_quantities=None):
        """Target-resolution crop with optional principal-point centering and
        crop augmentation (base_dataset.py:211)."""
        return crop_resize_if_necessary(
            image, resolution, depthmap=depthmap, intrinsics=intrinsics,
            additional_quantities=additional_quantities,
        )

    # -- main item path ------------------------------------------------------
    def _getitem_fn(self, idx):
        if isinstance(idx, tuple):
            if isinstance(self.num_views, int):
                idx, ar_idx = idx
                nv_idx = None
            else:
                idx, ar_idx, nv_idx = idx
        else:
            assert len(self._resolutions) == 1
            ar_idx, nv_idx = 0, None

        if self.seed is not None:
            self._rng = np.random.default_rng(
                seed=self.seed + self._seed_offset + idx
            )
        elif not hasattr(self, "_rng"):
            self._rng = np.random.default_rng()

        resolution = self._resolutions[ar_idx]
        if isinstance(self.num_views, int):
            num_views_to_sample = self.num_views
        else:
            num_views_to_sample = self.num_views[nv_idx]

        views = self._get_views(idx, num_views_to_sample, resolution)

        for v, view in enumerate(views):
            view["idx"] = (idx, ar_idx, v)
            view["is_metric_scale"] = self.is_metric_scale
            view["is_synthetic"] = self.is_synthetic

            assert "camera_intrinsics" in view and "camera_pose" in view
            assert np.isfinite(view["camera_pose"]).all()
            assert np.isfinite(view["depthmap"]).all()

            img = view["img"]
            if isinstance(img, PIL.Image.Image):
                width, height = img.size
            else:
                height, width = img.shape[:2]
                img = PIL.Image.fromarray(img)
            view["true_shape"] = np.int32((height, width))
            view["img"] = self._apply_transform(img, self._rng)
            view["data_norm_type"] = self.data_norm_type

            (pts3d, valid_mask, _ro, _rd, depth_along_ray,
             ray_dirs_cam, pts3d_cam) = get_absolute_pointmaps_and_rays_info(
                depthmap=view["depthmap"],
                camera_intrinsics=view["camera_intrinsics"],
                camera_pose=view["camera_pose"],
            )
            view["pts3d"] = pts3d
            view["valid_mask"] = valid_mask & np.isfinite(pts3d).all(axis=-1)
            view["depth_along_ray"] = depth_along_ray
            view["ray_directions_cam"] = ray_dirs_cam
            view["pts3d_cam"] = pts3d_cam

            if "prior_depth_z" in view:
                prior_pts, _ = depthmap_to_camera_coordinates(
                    view["prior_depth_z"], view["camera_intrinsics"]
                )
                view["prior_depth_along_ray"] = np.linalg.norm(
                    prior_pts, axis=-1, keepdims=True
                )
                del view["prior_depth_z"]

            if "non_ambiguous_mask" in view:
                view["non_ambiguous_mask"] = view["non_ambiguous_mask"].astype(bool)
            else:
                view["non_ambiguous_mask"] = ~(view["depthmap"] < 0)

            view["depthmap"] = view["depthmap"][..., None].astype(np.float32)
            view["camera_pose_quats"] = rotation_matrix_to_quaternion_np(
                view["camera_pose"][:3, :3]
            )
            view["camera_pose_trans"] = view["camera_pose"][:3, 3].astype(
                np.float32
            )
            view["rng"] = int.from_bytes(self._rng.bytes(4), "big")
        return views

    def __getitem__(self, idx):
        if self.max_num_retries == 0:
            return self._getitem_fn(idx)
        num_retries = 0
        while True:
            try:
                return self._getitem_fn(idx)
            except Exception as e:  # data fault tolerance (:624-657)
                if num_retries >= self.max_num_retries:
                    raise
                num_retries += 1
                replacement = int(np.random.randint(0, len(self)))
                if isinstance(idx, tuple):
                    idx = (replacement,) + tuple(idx[1:])
                else:
                    idx = replacement
                print(f"{type(self).__name__}: retry {num_retries} after {e!r} "
                      f"with scene_idx={replacement}")

    def __len__(self):
        return self.num_of_scenes

    def set_epoch(self, epoch):
        # bump the seed offset so repeated scenes yield new multi-view sets
        self._seed_offset = epoch * 1_000_003
