"""The 14 WAI training/eval datasets, table-driven; counterpart of
mapanything_tpu/data/wai_datasets.py.

The reference implements 14 near-identical classes (datasets/wai/*.py, each
differing only in metadata filename, modality names, metric/synthetic flags
and a few per-dataset quirks). One WAIDataset class and a registry row per
dataset cover the same surface:

    ASE, BlendedMVS, DL3DV, DynamicReplica, ETH3D, MegaDepth, MPSD,
    MVS-Synth, ParallelDomain4D, SAILVOS3D, ScanNetPP, Spring,
    TartanAirV2-WB, UnrealStereo4K

    python -m mapanything_tpu_torch.data.wai_datasets --root WAI_ROOT \
        [--spec eth3d] [--num_views 4] [--resolution 518 392]

prints a few samples of one dataset (the reference's per-dataset QA step);
`--viz` writes the first sample's valid points as sample.glb.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import PIL.Image

from .base_dataset import BaseDataset
from .image import rescale_image_and_other_optional_info
from .wai import load_covisibility_mmap, load_frame, load_scene_meta


@dataclasses.dataclass(frozen=True)
class WAIDatasetSpec:
    """Per-dataset quirk table (the content of each reference class).

    The reference's 14 classes differ only in the fields below; the quirk
    pipeline in WAIDataset._get_views applies them in the same order as the
    reference's per-class _get_views bodies."""

    name: str  # registry key, also used in dataset mix strings
    metadata_stem: str  # scene list file: {stem}_scene_list_{split}.npy
    depth_modality: str = "depth"
    image_modality: str = "image"
    is_metric_scale: bool = True
    is_synthetic: bool = False
    # moge2-style predicted valid mask: resized (nearest) to the image,
    # zeroes depth outside, and becomes non_ambiguous_mask
    # (blendedmvs.py:131-140 et al.)
    mask_modality: Optional[str] = None
    # sky mask zeroing depth (spring.py:126-128)
    sky_mask_modality: Optional[str] = None
    # zero-depth pixels are sky/ambiguous -> non_ambiguous = depth > 0
    # (mvs_synth.py:129-130, sailvos3d, paralleldomain4d, unrealstereo4k)
    zero_depth_is_ambiguous: bool = False
    # horizon/transparency outliers: zero depth above this percentile
    # (mvs_synth.py:132-135, tav2_wb.py:130-132, ...)
    depth_outlier_percentile: Optional[float] = None
    # MVS confidence filter (dl3dv.py:123-171): confidence modality +
    # threshold; depth below-confidence pixels are zeroed
    confidence_modality: Optional[str] = None
    confidence_threshold: float = 0.25


# Registry: flags + quirk pipeline per the reference dataset files
# (datasets/wai/<name>.py _get_views bodies).
WAI_DATASET_SPECS = {
    "ase": WAIDatasetSpec("ase", "ase", is_synthetic=True),
    "blendedmvs": WAIDatasetSpec("blendedmvs", "blendedmvs",
                                 is_metric_scale=False,
                                 mask_modality="pred_mask/moge2"),
    "dl3dv": WAIDatasetSpec("dl3dv", "dl3dv", is_metric_scale=False,
                            depth_modality="pred_depth/mvsanywhere",
                            mask_modality="pred_mask/moge2",
                            confidence_modality="depth_confidence/mvsanywhere"),
    "dynamicreplica": WAIDatasetSpec("dynamicreplica", "dynamicreplica",
                                     is_synthetic=True),
    "eth3d": WAIDatasetSpec("eth3d", "eth3d"),
    "megadepth": WAIDatasetSpec("megadepth", "megadepth",
                                is_metric_scale=False,
                                mask_modality="pred_mask/moge2"),
    "mpsd": WAIDatasetSpec("mpsd", "mpsd", mask_modality="pred_mask/moge2"),
    "mvs_synth": WAIDatasetSpec("mvs_synth", "mvs_synth", is_synthetic=True,
                                zero_depth_is_ambiguous=True,
                                depth_outlier_percentile=95.0),
    "paralleldomain4d": WAIDatasetSpec("paralleldomain4d", "paralleldomain4d",
                                       is_synthetic=True,
                                       zero_depth_is_ambiguous=True,
                                       depth_outlier_percentile=95.0),
    "sailvos3d": WAIDatasetSpec("sailvos3d", "sailvos3d", is_synthetic=True,
                                zero_depth_is_ambiguous=True,
                                depth_outlier_percentile=95.0),
    "scannetpp": WAIDatasetSpec("scannetpp", "scannetppv2",
                                depth_modality="rendered_depth"),
    "spring": WAIDatasetSpec("spring", "spring", is_synthetic=True,
                             mask_modality="pred_mask/moge2",
                             sky_mask_modality="skymask"),
    "tav2_wb": WAIDatasetSpec("tav2_wb", "tav2_wb", is_synthetic=True,
                              mask_modality="pred_mask/moge2",
                              depth_outlier_percentile=95.0),
    "unrealstereo4k": WAIDatasetSpec("unrealstereo4k", "unrealstereo4k",
                                     is_synthetic=True,
                                     zero_depth_is_ambiguous=True,
                                     depth_outlier_percentile=95.0),
}


def _nearest_resize_2d(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbor resize via index maps (pure numpy, any dtype)."""
    if x.shape[:2] == (h, w):
        return x
    ih, iw = x.shape[:2]
    ri = np.clip((np.arange(h) + 0.5) * ih / h, 0, ih - 1).astype(np.int64)
    ci = np.clip((np.arange(w) + 0.5) * iw / w, 0, iw - 1).astype(np.int64)
    return x[ri][:, ci]


def _aspect_match_no_upscale(depth_hw, img_h: int, img_w: int):
    """Target (h, w) for a depth map: the IMAGE's aspect ratio at a size
    that never exceeds the depth's own resolution (reference
    cropping.py:113 resize_with_nearest_interpolation_to_match_aspect_ratio).
    """
    dh, dw = int(depth_hw[0]), int(depth_hw[1])
    aspect = img_w / img_h
    h_keep_w = int(dw / aspect)   # option 1: keep width, adjust height
    w_keep_h = int(dh * aspect)   # option 2: keep height, adjust width
    if h_keep_w > dh and w_keep_h > dw:
        scale = min(dh / img_h, dw / img_w)
        return int(img_h * scale), int(img_w * scale)
    if h_keep_w > dh:
        return dh, w_keep_h
    if w_keep_h > dw:
        return h_keep_w, dw
    # neither increases: keep the option preserving more pixels
    if abs(dh * dw - dw * h_keep_w) < abs(dh * dw - w_keep_h * dh):
        return h_keep_w, dw
    return dh, w_keep_h


class WAIDataset(BaseDataset):
    """One multi-view dataset over a WAI-format scene tree."""

    def __init__(
        self,
        *args,
        ROOT: str,
        dataset_metadata_dir: Optional[str] = None,
        split: str = "train",
        spec: WAIDatasetSpec | str = "scannetpp",
        overfit_num_sets: Optional[int] = None,
        sample_specific_scene: bool = False,
        specific_scene_name: Optional[str] = None,
        **kwargs,
    ):
        super().__init__(*args, split=split, **kwargs)
        if isinstance(spec, str):
            spec = WAI_DATASET_SPECS[spec]
        self.spec = spec
        self.ROOT = ROOT
        self.dataset_metadata_dir = dataset_metadata_dir
        self.overfit_num_sets = overfit_num_sets
        self.sample_specific_scene = sample_specific_scene
        self.specific_scene_name = specific_scene_name
        self.is_metric_scale = spec.is_metric_scale
        self.is_synthetic = spec.is_synthetic
        self._load_scene_list()

    def _load_scene_list(self):
        if self.sample_specific_scene:
            self.scenes = [self.specific_scene_name]
        elif self.dataset_metadata_dir is not None:
            path = os.path.join(
                self.dataset_metadata_dir, self.split,
                f"{self.spec.metadata_stem}_scene_list_{self.split}.npy",
            )
            self.scenes = list(np.load(path, allow_pickle=True))
        else:
            # no metadata dir: every subdirectory with a scene_meta.json
            self.scenes = sorted(
                d for d in os.listdir(self.ROOT)
                if os.path.isfile(os.path.join(self.ROOT, d, "scene_meta.json"))
            )
        if self.overfit_num_sets is not None:
            self.scenes = self.scenes[: self.overfit_num_sets]
        self.num_of_scenes = len(self.scenes)

    def _get_views(self, sampled_idx, num_views_to_sample, resolution):
        scene_name = self.scenes[sampled_idx]
        scene_root = os.path.join(self.ROOT, scene_name)
        scene_meta = load_scene_meta(os.path.join(scene_root, "scene_meta.json"))
        frame_names = list(scene_meta["frame_names"].keys())

        covis = load_covisibility_mmap(scene_root)
        view_indices = self._sample_view_indices(
            num_views_to_sample, len(frame_names), covis
        )

        spec = self.spec
        modalities = [spec.image_modality, spec.depth_modality]
        for extra in (spec.mask_modality, spec.sky_mask_modality,
                      spec.confidence_modality):
            if extra:
                modalities.append(extra)

        views = []
        for vi in view_indices:
            data = load_frame(scene_root, frame_names[int(vi)],
                              modalities=modalities, scene_meta=scene_meta)
            image = data[spec.image_modality]
            depth = data[spec.depth_modality].astype(np.float32)
            intrinsics = data["intrinsics"].astype(np.float32)
            pose = data["extrinsics"].astype(np.float32)
            ih, iw = image.shape[:2]
            # clean non-finite depth (shared across all reference classes)
            depth = np.nan_to_num(depth, nan=0.0, posinf=0.0, neginf=0.0)
            if depth.shape[:2] != (ih, iw):
                # MVS depth at a different (lower) resolution: match the
                # image's aspect ratio WITHOUT increasing depth resolution,
                # then DOWNSIZE the image + intrinsics to the depth grid
                # (dl3dv.py:143-158) — never train full-detail images
                # against blocky nearest-upsampled depth
                th, tw = _aspect_match_no_upscale(depth.shape[:2], ih, iw)
                depth = _nearest_resize_2d(depth, th, tw)
                pil, _, intrinsics, _ = (
                    rescale_image_and_other_optional_info(
                        PIL.Image.fromarray(image), (tw, th),
                        camera_intrinsics=intrinsics))
                image = np.asarray(pil)
                ih, iw = image.shape[:2]
                if depth.shape[:2] != (ih, iw):  # <=1 px rounding slack
                    depth = _nearest_resize_2d(depth, ih, iw)

            # --- quirk pipeline, reference per-class order ---------------
            if spec.confidence_modality:  # dl3dv.py:162-171
                conf = np.asarray(data[spec.confidence_modality],
                                  dtype=np.float32)
                conf_mask = _nearest_resize_2d(
                    (conf > spec.confidence_threshold).astype(np.int32),
                    ih, iw)
                depth = np.where(conf_mask, depth, 0.0)
            if spec.sky_mask_modality:  # spring.py:126-128
                sky = _nearest_resize_2d(
                    np.asarray(data[spec.sky_mask_modality]).astype(bool),
                    ih, iw)
                depth = np.where(sky, 0.0, depth)
            non_ambiguous_mask = None
            if spec.zero_depth_is_ambiguous and not spec.mask_modality:
                # mvs_synth.py:129-130 — BEFORE the percentile zeroing:
                # horizon pixels clipped by the outlier step stay
                # non-ambiguous in the reference (only their depth is
                # invalidated), they are not sky
                non_ambiguous_mask = (depth > 0).astype(np.int32)

            if spec.depth_outlier_percentile is not None:
                # horizon/transparency outliers (mvs_synth.py:132-135)
                pct = np.percentile(depth, spec.depth_outlier_percentile)
                depth = np.where(depth > pct, 0.0, depth)

            if spec.mask_modality:  # moge2 mask (blendedmvs.py:131-140)
                non_ambiguous_mask = _nearest_resize_2d(
                    np.asarray(data[spec.mask_modality]).astype(np.int32),
                    ih, iw)
                depth = np.where(non_ambiguous_mask, depth, 0.0)

            if non_ambiguous_mask is not None:
                image, depth, intrinsics, extras = (
                    self._crop_resize_if_necessary(
                        image, resolution, depth, intrinsics,
                        additional_quantities=[non_ambiguous_mask],
                    )
                )
            else:
                image, depth, intrinsics = self._crop_resize_if_necessary(
                    image, resolution, depth, intrinsics
                )
                extras = None
            view = dict(
                img=image,
                depthmap=depth,
                camera_intrinsics=intrinsics,
                camera_pose=pose,
                dataset=spec.name,
                label=scene_name,
                instance=os.path.join("images", str(data["frame_name"])),
            )
            if extras is not None:
                view["non_ambiguous_mask"] = extras[0]
            views.append(view)
        return views


def make_wai_dataset(name: str, **kwargs) -> WAIDataset:
    """Factory: make_wai_dataset('eth3d', ROOT=..., num_views=4, ...)."""
    return WAIDataset(spec=WAI_DATASET_SPECS[name], **kwargs)


def main(argv=None) -> None:
    """Print a few samples of one dataset: view count, image shape, depth
    range, valid share and scene."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="WAI dataset root")
    ap.add_argument("--spec", default="eth3d",
                    choices=sorted(WAI_DATASET_SPECS))
    ap.add_argument("--num_views", type=int, default=4)
    ap.add_argument("--resolution", type=int, nargs=2, default=(518, 392))
    ap.add_argument("--viz", action="store_true",
                    help="write the first sample as sample.glb")
    ap.add_argument("--num_samples", type=int, default=3)
    args = ap.parse_args(argv)

    ds = WAIDataset(
        ROOT=args.root, spec=args.spec, num_views=args.num_views,
        covisibility_thres=0.25, resolution=tuple(args.resolution),
        data_norm_type="dinov2", seed=0,
    )
    print(f"{args.spec}: {len(ds)} scenes")
    for i in range(min(args.num_samples, len(ds))):
        views = ds[i]
        v0 = views[0]
        print(f"sample {i}: {len(views)} views, img {v0['img'].shape}, "
              f"depth [{float(np.min(v0['depthmap'])):.2f}, "
              f"{float(np.max(v0['depthmap'])):.2f}], "
              f"valid {float(np.mean(v0['valid_mask'])):.1%}, "
              f"scene {v0['label']}")
    if args.viz:
        from ..utils.viz import write_glb_pointcloud
        from .image import IMAGE_NORMALIZATION_DICT

        views = ds[0]
        valid = [np.asarray(v["valid_mask"], bool) for v in views]
        pts = np.concatenate([v["pts3d"][m] for v, m in zip(views, valid)])
        mean, std = IMAGE_NORMALIZATION_DICT["dinov2"]
        cols = np.concatenate([
            np.clip(np.asarray(v["img"]) * std + mean, 0, 1)[m]
            for v, m in zip(views, valid)])
        write_glb_pointcloud("sample.glb", pts, cols)
        print(f"wrote sample.glb ({len(pts)} points)")


if __name__ == "__main__":
    main()
