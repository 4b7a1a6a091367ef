"""The adapter seam; counterpart of mapanything_tpu/models/adapters.py (the
reference's section 2.9 wrapper contract).

Every model the benchmarks evaluate is called as

    model(views, geom_cfg=..., memory_efficient=...) -> preds

with `views` the stacked (B, V, ...) views on the model's device and
`preds` carrying the factored keys of FACTORED_PRED_KEYS. MapAnything
speaks it already; an adapter makes another model speak it, so a new model
needs no change to benchmarks/{dense_n_view,calibration,rmvd}.py or to
data/pseudo_depth.py. Three kinds:

  * over a port model: `ModularDUSt3RAdapter`, `MapAnythingAdapter`;
  * over a constructed torch module of a foreign model: `VGGTAdapter`,
    `Pi3Adapter`, `MoGeAdapter`. They are nn.Modules holding it (so
    benchmarks/dense_n_view.py::model_device finds the device through its
    parameters); the module runs on its device under eval() and no_grad,
    and the outputs stay there: nothing crosses to the host inside the
    call;
  * over a host callable, the pip pipelines whose own outputs are host
    arrays: `PosedDepthAdapter` (`DUSt3RAdapter`, `MASt3RAdapter`),
    `MUSt3RAdapter`, `Pow3RAdapter`, `AnyCalibAdapter`. The callable keeps
    the JAX package's numpy contract; the adapter names its `device` (the
    card unless the caller passes one), copies the callable's arrays there
    once and converts there. `from_pip` (on each but Pow3R's, as in the
    JAX package) builds the callable around the package, which the
    repository does not hold (ImportError naming it).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..data.image import IMAGE_NORMALIZATION_DICT
from ..geometry import (
    closed_form_pose_inverse,
    convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap,
    convert_z_depth_to_depth_along_ray,
    depthmap_to_camera_frame,
    get_rays_in_camera_frame,
    pose_quats_trans_to_matrix,
    recover_pinhole_intrinsics_from_ray_directions,
    rigid_points_registration,
    rotation_matrix_to_quaternion,
    safe_norm,
)
from ..geometry.quats import rotate
from ..utils.device import resolve_device
from .mapanything import GeometricInputConfig

FACTORED_PRED_KEYS = (
    "pts3d",
    "pts3d_cam",
    "ray_directions",
    "depth_along_ray",
    "cam_quats",
    "cam_trans",
    "metric_scaling_factor",
    "conf",
    "non_ambiguous_mask",
    "non_ambiguous_mask_logits",
)


def _rays_depth_from_cam_points(pts_cam: torch.Tensor):
    """(..., H, W, 3) camera-frame points -> unit rays and depth along the
    ray (..., H, W, 1)."""
    depth = safe_norm(pts_cam, keepdim=True)
    return pts_cam / depth.clamp_min(1e-8), depth


def _factored(pts3d, pts3d_cam, rays, depth_along_ray, cam_quats, cam_trans,
              conf, mask=None) -> Dict[str, torch.Tensor]:
    """The contract's dict: metric_scaling_factor 1 (none of the adapted
    models' geometry is consumed at metric scale), the mask every pixel
    unless given, its logits +-10."""
    b, v, h, w = conf.shape
    dev = conf.device
    if mask is None:
        mask = torch.ones((b, v, h, w), dtype=torch.bool, device=dev)
    return {
        "pts3d": pts3d,
        "pts3d_cam": pts3d_cam,
        "ray_directions": rays,
        "depth_along_ray": depth_along_ray,
        "cam_quats": cam_quats,
        "cam_trans": cam_trans,
        "metric_scaling_factor": torch.ones((b,), dtype=torch.float32,
                                            device=dev),
        "conf": conf,
        "non_ambiguous_mask": mask,
        "non_ambiguous_mask_logits": torch.where(mask, 10.0, -10.0),
    }


def _identity_poses(b: int, v: int, dev) -> tuple:
    """(B, V, 4) identity xyzw quaternions and (B, V, 3) zero translations."""
    quats = torch.zeros((b, v, 4), dtype=torch.float32, device=dev)
    quats[..., 3] = 1.0
    return quats, torch.zeros((b, v, 3), dtype=torch.float32, device=dev)


def _denormalize_images(views: Dict[str, torch.Tensor],
                        data_norm_type: str) -> torch.Tensor:
    """(B, V, H, W, 3) normalised images -> [0, 1] fp32 on their device:
    img * std + mean, clipped (data/image.py::rgb's arithmetic)."""
    img = views["img"].float()
    mean, std = (torch.as_tensor(np.asarray(x, np.float32), device=img.device)
                 for x in IMAGE_NORMALIZATION_DICT[data_norm_type])
    return (img * std + mean).clamp(0.0, 1.0)


def _factored_from_posed_depth(K, cam_quats, cam_trans, depth_z, conf=None):
    """(K, cam2world, z-depth) per view -> the factored keys, on their
    device: camera pointmaps from z-depth and K, depth along the ray, unit
    rays, world pointmaps by the factored recombination (the conversion
    every DUSt3R-lineage reference wrapper repeats,
    models/external/dust3r/__init__.py:170-218).

    K (B, V, 3, 3); cam_quats (B, V, 4) xyzw and cam_trans (B, V, 3),
    cam2world; depth_z (B, V, H, W); conf (B, V, H, W), ones when None.
    """
    b, v, h, w = depth_z.shape
    pts3d_cam, _ = depthmap_to_camera_frame(depth_z, K)
    depth_along_ray = convert_z_depth_to_depth_along_ray(depth_z, K)[..., None]
    _, rays = get_rays_in_camera_frame(K, h, w, normalize_to_unit_sphere=True)
    pts3d = convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap(
        rays, depth_along_ray, cam_trans, cam_quats)
    if conf is None:
        conf = torch.ones((b, v, h, w), dtype=torch.float32,
                          device=depth_z.device)
    return _factored(pts3d, pts3d_cam, rays, depth_along_ray, cam_quats,
                     cam_trans, conf)


class ModularDUSt3RAdapter(nn.Module):
    """ModularDUSt3R -> the factored contract, as the reference's
    DUSt3R-lineage wrappers derive it
    (models/external/dust3r/__init__.py:182-218):

      * view 1: its pointmap is its camera-frame pointmap (identity pose);
      * view 2: the swapped pair gives view 2's own camera-frame pointmap;
        its pose is the confidence-weighted rigid registration of that
        pointmap onto view 2's pointmap in view 1's frame, on the device;
      * rays and depth along the ray from the camera-frame pointmaps;
      * metric_scaling_factor 1 (DUSt3R's geometry has no metric scale).

    `model` is a ModularDUSt3R, or anything called as
    model({"img": (B, 2, H, W, 3)}) -> {"pts3d", "conf"}.
    """

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, views: Dict[str, torch.Tensor], geom_cfg=None,
                memory_efficient: bool = False) -> Dict[str, torch.Tensor]:
        del geom_cfg, memory_efficient  # an images-only, 2-view model
        imgs = views["img"]
        b, v, h, w, _ = imgs.shape
        if v != 2:
            raise ValueError(
                f"ModularDUSt3RAdapter adapts the 2-view model, got {v} views")
        fwd = self.model({"img": imgs})
        swapped = self.model({"img": imgs.flip(1)})

        pts_v1 = fwd["pts3d"]  # (B, 2, H, W, 3), both in view 1's frame
        conf = fwd["conf"]  # (B, 2, H, W)
        pts2_cam = swapped["pts3d"][:, 0]  # view 2 in its own frame
        # cam2world of view 2 (world = view 1's frame): the transform that
        # takes view 2's own pointmap onto its prediction in view 1's frame
        weights = (conf[:, 1] * swapped["conf"][:, 0]).reshape(b, h * w)
        r, t = rigid_points_registration(
            pts2_cam.reshape(b, h * w, 3), pts_v1[:, 1].reshape(b, h * w, 3),
            weights=weights)

        dt, dev = pts_v1.dtype, pts_v1.device
        identity_q = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dt,
                                  device=dev).expand(b, 4)
        pts_cam = torch.stack([pts_v1[:, 0], pts2_cam], dim=1)
        rays, depth = _rays_depth_from_cam_points(pts_cam)
        return _factored(
            pts_v1, pts_cam, rays, depth,
            torch.stack([identity_q, rotation_matrix_to_quaternion(r)], dim=1),
            torch.stack([torch.zeros((b, 3), dtype=dt, device=dev), t], dim=1),
            conf)


class MapAnythingAdapter(nn.Module):
    """MapAnything speaks the contract already; this wrapper lets tooling
    treat every model alike, and maps geom_cfg=None to the model's
    default."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, views, geom_cfg=None, memory_efficient: bool = False):
        kw = {} if geom_cfg is None else {"geom_cfg": geom_cfg}
        return self.model(views, memory_efficient=memory_efficient, **kw)


# ---------------------------------------------------------------------------
# Foreign torch modules (the reference's vendored VGGT, Pi3, MoGe)


class _ModuleAdapter(nn.Module):
    """Holds a constructed foreign module; the images reach it in [0, 1]
    (the foreign models apply their own normalisation), on its device."""

    def __init__(self, model: nn.Module, data_norm_type: str = "dinov2"):
        super().__init__()
        self.model = model
        self.data_norm_type = data_norm_type


class VGGTAdapter(_ModuleAdapter):
    """VGGT -> the factored contract, as the reference's VGGTWrapper
    (models/external/vggt/__init__.py:82-190).

    `model` is a constructed VGGT (the reference's vendored
    `mapanything.models.external.vggt.models.vggt.VGGT`, or the same
    architecture from `VGGT.from_pretrained("facebook/VGGT-1B")`), or
    anything with its three parts: `aggregator(images (B, V, 3, H, W) in
    [0, 1]) -> (tokens, patch_start_idx)`, `camera_head(tokens)[-1] ->
    (B, V, 9)` and `depth_head(tokens, images, patch_start_idx) -> (depth
    (B, V, H, W, 1), conf (B, V, H, W))`.

      * the pose encoding [t, xyzw quat, fov_h, fov_w] is cam-from-world
        (vggt pose_enc.py:108-130): inverted to cam2world; fx from fov_w,
        fy from fov_h, the principal point at the centre;
      * the z-depth through `_factored_from_posed_depth`, with the depth
        head's confidence.
    """

    def forward(self, views: Dict[str, torch.Tensor], geom_cfg=None,
                memory_efficient: bool = False) -> Dict[str, torch.Tensor]:
        del geom_cfg, memory_efficient
        imgs = _denormalize_images(views, self.data_norm_type)
        b, v, h, w, _ = imgs.shape
        imgs = imgs.permute(0, 1, 4, 2, 3).contiguous()  # (B, V, 3, H, W)
        self.model.eval()
        with torch.no_grad():
            tokens, ps_idx = self.model.aggregator(imgs)
            pose_enc = self.model.camera_head(tokens)[-1].float()
            depth, conf = self.model.depth_head(tokens, imgs, ps_idx)

        fov_h, fov_w = pose_enc[..., 7], pose_enc[..., 8]
        K = torch.zeros((b, v, 3, 3), dtype=torch.float32, device=imgs.device)
        K[..., 0, 0] = (w / 2.0) / torch.tan(fov_w / 2.0)
        K[..., 1, 1] = (h / 2.0) / torch.tan(fov_h / 2.0)
        K[..., 0, 2] = w / 2
        K[..., 1, 2] = h / 2
        K[..., 2, 2] = 1.0
        c2w = closed_form_pose_inverse(
            pose_quats_trans_to_matrix(pose_enc[..., 3:7], pose_enc[..., :3]))
        return _factored_from_posed_depth(
            K, rotation_matrix_to_quaternion(c2w[..., :3, :3]),
            c2w[..., :3, 3], depth[..., 0].float(), conf=conf.float())


class Pi3Adapter(_ModuleAdapter):
    """Pi3 -> the factored contract, as the reference's Pi3Wrapper
    (models/external/pi3/__init__.py:57-135).

    `model` is a constructed Pi3 (the reference's vendored
    `mapanything.models.external.pi3.models.pi3.Pi3`, or
    `Pi3.from_pretrained("yyfz233/Pi3")`), or anything called as
    model(images (B, V, 3, H, W) in [0, 1]) -> {"points", "local_points"
    (B, V, H, W, 3), "conf" (B, V, H, W, 1), "camera_poses" (B, V, 4, 4)}:

      * `camera_poses` are cam2world, read off directly;
      * `local_points` are the camera-frame pointmaps: depth along the ray
        is their norm, the rays their directions;
      * `points` are the world pointmaps;
      * metric_scaling_factor 1 (Pi3's geometry has no metric scale).
    """

    def forward(self, views: Dict[str, torch.Tensor], geom_cfg=None,
                memory_efficient: bool = False) -> Dict[str, torch.Tensor]:
        del geom_cfg, memory_efficient
        imgs = _denormalize_images(views, self.data_norm_type)
        self.model.eval()
        with torch.no_grad():
            res = self.model(imgs.permute(0, 1, 4, 2, 3).contiguous())
        pts_cam = res["local_points"].float()
        c2w = res["camera_poses"].float()
        rays, depth = _rays_depth_from_cam_points(pts_cam)
        return _factored(res["points"].float(), pts_cam, rays, depth,
                         rotation_matrix_to_quaternion(c2w[..., :3, :3]),
                         c2w[..., :3, 3], res["conf"][..., 0].float())


class MoGeAdapter(_ModuleAdapter):
    """MoGe v1/v2 (monocular) -> the factored contract, as the reference's
    MoGeWrapper (models/external/moge/__init__.py:64-127).

    `model` is a constructed MoGeModel (the reference's vendored
    `mapanything.models.external.moge.models.v2.MoGeModel`, or v1), or
    anything with `infer(image (B, 3, H, W) in [0, 1], num_tokens,
    apply_mask, use_fp16) -> {"points" (B, H, W, 3)[, "mask" (B, H, W)]}`.
    It runs once per view with num_tokens = max((H // 14) * (W // 14), 4):
    the reference asserts V == 1, and each view here gets that single-view
    answer, an identity pose with pts3d == pts3d_cam (so single-view depth
    evaluation works at any V; no multi-view alignment is claimed).

      * rays and depth along the ray from the camera-frame points;
      * non_ambiguous_mask from the model's mask (> 0.5) when it has one;
      * conf 1, metric_scaling_factor 1 (MoGe-2's metric scale is not
        consumed, as in the reference).
    """

    def forward(self, views: Dict[str, torch.Tensor], geom_cfg=None,
                memory_efficient: bool = False) -> Dict[str, torch.Tensor]:
        del geom_cfg, memory_efficient
        imgs = _denormalize_images(views, self.data_norm_type)
        b, v, h, w, _ = imgs.shape
        dev = imgs.device
        num_tokens = max((h // 14) * (w // 14), 4)
        pts, masks = [], []
        self.model.eval()
        with torch.no_grad():
            for view in range(v):
                out = self.model.infer(
                    image=imgs[:, view].permute(0, 3, 1, 2).contiguous(),
                    num_tokens=num_tokens, apply_mask=False, use_fp16=False)
                pts.append(out["points"].float())
                masks.append(out["mask"].float() > 0.5 if "mask" in out
                             else torch.ones((b, h, w), dtype=torch.bool,
                                             device=dev))
        pts_cam = torch.stack(pts, dim=1)  # (B, V, H, W, 3)
        rays, depth = _rays_depth_from_cam_points(pts_cam)
        quats, trans = _identity_poses(b, v, dev)
        return _factored(pts_cam, pts_cam, rays, depth, quats, trans,
                         torch.ones((b, v, h, w), dtype=torch.float32,
                                    device=dev),
                         torch.stack(masks, dim=1))


# ---------------------------------------------------------------------------
# Host callables (the pip pipelines)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _dust3r_normalized(imgs01: np.ndarray) -> np.ndarray:
    """(N, H, W, 3) [0, 1] images in the DUSt3R family's input
    normalisation, as (N, 3, H, W)."""
    mean, std = IMAGE_NORMALIZATION_DICT["dust3r"]
    return np.ascontiguousarray(((imgs01 - mean) / std).transpose(0, 3, 1, 2))


class _HostPipelineAdapter:
    """The callable adapters' device and conversions: the views'
    normalisation undone on their device, one copy of the images to the
    host for the callable, one copy of each of its arrays to `device`."""

    def __init__(self, data_norm_type: str = "dinov2", device=None):
        self.data_norm_type = data_norm_type
        self.device = resolve_device(device)

    def _images01(self, views: Dict[str, torch.Tensor]) -> np.ndarray:
        return _host(_denormalize_images(views, self.data_norm_type))

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)


class PosedDepthAdapter(_HostPipelineAdapter):
    """A host scene pipeline emitting (K, cam2world, z-depth) -> the
    contract. DUSt3R's pairwise inference with its global aligner and
    MASt3R's sparse global alignment both end in this per-view triple
    (reference dust3r/__init__.py:166-169, mast3r/__init__.py:141-144);
    the conversion after it is shared, `_factored_from_posed_depth`.

    Args:
        scene_fn: `(imgs01 (B, V, H, W, 3) numpy in [0, 1]) -> (K (B, V, 3,
            3), c2w (B, V, 4, 4), depth_z (B, V, H, W))` numpy arrays; the
            builders make it around the pip packages, the tests pass fakes.
        data_norm_type: the normalisation baked into views["img"], undone
            before scene_fn (the pipelines normalise for themselves).
        device: where the conversion runs; the card when None.
    """

    def __init__(self, scene_fn, data_norm_type: str = "dinov2", device=None):
        super().__init__(data_norm_type, device)
        self.scene_fn = scene_fn

    def __call__(self, views: Dict[str, torch.Tensor], geom_cfg=None,
                 memory_efficient: bool = False) -> Dict[str, torch.Tensor]:
        del geom_cfg, memory_efficient
        K, c2w, depth_z = map(self._tensor, self.scene_fn(
            self._images01(views)))
        return _factored_from_posed_depth(
            K, rotation_matrix_to_quaternion(c2w[..., :3, :3]),
            c2w[..., :3, 3], depth_z)


class DUSt3RAdapter(PosedDepthAdapter):
    """DUSt3R with its global aligner (pip `dust3r`) -> the contract, as the
    reference's DUSt3RBAWrapper (models/external/dust3r/__init__.py:
    69-222): pairwise inference over a scene graph, PointCloud global
    alignment, then (K, poses, depths)."""

    @classmethod
    def from_pip(cls, ckpt_path: str, scene_graph: str = "complete",
                 inference_batch_size: int = 32, niter: int = 300,
                 lr: float = 0.01, schedule: str = "cosine", device=None,
                 **kw):
        from dust3r.cloud_opt import GlobalAlignerMode, global_aligner
        from dust3r.image_pairs import make_pairs
        from dust3r.inference import inference
        from dust3r.model import AsymmetricCroCo3DStereo

        device = resolve_device(device)
        ckpt = torch.load(ckpt_path, map_location=device, weights_only=False)
        if isinstance(ckpt, dict) and "model" in ckpt:
            net = eval(  # noqa: S307  (the reference loads args the same way)
                ckpt["args"].model.replace("ManyAR_PatchEmbed",
                                           "PatchEmbedDust3R"))
            net.load_state_dict(ckpt["model"], strict=False)
        else:
            net = AsymmetricCroCo3DStereo.from_pretrained(ckpt_path)
        net = net.to(device)

        def scene_fn(imgs01):
            b, v, h, w, _ = imgs01.shape
            if b != 1:
                raise ValueError("global alignment runs one scene at a time")
            # the harnesses run under inference mode, which enable_grad does
            # not lift: the alignment's tensors are made outside it
            with torch.inference_mode(False):
                normed = torch.from_numpy(_dust3r_normalized(imgs01[0]))
                images = [{"img": normed[i:i + 1].float(), "idx": i,
                           "instance": str(i)} for i in range(v)]
                pairs = make_pairs(images, scene_graph=scene_graph,
                                   prefilter=None, symmetrize=True)
                out = inference(pairs, net, device,
                                batch_size=inference_batch_size,
                                verbose=False)
                with torch.enable_grad():
                    scene = global_aligner(
                        out, device=device,
                        mode=GlobalAlignerMode.PointCloudOptimizer,
                        verbose=False)
                    scene.compute_global_alignment(
                        init="mst", niter=niter, schedule=schedule, lr=lr)
                K = _host(scene.get_intrinsics())[None]
                c2w = _host(scene.get_im_poses())[None]
                depths = _host(torch.stack(
                    [d.reshape(h, w) for d in scene.get_depthmaps()]))[None]
            return K, c2w, depths

        return cls(scene_fn, device=device, **kw)


class MASt3RAdapter(PosedDepthAdapter):
    """MASt3R with sparse global alignment (pip `mast3r`) -> the contract,
    as the reference's MASt3RSGAWrapper (models/external/mast3r/
    __init__.py:28-196): matching-based sparse GA over pairs, then
    (scene.intrinsics, get_im_poses, get_dense_pts3d depths)."""

    @classmethod
    def from_pip(cls, ckpt_path: str, cache_dir: str,
                 scene_graph: str = "complete", lr1: float = 0.07,
                 niter1: int = 300, lr2: float = 0.01, niter2: int = 300,
                 optim_level: str = "refine+depth",
                 shared_intrinsics: bool = False,
                 matching_conf_thr: float = 5.0, device=None, **kw):
        from mast3r.cloud_opt.sparse_ga import sparse_global_alignment
        from mast3r.model import load_model
        from dust3r.image_pairs import make_pairs  # mast3r's dependency

        device = resolve_device(device)
        net = load_model(ckpt_path, device=device)

        def scene_fn(imgs01):
            b, v, h, w, _ = imgs01.shape
            if b != 1:
                raise ValueError("sparse GA runs one scene at a time")
            with torch.inference_mode(False):  # as DUSt3RAdapter's
                normed = torch.from_numpy(_dust3r_normalized(imgs01[0]))
                images = [{"img": normed[i:i + 1].float(), "idx": i,
                           "instance": str(i),
                           "true_shape": np.int32([[h, w]])}
                          for i in range(v)]
                paths = [f"scene/view_{i}" for i in range(v)]
                pairs = make_pairs(images, scene_graph=scene_graph,
                                   prefilter=None, symmetrize=True)
                with torch.enable_grad():
                    scene = sparse_global_alignment(
                        paths, pairs, cache_dir, net, lr1=lr1, niter1=niter1,
                        lr2=lr2, niter2=niter2, device=device,
                        opt_depth="depth" in optim_level,
                        shared_intrinsics=shared_intrinsics,
                        matching_conf_thr=matching_conf_thr, verbose=False)
                K = _host(scene.intrinsics)[None]
                c2w = _host(scene.get_im_poses())[None]
                _, depths, _ = scene.get_dense_pts3d()
                dz = _host(torch.stack([d.reshape(h, w) for d in depths]))
            return K, c2w, dz[None]

        return cls(scene_fn, device=device, **kw)


class MUSt3RAdapter(_HostPipelineAdapter):
    """MUSt3R's multi-view streaming model (pip `must3r`) -> the contract,
    as the reference's MUSt3RWrapper (models/external/must3r/
    __init__.py:163-288): keyframed streaming inference gives per view
    {pts3d, pts3d_local, conf, c2w}; depth along the ray is the local
    pointmap's norm, the rays its direction (:264-270).

    Args:
        scene_fn: `(imgs01 (B, V, H, W, 3)) -> list[V] of dicts` of numpy
            "pts3d" (B, H, W, 3), "pts3d_local" (B, H, W, 3), "conf" (B, H,
            W) and "c2w" (B, 4, 4).
        data_norm_type, device: as PosedDepthAdapter's.
    """

    def __init__(self, scene_fn, data_norm_type: str = "dinov2", device=None):
        super().__init__(data_norm_type, device)
        self.scene_fn = scene_fn

    @classmethod
    def from_pip(cls, ckpt_path: str, retrieval_ckpt_path: str = None,
                 img_size: int = 512, max_bs: int = 1, device=None, **kw):
        from must3r.engine.inference import inference_multi_ar
        from must3r.model import load_model

        del max_bs, retrieval_ckpt_path  # the reference wrapper's knobs
        device = resolve_device(device)
        net = load_model(ckpt_path, img_size=img_size)
        encoder, decoder = net if isinstance(net, tuple) else (net, None)
        encoder = encoder.to(device)
        decoder = None if decoder is None else decoder.to(device)

        def scene_fn(imgs01):
            b, v, h, w, _ = imgs01.shape
            if b != 1:
                raise ValueError(
                    "streaming inference runs one scene at a time")
            normed = torch.from_numpy(_dust3r_normalized(imgs01[0]))
            imgs = [normed[i:i + 1].float().to(device) for i in range(v)]
            true_shape = [torch.tensor([[h, w]]) for _ in range(v)]
            img_ids = [torch.tensor(i) for i in range(v)]
            x0, x_out = inference_multi_ar(
                encoder, decoder, imgs, img_ids, true_shape,
                mem_batches=[v], verbose=False)
            return [{
                "pts3d": _host(o["pts3d"]).reshape(1, h, w, 3),
                "pts3d_local": _host(o["pts3d_local"]).reshape(1, h, w, 3),
                "conf": _host(o["conf"]).reshape(1, h, w),
                "c2w": _host(o["c2w"])[None],
            } for o in (x0 or x_out)]

        return cls(scene_fn, device=device, **kw)

    def __call__(self, views: Dict[str, torch.Tensor], geom_cfg=None,
                 memory_efficient: bool = False) -> Dict[str, torch.Tensor]:
        del geom_cfg, memory_efficient
        per_view = self.scene_fn(self._images01(views))
        if len(per_view) != views["img"].shape[1]:
            raise ValueError(f"scene_fn returned {len(per_view)} views for "
                             f"{views['img'].shape[1]}")

        def stacked(key):
            return self._tensor(np.stack([o[key] for o in per_view], 1))

        pts_cam, c2w = stacked("pts3d_local"), stacked("c2w")
        rays, depth = _rays_depth_from_cam_points(pts_cam)
        return _factored(stacked("pts3d"), pts_cam, rays, depth,
                         rotation_matrix_to_quaternion(c2w[..., :3, :3]),
                         c2w[..., :3, 3], stacked("conf"))


class Pow3RAdapter(_HostPipelineAdapter):
    """Pow3R's 2-view model with optional geometric priors -> the contract,
    as the reference's Pow3RWrapper (models/external/pow3r/
    __init__.py:426-578): the priors (intrinsics, z-depth, cam2world) reach
    the network gated by a GeometricInputConfig's probabilities, view 1 is
    the world frame, and view 2's pose and scale come from the
    confidence-weighted Umeyama registration of its own-frame pointmap onto
    its prediction in view 1's frame (:545-560), on the device.

    Args:
        pair_fn: `(view1, view2) -> (pred1, pred2)` on the host; each view
            dict carries numpy "img" (B, H, W, 3) in [0, 1] and the priors
            its gate admitted: "camera_intrinsics" (B, 3, 3), "depthmap"
            (B, H, W, 1) z-depth, "camera_pose" (B, 4, 4) cam2world. pred1
            has "pts3d" (B, H, W, 3) and "conf" (B, H, W); pred2
            "pts3d_in_other_view", "pts3d2", "conf" and "conf2" (the
            network's own output names).
        geom_cfg: the gates' probabilities (all 1 when None); a call with a
            geom_cfg replaces it for later calls.
        seed: the gates' numpy generator. Each gate draws before it tests
            its keys, and a failed overall gate ends the view's draws, as
            in the JAX package, so a seed admits the same priors there.
        data_norm_type, device: as PosedDepthAdapter's.
    """

    def __init__(self, pair_fn, data_norm_type: str = "dinov2",
                 geom_cfg: Optional[GeometricInputConfig] = None,
                 seed: int = 0, device=None):
        super().__init__(data_norm_type, device)
        self.pair_fn = pair_fn
        self.geom_cfg = geom_cfg or GeometricInputConfig()
        self._rng = np.random.default_rng(seed)

    def _gated_priors(self, views: Dict[str, torch.Tensor],
                      view_idx: int) -> Dict[str, np.ndarray]:
        """One view's priors for pair_fn, each admitted by its gate."""
        g, out = self.geom_cfg, {}
        if self._rng.random() >= g.overall_prob:
            return out
        if self._rng.random() < g.ray_dirs_prob and \
                "ray_directions_cam" in views:
            out["camera_intrinsics"] = _host(
                recover_pinhole_intrinsics_from_ray_directions(
                    views["ray_directions_cam"][:, view_idx]))
        if (self._rng.random() < g.depth_prob
                and "depth_along_ray" in views
                and "ray_directions_cam" in views):
            # Pow3R takes z-depth: without the rays the depth along them
            # cannot be converted, so the depth prior needs calibration
            out["depthmap"] = _host(
                views["depth_along_ray"][:, view_idx]
                * views["ray_directions_cam"][:, view_idx, ..., 2:3])
        if self._rng.random() < g.cam_prob and "camera_pose_quats" in views:
            out["camera_pose"] = _host(pose_quats_trans_to_matrix(
                views["camera_pose_quats"][:, view_idx],
                views["camera_pose_trans"][:, view_idx]))
        return out

    def __call__(self, views: Dict[str, torch.Tensor], geom_cfg=None,
                 memory_efficient: bool = False) -> Dict[str, torch.Tensor]:
        del memory_efficient
        if geom_cfg is not None:
            self.geom_cfg = geom_cfg
        imgs01 = self._images01(views)
        b, v, h, w, _ = imgs01.shape
        if v != 2:
            raise ValueError(f"Pow3R is a 2-view model, got {v} views")
        view1 = {"img": imgs01[:, 0], **self._gated_priors(views, 0)}
        view2 = {"img": imgs01[:, 1], **self._gated_priors(views, 1)}
        pred1, pred2 = self.pair_fn(view1, view2)

        pts1, conf1 = self._tensor(pred1["pts3d"]), self._tensor(pred1["conf"])
        pts2_in1 = self._tensor(pred2["pts3d_in_other_view"])
        pts2_cam = self._tensor(pred2["pts3d2"])
        conf2 = torch.sqrt(self._tensor(pred2["conf"])
                           * self._tensor(pred2["conf2"]))
        # view 2's pose and scale: Umeyama from its own-frame points onto
        # its prediction in view 1's frame (reference pow3r :545-552)
        r, t, s = rigid_points_registration(
            pts2_cam.reshape(b, h * w, 3), pts2_in1.reshape(b, h * w, 3),
            weights=conf2.reshape(b, h * w), with_scale=True)
        pts2_cam = s[:, None, None, None] * pts2_cam
        pts2_world = rotate(r[:, None, None], pts2_cam) + t[:, None, None]

        identity_q, zeros = _identity_poses(b, 1, pts1.device)
        pts_cam = torch.stack([pts1, pts2_cam], dim=1)
        rays, depth = _rays_depth_from_cam_points(pts_cam)
        return _factored(
            torch.stack([pts1, pts2_world], dim=1), pts_cam, rays, depth,
            torch.cat([identity_q, rotation_matrix_to_quaternion(r)[:, None]],
                      dim=1),
            torch.cat([zeros, t[:, None]], dim=1),
            torch.stack([conf1, conf2], dim=1))


class AnyCalibAdapter(_HostPipelineAdapter):
    """AnyCalib's single-view calibration (pip `anycalib`) -> rays and K, as
    the reference's AnyCalibWrapper (models/external/anycalib/__init__.py:
    16-100): a pinhole (fx, fy, cx, cy) for view 0, its unit rays and 3x3
    K, as {"ray_directions": (B, 1, H, W, 3), "intrinsics": (B, 1, 3, 3)},
    the surface benchmarks/calibration.py reads.

    Args:
        calib_fn: `(imgs01 (B, H, W, 3) numpy in [0, 1]) -> (B, 4) numpy
            [fx, fy, cx, cy]`.
        data_norm_type, device: as PosedDepthAdapter's.
    """

    def __init__(self, calib_fn, data_norm_type: str = "dinov2", device=None):
        super().__init__(data_norm_type, device)
        self.calib_fn = calib_fn

    @classmethod
    def from_pip(cls, model_id: str = "anycalib_pinhole", device=None, **kw):
        from anycalib import AnyCalib

        device = resolve_device(device)
        net = AnyCalib(model_id=model_id).to(device)

        def calib_fn(imgs01):
            t_imgs = torch.from_numpy(np.ascontiguousarray(
                imgs01.transpose(0, 3, 1, 2))).to(device)
            out = net.predict(t_imgs, cam_id="pinhole")
            return np.stack([_host(torch.as_tensor(i).float())
                             for i in out["intrinsics"]])

        return cls(calib_fn, device=device, **kw)

    def __call__(self, views: Dict[str, torch.Tensor], geom_cfg=None,
                 memory_efficient: bool = False) -> Dict[str, torch.Tensor]:
        del geom_cfg, memory_efficient
        imgs01 = self._images01(views)
        b, v, h, w, _ = imgs01.shape
        fxyc = self._tensor(self.calib_fn(imgs01[:, 0]))  # (B, 4)
        K = torch.zeros((b, 3, 3), dtype=torch.float32, device=self.device)
        K[:, 0, 0], K[:, 1, 1] = fxyc[:, 0], fxyc[:, 1]
        K[:, 0, 2], K[:, 1, 2] = fxyc[:, 2], fxyc[:, 3]
        K[:, 2, 2] = 1.0
        _, rays = get_rays_in_camera_frame(K, h, w,
                                           normalize_to_unit_sphere=True)
        # the view axis kept: the calibration benchmark's [:, :1] slice is
        # then a no-op for this single-view model
        return {"ray_directions": rays[:, None], "intrinsics": K[:, None]}


__all__ = [
    "FACTORED_PRED_KEYS",
    "AnyCalibAdapter",
    "DUSt3RAdapter",
    "MASt3RAdapter",
    "MUSt3RAdapter",
    "MapAnythingAdapter",
    "MoGeAdapter",
    "ModularDUSt3RAdapter",
    "Pi3Adapter",
    "PosedDepthAdapter",
    "Pow3RAdapter",
    "VGGTAdapter",
]
