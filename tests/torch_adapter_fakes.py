"""Interface fakes of the foreign models behind models/adapters.py. No JAX:
`chip_smoke.py` phase 17 runs them on the card too, and the CPU tests hand
each one, unchanged, to the JAX package's adapter and the port's.

No VGGT, Pi3, MoGe, DUSt3R, MASt3R, MUSt3R, Pow3R or AnyCalib checkpoint or
package is in the repository, so each adapter is held through a stand-in of
its model's interface:

  * torch modules, seeded (on the CPU: move them with .to(device), so the
    card and the CPU hold the same weights), fp32 or bf16:
    - `VGGTStandIn`: VGGT's aggregator / camera_head / depth_head; the
      aggregator is the port's `nn/layers.py::Block`s alternating over each
      frame's patch tokens and over all views' (at VGGT-1B's attention
      width, dim 1024 and 16 heads of 64, it runs the port's flash kernel
      on the card);
    - `Pi3StandIn`: Pi3's forward (points, local points, conf, cam2world);
    - `MoGeStandIn`: MoGe's `infer` (points and a mask), picklable, the
      file `convert_dataset --pseudo-depth` loads;
  * host callables with the pip pipelines' numpy contracts, exact on a
    synthetic batch's ground truth (`make_synthetic_batch`): a posed-depth
    scene (DUSt3R / MASt3R), one that fits a scale under enable_grad as the
    global aligners do, a MUSt3R scene, a Pow3R pair with a wrong scale on
    view 2's own points, an AnyCalib calibration.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mapanything_tpu_torch.geometry import (
    closed_form_pose_inverse,
    pose_quats_trans_to_matrix,
)
from mapanything_tpu_torch.geometry.quats import rotate
from mapanything_tpu_torch.nn.layers import Block, Conv2d, Dense, init_weights_

PATCH = 14
ALIGN_STEPS = 8  # aligning_scene_fn's Adam steps
POW3R_SCALE = 0.5  # the scale error on view 2's own points


def _pinhole_dirs(h: int, w: int, device) -> torch.Tensor:
    """(H, W, 3) rays scaled to z = 1 through the synthetic batch's K
    (focal 0.8 max(H, W), centre (W / 2, H / 2))."""
    f = 0.8 * max(h, w)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([(xs - w / 2) / f, (ys - h / 2) / f,
                        torch.ones_like(xs)], -1)


def _pose(raw: torch.Tensor) -> torch.Tensor:
    """(..., 7) raw -> (..., 4, 4) near-identity poses: translation 0.1 x
    raw[:3], the rotation of the unit xyzw quaternion raw[3:7] + (0, 0, 0, 4)."""
    quat = raw[..., 3:7] + raw.new_tensor([0.0, 0.0, 0.0, 4.0])
    return pose_quats_trans_to_matrix(F.normalize(quat, dim=-1),
                                      0.1 * raw[..., :3])


class _Aggregator(nn.Module):
    """A 14 x 14 patch conv, then `pairs` x (a frame Block on each view's
    tokens, a global Block on all views' tokens); returns the tokens after
    each pair, (B, V, P, dim) each, and the patch start index 0."""

    def __init__(self, dim, heads, pairs, dtype):
        super().__init__()
        self.patch_embed = Conv2d(3, dim, PATCH, stride=PATCH, dtype=dtype)
        self.frame_blocks = nn.ModuleList(
            Block(dim, heads, dtype=dtype) for _ in range(pairs))
        self.global_blocks = nn.ModuleList(
            Block(dim, heads, dtype=dtype) for _ in range(pairs))

    def forward(self, images: torch.Tensor):
        b, v = images.shape[:2]
        x = self.patch_embed(images.flatten(0, 1))  # (B V, dim, gh, gw)
        x = x.flatten(2).transpose(1, 2)  # (B V, P, dim)
        p, dim = x.shape[1:]
        out = []
        for frame, glob in zip(self.frame_blocks, self.global_blocks):
            x = frame(x)
            x = glob(x.reshape(b, v * p, dim)).reshape(b * v, p, dim)
            out.append(x.reshape(b, v, p, dim))
        return out, 0


class _CameraHead(nn.Module):
    """Mean-pooled last tokens -> VGGT's pose encoding [t (3), xyzw quat
    (4), fov_h, fov_w], cam-from-world, as a one-element list."""

    def __init__(self, dim):
        super().__init__()
        self.fc = Dense(dim, 9)

    def forward(self, tokens):
        raw = self.fc(tokens[-1].float().mean(2))  # (B, V, 9)
        quat = F.normalize(raw[..., 3:7] + raw.new_tensor([0, 0, 0, 4.0]),
                           dim=-1)
        fov = 1.0 + 0.2 * torch.tanh(raw[..., 7:9])
        return [torch.cat([0.1 * raw[..., :3], quat, fov], -1)]


class _DepthHead(nn.Module):
    """Last tokens -> per-pixel z-depth in (1, 3) (B, V, H, W, 1) and
    confidence 1 + exp (B, V, H, W): a linear map of each token to its
    14 x 14 patch's two channels."""

    def __init__(self, dim):
        super().__init__()
        self.fc = Dense(dim, 2 * PATCH * PATCH)

    def forward(self, tokens, images, patch_start_idx):
        b, v, _, h, w = images.shape
        x = self.fc(tokens[-1][:, :, patch_start_idx:])  # (B, V, P, 2 p p)
        x = x.reshape(b, v, h // PATCH, w // PATCH, PATCH, PATCH, 2)
        x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, v, h, w, 2)
        return 2.0 + torch.tanh(x[..., :1]), 1.0 + torch.exp(x[..., 1])


class VGGTStandIn(nn.Module):
    """VGGT's interface (`aggregator`, `camera_head`, `depth_head`) over
    images (B, V, 3, H, W) in [0, 1], H and W multiples of 14. The blocks
    compute in `dtype`; the heads in fp32. Weights N(0, 0.02) from seed 0
    (nn/layers.py::init_weights_)."""

    def __init__(self, dim: int = 64, heads: int = 2, pairs: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.aggregator = _Aggregator(dim, heads, pairs, dtype)
        self.camera_head = _CameraHead(dim)
        self.depth_head = _DepthHead(dim)
        init_weights_(self, torch.Generator().manual_seed(0))

    def set_attn_impl(self, impl: str) -> None:
        """Every block's attention path (ops/attention.py::sdpa)."""
        for mod in self.modules():
            if hasattr(mod, "attn_impl"):
                mod.attn_impl = impl


class Pi3StandIn(nn.Module):
    """Pi3's interface: model(images (B, V, 3, H, W) in [0, 1]) ->
    {"points", "local_points" (B, V, H, W, 3), "conf" (B, V, H, W, 1),
    "camera_poses" (B, V, 4, 4) cam2world}. A 3 x 3 conv gives each pixel
    a z-depth in (1, 3) along the synthetic K's ray and a confidence; the
    pooled conv output gives each view a pose; points = pose(local)."""

    def __init__(self):
        super().__init__()
        self.conv = Conv2d(3, 4, 3, padding=1)
        self.pose = Dense(4, 7)
        init_weights_(self, torch.Generator().manual_seed(0), std=0.2)

    def forward(self, images: torch.Tensor) -> dict:
        b, v, _, h, w = images.shape
        f = self.conv(images.flatten(0, 1))  # (B V, 4, H, W)
        f = f.permute(0, 2, 3, 1).reshape(b, v, h, w, 4)
        local = (2.0 + torch.tanh(f[..., :1])) * _pinhole_dirs(h, w,
                                                               f.device)
        c2w = _pose(self.pose(f.mean((2, 3))))  # (B, V, 4, 4)
        points = (rotate(c2w[:, :, None, None, :3, :3], local)
                  + c2w[:, :, None, None, :3, 3])
        return {"points": points, "local_points": local,
                "conf": 1.0 + torch.exp(f[..., 1:2]), "camera_poses": c2w}


class MoGeStandIn(nn.Module):
    """MoGe's interface: infer(image (B, 3, H, W) in [0, 1], num_tokens,
    apply_mask, use_fp16) -> {"points" (B, H, W, 3), "mask" (B, H, W)}:
    camera-frame points at a z-depth in (1, 3) from a 3 x 3 conv, along the
    synthetic K's rays; the mask's probability 0.9, or 0.1 on the two
    leftmost columns (far from the adapter's 0.5 threshold). Keeps the
    num_tokens of each call in `num_tokens_seen`. Picklable whole."""

    def __init__(self, with_mask: bool = True):
        super().__init__()
        self.conv = Conv2d(3, 1, 3, padding=1)
        self.with_mask = with_mask
        self.num_tokens_seen = []
        init_weights_(self, torch.Generator().manual_seed(0), std=0.2)

    def infer(self, image: torch.Tensor, num_tokens: int, apply_mask: bool,
              use_fp16: bool) -> dict:
        del apply_mask, use_fp16
        self.num_tokens_seen.append(num_tokens)
        b, _, h, w = image.shape
        z = 2.0 + torch.tanh(self.conv(image)[:, 0])  # (B, H, W)
        out = {"points": z[..., None] * _pinhole_dirs(h, w, z.device)}
        if self.with_mask:
            mask = torch.full_like(z, 0.9)
            mask[..., :2] = 0.1
            out["mask"] = mask
        return out

    forward = infer


# ---------------------------------------------------------------------------
# Host callables, exact on a synthetic batch's ground truth


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def gt_scene_arrays(batch) -> tuple:
    """(K (B, V, 3, 3), c2w (B, V, 4, 4), z-depth (B, V, H, W)) numpy of a
    make_synthetic_batch batch's ground truth."""
    gt = batch["gt"]
    depth_z = _np(gt["pts3d_cam"][..., 2])
    b, v, h, w = depth_z.shape
    f = 0.8 * max(h, w)  # data/synthetic.py's intrinsics
    K = np.zeros((b, v, 3, 3), np.float32)
    K[..., 0, 0] = K[..., 1, 1] = f
    K[..., 0, 2], K[..., 1, 2], K[..., 2, 2] = w / 2, h / 2, 1.0
    c2w = _np(pose_quats_trans_to_matrix(gt["camera_pose_quats"],
                                         gt["camera_pose_trans"]))
    return K, c2w, depth_z


def posed_depth_scene_fn(batch, calls: list | None = None):
    """DUSt3R's / MASt3R's scene pipeline returning the ground truth; each
    call's image shape goes to `calls`, and images outside [0, 1] raise."""
    arrays = gt_scene_arrays(batch)

    def scene_fn(imgs01):
        if not (imgs01.min() >= 0.0 and imgs01.max() <= 1.0):
            raise ValueError("scene_fn takes images in [0, 1]")
        if calls is not None:
            calls.append(imgs01.shape)
        return arrays

    return scene_fn


def aligning_scene_fn(batch, fitted: list | None = None):
    """A global-alignment-style scene pipeline: from the depth at half the
    ground truth's scale, Adam fits one scale factor under enable_grad
    (ALIGN_STEPS steps) and returns the ground truth's K with the scene at the
    fitted scale, depth and camera positions alike (as an aligner's
    scale-free answer). Like the pip builders' scene functions it leaves
    the caller's inference mode first, which enable_grad does not lift. The
    fitted factor of each call goes to `fitted`."""
    K, c2w, depth_z = gt_scene_arrays(batch)

    def scene_fn(imgs01):
        del imgs01
        with torch.inference_mode(False), torch.enable_grad():
            target = torch.from_numpy(depth_z)
            start = 0.5 * target
            scale = torch.ones((), requires_grad=True)
            opt = torch.optim.Adam([scale], lr=0.2)
            for _ in range(ALIGN_STEPS):
                opt.zero_grad()
                loss = ((scale * start - target) ** 2).mean()
                loss.backward()
                opt.step()
            depth = (scale * start).detach()
        if fitted is not None:
            fitted.append(float(scale.detach()))
        posed = c2w.copy()
        posed[..., :3, 3] *= 0.5 * float(scale.detach())
        return K, posed, depth.numpy()

    return scene_fn


def must3r_scene_fn(batch):
    """MUSt3R's streaming pipeline: per view the ground truth's pointmap,
    camera-frame pointmap, confidence 1 and cam2world."""
    gt = batch["gt"]
    _, c2w, _ = gt_scene_arrays(batch)
    pts, pts_cam = _np(gt["pts3d"]), _np(gt["pts3d_cam"])

    def scene_fn(imgs01):
        b, v, h, w, _ = imgs01.shape
        return [{"pts3d": pts[:, i], "pts3d_local": pts_cam[:, i],
                 "conf": np.ones((b, h, w), np.float32), "c2w": c2w[:, i]}
                for i in range(v)]

    return scene_fn


def pow3r_pair_fn(batch, calls: list | None = None):
    """Pow3R's pair network: both views' ground truth in view 0's frame,
    and view 2's own-frame points at POW3R_SCALE times their size (the
    adapter's Umeyama registration undoes it). Each call's two view dicts
    go to `calls`. Returns (pair_fn, w2c of view 0, c2w)."""
    gt = batch["gt"]
    _, c2w, _ = gt_scene_arrays(batch)
    w2c0 = _np(closed_form_pose_inverse(torch.from_numpy(c2w[:, 0])))
    pts_w, pts_cam = _np(gt["pts3d"]), _np(gt["pts3d_cam"])

    def to_v0(p):
        return (np.einsum("bij,bhwj->bhwi", w2c0[:, :3, :3], p)
                + w2c0[:, None, None, :3, 3])

    def pair_fn(view1, view2):
        if calls is not None:
            calls.append((dict(view1), dict(view2)))
        b, h, w, _ = view1["img"].shape
        ones = np.ones((b, h, w), np.float32)
        return ({"pts3d": to_v0(pts_w[:, 0]), "conf": ones},
                {"pts3d_in_other_view": to_v0(pts_w[:, 1]),
                 "pts3d2": POW3R_SCALE * pts_cam[:, 1], "conf": ones,
                 "conf2": ones})

    return pair_fn, w2c0, c2w


def anycalib_calib_fn(h: int, w: int):
    """AnyCalib's calibration: the synthetic batch's pinhole [fx, fy, cx,
    cy] for every image."""
    f = 0.8 * max(h, w)

    def calib_fn(imgs01):
        return np.tile(np.asarray([f, f, w / 2, h / 2], np.float32),
                       (imgs01.shape[0], 1))

    return calib_fn
