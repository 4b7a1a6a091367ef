"""The geometric priors (models/mapanything.py::fuse_geometric_priors and the
inference path around it) against the JAX package, on the CPU.

The helpers and encoders are held against their JAX functions; the whole
`InferencePipeline.infer` against JAX's on the tiny model of
tests/test_torch_model.py with intrinsics, rays, z-depth, poses and the
metric flags in several mixes. Weights are the JAX init (on views carrying
every prior) perturbed by seeded numpy noise; inputs come from seeded numpy
generators. fp32 on both sides, JAX under
`jax.default_matmul_precision("highest")`. Tolerance: 1e-4 of the
reference's largest magnitude per output (assert_close_rel); boolean masks
agree on >= 99.9% of the pixels.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu import geometry as JG
from mapanything_tpu.models import GeometricInputConfig as JaxGeomCfg
from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.models import tasks as JTasks
from mapanything_tpu.nn import encoders as JE
from mapanything_tpu.utils import inference as JI
from mapanything_tpu_torch import geometry as PG
from mapanything_tpu_torch.models import (
    MapAnything,
    MapAnythingConfig,
    aug_training_config,
    tasks as PTasks,
)
from mapanything_tpu_torch.models.mapanything import (
    check_generator,
    draw_prior_masks,
)
from mapanything_tpu_torch.nn import encoders as PE
from mapanything_tpu_torch.parallel import init_distributed
from mapanything_tpu_torch.utils import inference as PI
from mapanything_tpu_torch.utils.weights import load_jax_params
from torch_jax_init import init_params

HIGHEST = "highest"
H, W = 42, 56  # 3 x 4 patches of 14
CFG = dict(encoder_size="test", trunk_dim=128, trunk_depth=4,
           trunk_num_heads=2, trunk_indices=(1, 2), dpt_feature_dim=32,
           dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))


def assert_close_rel(out, ref, tol=1e-4, name=""):
    """max |out - ref| <= tol * max(1, max |ref|)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    assert np.isfinite(out).all(), name
    err = np.max(np.abs(out - ref))
    bound = tol * max(1.0, float(np.max(np.abs(ref))))
    assert err <= bound, f"{name}: max abs err {err:.3g} > {bound:.3g}"


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _perturb(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(x.shape))
        .astype(np.float32), params)


def _rotations(rng, n):
    """n random proper rotations (QR of normals, det +1)."""
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def _pose(rng):
    pose = np.eye(4, dtype=np.float32)[None].copy()
    pose[0, :3, :3] = _rotations(rng, 1)[0]
    pose[0, :3, 3] = rng.standard_normal(3).astype(np.float32)
    return pose


def _intrinsics(rng):
    f = rng.uniform(40, 60)
    return np.array([[[f, 0, W / 2 + rng.uniform(-2, 2)],
                      [0, f * rng.uniform(0.95, 1.05), H / 2],
                      [0, 0, 1]]], np.float32)


def _view(seed, **priors):
    rng = np.random.default_rng(seed)
    view = {"img": rng.standard_normal((1, H, W, 3)).astype(np.float32),
            "data_norm_type": ["dinov2"]}
    for key, kind in priors.items():
        if kind is True and key == "intrinsics":
            view[key] = _intrinsics(rng)
        elif kind is True and key == "camera_poses":
            view[key] = _pose(rng)
        elif kind is True and key == "depth_z":
            depth = rng.uniform(1.0, 3.0, (1, H, W, 1)).astype(np.float32)
            depth[:, :5] = 0.0  # invalid rows
            view[key] = depth
        elif kind is True and key == "ray_directions":
            _, rays = JG.get_rays_in_camera_frame(
                jnp.asarray(_intrinsics(rng)), H, W,
                normalize_to_unit_sphere=False)
            view[key] = np.asarray(rays) * 2.0  # not unit: normalised
        else:
            view[key] = kind
    return view


# --- helpers and encoders ----------------------------------------------------


def test_normalize_depth_using_non_zero_pixels():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 4, (2, 3, H, W, 1)).astype(np.float32)
    depth[0, 1] = 0.0  # an all-zero map
    depth[1, :, :7] = 0.0
    ref, ref_f = JG.normalize_depth_using_non_zero_pixels(
        jnp.asarray(depth), return_norm_factor=True)
    out, out_f = PG.normalize_depth_using_non_zero_pixels(
        torch.from_numpy(depth), return_norm_factor=True)
    assert_close_rel(_np(out), np.asarray(ref), 1e-6, "depth")
    assert_close_rel(_np(out_f), np.asarray(ref_f), 1e-6, "factor")


def test_normalize_pose_translations():
    rng = np.random.default_rng(1)
    trans = rng.standard_normal((2, 5, 3)).astype(np.float32)
    trans[:, 0] = 0.0  # view 0 relative to itself
    ref, ref_f = JG.normalize_pose_translations(jnp.asarray(trans),
                                                return_norm_factor=True)
    out, out_f = PG.normalize_pose_translations(torch.from_numpy(trans),
                                                return_norm_factor=True)
    assert_close_rel(_np(out), np.asarray(ref), 1e-6, "trans")
    assert_close_rel(_np(out_f), np.asarray(ref_f), 1e-6, "factor")


def test_rotation_matrix_to_quaternion():
    rng = np.random.default_rng(2)
    rot = _rotations(rng, 64)
    # each of the four branches: near-identity and 180-degree turns
    rot[:4] = np.stack([np.eye(3), np.diag([1, -1, -1]), np.diag([-1, 1, -1]),
                        np.diag([-1, -1, 1])]).astype(np.float32)
    ref = np.asarray(JG.rotation_matrix_to_quaternion(jnp.asarray(rot)))
    out = _np(PG.rotation_matrix_to_quaternion(torch.from_numpy(rot)))
    assert_close_rel(out, ref, 1e-6, "quats")
    assert (out[:, 3] >= 0).all()
    back = _np(PG.quaternion_to_rotation_matrix(torch.from_numpy(out)))
    assert_close_rel(back, rot, 1e-5, "round trip")


def test_depth_along_ray_from_z_depth_and_rays():
    rng = np.random.default_rng(3)
    _, rays = JG.get_rays_in_camera_frame(jnp.asarray(_intrinsics(rng)), H, W,
                                          normalize_to_unit_sphere=True)
    depth_z = rng.uniform(0.5, 3, (1, H, W, 1)).astype(np.float32)
    ref = JG.depth_along_ray_from_z_depth_and_rays(jnp.asarray(depth_z), rays)
    out = PG.depth_along_ray_from_z_depth_and_rays(
        torch.from_numpy(depth_z), torch.from_numpy(np.array(rays)))
    assert_close_rel(_np(out), np.asarray(ref), 1e-6, "depth_along_ray")


@pytest.mark.parametrize("channels", [3, 1])
def test_dense_rep_encoder(channels):
    x = np.random.default_rng(4).standard_normal(
        (2, H, W, channels)).astype(np.float32)
    jm = JE.DenseRepEncoder(64, 14)
    with jax.default_matmul_precision(HIGHEST):
        params = _perturb(jm.init(jax.random.PRNGKey(0), x), 4)
        ref = np.asarray(jm.apply(params, x))
    port = load_jax_params(PE.DenseRepEncoder(channels, 64, 14), params)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert_close_rel(_np(out), ref, name="dense")


@pytest.mark.parametrize("in_dim", [1, 3, 4])
def test_global_rep_encoder(in_dim):
    x = np.random.default_rng(5).standard_normal((6, in_dim)).astype(
        np.float32)
    jm = JE.GlobalRepEncoder(64)
    with jax.default_matmul_precision(HIGHEST):
        params = _perturb(jm.init(jax.random.PRNGKey(0), x), 5, scale=0.5)
        ref = np.asarray(jm.apply(params, x))
    port = load_jax_params(PE.GlobalRepEncoder(in_dim, 64), params)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert_close_rel(_np(out), ref, name="global")


@pytest.mark.parametrize("name", JTasks.TASK_NAMES)
def test_task_presets_equal_jax(name):
    assert PTasks.TASK_NAMES == JTasks.TASK_NAMES
    assert (dataclasses.asdict(PTasks.task_config(name))
            == dataclasses.asdict(JTasks.task_config(name)))


# --- the pipeline ------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **CFG))
    params = _perturb(init_params(jax_model, H, W), 21, scale=0.05)
    port = load_jax_params(
        MapAnything(MapAnythingConfig(dtype=torch.float32, **CFG),
                    device="cpu"), params)
    return jax_model, params, port


def _compare(ref, out):
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        assert set(r) == set(o), (sorted(r), sorted(o))
        for key in r:
            if np.asarray(r[key]).dtype == bool:
                agree = np.mean(_np(o[key]) == np.asarray(r[key]))
                assert agree >= 0.999, f"{key} agreement {agree}"
            else:
                assert_close_rel(_np(o[key]), np.asarray(r[key]), name=key)


def _both(models, views, **kw):
    jax_model, params, port = models
    with jax.default_matmul_precision(HIGHEST):
        ref = JI.InferencePipeline(jax_model, params).infer(views, **kw)
    out = PI.InferencePipeline(port).infer(views, **kw)
    return ref, out


CASES = {
    # BASELINE config 3's inputs: intrinsics and 4x4 poses
    "intrinsics_poses": lambda: [
        _view(40 + i, intrinsics=True, camera_poses=True,
              is_metric_scale=True) for i in range(3)],
    # unnormalised rays, z-depth, poses, metric flags mixed
    "rays_depth_poses_mixed_metric": lambda: [
        _view(50 + i, ray_directions=True, depth_z=True, camera_poses=True,
              is_metric_scale=bool(i % 2)) for i in range(3)],
    # priors on some views only (each kind missing somewhere)
    "partial_priors": lambda: [
        _view(60, intrinsics=True, depth_z=True, camera_poses=True),
        _view(61),
        _view(62, intrinsics=True, camera_poses=True),
    ],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_infer_with_priors_matches_jax(models, case):
    ref, out = _both(models, CASES[case](), apply_confidence_mask=True)
    _compare(ref, out)


@pytest.mark.parametrize("flag", [
    "ignore_calibration_inputs", "ignore_depth_inputs", "ignore_pose_inputs",
    "ignore_depth_scale_inputs", "ignore_pose_scale_inputs"])
def test_infer_ignore_flags_match_jax(models, flag):
    views = [_view(70 + i, intrinsics=True, depth_z=True, camera_poses=True)
             for i in range(2)]
    ref, out = _both(models, views, **{flag: True})
    _compare(ref, out)


@pytest.mark.parametrize("task", ["mvs", "registration"])
def test_infer_task_presets_match_jax(models, task):
    views = [_view(80 + i, intrinsics=True, depth_z=True, camera_poses=True)
             for i in range(2)]
    ref, out = _both(models, views, task=task)
    _compare(ref, out)


def test_priors_change_the_output(models):
    """The priors reach the output: dropping them changes it."""
    _, _, port = models
    pipe = PI.InferencePipeline(port)
    views = CASES["intrinsics_poses"]()
    with_priors = pipe.infer(views)
    without = pipe.infer(views, ignore_calibration_inputs=True,
                         ignore_pose_inputs=True)
    diff = (with_priors[1]["pts3d"] - without[1]["pts3d"]).abs().max()
    assert diff > 1e-3 * without[1]["pts3d"].abs().max()


# --- the sparse branch, the refusals ------------------------------------------


def test_sparse_branch_matches_jax_without_removal(models):
    """At a removal share of 0 every pixel is kept whatever the draw, so
    the sparse branch must equal JAX's exactly as the dense one."""
    jax_model, params, port = models
    views = [_view(90 + i, intrinsics=True, depth_z=True) for i in range(2)]
    geom = dict(ray_dirs_prob=1.0, depth_prob=1.0, cam_prob=0.0,
                sparse_depth_prob=1.0, sparsification_removal_percent=0.0)
    jb = JI.stack_views(JI.preprocess_input_views_for_inference(views))
    with jax.default_matmul_precision(HIGHEST):
        ref = jax_model.apply(params, jb, JaxGeomCfg(**geom),
                              rng=jax.random.PRNGKey(0))
    pb = PI.stack_views(PI.preprocess_input_views_for_inference(views))
    with torch.no_grad():
        out = port(pb, PI.GeometricInputConfig(**geom),
                   generator=torch.Generator().manual_seed(0))
    for key in ("pts3d", "depth_along_ray", "conf", "cam_quats"):
        assert_close_rel(_np(out[key]), np.asarray(ref[key]), name=key)


def test_sparse_branch_kept_share():
    """At removal 0.9 about a tenth of the pixels stay (the draw itself is
    the pinned divergence from JAX's), and the same seed gives the same
    pixels."""
    cfg = PTasks.task_config("registration_sparse")

    def kept(seed):
        return draw_prior_masks(cfg, 1, 2, "cpu",
                                torch.Generator().manual_seed(seed),
                                (100, 100))["keep_px"]

    share = float(kept(0).float().mean())
    assert abs(share - 0.1) < 0.01, share
    assert torch.equal(kept(0), kept(0))
    assert not torch.equal(kept(0), kept(1))


def test_sparse_preset_is_seeded(models):
    _, _, port = models
    pipe = PI.InferencePipeline(port)
    views = [_view(95 + i, intrinsics=True, depth_z=True) for i in range(2)]
    a = pipe.infer(views, task="registration_sparse")
    b = pipe.infer(views, task="registration_sparse")
    dense = pipe.infer(views, task="registration")
    assert torch.equal(a[0]["pts3d"], b[0]["pts3d"])
    assert not torch.equal(a[0]["pts3d"], dense[0]["pts3d"])


def test_stochastic_configs_raise(models):
    """Inference refuses a stochastic preset, as JAX's; the model refuses a
    stochastic config without a generator (JAX's refusal without an rng),
    or with one on another device, and runs it with one."""
    _, _, port = models
    views = [_view(100, intrinsics=True)]
    with pytest.raises(ValueError, match="stochastic"):
        PI.InferencePipeline(port).infer(views, task="aug_training")
    batched = PI.stack_views(PI.preprocess_input_views_for_inference(views))
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        port(batched, aug_training_config())
    # a CPU generator for a card's model (stands in: no card here)
    with pytest.raises(ValueError, match="generator lives on cpu"):
        check_generator(aug_training_config(), torch.Generator(), "cuda")
    with torch.no_grad():
        out = port(batched, aug_training_config(),
                   generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out["pts3d"]).all()


def test_sharded_call_with_priors_raises(models):
    """The view-sharded call with priors (one rank here; p = 2 and 4 in
    tests/test_torch_train_priors.py) equals the unsharded one; a
    stochastic config raises there, as in JAX."""
    import torch.distributed as dist

    from mapanything_tpu_torch.parallel.inference import view_sharded_forward

    _, _, port = models
    views = [_view(110, intrinsics=True, camera_poses=True,
                   is_metric_scale=True),
             _view(111, intrinsics=True, depth_z=True)]
    group = init_distributed(device="cpu")
    try:
        out = PI.InferencePipeline(port, view_shard_group=group).infer(
            views, task="depth_completion")
        batched = PI.stack_views(
            PI.preprocess_input_views_for_inference(views))
        with pytest.raises(ValueError, match="deterministic"):
            view_sharded_forward(port, batched, group, aug_training_config(),
                                 torch.Generator().manual_seed(0))
    finally:
        dist.destroy_process_group()
    ref = PI.InferencePipeline(port).infer(views, task="depth_completion")
    for key in ("pts3d", "depth_along_ray", "cam_quats", "conf"):
        for o, r in zip(out, ref):
            assert_close_rel(_np(o[key]), _np(r[key]), 1e-5, name=key)
