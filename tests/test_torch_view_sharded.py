"""The sequence-parallel slice as a whole: view-sharded MapAnything inference
(parallel/inference.py, InferencePipeline(view_shard_group=...)) against the
JAX package and against the port's unsharded forward, on the CPU.

A tiny model (encoder "test", trunk dim 64, depth 2, 4 views of 28 x 28)
gets the JAX package's init perturbed by seeded numpy noise. Two spawned
CPU ranks over gloo each run half the views; the forward must match JAX
`model.apply` of the same weights within 1e-4 of the reference's largest
magnitude (fp32, summation order only), on every rank, and the sharded
pipeline must match the unsharded one. The one-process group of
`init_distributed` runs in this process. JAX is imported inside the
fixtures and tests only, so the spawned ranks load torch alone. Also here:
the entry points' device default (the card, or an error without one).
"""

import os

import numpy as np
import pytest
import torch

from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.ops.flash_attention import (
    flash_attention,
    reset_launch_counts,
)
from mapanything_tpu_torch.parallel import (
    all_reduce_mean,
    barrier,
    init_distributed,
    is_main_process,
    spawn_cpu_ranks,
    view_sharded_forward,
)
from mapanything_tpu_torch.utils.inference import InferencePipeline

CFG = dict(encoder_size="test", trunk_dim=64, trunk_depth=2,
           trunk_num_heads=2, trunk_indices=(0, 1), dpt_feature_dim=32,
           dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8),
           dense_head_chunk=2)
V, HW = 4, 28
PIPE_KEYS = ("pts3d", "depth_along_ray", "conf", "camera_poses",
             "intrinsics", "metric_scaling_factor")


def assert_close_rel(out, ref, tol=1e-4, name=""):
    """max |out - ref| <= tol * max(1, max |ref|)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    assert np.isfinite(out).all(), name
    err = np.max(np.abs(out - ref))
    bound = tol * max(1.0, float(np.max(np.abs(ref))))
    assert err <= bound, f"{name}: max abs err {err:.3g} > {bound:.3g}"


def _port_model(folder):
    inp = np.load(os.path.join(folder, "inputs.npz"))
    model = MapAnything(MapAnythingConfig(dtype=torch.float32, **CFG),
                        device="cpu")
    model.load_state_dict({key[6:]: torch.from_numpy(inp[key])
                           for key in inp.files if key.startswith("model.")})
    return model, inp["img"]


def _view_list(img):
    return [{"img": img[:, i], "data_norm_type": ["dinov2"]}
            for i in range(img.shape[1])]


def _slice_rank(group, folder):
    """One rank: the sharded forward, the sharded and unsharded pipelines,
    and the ragged view count; writes its results to `folder`."""
    import torch.distributed as dist

    model, img = _port_model(folder)
    res = {}
    with torch.inference_mode():
        out = view_sharded_forward(model, {"img": torch.from_numpy(img)},
                                   group)
        try:
            view_sharded_forward(model, {"img": torch.from_numpy(img[:, :3])},
                                 group)
        except ValueError as exc:
            res["ragged_error"] = np.array(str(exc))
    res.update({f"fwd.{key}": t.numpy() for key, t in out.items()})
    reset_launch_counts()
    sharded = InferencePipeline(model, view_shard_group=group).infer(
        _view_list(img), apply_confidence_mask=True)
    # plain twins on the CPU: the 2 encoder blocks and the frame layer over
    # the 2 local views, and the global layer's 2 ring steps
    res["plain_launches"] = np.array(flash_attention.plain_launches)
    plain = InferencePipeline(model).infer(_view_list(img),
                                           apply_confidence_mask=True)
    for name, views in (("sharded", sharded), ("plain", plain)):
        for i, view in enumerate(views):
            for key in PIPE_KEYS + ("mask",):
                res[f"{name}.{i}.{key}"] = view[key].numpy()
    np.savez(os.path.join(folder, f"rank{dist.get_rank(group)}.npz"), **res)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """JAX model, params and reference forward; every rank's results."""
    import jax
    import jax.numpy as jnp

    from mapanything_tpu.models import MapAnything as JaxMapAnything
    from mapanything_tpu.models import MapAnythingConfig as JaxConfig
    from mapanything_tpu.models import images_only_config
    from mapanything_tpu_torch.utils.weights import from_jax_params
    from torch_jax_init import init_params

    folder = str(tmp_path_factory.mktemp("slice"))
    rng = np.random.default_rng(40)
    img = (0.3 * rng.standard_normal((1, V, HW, HW, 3))).astype(np.float32)
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **CFG))
    with jax.default_matmul_precision("highest"):
        params = init_params(jax_model, HW, HW)
        params = jax.tree.map(lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(
            a.shape)).astype(np.float32), params)
        ref = jax.jit(lambda p, vw: jax_model.apply(
            p, vw, images_only_config()))(params, {"img": jnp.asarray(img)})
    state = from_jax_params(params, MapAnything(
        MapAnythingConfig(dtype=torch.float32, **CFG), device="meta"))
    np.savez(os.path.join(folder, "inputs.npz"), img=img,
             **{f"model.{key}": np.ascontiguousarray(val)
                for key, val in state.items()})
    spawn_cpu_ranks(_slice_rank, 2, folder)
    ranks = [dict(np.load(os.path.join(folder, f"rank{r}.npz")))
             for r in range(2)]
    return dict(folder=folder, ref=jax.tree.map(np.asarray, ref), ranks=ranks)


def test_view_sharded_forward_matches_jax(slice_run):
    """p = 2 against JAX model.apply of the same weights, on both ranks."""
    ref = slice_run["ref"]
    keys = [key[4:] for key in slice_run["ranks"][0]
            if key.startswith("fwd.") and key[4:] in ref]
    assert "pts3d" in keys and "metric_scaling_factor" in keys
    for rank in slice_run["ranks"]:
        for key in keys:
            got = rank[f"fwd.{key}"]
            if got.dtype == bool:
                agree = np.mean(got == ref[key])
                assert agree >= 0.999, f"{key}: agreement {agree}"
            else:
                assert_close_rel(got, ref[key], name=key)


def test_sharded_pipeline_matches_unsharded(slice_run):
    for rank in slice_run["ranks"]:
        assert rank["plain_launches"] == 2 + 1 + 2
        for i in range(V):
            for key in PIPE_KEYS:
                assert_close_rel(rank[f"sharded.{i}.{key}"],
                                 rank[f"plain.{i}.{key}"], name=key)
            agree = np.mean(rank[f"sharded.{i}.mask"]
                            == rank[f"plain.{i}.mask"])
            assert agree >= 0.999, f"view {i} mask agreement {agree}"


def test_ragged_view_count_rejected(slice_run):
    for rank in slice_run["ranks"]:
        assert "multiple of the group size 2" in str(rank["ragged_error"])


def test_one_process_group(slice_run):
    """init_distributed() without torchrun: a group of this one process
    (gloo on the CPU); the sharded forward then equals the plain one."""
    import torch.distributed as dist

    model, img = _port_model(slice_run["folder"])
    views = {"img": torch.from_numpy(img)}
    group = init_distributed(device="cpu")
    try:
        assert dist.get_world_size(group) == 1 and dist.get_rank() == 0
        assert is_main_process() and all_reduce_mean(2.5) == 2.5
        barrier()
        with torch.inference_mode():
            out = view_sharded_forward(model, views, group)
            ref = model(views)
    finally:
        dist.destroy_process_group()
    assert set(out) == set(ref)
    for key in ref:
        torch.testing.assert_close(out[key], ref[key], atol=1e-5, rtol=1e-5)


def test_trunk_seq_axis_points_at_the_group():
    with pytest.raises(ValueError, match="seq_group"):
        MapAnythingConfig(trunk_seq_axis="model").check_supported()


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MapAnythingConfig(dtype=torch.float32, **CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MapAnything(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_synthetic_batch(1, 1, HW, HW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed()
    assert MapAnything(cfg, device="cpu").scale_token.device.type == "cpu"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the entry points' default device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda_device):
    model = MapAnything(MapAnythingConfig(dtype=torch.float32, **CFG))
    assert {p.device.type for p in model.parameters()} == {"cuda"}
    batch = make_synthetic_batch(1, 1, HW, HW)
    assert batch["views"]["img"].device.type == "cuda"
