"""The many-view memory path against the JAX package, on the CPU: the memory
policy, the MLP's row chunks, the chunked dense head and the chunked
postprocess.

The tiny model of tests/test_torch_priors.py, fp32 on both sides, JAX
under `jax.default_matmul_precision("highest")`; weights are the JAX init
perturbed by seeded numpy noise. Tolerances: 1e-4 of the reference's
largest magnitude against JAX; 1e-5 between the port's chunked and
unchunked calls (the same arithmetic on fewer rows at a time); the chunked
postprocess equals the unchunked one exactly, view by view.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.models.mapanything import (
    resolve_memory_policy as jax_policy,
)
from mapanything_tpu.nn import layers as JL
from mapanything_tpu.utils import inference as JI
from mapanything_tpu_torch.models import (
    MapAnything,
    MapAnythingConfig,
    resolve_memory_policy,
)
from mapanything_tpu_torch.nn import layers as PL
from mapanything_tpu_torch.utils import inference as PI
from mapanything_tpu_torch.utils.weights import load_jax_params
from torch_jax_init import init_params

HIGHEST = "highest"
H, W = 42, 56
# dense_head_chunk 2 of 5 views: 3 chunks, the last one padded; encoder rows
# 5 x 128 and trunk rows 5 x 12 (+ the token) by 100: ragged last chunks
CFG = dict(encoder_size="test", trunk_dim=128, trunk_depth=4,
           trunk_num_heads=2, trunk_indices=(1, 2), dpt_feature_dim=32,
           dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8),
           dense_head_chunk=2, mlp_token_chunk=100)


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


def _views(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"img": rng.standard_normal((1, H, W, 3)).astype(np.float32),
             "data_norm_type": ["dinov2"]} for _ in range(n)]


@pytest.mark.parametrize("hbm_gb", [16.0, 80.0])
@pytest.mark.parametrize("batch", [1, 2])
def test_memory_policy_equals_jax(hbm_gb, batch):
    jcfg, pcfg = JaxConfig(), MapAnythingConfig()
    for views in (1, 2, 4, 8, 24, 32, 48, 64, 100, 128, 192, 256, 400, 640):
        for hw in ((518, 518), (392, 518), (294, 518)):
            ref = jax_policy(jcfg, batch, views, *hw, hbm_gb=hbm_gb)
            out = resolve_memory_policy(pcfg, batch, views, *hw,
                                        hbm_gb=hbm_gb)
            assert (out.memory_efficient, out.post_view_chunk) == (
                ref.memory_efficient, ref.post_view_chunk), (views, hw)
            assert (out.cfg.dense_head_chunk, out.cfg.mlp_token_chunk) == (
                ref.cfg.dense_head_chunk, ref.cfg.mlp_token_chunk)
            unchanged = {f.name for f in dataclasses.fields(pcfg)} - {
                "dense_head_chunk", "mlp_token_chunk"}
            assert all(getattr(out.cfg, f) == getattr(pcfg, f)
                       for f in unchanged)


def test_policy_at_80_gb_runs_32_and_100_views_unchunked():
    for views in (32, 100):
        assert not resolve_memory_policy(MapAnythingConfig(), 1, views, 518,
                                         518, hbm_gb=80.0).memory_efficient


def test_mlp_token_chunk():
    """Chunked rows (a chunk that divides no row count) against unchunked,
    and against JAX's Mlp(token_chunk)."""
    x = np.random.default_rng(1).standard_normal((3, 37, 64)).astype(
        np.float32)
    jm = JL.Mlp(hidden_dim=256, out_dim=64, token_chunk=25)
    with jax.default_matmul_precision(HIGHEST):
        params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0), x))
        ref = np.asarray(jm.apply(params, x))
    port = load_jax_params(PL.Mlp(64, 256, 64), params)
    with torch.no_grad():
        full = port(torch.from_numpy(x))
        chunked = port(torch.from_numpy(x), token_chunk=25)
    assert_close_rel(_np(chunked), _np(full), 1e-6, "chunked vs full")
    assert_close_rel(_np(chunked), ref, name="vs jax")


@pytest.fixture(scope="module")
def models():
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **CFG))
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * np.random.default_rng(3)
                   .standard_normal(x.shape)).astype(np.float32),
        init_params(jax_model, H, W))
    port = load_jax_params(
        MapAnything(MapAnythingConfig(dtype=torch.float32, **CFG),
                    device="cpu"), params)
    return jax_model, params, port


def test_memory_efficient_infer_matches_jax_and_unchunked(models):
    jax_model, params, port = models
    views = _views(5)
    with jax.default_matmul_precision(HIGHEST):
        ref = JI.InferencePipeline(jax_model, params).infer(
            views, memory_efficient_inference=True,
            apply_confidence_mask=True)
    pipe = PI.InferencePipeline(port)
    out = pipe.infer(views, memory_efficient_inference=True,
                     apply_confidence_mask=True)
    dense = pipe.infer(views, memory_efficient_inference=False,
                       apply_confidence_mask=True)
    for r, o, d in zip(ref, out, dense):
        for key in ("pts3d", "depth_along_ray", "ray_directions", "conf",
                    "intrinsics", "camera_poses", "metric_scaling_factor"):
            assert_close_rel(_np(o[key]), np.asarray(r[key]), name=key)
            assert_close_rel(_np(o[key]), _np(d[key]), 1e-5, name=key)
        agree = np.mean(_np(o["mask"]) == np.asarray(r["mask"]))
        assert agree >= 0.999, agree


def test_memory_efficient_forward_chunks_the_head(models, monkeypatch):
    """5 views by dense_head_chunk 2: three head calls of 2 views each."""
    _, _, port = models
    calls = []
    head = port.dense_head.forward
    monkeypatch.setattr(port.dense_head, "forward",
                        lambda hooks, hw: calls.append(hooks[0].shape[0])
                        or head(hooks, hw))
    batched = PI.stack_views(_views(5))
    with torch.no_grad():
        port(batched, memory_efficient=True)
    assert calls == [2, 2, 2]


@pytest.mark.parametrize("num_views,chunk", [(4, 2), (6, 4)])
def test_postprocess_view_chunk_is_exact(models, num_views, chunk):
    _, _, port = models
    batched = PI.stack_views(_views(num_views, seed=num_views))
    with torch.no_grad():
        preds = port(batched)
    kw = dict(apply_mask=True, mask_edges=True, apply_confidence_mask=True,
              confidence_percentile=30.0)
    full = PI.postprocess_outputs(preds, batched["img"], **kw)
    chunked = PI.postprocess_outputs(preds, batched["img"], view_chunk=chunk,
                                     **kw)
    assert set(full) == set(chunked)
    for key in full:
        assert torch.equal(full[key], chunked[key]), key
    assert PI._largest_divisor_leq(num_views, chunk) == \
        JI._largest_divisor_leq(num_views, chunk)


def test_resize_in_batch_slices_equals_one_call(monkeypatch):
    """A resize whose output passes the upsample kernel's 32-bit limit (the
    100-view dense head) runs in batch slices; the result is the same."""
    from mapanything_tpu_torch.ops import resize

    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (7, 3, 5, 6)).astype(np.float32))
    whole = resize.bilinear_resize_nchw(x, (11, 13))
    monkeypatch.setattr(resize, "MAX_OUTPUT_ELEMENTS", 2 * 3 * 11 * 13)
    for inp in (x, x.contiguous(memory_format=torch.channels_last)):
        sliced = resize.bilinear_resize_nchw(inp, (11, 13))
        assert torch.equal(sliced, whole)
