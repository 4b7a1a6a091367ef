"""JAX param tree -> port state dict (mapanything_tpu_torch.utils.weights),
and the port's independence from JAX at import."""

import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.models import images_only_config, jit_init
from torch_jax_init import prior_views
from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.utils.weights import from_jax_params

_SMALL = dict(encoder_size="test", trunk_dim=128, trunk_depth=4,
              trunk_num_heads=2, trunk_indices=(1, 2), dpt_feature_dim=32,
              dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))


def _jax_param_shapes(**cfg):
    model = JaxMapAnything(cfg=JaxConfig(**cfg))
    views = prior_views(1, 1, 28, 28)  # a tree with the six prior encoders
    return jax.eval_shape(
        lambda: jit_init(model, jax.random.PRNGKey(0), views,
                         images_only_config()))


def _zero_views(shapes):
    """Shape-only numpy leaves: zero-stride views, nothing allocated."""
    return jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)


@pytest.fixture(scope="module")
def small_params():
    rng = np.random.default_rng(0)
    shapes = _jax_param_shapes(dtype=jnp.float32, **_SMALL)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def test_small_config_consumes_every_leaf(small_params):
    model = MapAnything(MapAnythingConfig(dtype=torch.float32, **_SMALL),
                        device="cpu")
    state = from_jax_params(small_params, model)
    n_leaves = len(jax.tree_util.tree_leaves(small_params))
    assert len(state) == n_leaves == len(list(model.parameters()))
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in state.items()})
    qkv = small_params["params"]["encoder"]["blocks_1"]["attn"]["qkv"]
    np.testing.assert_array_equal(
        model.encoder.blocks[1].attn.qkv.weight.detach().numpy(), qkv["kernel"].T)
    # ConvTranspose kernels are flipped and moved to (in, out, kh, kw)
    k = small_params["params"]["dense_head"]["dpt_feature"]["resize_0"]["kernel"]
    np.testing.assert_array_equal(
        model.dense_head.dpt_feature.resize_0.weight.detach().numpy(),
        k[::-1, ::-1].transpose(2, 3, 0, 1))


def test_released_config_shapes_on_meta():
    shapes = _jax_param_shapes()
    model = MapAnything(MapAnythingConfig(), device="meta")
    state = from_jax_params(_zero_views(shapes), model)
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes))
    assert sum(v.size for v in state.values()) == n_jax
    assert n_jax == sum(p.numel() for p in model.parameters())
    assert len(state) == len(jax.tree_util.tree_leaves(shapes))


def test_mismatches_fail_loudly(small_params):
    model = MapAnything(MapAnythingConfig(dtype=torch.float32, **_SMALL),
                        device="meta")
    inner = dict(small_params["params"])
    extra = dict(inner, normal_encoder={"kernel": np.zeros((3, 3))})
    with pytest.raises(KeyError, match="normal_encoder"):
        from_jax_params(extra, model)
    missing = {k: v for k, v in inner.items() if k != "scale_token"}
    with pytest.raises(KeyError, match="scale_token"):
        from_jax_params(missing, model)
    wrong = dict(inner, scale_token=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="scale_token"):
        from_jax_params(wrong, model)


def test_import_does_not_load_jax():
    code = ("import sys, mapanything_tpu_torch, "
            "mapanything_tpu_torch.utils.inference, "
            "mapanything_tpu_torch.utils.weights, "
            "mapanything_tpu_torch.data.image; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'mapanything_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_generator_init_is_seeded_and_runs():
    cfg = MapAnythingConfig(dtype=torch.float32, **_SMALL)

    def build(seed):
        return MapAnything(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(seed))

    a, b, c = build(0), build(0), build(1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["scale_token"], sc["scale_token"])
    ln = a.encoder.blocks[0].norm1
    assert torch.equal(ln.weight, torch.ones_like(ln.weight))
    assert torch.equal(a.encoder.blocks[0].ls1.gamma,
                       torch.ones_like(a.encoder.blocks[0].ls1.gamma))
    img = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 2, 42, 56, 3)).astype(np.float32))
    with torch.no_grad():
        out = a({"img": img})
    assert out["pts3d"].shape == (1, 2, 42, 56, 3)
    assert all(torch.isfinite(t).all() for t in out.values()
               if t.is_floating_point())
