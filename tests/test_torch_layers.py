"""Port building blocks, ops and geometry against the JAX package.

Inputs and weights come from seeded numpy generators and go through the JAX
function and its port counterpart. The JAX side runs with
`jax.default_matmul_precision("highest")` so its fp32 matmuls are fp32.
Tolerances are stated per test: 1e-5 for single fp32 layers (summation order
only), looser where the comparison is in bf16.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu import geometry as JG
from mapanything_tpu.nn import layers as JL
from mapanything_tpu.ops.quantile import quantile_threshold as jax_quantile
from mapanything_tpu.ops.resize import bilinear_resize as jax_resize
from mapanything_tpu_torch import geometry as PG
from mapanything_tpu_torch.nn import adaptors as PA
from mapanything_tpu_torch.nn import layers as PL
from mapanything_tpu_torch.ops.quantile import quantile_threshold
from mapanything_tpu_torch.ops.resize import bilinear_resize
from mapanything_tpu_torch.utils.weights import load_jax_params

HIGHEST = "highest"


def _init(module, seed, *args):
    """JAX params of `module`, every leaf perturbed so no LayerNorm scale
    or LayerScale gamma sits at its trivial init value."""
    rng = np.random.default_rng(seed)
    with jax.default_matmul_precision(HIGHEST):
        params = module.init(jax.random.PRNGKey(seed), *args)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params)


def _apply(module, params, *args):
    with jax.default_matmul_precision(HIGHEST):
        return np.asarray(module.apply(params, *args))


def _t(x):
    return torch.from_numpy(np.array(x))


class TestLayers:
    def test_fused_layer_norm(self):
        x = np.random.default_rng(0).standard_normal((3, 7, 96)) * 3 + 1
        x = x.astype(np.float32)
        params = _init(JL.FusedLayerNorm(), 0, x)
        ref = _apply(JL.FusedLayerNorm(), params, x)
        port = load_jax_params(PL.FusedLayerNorm(96), params)
        np.testing.assert_allclose(port(_t(x)).detach().numpy(), ref,
                                   atol=1e-5, rtol=1e-5)

    def test_mlp_erf_gelu(self):
        x = np.random.default_rng(1).standard_normal((2, 9, 64)).astype(
            np.float32)
        jm = JL.Mlp(256, 64)
        params = _init(jm, 1, x)
        port = load_jax_params(PL.Mlp(64, 256, 64), params)
        np.testing.assert_allclose(port(_t(x)).detach().numpy(),
                                   _apply(jm, params, x), atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("n_valid", [None, 100])
    def test_attention(self, n_valid):
        x = np.random.default_rng(2).standard_normal((2, 128, 128)).astype(
            np.float32)
        ja = JL.Attention(128, 2)
        params = _init(ja, 2, x, None, n_valid)
        ref = _apply(ja, params, x, None, n_valid)
        port = load_jax_params(PL.Attention(128, 2), params)
        out = port(_t(x), n_valid=n_valid).detach().numpy()
        rows = n_valid or 128
        np.testing.assert_allclose(out[:, :rows], ref[:, :rows],
                                   atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("n_valid", [None, 100])
    @pytest.mark.parametrize("layerscale", [None, 1.0])
    def test_block(self, n_valid, layerscale):
        x = np.random.default_rng(3).standard_normal((2, 128, 128)).astype(
            np.float32)
        jb = JL.Block(128, 2, layerscale_init=layerscale)
        params = _init(jb, 3, x, None, n_valid)
        ref = _apply(jb, params, x, None, n_valid)
        port = load_jax_params(PL.Block(128, 2, layerscale_init=layerscale),
                               params)
        with torch.no_grad():
            out = port(_t(x), n_valid).numpy()
        rows = n_valid or 128
        np.testing.assert_allclose(out[:, :rows], ref[:, :rows],
                                   atol=1e-5, rtol=1e-5)

    def test_block_bf16(self):
        """bf16 compute, tanh GELU on both sides; the two frameworks round
        at different places, so 5e-2 abs on O(1) activations."""
        x = np.random.default_rng(4).standard_normal((1, 128, 128)).astype(
            np.float32)
        jb = JL.Block(128, 2, layerscale_init=1.0, dtype=jnp.bfloat16)
        params = _init(jb, 4, x, None, 100)
        ref = _apply(jb, params, x, None, 100).astype(np.float32)
        port = load_jax_params(
            PL.Block(128, 2, layerscale_init=1.0, dtype=torch.bfloat16),
            params)
        with torch.no_grad():
            out = port(_t(x), 100).float().numpy()
        np.testing.assert_allclose(out[:, :100], ref[:, :100], atol=5e-2)


class TestOps:
    @pytest.mark.parametrize("src,dst", [((5, 7), (40, 56)), ((37, 37),
                                                               (74, 74))])
    def test_bilinear_resize(self, src, dst):
        x = np.random.default_rng(5).standard_normal((2, *src, 3)).astype(
            np.float32)
        with jax.default_matmul_precision(HIGHEST):
            ref = np.asarray(jax_resize(jnp.asarray(x), dst))
        np.testing.assert_allclose(bilinear_resize(_t(x), dst).numpy(), ref,
                                   atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("q", [0.1, 0.5, 0.97])
    def test_quantile_threshold(self, q):
        x = np.random.default_rng(6).gamma(2.0, size=(2, 3, 500)).astype(
            np.float32)
        ref = np.asarray(jax_quantile(jnp.asarray(x), q))
        np.testing.assert_allclose(quantile_threshold(_t(x), q).numpy(), ref,
                                   rtol=1e-6)


def _pose_inputs(seed, b=2, v=3, h=11, w=13):
    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal((b, v, h, w, 3)).astype(np.float32)
    dirs[..., 2] = np.abs(dirs[..., 2]) + 1.0
    depth = np.exp(rng.standard_normal((b, v, h, w, 1))).astype(np.float32)
    trans = rng.standard_normal((b, v, 3)).astype(np.float32)
    quats = rng.standard_normal((b, v, 4)).astype(np.float32)
    return dirs, depth, trans, quats


class TestGeometry:
    def test_quats_and_pose_matrix(self):
        _, _, trans, quats = _pose_inputs(7)
        ref = np.asarray(JG.pose_quats_trans_to_matrix(jnp.asarray(quats),
                                                       jnp.asarray(trans)))
        out = PG.pose_quats_trans_to_matrix(_t(quats), _t(trans)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)

    def test_pointmap_recombination(self):
        args = _pose_inputs(8)
        ref = np.asarray(
            JG.convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap(
                *map(jnp.asarray, args)))
        out = PG.convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap(
            *map(_t, args)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("geometric", [False, True])
    def test_recover_intrinsics(self, geometric):
        h, w = 60, 80
        k = np.array([[70.0, 0, 41.0], [0, 66.0, 28.5], [0, 0, 1]], np.float32)
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        rng = np.random.default_rng(9)
        dirs = np.stack([(xs - k[0, 2]) / k[0, 0], (ys - k[1, 2]) / k[1, 1],
                         np.ones_like(xs)], -1)
        dirs = dirs + 1e-3 * rng.standard_normal(dirs.shape)
        dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))[None]
        dirs = dirs.astype(np.float32)
        ref = np.asarray(JG.recover_pinhole_intrinsics_from_ray_directions(
            jnp.asarray(dirs), use_geometric_calculation=geometric))
        out = PG.recover_pinhole_intrinsics_from_ray_directions(
            _t(dirs), use_geometric_calculation=geometric).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-3)

    def test_edges(self):
        dirs, depth, trans, quats = _pose_inputs(10, h=24, w=30)
        depth[..., 10:, :, :] *= 3.0  # a depth discontinuity
        pts = np.asarray(
            JG.convert_ray_dirs_depth_along_ray_pose_trans_quats_to_pointmap(
                *map(jnp.asarray, (dirs, depth, trans, quats))))
        mask = np.random.default_rng(11).random(pts.shape[:-1]) > 0.1
        ref_n = np.asarray(JG.points_normal_edges(jnp.asarray(pts), tol=5.0,
                                                  mask=jnp.asarray(mask)))
        out_n = PG.points_normal_edges(_t(pts), tol=5.0, mask=_t(mask)).numpy()
        ref_d = np.asarray(JG.depth_edge(jnp.asarray(depth[..., 0]),
                                         rtol=0.03, mask=jnp.asarray(mask)))
        out_d = PG.depth_edge(_t(depth[..., 0]), rtol=0.03,
                              mask=_t(mask)).numpy()
        assert ref_n.any() and ref_d.any()
        np.testing.assert_array_equal(out_n, ref_n)
        np.testing.assert_array_equal(out_d, ref_d)


def test_adaptors():
    from mapanything_tpu.nn import adaptors as JA

    x = np.random.default_rng(12).standard_normal((2, 5, 7)).astype(np.float32)
    for name in ("depth_adaptor", "confidence_adaptor", "scale_adaptor",
                 "normalize_to_unit_sphere"):
        np.testing.assert_allclose(getattr(PA, name)(_t(x)).numpy(),
                                   np.asarray(getattr(JA, name)(x)),
                                   rtol=1e-6, err_msg=name)
    for name in ("mask_adaptor", "pose_adaptor"):
        ref, out = getattr(JA, name)(x), getattr(PA, name)(_t(x))
        for key in ref:
            np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                       rtol=1e-6, err_msg=f"{name}[{key}]")
