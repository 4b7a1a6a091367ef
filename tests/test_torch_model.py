"""Port model modules and the whole images-only slice against the JAX package.

Weights are the JAX package's own init with every leaf perturbed by seeded
numpy noise; inputs come from seeded numpy generators. Both sides run at
fp32, the JAX side with `jax.default_matmul_precision("highest")`.
Tolerances: 1e-4 relative to the reference's largest magnitude for each
module and each output of the slice (fp32 through a few dozen layers,
summation order only); masks agree on >= 99.9% of the pixels.
"""

import numpy as np
import PIL.Image
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu.data.image import load_images as jax_load_images
from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.nn import dinov2 as JD
from mapanything_tpu.nn import dpt as JDPT
from mapanything_tpu.nn import heads as JH
from mapanything_tpu.nn import trunk as JT
from mapanything_tpu.utils.inference import InferencePipeline as JaxPipeline
from mapanything_tpu_torch.data.image import load_images
from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.nn import dinov2 as PD
from mapanything_tpu_torch.nn import dpt as PDPT
from mapanything_tpu_torch.nn import heads as PH
from mapanything_tpu_torch.nn import trunk as PT
from mapanything_tpu_torch.ops.flash_attention import (
    flash_attention,
    reset_launch_counts,
)
from mapanything_tpu_torch.utils.inference import InferencePipeline
from mapanything_tpu_torch.utils.weights import load_jax_params
from torch_jax_init import init_params

HIGHEST = "highest"
H, W = 70, 84  # 5 x 6 patches of 14


def _perturb(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(x.shape))
        .astype(np.float32), params)


def _init(module, seed, *args):
    with jax.default_matmul_precision(HIGHEST):
        params = module.init(jax.random.PRNGKey(seed), *args)
    return _perturb(params, seed)


def _apply(module, params, *args):
    with jax.default_matmul_precision(HIGHEST):
        return jax.tree.map(np.asarray, module.apply(params, *args))


def _np(x):
    return x.detach().float().numpy()


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_close_rel(out, ref, tol=1e-4, name=""):
    """max |out - ref| <= tol * max(1, max |ref|)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    assert np.isfinite(out).all(), name
    err = np.max(np.abs(out - ref))
    bound = tol * max(1.0, float(np.max(np.abs(ref))))
    assert err <= bound, f"{name}: max abs err {err:.3g} > {bound:.3g}"


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class TestModules:
    def test_interpolate_pos_embed(self):
        pe = _rand(0, 37 * 37, 16)
        with jax.default_matmul_precision(HIGHEST):
            ref = np.asarray(JD.interpolate_pos_embed(jnp.asarray(pe),
                                                      (37, 37), (28, 37)))
        out = PD.interpolate_pos_embed(_t(pe), (37, 37), (28, 37))
        assert_close_rel(_np(out), ref, 1e-5)

    def test_dinov2_test_size(self):
        x = _rand(1, 2, H, W, 3)
        jm = JD.DinoViT(size="test", pad_tokens_to=128)
        params = _init(jm, 1, x)
        port = load_jax_params(PD.DinoViT(size="test", pad_tokens_to=128),
                               params)
        with torch.no_grad():
            out = port(_t(x))
        assert_close_rel(_np(out), _apply(jm, params, x), name="dinov2")

    def test_trunk(self):
        feats = _rand(2, 1, 2, 5, 6, 64)
        tok = _rand(3, 1, 1, 64)
        kw = dict(input_embed_dim=64, dim=128, depth=4, num_heads=2,
                  indices=(1, 2), pad_tokens_to=128)
        jm = JT.AlternatingAttentionTrunk(**kw)
        params = _init(jm, 2, feats, tok)
        ref_final, ref_inter, ref_tok = _apply(jm, params, feats, tok)
        port = load_jax_params(PT.AlternatingAttentionTrunk(**kw), params)
        with torch.no_grad():
            final, inter, tok_out = port(_t(feats), _t(tok))
        assert_close_rel(_np(final), ref_final, name="final")
        assert_close_rel(_np(tok_out), ref_tok, name="tok")
        assert len(inter) == len(ref_inter) == 2
        for a, b in zip(inter, ref_inter):
            assert_close_rel(_np(a), b, name="tap")

    def test_dpt_feature_and_regressor(self):
        hooks = [_rand(4 + i, 2, 5, 6, c)
                 for i, c in enumerate((64, 128, 128, 128))]
        fkw = dict(input_feature_dims=(64, 128, 128, 128), feature_dim=32,
                   out_channels=(32, 32, 32, 32))
        jf = JDPT.DPTFeature(**fkw)
        fparams = _init(jf, 4, hooks)
        ref_feat = _apply(jf, fparams, hooks)  # NHWC
        pf = load_jax_params(PDPT.DPTFeature(**fkw), fparams)
        with torch.no_grad():
            feat = pf([_t(h) for h in hooks])  # NCHW
        assert_close_rel(_np(feat.permute(0, 2, 3, 1)), ref_feat, name="feat")

        rkw = dict(input_feature_dim=32, output_dim=6, hidden_dims=(16, 8))
        jr = JDPT.DPTRegressionProcessor(**rkw)
        rparams = _init(jr, 5, ref_feat, (H, W))
        pr = load_jax_params(PDPT.DPTRegressionProcessor(**rkw), rparams)
        with torch.no_grad():
            out = pr(_t(ref_feat).permute(0, 3, 1, 2), (H, W))
        assert_close_rel(_np(out), _apply(jr, rparams, ref_feat, (H, W)),
                         name="regressor")

    def test_heads(self):
        x = _rand(8, 2, 5, 6, 128)
        jp = JH.PoseHead(input_feature_dim=128)
        params = _init(jp, 8, x)
        pp = load_jax_params(PH.PoseHead(input_feature_dim=128), params)
        with torch.no_grad():
            assert_close_rel(_np(pp(_t(x))), _apply(jp, params, x), name="pose")
        tok = _rand(9, 2, 128)
        jm = JH.MLPHead(input_feature_dim=128)
        mparams = _init(jm, 9, tok)
        pm = load_jax_params(PH.MLPHead(input_feature_dim=128), mparams)
        with torch.no_grad():
            assert_close_rel(_np(pm(_t(tok))), _apply(jm, mparams, tok),
                             name="scale")


def test_load_images_matches(tmp_path):
    rng = np.random.default_rng(10)
    for i, (w, h) in enumerate([(600, 450), (640, 480)]):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        PIL.Image.fromarray(arr).save(tmp_path / f"im{i}.png")
    ref = jax_load_images(str(tmp_path))
    out = load_images(str(tmp_path))
    assert len(out) == len(ref) == 2
    for a, b in zip(out, ref):
        assert a["img"].shape == b["img"].shape == (1, 392, 518, 3)
        np.testing.assert_array_equal(a["img"], b["img"])
        assert a["true_shape"] == b["true_shape"]


# --- the whole slice ---------------------------------------------------------

_SLICE_CFG = dict(encoder_size="test", trunk_dim=128, trunk_depth=4,
                  trunk_num_heads=2, trunk_indices=(1, 2), dpt_feature_dim=32,
                  dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
_SLICE_KEYS = ("pts3d", "depth_along_ray", "ray_directions", "intrinsics",
               "camera_poses", "conf", "metric_scaling_factor")


@pytest.fixture(scope="module")
def slice_models():
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **_SLICE_CFG))
    params = _perturb(init_params(jax_model, H, W), 11)
    port = MapAnything(MapAnythingConfig(dtype=torch.float32, **_SLICE_CFG),
                       device="cpu")
    load_jax_params(port, params)
    return JaxPipeline(jax_model, params), InferencePipeline(port)


@pytest.mark.parametrize("num_views", [1, 2])
def test_slice_matches_jax(slice_models, num_views):
    jax_pipe, port_pipe = slice_models
    views = [{"img": _rand(20 + i, 1, H, W, 3), "data_norm_type": ["dinov2"]}
             for i in range(num_views)]
    with jax.default_matmul_precision(HIGHEST):
        ref = jax_pipe.infer(views, apply_mask=True, mask_edges=True)
    reset_launch_counts()
    out = port_pipe.infer(views, apply_mask=True, mask_edges=True)
    # 2 encoder + 4 trunk attentions, all on the plain path on the CPU
    assert flash_attention.plain_launches == 6
    assert flash_attention.kernel_launches == 0
    assert len(out) == num_views
    for r, o in zip(ref, out):
        for key in _SLICE_KEYS:
            assert_close_rel(_np(o[key]), np.asarray(r[key]), name=key)
        agree = np.mean(o["mask"].numpy() == np.asarray(r["mask"]))
        assert agree >= 0.999, f"mask agreement {agree}"


def test_slice_ignored_priors_and_stochastic_presets(slice_models):
    """What stays of the refusals: an ignored prior gives the images-only
    result, and a stochastic task preset raises."""
    _, port_pipe = slice_models
    view = {"img": _rand(30, 1, H, W, 3), "data_norm_type": ["dinov2"],
            "intrinsics": np.array([[[60.0, 0, 42], [0, 60.0, 35], [0, 0, 1]]],
                                   np.float32)}
    plain = port_pipe.infer([{k: view[k] for k in ("img", "data_norm_type")}])
    ignored = port_pipe.infer([view], ignore_calibration_inputs=True)
    torch.testing.assert_close(ignored[0]["pts3d"], plain[0]["pts3d"])
    with pytest.raises(ValueError, match="stochastic"):
        port_pipe.infer([view], task="aug_training")
