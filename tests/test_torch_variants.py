"""The model variants of the port against the JAX package, on the CPU.

The modules beyond the released config (the model of tests/test_variants.py):
RoPE2D, attention with RoPE, entropy scaling and a key mask, the global and
cross-attention trunks and the alternating trunk's options, the RADIO
encoder, DINOv2 with registers and folded LayerScale, the recombination of
all 20 scene-representation arms, the postprocess of each family, and the
config's rejections. MapAnything end to end with each variant is in
tests/test_torch_variant_models.py.

Both packages get the same tree (JAX's init with seeded noise on every leaf,
through utils/weights.py::from_jax_params) and the same seeded numpy
inputs; both run fp32, the JAX side under
`jax.default_matmul_precision("highest")`. Limit: max-abs error within
1e-4 of the JAX output's largest magnitude (1e-5 for single modules).
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.models import images_only_config as jax_images_only
from mapanything_tpu.models import (
    mapanything_ablations_config as jax_ablations_config,
)
from mapanything_tpu.models import mapanything as JM
from mapanything_tpu.nn import dinov2 as JD
from mapanything_tpu.nn import heads as JH
from mapanything_tpu.nn import layers as JL
from mapanything_tpu.nn import radio as JR
from mapanything_tpu.nn import rope as JRope
from mapanything_tpu.nn import trunk as JT
from mapanything_tpu.ops.attention import _sdpa_xla
from mapanything_tpu.utils.inference import (
    postprocess_outputs as jax_postprocess,
)
from mapanything_tpu_torch.models import (
    MapAnything,
    MapAnythingConfig,
    dense_dim_for,
    mapanything_ablations_config,
)
from mapanything_tpu_torch.models.mapanything import scene_rep_outputs
from mapanything_tpu_torch.nn import dinov2 as PD
from mapanything_tpu_torch.nn import layers as PL
from mapanything_tpu_torch.nn import radio as PR
from mapanything_tpu_torch.nn import rope as PRope
from mapanything_tpu_torch.nn import trunk as PT
from mapanything_tpu_torch.nn.adaptors import pose_adaptor, scale_adaptor
from mapanything_tpu_torch.ops import attention as PA
from mapanything_tpu_torch.ops.flash_attention import (
    flash_attention,
    reset_launch_counts,
)
from mapanything_tpu_torch.utils.inference import postprocess_outputs
from mapanything_tpu_torch.utils.weights import load_jax_params

HIGHEST = "highest"
MODULE_TOL, MODEL_TOL = 1e-5, 1e-4
TINY = dict(encoder_size="test", trunk_dim=64, trunk_depth=2,
            trunk_num_heads=2, trunk_indices=(0, 1), dpt_feature_dim=32,
            dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
FAMILIES = ("pointmap", "raymap+depth", "raydirs+depth+pose",
            "campointmap+pose", "pointmap+raydirs+depth+pose")
ARMS = [f + flags for f in FAMILIES
        for flags in ("", "+confidence", "+mask", "+confidence+mask")]


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _perturb(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(np.shape(x)))
        .astype(np.float32), params)


def _init(module, seed, *args, **kw):
    with jax.default_matmul_precision(HIGHEST):
        params = module.init(jax.random.PRNGKey(seed), *args, **kw)
    return _perturb(params, seed)


def _apply(module, params, *args, **kw):
    with jax.default_matmul_precision(HIGHEST):
        return jax.tree.map(np.asarray, module.apply(params, *args, **kw))


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_close_rel(out, ref, tol=MODEL_TOL, name=""):
    """max |out - ref| <= tol * max(1, max |ref|)."""
    if isinstance(out, torch.Tensor):
        out = out.detach().float().numpy()
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    assert np.isfinite(out).all(), name
    err = np.max(np.abs(out - ref)) if out.size else 0.0
    bound = tol * max(1.0, float(np.max(np.abs(ref))) if ref.size else 1.0)
    assert err <= bound, f"{name}: max abs err {err:.3g} > {bound:.3g}"


# --- RoPE, attention ---------------------------------------------------------


def test_rope_tables_and_apply():
    for gh, gw, d in ((5, 6, 32), (37, 37, 64)):
        cos, sin = PRope.rope_2d_cos_sin(gh, gw, d, 100.0)
        jcos, jsin = JRope.rope_2d_cos_sin(gh, gw, d, 100.0)
        np.testing.assert_array_equal(cos, np.asarray(jcos))
        np.testing.assert_array_equal(sin, np.asarray(jsin))
    x = _rand(1, 2, 30, 2, 32)
    cos, sin = PRope.rope_tables(5, 6, 32, 100.0, "cpu")
    ref = np.asarray(JRope.apply_rope(jnp.asarray(x),
                                      *JRope.rope_2d_cos_sin(5, 6, 32)))
    assert_close_rel(PRope.apply_rope(_t(x), cos, sin), ref, MODULE_TOL)


@pytest.mark.parametrize("rope,base,n_valid", [
    (True, None, None), (False, 16, None), (False, 16, 40), (True, 16, None)])
def test_attention_rope_and_entropy_scaling(rope, base, n_valid):
    x = _rand(2, 2, 48, 64)
    tables = JRope.rope_2d_cos_sin(6, 8, 32) if rope else None
    jm = JL.Attention(64, 2, entropy_scaling_base=base)
    params = _init(jm, 2, x)
    ref = _apply(jm, params, x, tables, n_valid)
    port = load_jax_params(PL.Attention(64, 2), params)
    with torch.no_grad():
        out = port(_t(x), n_valid=n_valid,
                   rope=PRope.rope_tables(6, 8, 32, 100.0, "cpu")
                   if rope else None, entropy_scaling_base=base)
    real = 48 if n_valid is None else n_valid
    assert_close_rel(out[:, :real], ref[:, :real], MODULE_TOL)


@pytest.mark.parametrize("batched", [False, True])
def test_sdpa_key_mask(batched):
    q, k, v = (_rand(3 + i, 2, 20 if i == 0 else 30, 2, 64)
               for i in range(3))
    mask = np.random.default_rng(6).random((2, 30) if batched else 30) > 0.4
    with jax.default_matmul_precision(HIGHEST):
        ref = np.asarray(_sdpa_xla(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), key_mask=jnp.asarray(mask)))
    for impl in ("auto", "math"):
        out = PA.sdpa(_t(q), _t(k), _t(v), impl=impl, key_mask=_t(mask))
        assert_close_rel(out, ref, MODULE_TOL, impl)


# --- trunks -------------------------------------------------------------------

FEATS, TOK = _rand(10, 1, 3, 4, 5, 48), _rand(11, 1, 1, 48)
TRUNK_KW = dict(input_embed_dim=48, dim=64, depth=4, num_heads=2,
                indices=(1, 2))


def _trunk_pair(jcls, pcls, seed, jkw=None, pkw=None, feats=FEATS, tok=TOK):
    jm = jcls(**TRUNK_KW, **(jkw or {}))
    params = _init(jm, seed, feats, tok)
    port = load_jax_params(pcls(**TRUNK_KW, **(pkw or {})), params)
    return jm, params, port


def _assert_trunk(got, ref):
    assert_close_rel(got[0], ref[0], MODEL_TOL, "final")
    assert_close_rel(got[2], ref[2], MODEL_TOL, "tok")
    assert len(got[1]) == len(ref[1])
    for a, b in zip(got[1], ref[1]):
        assert_close_rel(a, b, MODEL_TOL, "tap")


def test_global_trunk():
    kw = dict(pad_tokens_to=32)
    jm, params, port = _trunk_pair(JT.GlobalAttentionTrunk,
                                   PT.GlobalAttentionTrunk, 12, kw, kw)
    reset_launch_counts()
    with torch.no_grad():
        got = port(_t(FEATS), _t(TOK))
    assert flash_attention.plain_launches == 4  # every layer global
    _assert_trunk(got, _apply(jm, params, FEATS, TOK))


@pytest.mark.parametrize("impl", ["auto", "math"])
def test_cross_trunk_against_jax_masked_form(impl):
    """The port's gathered contexts ("auto", the kernel's form: one call
    per branch and per layer) and its masked math ("math") against JAX's
    shared context under a key mask."""
    jm, params, port = _trunk_pair(JT.CrossAttentionTrunk,
                                   PT.CrossAttentionTrunk, 13)
    for mod in port.modules():
        if hasattr(mod, "attn_impl"):
            mod.attn_impl = impl
    reset_launch_counts()
    with torch.no_grad():
        got = port(_t(FEATS), _t(TOK))
    if impl == "auto":  # ref, others, token: self + cross each, per layer
        assert flash_attention.plain_launches == 4 * 6
    _assert_trunk(got, _apply(jm, params, FEATS, TOK))


def test_other_views_index():
    idx = PT.other_views_index(3, 2, 1)
    np.testing.assert_array_equal(idx, [[2, 3, 4, 5, 6], [0, 1, 4, 5, 6],
                                        [0, 1, 2, 3, 6]])


@pytest.mark.parametrize("option", ["view_pe", "rope", "entropy"])
def test_alternating_trunk_options(option):
    kw = {"view_pe": dict(use_view_pe=True),
          "rope": dict(rope_freq=100.0),
          "entropy": dict(use_entropy_scaling=True)}[option]
    pad = dict(pad_tokens_to=32)
    jm, params, port = _trunk_pair(
        JT.AlternatingAttentionTrunk, PT.AlternatingAttentionTrunk, 14,
        {**kw, **pad}, {**kw, **pad})
    with torch.no_grad():
        got = port(_t(FEATS), _t(TOK))
    ref = _apply(jm, params, FEATS, TOK)
    _assert_trunk(got, ref)
    if option == "view_pe":  # rows picked by explicit indices
        idx = np.array([[0, 7, 3]])
        with torch.no_grad():
            got = port(_t(FEATS), _t(TOK), view_indices=_t(idx))
        _assert_trunk(got, _apply(jm, params, FEATS, TOK,
                                  view_indices=jnp.asarray(idx)))
    if option == "entropy":  # as JAX's TestTrunkOptions: it changes output
        plain = load_jax_params(PT.AlternatingAttentionTrunk(**TRUNK_KW,
                                                             **pad), params)
        with torch.no_grad():
            assert (plain(_t(FEATS), _t(TOK))[0] - got[0]).abs().max() > 1e-6


# --- encoders -------------------------------------------------------------------


@pytest.mark.parametrize("registers", [0, 2])
def test_radio_vit(registers):
    x = np.random.default_rng(15).random((2, 48, 80, 3)).astype(np.float32)
    kw = dict(size="test", patch_size=16, img_size=64,
              num_register_tokens=registers)
    jm = JR.RadioViT(**kw)
    params = _init(jm, 15, x)
    port = load_jax_params(PR.RadioViT(**kw), params)
    with torch.no_grad():
        out = port(_t(x))
    assert out.shape == (2, 3, 5, 64)
    assert_close_rel(out, _apply(jm, params, x), MODULE_TOL * 10)


@pytest.mark.parametrize("registers,fold", [(2, False), (0, True), (3, True)])
def test_dinov2_registers_and_folded_layerscale(registers, fold):
    x = _rand(16, 2, 70, 84, 3)
    kw = dict(size="test", num_register_tokens=registers,
              fold_layerscale=fold, pad_tokens_to=128)
    jm = JD.DinoViT(**kw)
    params = _init(jm, 16, x)
    port = load_jax_params(PD.DinoViT(**kw), params)
    assert all(blk.ls1 is None for blk in port.blocks) == fold
    with torch.no_grad():
        out = port(_t(x))
    assert_close_rel(out, _apply(jm, params, x), MODULE_TOL * 10)


def test_ablations_preset():
    cfg = mapanything_ablations_config(**TINY)
    jcfg = jax_ablations_config(**TINY)
    assert (cfg.use_scale_token, cfg.trunk_rope_freq) == (
        jcfg.use_scale_token, jcfg.trunk_rope_freq) == (False, 100.0)
    model = MapAnything(cfg, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert not any("scale_token" in n or "scale_head" in n for n in names)


def _tiny_model(**kw):
    return MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY, **kw),
                       device="cpu",
                       generator=torch.Generator().manual_seed(0)).eval()


def test_view_pe_drawn_from_the_generator():
    """Inference takes the view indices; a forward given a generator draws
    the other views' rows from it (the JAX package from its rng)."""
    model = _tiny_model(use_view_pe=True)
    views = {"img": _t(_rand(19, 1, 3, 28, 42, 3, scale=0.3))}
    with torch.no_grad():
        i1, i2 = model(views)["pts3d"], model(views)["pts3d"]
        g = [torch.Generator().manual_seed(s) for s in (2, 3, 2)]
        o = [model(views, generator=gen)["pts3d"] for gen in g]
    torch.testing.assert_close(i1, i2, rtol=0, atol=0)
    torch.testing.assert_close(o[0], o[2], rtol=0, atol=0)
    assert (o[0] - o[1]).abs().max() > 0
    idx = model.view_pe_indices(1, 3, torch.Generator().manual_seed(2))
    assert idx[0, 0] == 0 and (idx[0, 1:] >= 1).all()


def test_cross_scale_token_conditions_on_input():
    model = _tiny_model(info_sharing_type="cross")
    with torch.no_grad():
        sa, sb = (model({"img": _t(_rand(s, 1, 2, 28, 28, 3, scale=0.3))})
                  ["metric_scaling_factor"] for s in (20, 21))
    assert (sa - sb).abs().max() > 1e-8


@pytest.mark.parametrize("field,value,match", [
    ("encoder_type", "bogus", "encoder_type"),
    ("info_sharing_type", "ring", "info_sharing_type"),
    ("scene_rep_type", "bogus", "scene_rep_type"),
    ("dense_output_dim", 5, "dense_output_dim"),
])
def test_rejections(field, value, match):
    with pytest.raises(ValueError, match=match):
        MapAnything(MapAnythingConfig(**TINY, **{field: value}),
                    device="cpu")


def test_seq_group_needs_the_alternating_trunk():
    model = _tiny_model(info_sharing_type="global")
    with pytest.raises(ValueError, match="alternating"):
        model({"img": torch.zeros(1, 2, 28, 28, 3)}, seq_group=object())


# --- the 20 arms' recombination and the postprocess -----------------------------

B, V, H, W = 1, 2, 28, 28
RAW = _rand(30, B * V, H, W, 9, scale=0.5)
RAW_POSE = _rand(31, B * V, 7)
RAW_SCALE = _rand(32, B, 1, scale=0.3)


@pytest.fixture(scope="module")
def jax_arm_outputs():
    """The JAX model's recombination of each arm on the shared raw head
    outputs: its encoder, trunk and heads replaced by interceptors that
    return RAW, RAW_POSE and RAW_SCALE (one init, no model per arm)."""
    base = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **TINY))
    views = {"img": jnp.zeros((B, V, H, W, 3))}
    with jax.default_matmul_precision(HIGHEST):
        params = base.init(jax.random.PRNGKey(0), views, jax_images_only())

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        if isinstance(mod, JD.DinoViT):
            return jnp.zeros((B * V, H // 14, W // 14, 64))
        if isinstance(mod, JT.AlternatingAttentionTrunk):
            x = jnp.zeros((B, V, H // 14, W // 14, 64))
            return x, [x, x], jnp.zeros((B, 1, 64))
        if isinstance(mod, JM._DenseHead):
            return jnp.asarray(RAW[..., :mod.cfg.dense_output_dim])
        if isinstance(mod, JH.PoseHead):
            return jnp.asarray(RAW_POSE)
        if isinstance(mod, JH.MLPHead):
            return jnp.asarray(RAW_SCALE)
        return next_fun(*args, **kwargs)

    out = {}
    for arm in ARMS + ["pointmap+raydirs+depth+pose:direct"]:
        srt, _, direct = arm.partition(":")
        cfg = JaxConfig(dtype=jnp.float32, scene_rep_type=srt,
                        dense_output_dim=dense_dim_for(srt),
                        use_factored_global_pointmaps=not direct, **TINY)
        with fnn.intercept_methods(interceptor):
            out[arm] = _apply(JaxMapAnything(cfg=cfg), params, views,
                              jax_images_only())
    return out


def _port_arm(arm):
    srt, _, direct = arm.partition(":")
    raw = _t(RAW[..., :dense_dim_for(srt)]).reshape(B, V, H, W, -1)
    pose = (pose_adaptor(_t(RAW_POSE).reshape(B, V, 7))
            if "pose" in srt else None)
    return scene_rep_outputs(srt, raw, scale_adaptor(_t(RAW_SCALE))[:, 0],
                             pose, use_factored_global_pointmaps=not direct)


@pytest.mark.parametrize("arm",
                         ARMS + ["pointmap+raydirs+depth+pose:direct"])
def test_scene_rep_arm(jax_arm_outputs, arm):
    ref, out = jax_arm_outputs[arm], _port_arm(arm)
    assert set(out) == set(ref), arm
    for key, val in ref.items():
        if val.dtype == bool:
            np.testing.assert_array_equal(out[key].numpy(), val, key)
        else:
            assert_close_rel(out[key], val, MODULE_TOL, key)


@pytest.mark.parametrize("family", FAMILIES)
def test_postprocess_each_family(jax_arm_outputs, family):
    """postprocess_outputs on each family's outputs. JAX's edge mask reads
    depth_z, which the pointmap and raymap+depth families lack (it raises
    KeyError there), so those compare without edges; the port skips the
    edge step for them, and with edges gives the same."""
    arm = family + "+confidence+mask"
    imgs = _rand(33, B, V, H, W, 3, scale=0.5)
    edges = family not in ("pointmap", "raymap+depth")
    kw = dict(apply_confidence_mask=True, mask_edges=edges)
    with jax.default_matmul_precision(HIGHEST):
        ref = jax.tree.map(np.asarray, jax_postprocess(
            {k: jnp.asarray(v) for k, v in jax_arm_outputs[arm].items()},
            jnp.asarray(imgs), **kw))
    out = postprocess_outputs(_port_arm(arm), _t(imgs), **kw)
    assert set(out) == set(ref)
    assert ("camera_poses" in out) == family.endswith("pose")
    assert ("ray_origins" in out) == (family == "raymap+depth")
    for key, val in ref.items():
        if val.dtype == bool:
            assert np.mean(out[key].numpy() == val) >= 0.999, key
        else:
            assert_close_rel(out[key], val, MODEL_TOL, key)
    if not edges:
        with_edges = postprocess_outputs(_port_arm(arm), _t(imgs),
                                         apply_confidence_mask=True)
        torch.testing.assert_close(with_edges["mask"], out["mask"])


def test_train_step_refuses_other_scene_reps():
    """A pointmap model's outputs lack the factored rays, depth, pose and
    confidence that the released criterion reads: both train steps refuse
    it, naming the missing keys and the criteria that take the family."""
    from mapanything_tpu_torch.models import images_only_config
    from mapanything_tpu_torch.train.seq_parallel import (
        make_view_sharded_train_step,
    )
    from mapanything_tpu_torch.train.step import make_train_step

    model = _tiny_model(scene_rep_type="pointmap", dense_output_dim=3)
    with pytest.raises(ValueError, match="cam_quats.*Regr3D"):
        make_train_step(model, images_only_config())
    with pytest.raises(ValueError, match="view-sharded.*cam_quats"):
        make_view_sharded_train_step(model, images_only_config())


@pytest.fixture(scope="module")
def jax_loss_gt():
    from mapanything_tpu.data.synthetic import make_synthetic_batch

    with jax.default_matmul_precision(HIGHEST):
        return make_synthetic_batch(B, V, H, W, seed=3)["gt"]


def _jax_total(gt, preds):
    from mapanything_tpu.train.losses import overall_loss

    return overall_loss(gt, preds)[0]


@pytest.mark.parametrize("arm", ARMS)
def test_train_gate_matches_jax_loss(jax_arm_outputs, jax_loss_gt, arm):
    """make_train_step takes exactly the arms whose outputs JAX's
    overall_loss (its make_train_step's loss) reads without error."""
    from mapanything_tpu_torch.models import images_only_config
    from mapanything_tpu_torch.train.step import make_train_step

    preds = {k: jnp.asarray(v) for k, v in jax_arm_outputs[arm].items()}
    try:  # a missing key raises while tracing; the arms it takes share
        with jax.default_matmul_precision(HIGHEST):  # one compile
            loss = float(jax.jit(_jax_total)(jax_loss_gt, preds))
        jax_trains = np.isfinite(loss)
    except KeyError:
        jax_trains = False
    model = MapAnything(MapAnythingConfig(
        dtype=torch.float32, **TINY, scene_rep_type=arm,
        dense_output_dim=dense_dim_for(arm)), device="cpu")
    try:
        make_train_step(model, images_only_config())
        port_trains = True
    except ValueError:
        port_trains = False
    assert port_trains == jax_trains, arm
    assert jax_trains == (arm.endswith("pose+confidence+mask")), arm


def test_luma_histograms_rank_like_jax():
    """demo_colmap's frame descriptors for a CroCo or RADIO model: JAX's
    64-bin luma histograms (scripts/demo_colmap.py), equal counts."""
    from mapanything_tpu.utils.tracking import to_gray as jax_to_gray
    from mapanything_tpu_torch.demo_colmap import luma_histograms

    imgs = np.random.default_rng(34).random((3, 20, 24, 3)).astype(np.float32)
    ref = np.stack([np.asarray(jnp.histogram(jax_to_gray(jnp.asarray(im)),
                                             bins=64, range=(0, 1))[0])
                    for im in imgs])
    np.testing.assert_array_equal(luma_histograms(_t(imgs)).numpy(), ref)


def test_cross_trunk_gradients_match_masked_form():
    """The gathered contexts stay differentiable (FlashAttention and the
    gather): the parameter gradients equal the masked math form's."""
    grads = []
    for impl in ("auto", "math"):
        trunk = PL.init_weights_(
            PT.CrossAttentionTrunk(**TRUNK_KW, device="cpu"),
            torch.Generator().manual_seed(0))
        for mod in trunk.modules():
            if hasattr(mod, "attn_impl"):
                mod.attn_impl = impl
        final, _, tok = trunk(_t(FEATS), _t(TOK))
        (final.square().sum() + tok.square().sum()).backward()
        grads.append({n: p.grad for n, p in trunk.named_parameters()
                      if p.grad is not None})
    assert set(grads[0]) == set(grads[1])
    for name, g in grads[1].items():
        assert_close_rel(grads[0][name], g.numpy(), MODEL_TOL, name)
