"""The second model family on the CPU: CroCo (nn/croco.py), LinearFeature,
ModularDUSt3R, its adapter and the rigid registration behind it, and the
CroCo checkpoint conversion, each against the JAX package's counterpart.

Every test feeds the same seeded numpy inputs (and the same parameters,
JAX's init carried across by utils/weights.py::load_jax_params) to both
packages, fp32, the JAX side under jax.default_matmul_precision("highest").
Tolerances: the sin-cos table and convert_croco bitwise; the blocks
(CrossAttention, DecoderBlock, CroCoViT, LinearFeature) within 1e-5 of
the reference's largest magnitude; the whole model and the adapter within
1e-4 (each factored key; poses compared as 4x4 matrices, since a
quaternion's sign is free); the registration within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapanything_tpu.geometry import pose_quats_trans_to_matrix as jax_pose
from mapanything_tpu.geometry import quaternion_to_rotation_matrix as jax_q2r
from mapanything_tpu.geometry import rigid_points_registration as jax_rigid
from mapanything_tpu.models import MODEL_CONFIGS as JAX_MODEL_CONFIGS
from mapanything_tpu.models import ModularDUSt3R as JaxDUSt3R
from mapanything_tpu.models import ModularDUSt3RConfig as JaxDUSt3RConfig
from mapanything_tpu.models.adapters import ModularDUSt3RAdapter as JaxAdapter
from mapanything_tpu.nn import croco as JC
from mapanything_tpu.nn.heads import LinearFeature as JaxLinearFeature
from mapanything_tpu.utils.weights import convert_croco as jax_convert_croco
from mapanything_tpu_torch.geometry import (
    pose_quats_trans_to_matrix,
    quaternion_to_rotation_matrix,
    rigid_points_registration,
)
from mapanything_tpu_torch.models import (
    MODEL_CONFIGS,
    ModularDUSt3R,
    ModularDUSt3RConfig,
    model_factory,
)
from mapanything_tpu_torch.models.adapters import (
    FACTORED_PRED_KEYS,
    ModularDUSt3RAdapter,
)
from mapanything_tpu_torch.nn import croco as PC
from mapanything_tpu_torch.nn.heads import LinearFeature
from mapanything_tpu_torch.utils.weights import convert_croco, load_jax_params

BLOCK_TOL = 1e-5
MODEL_TOL = 1e-4
TINY = dict(encoder_size="test", patch_size=4, decoder_dim=64,
            decoder_depth=2, decoder_num_heads=2)
H = W = 16


def rel_max(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def jax_init(module, *args, seed=0):
    with jax.default_matmul_precision("highest"):
        return jax.jit(module.init)(jax.random.PRNGKey(seed), *args)


def jax_apply(module, params, *args):
    with jax.default_matmul_precision("highest"):
        return module.apply(params, *args)


def perturbed(params, seed):
    """JAX's init with seeded noise on every leaf, so that zero biases and
    unit LayerNorm scales do not hide a misplaced parameter."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), params)


def port(module, params):
    return load_jax_params(module, params).eval()


def randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("gh,gw,dim", [(3, 5, 8), (24, 32, 64),
                                       (24, 32, 1024)])
def test_sincos_pos_embed_bitwise(gh, gw, dim):
    np.testing.assert_array_equal(PC.sincos_pos_embed_2d(gh, gw, dim),
                                  JC.sincos_pos_embed_2d(gh, gw, dim))


@pytest.mark.parametrize("n,m", [(12, 12), (10, 14)])
def test_cross_attention_matches_jax(n, m):
    x, ctx = randn(2, n, 64, seed=1), randn(2, m, 64, seed=2)
    jmod = JC.CrossAttention(64, 4)
    params = perturbed(jax_init(jmod, x, ctx), 3)
    ref = jax_apply(jmod, params, x, ctx)
    pmod = port(PC.CrossAttention(64, 4, device="cpu"), params)
    with torch.no_grad():
        got = pmod(torch.from_numpy(x), torch.from_numpy(ctx))
    assert rel_max(got, ref) <= BLOCK_TOL


def test_cross_attention_refuses_key_mask():
    """A key mask on CPU tensors runs the math path and gives JAX's masked
    cross-attention; on the card it is refused unless "math" is asked for
    (tests/test_torch_variants_cuda.py)."""
    x, ctx = randn(2, 12, 64, seed=7), randn(2, 14, 64, seed=8)
    mask = np.arange(14) % 3 != 1
    jmod = JC.CrossAttention(64, 4)
    params = perturbed(jax_init(jmod, x, ctx), 9)
    ref = jax_apply(jmod, params, x, ctx, jnp.asarray(mask))
    pmod = port(PC.CrossAttention(64, 4, device="cpu"), params)
    with torch.no_grad():
        got = pmod(torch.from_numpy(x), torch.from_numpy(ctx),
                   key_mask=torch.from_numpy(mask))
    assert rel_max(got, ref) <= BLOCK_TOL


def test_decoder_block_matches_jax():
    x, ctx = randn(2, 12, 64, seed=4), randn(2, 12, 64, seed=5)
    jmod = JC.DecoderBlock(64, 2)
    params = perturbed(jax_init(jmod, x, ctx), 6)
    ref = jax_apply(jmod, params, x, ctx)
    pmod = port(PC.DecoderBlock(64, 2, device="cpu"), params)
    with torch.no_grad():
        got = pmod(torch.from_numpy(x), torch.from_numpy(ctx))
    assert rel_max(got, ref) <= BLOCK_TOL


@pytest.mark.parametrize("h,w", [(16, 16), (16, 24)])
def test_croco_vit_matches_jax(h, w):
    img = randn(2, h, w, 3, seed=7)
    jmod = JC.CroCoViT(size="test", patch_size=4)
    params = perturbed(jax_init(jmod, img), 8)
    ref = jax_apply(jmod, params, img)
    pmod = port(PC.CroCoViT("test", 4, device="cpu"), params)
    with torch.no_grad():
        got = pmod(torch.from_numpy(img))
    assert got.shape == ref.shape == (2, h // 4, w // 4, 64)
    assert rel_max(got, ref) <= BLOCK_TOL


@pytest.mark.parametrize("patch", [4, 16])
def test_linear_feature_matches_jax(patch):
    # the pixel shuffle's permutation shows only against the reference
    x = randn(2, 3, 5, 32, seed=9)
    jmod = JaxLinearFeature(32, output_dim=4, patch_size=patch)
    params = perturbed(jax_init(jmod, x), 10)
    ref = jax_apply(jmod, params, x)
    pmod = port(LinearFeature(32, 4, patch, device="cpu"), params)
    with torch.no_grad():
        got = pmod(torch.from_numpy(x))
    assert got.shape == ref.shape == (2, 3 * patch, 5 * patch, 4)
    assert rel_max(got, ref) <= BLOCK_TOL


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX ModularDUSt3R at tests/test_adapters.py's TINY_DUST3R, its
    perturbed params, and the port's model holding them."""
    jmodel = JaxDUSt3R(cfg=JaxDUSt3RConfig(dtype=jnp.float32, **TINY))
    params = perturbed(
        jax_init(jmodel, {"img": np.zeros((1, 2, H, W, 3), np.float32)}), 11)
    pmodel = port(ModularDUSt3R(ModularDUSt3RConfig(dtype=torch.float32,
                                                    **TINY), device="cpu"),
                  params)
    return jmodel, params, pmodel


def test_modular_dust3r_matches_jax(tiny_pair):
    jmodel, params, pmodel = tiny_pair
    img = randn(2, 2, H, W, 3, seed=12)
    ref = jax_apply(jmodel, params, {"img": img})
    with torch.no_grad():
        got = pmodel({"img": torch.from_numpy(img)})
    assert set(got) == {"pts3d", "conf"}
    for key in ("pts3d", "conf"):
        assert got[key].shape == ref[key].shape
        assert rel_max(got[key], ref[key]) <= MODEL_TOL, key


def test_modular_dust3r_refuses_other_view_counts(tiny_pair):
    with pytest.raises(ValueError, match="2-view"):
        tiny_pair[2]({"img": torch.zeros(1, 3, H, W, 3)})


def test_adapter_matches_jax(tiny_pair):
    jmodel, params, pmodel = tiny_pair
    img = randn(2, 2, H, W, 3, seed=13)
    with jax.default_matmul_precision("highest"):
        ref = JaxAdapter(jmodel).apply(params, {"img": jnp.asarray(img)})
    with torch.no_grad():
        got = ModularDUSt3RAdapter(pmodel)({"img": torch.from_numpy(img)})
    assert set(got) == set(FACTORED_PRED_KEYS)
    for key in FACTORED_PRED_KEYS:
        assert tuple(got[key].shape) == ref[key].shape, key
        if key in ("cam_quats", "cam_trans"):
            continue
        if got[key].dtype == torch.bool:
            assert np.array_equal(got[key].numpy(), np.asarray(ref[key]))
        else:
            assert rel_max(got[key], ref[key]) <= MODEL_TOL, key
    poses = pose_quats_trans_to_matrix(got["cam_quats"], got["cam_trans"])
    ref_poses = jax_pose(ref["cam_quats"], ref["cam_trans"])
    assert rel_max(poses, ref_poses) <= MODEL_TOL
    np.testing.assert_array_equal(got["cam_quats"][:, 0].numpy(),
                                  [[0, 0, 0, 1]] * 2)


def test_adapter_through_the_benchmark_unmodified(tiny_pair, tmp_path):
    """The second model through the dense N-view harness as it stands."""
    import json

    from mapanything_tpu_torch.benchmarks import run_dense_n_view_benchmark
    from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
    from torch_eval_oracles import ListLoader

    batch = make_synthetic_batch(2, 2, H, W, seed=3, device="cpu")
    out = tmp_path / "dust3r.json"
    summary = run_dense_n_view_benchmark(
        ModularDUSt3RAdapter(tiny_pair[2]), ListLoader([batch]), None,
        output_json=str(out))
    assert summary["num_sets"] == 2
    for key in ("pointmaps_abs_rel", "depth_abs_rel", "pose_ate_rmse"):
        assert np.isfinite(summary[key]), summary
    assert len(json.loads(out.read_text())["per_set"]) == 2


def known_transform(seed, n, batch=(), scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    r = np.asarray(jax_q2r(jnp.asarray(q, jnp.float32)))
    t = rng.normal(size=3).astype(np.float32)
    a = rng.normal(size=(*batch, n, 3)).astype(np.float32)
    b = (scale * np.einsum("ij,...nj->...ni", r, a) + t).astype(np.float32)
    return r, t, a, b


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_rigid_points_registration_matches_jax(with_scale, weighted):
    r_true, t_true, a, b = known_transform(0, 60, (3,), scale=2.5)
    rng = np.random.default_rng(1)
    b = b + 0.05 * rng.standard_normal(b.shape).astype(np.float32)
    w = rng.uniform(0.1, 2.0, (3, 60)).astype(np.float32) if weighted else None
    with jax.default_matmul_precision("highest"):
        ref = jax_rigid(jnp.asarray(a), jnp.asarray(b),
                        None if w is None else jnp.asarray(w),
                        with_scale=with_scale)
    got = rigid_points_registration(
        torch.from_numpy(a), torch.from_numpy(b),
        None if w is None else torch.from_numpy(w), with_scale=with_scale)
    assert len(got) == len(ref) == (3 if with_scale else 2)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


def test_rigid_points_registration_recovers_scale_and_skips_outliers():
    """tests/test_adapters.py's case: zero weights on corrupted points."""
    a = np.random.default_rng(1).normal(size=(40, 3)).astype(np.float32)
    b = 2.5 * a + np.asarray([1.0, -2.0, 0.5], np.float32)
    b[:5] += 100.0
    w = np.ones(40, np.float32)
    w[:5] = 0.0
    r, t, s = rigid_points_registration(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(w),
        with_scale=True)
    np.testing.assert_allclose(float(s), 2.5, rtol=1e-4)
    np.testing.assert_allclose(r.numpy(), np.eye(3), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), [1.0, -2.0, 0.5], atol=1e-4)


def umeyama_fp64(a, b, w):
    """The weighted Umeyama fit in numpy fp64: (R, t, s)."""
    a, b, w = (np.asarray(x, np.float64) for x in (a, b, w))
    w = w / w.sum()
    mu_a, mu_b = w @ a, w @ b
    ac, bc = a - mu_a, b - mu_b
    u, sv, vt = np.linalg.svd((bc * w[:, None]).T @ ac)
    d = np.array([1.0, 1.0, np.linalg.det(u @ vt)])
    r = (u * d) @ vt
    s = (sv * d).sum() / (w @ (ac * ac).sum(-1))
    return r, mu_b - s * r @ mu_a, s


def test_rigid_points_registration_sums_in_fp64():
    """An image's worth of fp32 points far from their origin (518 x 392,
    offset 50): the fit is the fp64 inputs' fit rounded once to fp32
    (bitwise), and matches numpy's fp64 one."""
    rng = np.random.default_rng(7)
    r_true, t_true, a, b = known_transform(8, 518 * 392, scale=0.5)
    a = (a + 50.0).astype(np.float32)
    b = (b + 0.01 * rng.standard_normal(b.shape)).astype(np.float32)
    w = rng.uniform(0.1, 2.0, len(a)).astype(np.float32)
    got = rigid_points_registration(torch.from_numpy(a), torch.from_numpy(b),
                                    torch.from_numpy(w), with_scale=True)
    wide = rigid_points_registration(
        *(torch.from_numpy(x).double() for x in (a, b, w)), with_scale=True)
    for g, x in zip(got, wide):
        assert g.dtype == torch.float32
        assert torch.equal(g, x.float())
    for g, want in zip(got, umeyama_fp64(a, b, w)):
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-6, atol=1e-6)


def test_adapter_recovers_a_known_pose():
    """A stub model whose forward and swapped runs are related by a known
    rigid transform (tests/test_adapters.py:124): the adapter recovers it."""
    h = w = 8
    r_true, t_true, pts2_cam, pts2_in_v1 = known_transform(5, h * w)
    pts2_cam = pts2_cam.reshape(1, h, w, 3)
    pts2_in_v1 = pts2_in_v1.reshape(1, h, w, 3)
    pts1 = np.random.default_rng(6).normal(size=(1, h, w, 3)).astype(
        np.float32)
    calls = []

    def stub(views):
        first = np.stack([pts2_cam[0], pts1[0]]) if calls else np.stack(
            [pts1[0], pts2_in_v1[0]])
        calls.append(1)
        return {"pts3d": torch.from_numpy(first[None]),
                "conf": torch.ones(1, 2, h, w)}

    preds = ModularDUSt3RAdapter(stub)({"img": torch.zeros(1, 2, h, w, 3)})
    r_rec = quaternion_to_rotation_matrix(preds["cam_quats"][:, 1])[0]
    np.testing.assert_allclose(r_rec.numpy(), r_true, atol=1e-4)
    np.testing.assert_allclose(preds["cam_trans"][0, 1].numpy(), t_true,
                               atol=1e-4)
    np.testing.assert_allclose(preds["pts3d_cam"][0, 1].numpy(), pts2_cam[0])
    assert float(preds["metric_scaling_factor"][0]) == 1.0


def fake_croco_state_dict(depth=2, dim=64, with_pos=True, prefix=""):
    rng = np.random.default_rng(14)
    sd = {}

    def put(k, *shape):
        sd[prefix + k] = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))

    put("patch_embed.proj.weight", dim, 3, 4, 4)
    put("patch_embed.proj.bias", dim)
    for i in range(depth):
        b = f"enc_blocks.{i}."
        for name, shape in (("norm1", (dim,)), ("norm2", (dim,))):
            put(b + name + ".weight", *shape)
            put(b + name + ".bias", *shape)
        put(b + "attn.qkv.weight", 3 * dim, dim)
        put(b + "attn.qkv.bias", 3 * dim)
        put(b + "attn.proj.weight", dim, dim)
        put(b + "attn.proj.bias", dim)
        put(b + "mlp.fc1.weight", 4 * dim, dim)
        put(b + "mlp.fc1.bias", 4 * dim)
        put(b + "mlp.fc2.weight", dim, 4 * dim)
        put(b + "mlp.fc2.bias", dim)
    put("enc_norm.weight", dim)
    put("enc_norm.bias", dim)
    if with_pos:
        put("enc_pos_embed", 16, dim)
    return sd


@pytest.mark.parametrize("with_pos,prefix", [(True, ""),
                                             (False, "encoder.")])
def test_convert_croco_bitwise_and_loads(with_pos, prefix):
    sd = fake_croco_state_dict(with_pos=with_pos, prefix=prefix)
    tree, used = convert_croco(sd, prefix)
    ref_tree, ref_used = jax_convert_croco(sd, prefix)
    assert used == ref_used == len(sd)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    ref_flat = jax.tree_util.tree_leaves_with_path(ref_tree)
    assert [p for p, _ in flat] == [p for p, _ in ref_flat]
    for (_, x), (_, y) in zip(flat, ref_flat):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # the tree loads onto the port's CroCoViT of that shape ("test")
    model = load_jax_params(PC.CroCoViT("test", 4, device="cpu"), tree)
    np.testing.assert_array_equal(
        model.blocks[1].attn.qkv.weight.detach().numpy(),
        sd[prefix + "enc_blocks.1.attn.qkv.weight"].numpy())


def test_model_factory_builds_each_family():
    assert set(MODEL_CONFIGS) == set(JAX_MODEL_CONFIGS)
    gen = torch.Generator().manual_seed(0)
    model = model_factory("modular_dust3r", device="cpu", generator=gen,
                          dtype=torch.float32, **TINY)
    assert isinstance(model, ModularDUSt3R)
    ref_cfg = JAX_MODEL_CONFIGS["modular_dust3r"](**TINY)
    for field in TINY:
        assert getattr(model.cfg, field) == getattr(ref_cfg, field)
    out = model({"img": torch.zeros(1, 2, H, W, 3)})
    assert out["pts3d"].shape == (1, 2, H, W, 3)
    assert torch.isfinite(out["pts3d"]).all()
    with pytest.raises(ValueError, match="unknown model"):
        model_factory("vggt", device="cpu")


def test_set_attn_impl_reaches_every_attention(tiny_pair):
    pmodel = tiny_pair[2]
    img = torch.from_numpy(randn(1, 2, H, W, 3, seed=15))
    with torch.no_grad():
        flash = pmodel({"img": img})["pts3d"]
        pmodel.set_attn_impl("math")
        try:
            impls = {m.attn_impl for m in pmodel.modules()
                     if hasattr(m, "attn_impl")}
            math_out = pmodel({"img": img})["pts3d"]
        finally:
            pmodel.set_attn_impl("auto")
    assert impls == {"math"}
    assert rel_max(math_out, flash) <= BLOCK_TOL
