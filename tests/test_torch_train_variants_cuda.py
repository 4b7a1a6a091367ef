"""Training the model variants on the card: the training kernels at the
variants' shapes and a small-depth variant step, flash against math.

This file imports no JAX, so it also runs on the GPU machine:
``python -m pytest tests/test_torch_train_variants_cuda.py -m cuda
--noconftest``. Every test needs a card and skips without one.

  * the forward with lse, dK/dV and dQ against their plain versions
    (chip_smoke.py's 16c method and limit: max-abs over the plain's max-abs
    and rel-L2 within 1e-2, over q's real rows for the outputs and dQ and
    the keys' for dK and dV) where q and k differ in length (the cross
    trunk's gathered context, the extra token's one-row q), q and k are
    RoPE'd new tensors beside a strided v, and at RADIO-L's 769 tokens
    (with one key, dQ and dK are zero in exact arithmetic: there they are
    held against the size of their products, as 16c does);
  * dO as an expanded zero and as the slice of a wider row through the
    Function's backward: one dK/dV and one dQ launch and the plain
    backward's gradients;
  * the entropy-scaled attention layer (q scaled before the kernel): the
    whole layer's gradient, flash against math, within 1e-2 rel-L2;
  * one step of a tiny bf16 model of each trunk and of the two pose
    families at N(0, 0.02) weights through train/grad_check.py::compare:
    the loss within 1e-2 relative and the pulled-back gradient within
    2e-2 rel-L2 of the math path's; the step launches the training
    kernels and the plain path never.
"""

import pytest
import torch

from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.models import (
    MapAnything,
    MapAnythingConfig,
    dense_dim_for,
    images_only_config,
)
from mapanything_tpu_torch.nn import layers as PL
from mapanything_tpu_torch.nn.rope import apply_rope, rope_tables
from mapanything_tpu_torch.ops import flash_attention as fa
from mapanything_tpu_torch.train.grad_check import compare
from mapanything_tpu_torch.train.losses import overall_loss
from mapanything_tpu_torch.train.step import loss_and_grads, make_loss_fn
from mapanything_tpu_torch.utils.weights import random_normal_

LIMIT, GRAD_LIMIT = 1e-2, 2e-2
TINY = dict(encoder_size="small", patch_size=14, trunk_dim=384,
            trunk_depth=4, trunk_num_heads=6, trunk_indices=(1, 2),
            dpt_feature_dim=64, dpt_out_channels=(64, 64, 64, 64),
            dpt_hidden_dims=(32, 16))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the test holds the card's training "
                    "kernels against their plain versions")
    return torch.device("cuda")


def errors(out, ref):
    o, r = out.double(), ref.double()
    return (float((o - r).abs().max() / r.abs().max().clamp_min(1e-30)),
            float((o - r).norm() / r.norm().clamp_min(1e-30)))


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _inputs(case, gen, device):
    """q, k, v of a case: (B, Nq, H, D) and (B, Nk, H, D)."""
    if case == "rope_frame":  # the frame layer at 518^2: 37 x 37 patches
        q, k, v = _randn(gen, 2, 1369, 3, 16, 64).unbind(2)
        cos, sin = rope_tables(37, 37, 64, 100.0, device)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v
    if case == "one_row_self":
        return _randn(gen, 1, 1, 3, 16, 64).unbind(2)
    if case == "radio_ragged":
        return _randn(gen, 2, 769, 3, 16, 64).unbind(2)
    b, nq, keys = {"one_row_cross": (1, 1, 2739),
                   "cross_2view": (1, 1369, 1370),
                   "cross_rest_4view": (3, 1369, 4108)}[case]
    k, v = _randn(gen, b, keys, 2, 16, 64).unbind(2)
    return _randn(gen, b, nq, 16, 64), k, v


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rope_frame", "one_row_self",
                                  "one_row_cross", "cross_2view",
                                  "cross_rest_4view", "radio_ragged"])
def test_training_kernels_against_plain(cuda_device, case):
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = _inputs(case, gen, cuda_device)
    dout = _randn(gen, *q.shape)
    fa.reset_launch_counts()
    out, lse = fa.flash_attention_fwd_lse(q, k, v)
    ref_out, ref_lse = fa.flash_attention_fwd_lse_plain(q, k, v)
    delta = fa.attention_delta(dout, ref_out)
    args = (q, k, v, dout, ref_lse, delta)
    dk, dv = fa.flash_attention_dkv(*args)
    dq = fa.flash_attention_dq(*args)
    ref_dk, ref_dv = fa.flash_attention_dkv_plain(*args)
    ref_dq = fa.flash_attention_dq_plain(*args)
    counts = fa.flash_attention.kernel_counts
    assert (counts["fwd_lse"], counts["dkv"], counts["dq"]) == (1, 1, 1)
    assert fa.flash_attention.plain_launches == 0
    for name, got, ref in (("out", out, ref_out), ("lse", lse, ref_lse),
                           ("dk", dk, ref_dk), ("dv", dv, ref_dv),
                           ("dq", dq, ref_dq)):
        if k.shape[1] == 1 and name in ("dk", "dq"):
            # one key: dS, dQ and dK are zero in exact arithmetic and both
            # sides are rounding noise; held against the products' size
            scale = (dout.float().abs().max() * v.float().abs().max()
                     * (k if name == "dq" else q).float().abs().max() / 8)
            assert (got.float() - ref.float()).abs().max() <= LIMIT * scale
        else:
            assert max(errors(got.float(), ref.float())) <= LIMIT, name


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["expanded_zero", "row_slice"])
def test_backward_takes_any_dout_layout(cuda_device, layout):
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (x.detach().requires_grad_()
               for x in _randn(gen, 1, 1369, 3, 16, 64).unbind(2))
    out = fa.flash_attention(q, k, v)
    if layout == "expanded_zero":
        dout = torch.zeros((), dtype=out.dtype, device="cuda").expand(
            out.shape)
    else:
        dout = _randn(gen, 1, 1369, 16, 128)[..., :64]
    fa.reset_launch_counts()
    grads = torch.autograd.grad(out, (q, k, v), dout)
    counts = fa.flash_attention.kernel_counts
    assert (counts["dkv"], counts["dq"]) == (1, 1)
    with torch.no_grad():
        ref = fa.flash_attention_bwd_plain(
            q, k, v, out, fa.flash_attention_fwd_lse_plain(q, k, v)[1], dout)
    for got, want in zip(grads, ref):
        if layout == "expanded_zero":
            assert not got.any()
        else:
            assert max(errors(got.float(), want.float())) <= LIMIT


@pytest.mark.cuda
def test_entropy_scaled_layer_gradient(cuda_device):
    """The 2-view global layer's size at head dim 64: 2 x 37 x 37 patches
    and the token, entropy base 1369 (the patches per view)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    attn = PL.init_weights_(
        PL.Attention(256, 4, dtype=torch.bfloat16, device=cuda_device),
        gen)
    x = torch.randn(1, 2739, 256, generator=gen, device="cuda").to(
        torch.bfloat16)
    grads = []
    for impl in ("auto", "math"):
        attn.attn_impl = impl
        xi = x.clone().requires_grad_()
        out = attn(xi, entropy_scaling_base=1369)
        g = torch.autograd.grad(out.float().square().sum(),
                                [xi, *attn.parameters()])
        grads.append(torch.cat([t.float().flatten() for t in g]))
    assert errors(grads[0], grads[1])[1] <= LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [
    dict(info_sharing_type="global"), dict(info_sharing_type="cross"),
    dict(use_scale_token=False, trunk_rope_freq=100.0),
    dict(scene_rep_type="campointmap+pose+confidence+mask"),
    dict(scene_rep_type="pointmap+raydirs+depth+pose+confidence+mask")],
    ids=["global", "cross", "ablations", "campointmap_pose",
         "pointmap_raydirs_depth_pose"])
def test_variant_step_flash_vs_math(cuda_device, variant):
    kw = dict(variant)
    if "scene_rep_type" in kw:
        kw["dense_output_dim"] = dense_dim_for(kw["scene_rep_type"])
    model = MapAnything(MapAnythingConfig(**TINY, **kw))
    random_normal_(model, seed=8)
    batch = make_synthetic_batch(1, 2, 112, 112, seed=0)
    res = compare(model, batch, loss_fn=overall_loss)
    assert res["loss_rel_diff"] <= LIMIT
    assert res["grad_rel_l2"] <= GRAD_LIMIT
    fa.reset_launch_counts()
    loss, _, _ = loss_and_grads(make_loss_fn(model, images_only_config()),
                                list(model.parameters()), batch)
    counts = fa.flash_attention.kernel_counts
    assert counts["fwd_lse"] == counts["dkv"] == counts["dq"] > 0
    assert fa.flash_attention.plain_launches == 0
    assert torch.isfinite(loss)
