"""The model variants' kernel layouts and forwards on the card.

This file imports no JAX, so it also runs on the GPU machine:
``python -m pytest tests/test_torch_variants_cuda.py -m cuda --noconftest``.
Every test needs a card and skips without one.

  * the flash forward kernel against its plain version on the layouts only
    the variants give it: RoPE'd q and k (new tensors) beside the fused
    tensor's strided v, a one-row q (the extra token's self- and
    cross-attention), and the cross trunk's gathered context (q of its own,
    k and v the strided halves of one gathered kv tensor): max-abs over
    the plain's max-abs and rel-L2 within 1e-2 each, as chip_smoke.py;
  * a tiny bf16 forward of each trunk through MapAnything at N(0, 0.02)
    weights: finite outputs, the kernel launched and the plain path
    never, flash against math within 1e-2 rel-L2 on pts3d;
  * a key mask on the card raises unless "math" is asked for, and RADIO
    "huge" (head dim 80) raises naming the kernel's head dim.
"""

import numpy as np
import pytest
import torch

from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.nn.radio import RadioViT
from mapanything_tpu_torch.nn.rope import apply_rope, rope_tables
from mapanything_tpu_torch.ops import attention as PA
from mapanything_tpu_torch.ops import flash_attention as fa

LIMIT = 1e-2
TINY = dict(encoder_size="small", patch_size=14, trunk_dim=384,
            trunk_depth=4, trunk_num_heads=6, trunk_indices=(1, 2),
            dpt_feature_dim=64, dpt_out_channels=(64, 64, 64, 64),
            dpt_hidden_dims=(32, 16))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the test holds the card's kernel "
                    "against its plain version")
    return torch.device("cuda")


def errors(out, ref):
    o, r = out.double(), ref.double()
    return (float((o - r).abs().max() / r.abs().max()),
            float((o - r).norm() / r.norm()))


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rope", "one_row_self", "one_row_cross",
                                  "cross_rest_4view"])
def test_kernel_layouts_against_plain(cuda_device, case):
    gen = torch.Generator(device="cuda").manual_seed(3)
    if case == "rope":  # the frame layer at 518^2: 37 x 37 patches
        q, k, v = _randn(gen, 2, 1369, 3, 16, 64).unbind(2)
        cos, sin = rope_tables(37, 37, 64, 100.0, cuda_device)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    elif case == "one_row_self":
        q, k, v = _randn(gen, 1, 1, 3, 16, 64).unbind(2)
    else:
        b, keys = (1, 2739) if case == "one_row_cross" else (3, 4108)
        q = _randn(gen, b, 1 if case == "one_row_cross" else 1369, 16, 64)
        k, v = _randn(gen, b, keys, 2, 16, 64).unbind(2)
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v)
    assert fa.flash_attention.kernel_counts["fwd"] == 1
    assert fa.flash_attention.plain_launches == 0
    ref = fa.flash_attention_plain(q, k, v)
    assert max(errors(out.float(), ref.float())) <= LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("trunk", ["global", "cross", "ablations"])
def test_trunk_forward_bf16(cuda_device, trunk):
    kw = {"global": dict(info_sharing_type="global"),
          "cross": dict(info_sharing_type="cross"),
          "ablations": dict(use_scale_token=False,
                            trunk_rope_freq=100.0)}[trunk]
    model = MapAnything(MapAnythingConfig(**TINY, **kw)).eval()
    # every parameter N(0, 0.02), LayerNorms too: at a model's own init
    # bf16's own flash-vs-math floor on pts3d passes 1e-2 (chip_smoke.py
    # gates there too, ROADMAP "a weak gate")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    rng = np.random.default_rng(1)
    views = {"img": torch.from_numpy(
        rng.standard_normal((1, 3, 126, 168, 3)).astype(np.float32)).cuda()}
    fa.reset_launch_counts()
    with torch.inference_mode():
        flash = model(views)
    assert fa.flash_attention.kernel_counts["fwd"] > 0
    assert fa.flash_attention.plain_launches == 0
    for key, t in flash.items():
        assert t.dtype == torch.bool or torch.isfinite(t).all(), key
    model.set_attn_impl("math")
    with torch.inference_mode():
        math = model(views)
    assert errors(flash["pts3d"], math["pts3d"])[1] <= LIMIT


@pytest.mark.cuda
def test_key_mask_and_head_dim_refusals(cuda_device):
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16, device=cuda_device)
    mask = torch.ones(4, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="key mask"):
        PA.sdpa(q, q, q, key_mask=mask)
    assert PA.sdpa(q, q, q, impl="math", key_mask=mask).shape == q.shape
    radio = RadioViT(size="huge", dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="head dim 64"):
        radio(torch.zeros(1, 32, 32, 3, device=cuda_device))
