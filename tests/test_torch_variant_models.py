"""MapAnything with each variant end to end, against the JAX package on
the CPU: each encoder (CroCo, RADIO), each trunk (global, cross), the
ablations (no scale token, RoPE2D), view PE, and each of the five scene
representation families with confidence and mask, at the size and with the
tree and limits of tests/test_torch_variants.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.models import images_only_config as jax_images_only
from mapanything_tpu_torch.models import (
    MapAnything,
    MapAnythingConfig,
    dense_dim_for,
)
from mapanything_tpu_torch.utils.weights import load_jax_params
from test_torch_variants import (
    FAMILIES,
    MODEL_TOL,
    TINY,
    _apply,
    _perturb,
    _rand,
    _t,
    assert_close_rel,
)
from torch_jax_init import init_params

MODEL_CASES = {
    "croco": dict(encoder_type="croco", patch_size=16),
    "radio": dict(encoder_type="radio", patch_size=16),
    "global": dict(info_sharing_type="global"),
    "cross": dict(info_sharing_type="cross"),
    "ablations": dict(use_scale_token=False, trunk_rope_freq=100.0),
    "view_pe": dict(use_view_pe=True),
}
MODEL_CASES.update({
    family: dict(scene_rep_type=family + "+confidence+mask",
                 dense_output_dim=dense_dim_for(family + "+confidence+mask"))
    for family in FAMILIES})


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_mapanything_variant_matches_jax(case):
    kw = MODEL_CASES[case]
    h, w = (32, 48) if "patch_size" in kw else (28, 42)
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **TINY, **kw))
    params = _perturb(init_params(jax_model, h, w), 17)
    port = MapAnything(MapAnythingConfig(dtype=torch.float32, **TINY, **kw),
                       device="cpu")
    load_jax_params(port, params)
    img = _rand(18, 1, 2, h, w, 3, scale=0.5)
    if kw.get("encoder_type") == "radio":  # RADIO takes [0, 1] images
        img = np.abs(img).clip(0, 1)
    ref = _apply(jax_model, params, {"img": jnp.asarray(img)},
                 jax_images_only())
    with torch.no_grad():
        out = port({"img": _t(img)})
    assert set(out) == set(ref)
    for key, val in ref.items():
        if val.dtype == bool:
            assert np.mean(out[key].numpy() == val) >= 0.999, key
        else:
            assert_close_rel(out[key], val, MODEL_TOL, key)
    if case == "ablations":
        np.testing.assert_array_equal(out["metric_scaling_factor"], 1.0)
