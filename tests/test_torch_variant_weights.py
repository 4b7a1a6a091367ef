"""Checkpoints of the model variants in the reference's layout, against the
JAX package's converter on the CPU.

Each checkpoint is written inside the test from a seeded port model with a
RADIO or a CroCo encoder (tests/torch_reference_layout.py), so no file is
needed: JAX's `convert_radio` and the RADIO and CroCo branches of its
`convert_mapanything_checkpoint` take it whole and the port's tree equals
theirs bitwise; `from_pretrained` loads it bitwise; `infer` (unmasked)
matches JAX's under JAX's tree within 1e-4 relative. A DINOv2 checkpoint loaded with
`fold_layerscale` gives the unfolded model's outputs within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.utils import weights as JW
from mapanything_tpu.utils.inference import InferencePipeline as JaxPipeline
from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.models.pretrained import from_pretrained
from mapanything_tpu_torch.utils import weights as PW
from mapanything_tpu_torch.utils.inference import InferencePipeline
from torch_reference_layout import reference_state_dict, write_snapshot

SMALL = dict(encoder_size="test", trunk_dim=64, trunk_depth=2,
             trunk_num_heads=2, trunk_indices=(0, 1), dpt_feature_dim=32,
             dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
ENCODERS = {"radio": dict(encoder_type="radio", patch_size=16,
                          encoder_img_size=64, data_norm_type="radio"),
            "croco": dict(encoder_type="croco", patch_size=16,
                          data_norm_type="croco")}
# what infer_model_config cannot read from the shapes
OVERRIDES = dict(encoder_size="test", trunk_num_heads=2, trunk_indices=(0, 1))
H, W = 48, 64


def _model(**kw) -> MapAnything:
    """A port model at its seeded init with N(0, 0.02) noise on every
    parameter but RADIO's conditioner, so that zero biases and unit
    LayerNorm scales do not hide a misplaced parameter."""
    model = MapAnything(MapAnythingConfig(dtype=torch.float32, **SMALL,
                                          **kw), device="cpu",
                        generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for mod in model.modules():
            consts = getattr(mod, "init_constants", {})
            for name, p in mod.named_parameters(recurse=False):
                if name not in consts:
                    p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return model.eval()


@pytest.fixture(scope="module", params=list(ENCODERS))
def encoder_case(request):
    """(name, port model, its state dict in the reference's layout)."""
    model = _model(**ENCODERS[request.param])
    sd = reference_state_dict(model.state_dict(), SMALL["trunk_indices"])
    return request.param, model, sd


def _leaves(tree):
    return {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                {k: v for k, v in tree.items() if not k.startswith("_")})[0]}


def _assert_trees_bitwise(ours, ref):
    a, b = _leaves(ours), _leaves(ref)
    assert list(a) == list(b)
    for key in b:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_converted_tree_equals_jax(encoder_case):
    name, _, sd = encoder_case
    ref = JW.convert_mapanything_checkpoint(sd, trunk_indices=(0, 1))
    ours = PW.convert_mapanything_checkpoint(sd, trunk_indices=(0, 1))
    assert ours.get("_unconverted") == ref.get("_unconverted") is None
    assert ours.get("_aliases") == ref.get("_aliases")
    _assert_trees_bitwise(ours, ref)
    if name == "radio":  # the encoder's own converter, alone
        enc_ref, used = JW.convert_radio(sd, "encoder.model.")
        assert used == sum(k.startswith("encoder.") for k in sd)
        _assert_trees_bitwise(PW.convert_radio(sd, "encoder.model."),
                              enc_ref)
    assert (PW.infer_model_config(sd, (0, 1))
            == JW.infer_model_config(sd, (0, 1)))


def test_from_pretrained_loads_bitwise(tmp_path, encoder_case):
    name, model, sd = encoder_case
    path = write_snapshot(str(tmp_path / name), sd)
    loaded = from_pretrained(path, torch.float32,
                             dict(OVERRIDES, **ENCODERS[name]), device="cpu")
    assert loaded.cfg == model.cfg
    want, got = model.state_dict(), loaded.state_dict()
    assert list(got) == list(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_infer_matches_jax(tmp_path, encoder_case):
    name, _, sd = encoder_case
    tree = JW.convert_mapanything_checkpoint(sd, trunk_indices=(0, 1))
    tree = {k: v for k, v in tree.items() if not k.startswith("_")}
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **SMALL,
                                             **ENCODERS[name]))
    path = write_snapshot(str(tmp_path / name), sd)
    port = from_pretrained(path, torch.float32,
                           dict(OVERRIDES, **ENCODERS[name]), device="cpu")
    rng = np.random.default_rng(8)
    views = [{"img": rng.random((1, H, W, 3)).astype(np.float32),
              "data_norm_type": [name]} for _ in range(2)]
    # unmasked: these random weights mask every pixel; and the rays, not
    # the pinhole fit to them, whose conditioning these weights ruin
    with jax.default_matmul_precision("highest"):
        ref = JaxPipeline(jax_model, {"params": tree}).infer(
            views, apply_mask=False, data_norm_type=name)
    out = InferencePipeline(port).infer(views, apply_mask=False,
                                        data_norm_type=name)
    for r, o in zip(ref, out):
        for key in ("pts3d", "depth_along_ray", "ray_directions",
                    "camera_poses", "conf", "metric_scaling_factor"):
            want = np.asarray(r[key], np.float64)
            err = np.abs(o[key].double().numpy() - want).max()
            assert err <= 1e-4 * max(1.0, np.abs(want).max()), (key, err)


def test_fold_layerscale_matches_unfolded(tmp_path):
    model = _model()
    sd = reference_state_dict(model.state_dict(), SMALL["trunk_indices"])
    path = write_snapshot(str(tmp_path / "dinov2"), sd)
    folded = from_pretrained(path, torch.float32,
                             dict(OVERRIDES, fold_layerscale=True),
                             device="cpu")
    assert not any(".ls1." in key or ".ls2." in key
                   for key in folded.state_dict())
    rng = np.random.default_rng(9)
    views = [{"img": rng.standard_normal((1, 42, 56, 3)).astype(np.float32),
              "data_norm_type": ["dinov2"]} for _ in range(2)]
    ref = InferencePipeline(model).infer(views)
    out = InferencePipeline(folded).infer(views)
    for r, o in zip(ref, out):
        for key in ("pts3d", "depth_along_ray", "conf",
                    "metric_scaling_factor"):
            err = (o[key] - r[key]).abs().max()
            assert err <= 1e-5 * max(1.0, float(r[key].abs().max())), key
