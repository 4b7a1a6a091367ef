"""Checkpoints in the reference's layout: the port's safetensors I/O, its
copy of the conversion rules and `from_pretrained`, against the JAX
package's on the CPU.

The checkpoint is built inside the test from a seeded port model
(tests/torch_reference_layout.py, the inverse of the rules), so no file is
needed. Every comparison of weights is bitwise: both packages run the same
numpy. `infer` of the loaded model is held against JAX's `infer` under
JAX's converted tree within 1e-4 relative (fp32, as test_torch_model.py).
"""

import argparse
import dataclasses
import json
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu.models import MapAnything as JaxMapAnything
from mapanything_tpu.models import MapAnythingConfig as JaxConfig
from mapanything_tpu.utils import weights as JW
from mapanything_tpu.utils.inference import InferencePipeline as JaxPipeline
from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.models.pretrained import from_pretrained
from mapanything_tpu_torch.utils import weights as PW
from mapanything_tpu_torch.utils.inference import InferencePipeline
from torch_jax_init import init_params
from torch_reference_layout import reference_state_dict, write_snapshot

SMALL = dict(encoder_size="test", trunk_dim=64, trunk_depth=4,
             trunk_num_heads=2, trunk_indices=(1, 3), dpt_feature_dim=32,
             dpt_out_channels=(32, 32, 32, 32), dpt_hidden_dims=(16, 8))
TAPS = SMALL["trunk_indices"]
PAIR_TAPS = (0, 1)  # the same taps counted in frame/global pairs
# what infer_model_config cannot read from shapes
OVERRIDES = dict(encoder_size="test", trunk_num_heads=2, trunk_indices=TAPS)
H, W = 42, 56


def _perturb(params, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(x.shape))
        .astype(np.float32), params)


@pytest.fixture(scope="module")
def models():
    """(JAX model, the port's model holding the same seeded weights)."""
    jax_model = JaxMapAnything(cfg=JaxConfig(dtype=jnp.float32, **SMALL))
    params = _perturb(init_params(jax_model, H, W), 4)
    port = MapAnything(MapAnythingConfig(dtype=torch.float32, **SMALL),
                       device="cpu")
    PW.load_jax_params(port, params)
    return jax_model, port.eval()


@pytest.fixture(scope="module")
def reference(models):
    return reference_state_dict(models[1].state_dict(), TAPS)


def _leaves(tree):
    return {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                {k: v for k, v in tree.items() if not k.startswith("_")})[0]}


def _assert_bitwise(model, want):
    got = model.state_dict()
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def test_jax_converter_consumes_it_whole(reference):
    tree = JW.convert_mapanything_checkpoint(reference, trunk_indices=TAPS)
    assert "_unconverted" not in tree
    aliases = set(tree["_aliases"])
    assert aliases == {k for k in reference
                       if k.startswith("dense_head.")
                       or k.endswith("mask_token")}
    assert "encoder.model.mask_token" in aliases


@pytest.mark.parametrize("paired", [False, True], ids=["flat", "paired"])
def test_converted_tree_equals_jax(models, paired):
    sd = reference_state_dict(models[1].state_dict(), TAPS, paired=paired)
    taps = PAIR_TAPS if paired else TAPS
    ours = PW.convert_mapanything_checkpoint(sd, trunk_indices=taps)
    ref = JW.convert_mapanything_checkpoint(sd, trunk_indices=taps)
    assert ours.get("_unconverted") == ref.get("_unconverted") is None
    assert ours["_aliases"] == ref["_aliases"]
    a, b = _leaves(ours), _leaves(ref)
    assert list(a) == list(b)
    for key in b:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for indices in ((11, 17), taps):
        assert (PW.infer_model_config(sd, indices)
                == JW.infer_model_config(sd, indices))


def test_released_config_is_inferred():
    """A reference-layout state dict of the released architecture gives
    back MapAnythingConfig() (shapes only: meta tensors)."""
    model = MapAnything(MapAnythingConfig(), device="meta")
    sd = reference_state_dict(model.state_dict(),
                              MapAnythingConfig().trunk_indices)
    inferred = PW.infer_model_config(sd)
    assert inferred == JW.infer_model_config(sd)
    fields = {f.name for f in dataclasses.fields(MapAnythingConfig)}
    cfg = MapAnythingConfig(**{k: v for k, v in inferred.items()
                               if k in fields})
    assert cfg == MapAnythingConfig()
    assert inferred["enc_dim"] == 1024


def _safetensors(tmp_path, sd):
    path = tmp_path / "model.safetensors"
    PW.write_safetensors(str(path), sd)
    return path


def _bf16(tmp_path, sd):
    path = tmp_path / "bf16.safetensors"
    PW.write_safetensors(str(path), {k: v.to(torch.bfloat16)
                                     for k, v in sd.items()})
    return path


LAYOUTS = {
    "safetensors": _safetensors,
    "snapshot": lambda p, sd: write_snapshot(str(p / "snap"), sd),
    "sharded_snapshot": lambda p, sd: write_snapshot(str(p / "snap"), sd,
                                                     shards=2),
    "pt_model": lambda p, sd: (torch.save({"model": sd}, p / "ref.pt"),
                               p / "ref.pt")[1],
    "pth_state_dict": lambda p, sd: (
        torch.save({"state_dict": sd, "epoch": 3}, p / "ref.pth"),
        p / "ref.pth")[1],
    "bf16_safetensors": _bf16,
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_from_pretrained_loads_bitwise(tmp_path, models, reference, layout):
    path = LAYOUTS[layout](tmp_path, reference)
    model = from_pretrained(str(path), torch.float32, OVERRIDES,
                            device="cpu")
    want = models[1].state_dict()
    if layout.startswith("bf16"):
        want = {k: v.to(torch.bfloat16).float() for k, v in want.items()}
    _assert_bitwise(model, want)
    assert model.cfg == MapAnythingConfig(dtype=torch.float32, **SMALL)
    assert not model.training


def test_sharded_snapshot_index(tmp_path, reference):
    folder = write_snapshot(str(tmp_path / "snap"), reference, shards=2)
    with open(f"{folder}/model.safetensors.index.json") as f:
        weight_map = json.load(f)["weight_map"]
    assert set(weight_map) == set(reference)
    assert sorted(set(weight_map.values())) == [
        "model-00001-of-00002.safetensors",
        "model-00002-of-00002.safetensors"]


def test_paired_trunk_loads_bitwise(tmp_path, models):
    """A trunk of frame/global pairs: the config's tap layers (1, 3) are the
    global layers of pairs (0, 1). An even (frame) tap raises."""
    sd = reference_state_dict(models[1].state_dict(), TAPS, paired=True)
    path = _safetensors(tmp_path, sd)
    model = from_pretrained(str(path), torch.float32, OVERRIDES,
                            device="cpu")
    _assert_bitwise(model, models[1].state_dict())
    with pytest.raises(ValueError, match="odd"):
        from_pretrained(str(path), torch.float32,
                        dict(OVERRIDES, trunk_indices=(1, 2)), device="cpu")


def test_heads_only_under_their_aliases_load(tmp_path, models, reference):
    """safetensors keeps one name of each shared tensor, the sorted first:
    dense_head.{0,1} for the DPT heads. Those load as the heads."""
    sd = {k: v for k, v in reference.items()
          if not k.startswith(("dpt_feature_head.", "dpt_regressor_head."))}
    model = from_pretrained(str(_safetensors(tmp_path, sd)), torch.float32,
                            OVERRIDES, device="cpu")
    _assert_bitwise(model, models[1].state_dict())


def test_unknown_key_is_strict(tmp_path, models, reference):
    path = _safetensors(tmp_path, dict(reference,
                                       **{"mystery.weight": torch.zeros(3)}))
    with pytest.raises(ValueError, match="no conversion rule"):
        from_pretrained(str(path), torch.float32, OVERRIDES, device="cpu")
    model = from_pretrained(str(path), torch.float32, OVERRIDES,
                            device="cpu", strict=False)
    _assert_bitwise(model, models[1].state_dict())


def test_pickled_objects_are_refused(tmp_path, reference):
    path = tmp_path / "pickled.pt"
    torch.save({"model": dict(reference), "args": argparse.Namespace(lr=1)},
               path)
    with pytest.raises(pickle.UnpicklingError, match="weights_only=True"):
        from_pretrained(str(path), device="cpu")


def test_safetensors_io_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "f16": rng.standard_normal(7).astype(np.float16),
              "i64": rng.integers(-9, 9, (2, 2)),
              "u8": rng.integers(0, 255, 5).astype(np.uint8),
              "b": rng.random(3) > 0.5,
              "odd": rng.standard_normal((1, 3)).astype(np.float32)}
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "jax.safetensors"
    PW.write_safetensors(str(ours), arrays)
    JW.write_safetensors(str(theirs), arrays)
    assert ours.read_bytes() == theirs.read_bytes()
    # BF16 from a torch tensor, at an offset that is not 4-byte aligned
    mixed = {"h": torch.from_numpy(arrays["f16"]),
             "bf16": torch.from_numpy(arrays["f32"]).to(torch.bfloat16),
             "f32": torch.from_numpy(arrays["f32"])}
    PW.write_safetensors(str(ours), mixed)
    for path in (ours, theirs):
        got, want = PW.read_safetensors(str(path)), JW.read_safetensors(
            str(path))
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    got = PW.read_safetensors(str(ours))
    np.testing.assert_array_equal(
        got["bf16"], mixed["bf16"].float().numpy())
    assert got["f32"].flags.writeable


def test_infer_matches_jax(tmp_path, models, reference):
    jax_model, _ = models
    tree = JW.convert_mapanything_checkpoint(reference, trunk_indices=TAPS)
    tree = {k: v for k, v in tree.items() if not k.startswith("_")}
    path = write_snapshot(str(tmp_path / "snap"), reference, shards=2)
    port = from_pretrained(path, torch.float32, OVERRIDES, device="cpu")
    rng = np.random.default_rng(8)
    views = [{"img": rng.standard_normal((1, H, W, 3)).astype(np.float32),
              "data_norm_type": ["dinov2"]} for _ in range(2)]
    with jax.default_matmul_precision("highest"):
        ref = JaxPipeline(jax_model, {"params": tree}).infer(views)
    out = InferencePipeline(port).infer(views)
    for r, o in zip(ref, out):
        for key in ("pts3d", "depth_along_ray", "intrinsics",
                    "camera_poses", "conf", "metric_scaling_factor"):
            want = np.asarray(r[key], np.float64)
            err = np.abs(o[key].double().numpy() - want).max()
            assert err <= 1e-4 * max(1.0, np.abs(want).max()), (key, err)
