"""The port's pseudo-depth stage and its consistency filter
(mapanything_tpu_torch/data/pseudo_depth.py) against the JAX package's, on
the CPU.

The JAX stage calls its adapters as ``adapter.apply(params, views)`` with
numpy (1, V, H, W, 3) images (tests/test_converters.py's fakes); the port's
as ``adapter(views)`` with tensors on the adapter's device
(tests/torch_offline_scenes.py's twins of those fakes). Given the same
scene, the two stages must write the same tree: depth, masks and the
generator's confidence within 1e-6, the consistency filter's confidence
within tests/test_torch_covisibility.py's share of differing pixels.
MapAnything self-labels through `MapAnythingAdapter`: what the stage
stores is the model's own output read back.
"""

import shutil

import numpy as np
import pytest
import torch

import jax

import test_converters as JT
from mapanything_tpu.data import converters as JV
from mapanything_tpu.data import pseudo_depth as JP
from mapanything_tpu_torch.data import pseudo_depth as PP
from mapanything_tpu_torch.data.wai import (
    load_frame,
    load_scene_meta,
    write_scene,
)
from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.models.adapters import MapAnythingAdapter
from mapanything_tpu_torch.utils.weights import random_normal_

from torch_offline_scenes import (
    CONF_SHARE,
    FakeMVSAdapter,
    FakeMonoAdapter,
    assert_trees_equal,
)


@pytest.fixture(scope="module")
def tav2(tmp_path_factory):
    """A converted 3-frame TartanAirV2-WB scene (JAX's fixture)."""
    root = tmp_path_factory.mktemp("tav2")
    JT._write_tav2_scene(root / "raw")
    return JV.convert_tav2_wb_scene(root / "raw", root / "wai",
                                    "Supermarket", link=False)


def _copies(scene, tmp_path):
    return [shutil.copytree(scene, tmp_path / tag / scene.name)
            for tag in ("jax", "port")]


@pytest.mark.parametrize("kind,name,batch", [("mono", "moge2", 2),
                                             ("mvs", "mvsanywhere", 3)])
def test_stage_tree_matches_jax(tav2, tmp_path, kind, name, batch):
    jax_dst, port_dst = _copies(tav2, tmp_path)
    jax_adapter = {"mono": JT._FakeMonoAdapter,
                   "mvs": JT._FakeMVSAdapter}[kind]()
    port_adapter = {"mono": FakeMonoAdapter, "mvs": FakeMVSAdapter}[kind]()
    JP.run_pseudo_depth_stage(jax_dst, jax_adapter, model_name=name,
                              batch_frames=batch)
    PP.run_pseudo_depth_stage(port_dst, port_adapter, model_name=name,
                              batch_frames=batch)
    assert_trees_equal(jax_dst, port_dst)
    meta = load_scene_meta(port_dst / "scene_meta.json")
    assert (f"depth_confidence/{name}" in meta["frame_modalities"]) == (
        kind == "mvs")
    m = load_frame(port_dst, 0, [f"pred_mask/{name}"],
                   scene_meta=meta)[f"pred_mask/{name}"]
    assert not m[:, :2].any() and m[:, 2:].all()


@pytest.mark.parametrize("gated", [False, True])
def test_consistency_stage_matches_jax(tav2, tmp_path, gated):
    jax_dst, port_dst = _copies(tav2, tmp_path)
    JP.run_pseudo_depth_stage(jax_dst, JT._FakeMonoAdapter())
    PP.run_pseudo_depth_stage(port_dst, FakeMonoAdapter())
    overlap = (np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1]], bool)
               if gated else None)
    with jax.default_matmul_precision("highest"):
        JP.run_depth_consistency_stage(jax_dst, "pred_depth/moge2",
                                       overlap=overlap)
    PP.run_depth_consistency_stage(port_dst, "pred_depth/moge2",
                                   overlap=overlap, device="cpu")

    def conf_close(ref, got):
        assert (np.abs(got - ref) > 1e-6).mean() <= CONF_SHARE

    assert_trees_equal(jax_dst, port_dst,
                       compare={"depth_confidence/": conf_close})
    if not torch.cuda.is_available():  # the card by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PP.run_depth_consistency_stage(port_dst, "depth")


def test_gt_depth_consistency_is_high(tav2, tmp_path):
    """On the scene's own (random, so mutually inconsistent) GT depth, a
    frame is consistent with itself: every pixel scores at least its own
    inlier vote of three, but on row and column 0, whose self-projection
    can round below 0 and leave the image (in both packages)."""
    dst = shutil.copytree(tav2, tmp_path / "s")
    PP.run_depth_consistency_stage(dst, "depth", model_name="gt",
                                   device="cpu")
    meta = load_scene_meta(dst / "scene_meta.json")
    conf = load_frame(dst, 1, ["depth_confidence/gt"],
                      scene_meta=meta)["depth_confidence/gt"]
    assert conf.shape == (30, 40)
    assert conf[1:, 1:].min() >= 1 / 3 - 1e-6


def test_mapanything_self_labels_through_the_adapter(tmp_path):
    """A seeded tiny MapAnything labels a 3-frame 42 x 28 scene; the stored
    depth, mask and confidence are its own outputs, bitwise (EXR holds
    fp32)."""
    rng = np.random.default_rng(8)
    frames = [{"frame_name": f"f{i}",
               "image": rng.integers(0, 255, (28, 42, 3), np.uint8),
               "depth": np.ones((28, 42), np.float32),
               "transform_matrix": np.eye(4)} for i in range(3)]
    dst = write_scene(tmp_path / "s", frames,
                      dict(fx=30.0, fy=30.0, cx=21.0, cy=14.0, w=42, h=28))
    cfg = MapAnythingConfig(dtype=torch.float32, encoder_size="test",
                            trunk_dim=64, trunk_depth=2, trunk_num_heads=2,
                            trunk_indices=(0, 1), dpt_feature_dim=32,
                            dpt_out_channels=(32, 32, 32, 32),
                            dpt_hidden_dims=(16, 8))
    adapter = MapAnythingAdapter(
        random_normal_(MapAnything(cfg, device="cpu"), seed=3).eval())
    PP.run_pseudo_depth_stage(dst, adapter, model_name="self",
                              batch_frames=3)

    imgs = np.stack([f["image"] for f in frames]).astype(np.float32) / 255
    with torch.inference_mode():
        out = adapter({"img": torch.from_numpy(
            PP._normalize_images(imgs[None], "dinov2"))})
    z = out["pts3d_cam"][0, ..., 2].numpy()
    z = np.where(np.isfinite(z) & (z > 0), z, 0.0)
    meta = load_scene_meta(dst / "scene_meta.json")
    for i in range(3):
        got = load_frame(dst, i, ["pred_depth/self", "pred_mask/self",
                                  "depth_confidence/self"], scene_meta=meta)
        np.testing.assert_array_equal(got["pred_depth/self"], z[i])
        np.testing.assert_array_equal(got["pred_mask/self"],
                                      out["non_ambiguous_mask"][0, i].numpy())
        np.testing.assert_array_equal(got["depth_confidence/self"],
                                      out["conf"][0, i].numpy())
