"""The demo app's normal maps, the app itself, the profiler and the
converter on the card.

This file imports no JAX, so it also runs on the GPU machine:
``python -m pytest tests/test_torch_demo_app_cuda.py -m cuda --noconftest``.
Every test needs a card and skips without one. The normal maps of smooth
surfaces on the card lie within 1e-5 of the CPU's (fp32 elementwise
arithmetic; chip_smoke.py phase 11e holds the same limit at full size
where the normal is well defined).
"""

import os

import numpy as np
import PIL.Image
import pytest
import torch

from mapanything_tpu_torch import convert_torch_checkpoint as conv
from mapanything_tpu_torch import demo_app, profile_dataloading
from mapanything_tpu_torch.data.wai import write_scene
from mapanything_tpu_torch.geometry import points_to_normals
from mapanything_tpu_torch.models import MapAnything, MapAnythingConfig
from mapanything_tpu_torch.models.pretrained import from_pretrained
from mapanything_tpu_torch.ops import flash_attention as fa
from mapanything_tpu_torch.utils import demo_core as PD
from mapanything_tpu_torch.utils.weights import random_normal_
from torch_reference_layout import reference_state_dict

CARD_VS_CPU = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the test holds the card against "
                    "the CPU")
    return torch.device("cuda")


def wavy_points(n, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    z = (2 + 0.3 * np.sin(xx / 5 + rng.uniform(0, 6, (n, 1, 1)))
         + rng.uniform(0, 0.01, (n, h, w)))
    return np.stack([(xx - w / 2) * z / 500, (yy - h / 2) * z / 500, z],
                    -1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_cuda_normals_match_cpu(cuda_device, masked):
    pts = torch.from_numpy(wavy_points(3, 64, 80, 0))
    mask = (torch.from_numpy(np.random.default_rng(1).uniform(
        size=(3, 64, 80)) > 0.2) if masked else None)
    got, got_mask = points_to_normals(
        pts.to(cuda_device), None if mask is None else mask.to(cuda_device))
    assert got.device.type == "cuda"
    want, want_mask = points_to_normals(pts, mask)
    assert torch.equal(got_mask.cpu(), want_mask)
    assert float((got.cpu() - want).abs().max()) <= CARD_VS_CPU


@pytest.mark.cuda
def test_cuda_process_for_visualization(cuda_device):
    rng = np.random.default_rng(2)
    preds = {"world_points": wavy_points(2, 30, 40, 2),
             "depth": rng.uniform(1, 2, (2, 30, 40, 1)).astype(np.float32),
             "images": rng.uniform(size=(2, 30, 40, 3)).astype(np.float32),
             "final_mask": rng.uniform(size=(2, 30, 40)) > 0.1}
    got = PD.process_for_visualization(preds, device=cuda_device)
    want = PD.process_for_visualization(preds, device="cpu")
    for i in want:
        assert np.array_equal(got[i]["mask"], want[i]["mask"])
        assert np.abs(got[i]["normal"] - want[i]["normal"]).max() \
            <= CARD_VS_CPU


@pytest.mark.cuda
def test_cuda_app(cuda_device, tmp_path):
    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(3)
    for i in range(2):
        PIL.Image.fromarray(rng.integers(0, 255, (100, 310, 3)).astype(
            np.uint8)).save(folder / f"im{i}.png")
    out = tmp_path / "out"
    fa.reset_launch_counts()
    rc = demo_app.main(["--image_folder", str(folder), "--out_dir", str(out),
                        "--tiny", "--sky_masks", "--measure", "5,5,60,40"])
    assert rc == 0
    assert fa.flash_attention.kernel_counts["fwd"] > 0
    assert fa.flash_attention.plain_launches == 0
    assert {"scene.glb", "measure.json", "depth_000.png",
            "normal_001.png"} <= set(os.listdir(out))
    assert len(os.listdir(out / "sky")) == 2


@pytest.mark.cuda
def test_cuda_converter_and_profiler(cuda_device, tmp_path):
    from mapanything_tpu_torch.demo_colmap import TINY_CONFIG

    model = random_normal_(MapAnything(MapAnythingConfig(**TINY_CONFIG),
                                       device="cpu"), seed=4)
    path = tmp_path / "ref.pt"
    torch.save(reference_state_dict(model.state_dict(),
                                    TINY_CONFIG["trunk_indices"]), path)
    out = str(tmp_path / "port.pt")
    assert conv.main(["--input", str(path), "--output", out],
                     TINY_CONFIG) == 0
    loaded = from_pretrained(out, config_overrides=TINY_CONFIG)
    for key, val in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[key].cpu(), val), key

    frames = [{"frame_name": f"f{i}",
               "image": rng_image(i), "transform_matrix": np.eye(4),
               "depth": np.full((64, 80), 2.0, np.float32)}
              for i in range(4)]
    write_scene(tmp_path / "wai" / "scene", frames,
                dict(fx=60.0, fy=60.0, cx=40.0, cy=32.0, w=80, h=64),
                np.ones((4, 4), np.float32))
    res = profile_dataloading.main([
        "--wai_root", str(tmp_path / "wai"), "--dataset_spec",
        "4 @ WAIDataset(ROOT=wai_root, spec='eth3d', num_views=2, "
        "covisibility_thres=0.25, resolution=(56, 42), seed=7)",
        "--max_imgs_per_device", "4", "--num_workers", "2"])
    assert res["batches"] == [2] and res["images"] == 8


def rng_image(seed):
    return np.random.default_rng(seed).integers(0, 255, (64, 80, 3),
                                                dtype=np.uint8)
