"""The offline data-processing slice's device stages on the card.

This file imports no JAX, so it also runs on the GPU machine:
``python -m pytest tests/test_torch_offline_cuda.py -m cuda --noconftest``.
Every test needs a card and skips without one. The card is held to the
CPU with the limits of tests/torch_offline_scenes.py (the CPU tests hold
the CPU to JAX with the same ones):

  * covisibility and the depth-consistency confidence of a room scene;
  * the mesh ray cast, and against the room's closed-form depth;
  * the CLI with no --device (scannetppv2 with --undistort and
    --render-depth) against the same CLI at --device cpu;
  * the pseudo-depth stage and its consistency filter with the adapter
    on the card.
"""

import shutil

import numpy as np
import pytest
import torch

from mapanything_tpu_torch import convert_dataset as CLI
from mapanything_tpu_torch.data import covisibility as PC
from mapanything_tpu_torch.data import pseudo_depth as PP
from mapanything_tpu_torch.data import rendering as PR
from mapanything_tpu_torch.data.wai import write_scene

from torch_offline_scenes import (
    ANALYTIC_RTOL,
    CONF_SHARE,
    COVIS_PIXELS,
    FakeMonoAdapter,
    assert_render_close,
    assert_trees_equal,
    room_cameras,
    room_depth,
    room_mesh,
    write_scannetpp_raw,
)

H, W = 120, 160
K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]])
FRAMES = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the test holds the card's stage "
                    "against the CPU's")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def room():
    poses = room_cameras(FRAMES)
    depths = np.stack([room_depth(K, p, (H, W)) for p in poses])
    return dict(mesh=room_mesh(cells=20), poses=poses,
                depths=depths.astype(np.float32),
                Ks=np.tile(K.astype(np.float32), (FRAMES, 1, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["valid_target_depth", "full"])
def test_cuda_covisibility_matches_cpu(cuda_device, room, mode):
    args = (room["depths"], room["Ks"], room["poses"])
    card = PC.compute_pairwise_covisibility(*args, denominator_mode=mode)
    cpu = PC.compute_pairwise_covisibility(*args, denominator_mode=mode,
                                           device="cpu")
    h, w = PC._downsample(room["depths"], room["Ks"], 224)[0].shape[1:]
    assert np.abs(card - cpu).max() <= COVIS_PIXELS / (h * w)
    np.testing.assert_allclose(np.diag(card), 1.0, atol=1e-6)


@pytest.mark.cuda
def test_cuda_confidence_matches_cpu(cuda_device, room):
    rng = np.random.default_rng(0)
    depths = room["depths"] * rng.uniform(0.97, 1.03, room["depths"].shape)
    args = (depths.astype(np.float32), room["Ks"], room["poses"])
    card = PC.compute_depth_consistency_confidence(*args)
    cpu = PC.compute_depth_consistency_confidence(*args, device="cpu")
    assert (np.abs(card - cpu) > 1e-6).mean() <= CONF_SHARE


@pytest.mark.cuda
def test_cuda_render_matches_cpu_and_closed_form(cuda_device, room):
    verts, faces, _ = room["mesh"]
    Ks = np.tile(K, (3, 1, 1))
    card = PR.render_scene_depths(verts, faces, Ks, room["poses"][:3],
                                  (H, W))
    cpu = PR.render_scene_depths(verts, faces, Ks, room["poses"][:3],
                                 (H, W), device="cpu")
    assert_render_close(cpu, card)
    np.testing.assert_allclose(card, room["depths"][:3], rtol=ANALYTIC_RTOL)


@pytest.mark.cuda
def test_cuda_cli_matches_cpu(cuda_device, room, tmp_path):
    write_scannetpp_raw(tmp_path / "raw", "scene0", room["poses"][:4], 176,
                        117, mesh=room["mesh"])
    argv = ["scannetppv2", str(tmp_path / "raw"), "--undistort",
            "--render-depth", "--copy"]
    CLI.main(argv[:2] + [str(tmp_path / "card")] + argv[2:])
    CLI.main(argv[:2] + [str(tmp_path / "cpu")] + argv[2:]
             + ["--device", "cpu"])
    assert_trees_equal(tmp_path / "cpu", tmp_path / "card",
                       compare={"scene0/rendered_depth/":
                                assert_render_close})


@pytest.mark.cuda
def test_cuda_pseudo_depth_stages(cuda_device, room, tmp_path):
    rng = np.random.default_rng(1)
    frames = [{"frame_name": f"f{i}",
               "image": rng.integers(0, 255, (H, W, 3), np.uint8),
               "depth": room["depths"][i],
               "transform_matrix": room["poses"][i]} for i in range(FRAMES)]
    scene = write_scene(tmp_path / "base" / "s", frames,
                        dict(fx=100.0, fy=100.0, cx=W / 2, cy=H / 2, w=W,
                             h=H))
    roots = {tag: shutil.copytree(scene, tmp_path / tag / "s")
             for tag in ("card", "cpu")}
    for tag, dev in (("card", None), ("cpu", "cpu")):
        PP.run_pseudo_depth_stage(roots[tag], FakeMonoAdapter(dev or "cuda"))
        PP.run_depth_consistency_stage(roots[tag], "depth", device=dev)

    def conf_close(ref, got):
        assert (np.abs(got - ref) > 1e-6).mean() <= CONF_SHARE

    assert_trees_equal(roots["cpu"], roots["card"],
                       compare={"depth_confidence/": conf_close})
