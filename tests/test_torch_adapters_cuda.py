"""The external-model adapters on the card, against the same adapters on the
CPU.

This file imports no JAX, so it also runs on the GPU machine:
``python -m pytest tests/test_torch_adapters_cuda.py -m cuda --noconftest``.
Every test needs a card and skips without one. Each adapter runs its
interface fake (tests/torch_adapter_fakes.py) on the card and on the CPU
over the same make_synthetic_batch inputs, fp32 with TF32 off: every key
within 1e-5 rel-L2 (masks equal), the outputs on the card, and nothing
copied to the host inside a module adapter's call. The VGGT
stand-in in bf16 launches the flash forward, 4 times a call; the pseudo-depth
CLI stores the same tree on the card as with --device cpu.
"""

import numpy as np
import pytest
import torch

from mapanything_tpu_torch import convert_dataset as CLI
from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.data.wai import load_frame, load_scene_meta
from mapanything_tpu_torch.models import GeometricInputConfig
from mapanything_tpu_torch.models import adapters as PA
from mapanything_tpu_torch.ops import flash_attention as fa
from mapanything_tpu_torch.perf.timing import host_transfers
from mapanything_tpu_torch.utils.device import full_fp32

import torch_adapter_fakes as FK
from torch_offline_scenes import room_cameras, write_scannetpp_raw

H, W = 56, 84
LIMIT = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the test holds the card's adapter "
                    "against the CPU's")
    return torch.device("cuda")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def assert_card_matches_cpu(card: dict, cpu: dict):
    assert set(card) == set(cpu)
    for key, val in card.items():
        assert val.is_cuda, key
        if val.dtype == torch.bool:
            assert torch.equal(val.cpu(), cpu[key]), key
        else:
            assert torch.isfinite(val).all(), key
            assert rel_l2(val, cpu[key]) <= LIMIT, (key, rel_l2(val,
                                                                cpu[key]))


def both(v=2, seed=0):
    return [make_synthetic_batch(1, v, H, W, seed=seed, device=dev)
            for dev in ("cuda", "cpu")]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vggt", "pi3", "moge"])
def test_cuda_module_adapter_matches_cpu(cuda_device, name):
    make = {"vggt": FK.VGGTStandIn, "pi3": FK.Pi3StandIn,
            "moge": FK.MoGeStandIn}[name]
    cls = {"vggt": PA.VGGTAdapter, "pi3": PA.Pi3Adapter,
           "moge": PA.MoGeAdapter}[name]
    outs = []
    for batch, dev in zip(both(), ("cuda", "cpu")):
        fake = make().to(dev)
        if name == "vggt":  # fp32: the flash kernel takes bf16 only
            fake.set_attn_impl("math")
        with full_fp32():
            outs.append(cls(fake)(batch["views"]))
    assert_card_matches_cpu(*outs)
    # the outputs stay on the card: nothing crosses to the host in the call
    assert host_transfers(lambda: cls(fake.cuda())(both()[0]["views"])) == {
        "copies": 0, "reads": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dust3r", "must3r", "pow3r", "anycalib"])
def test_cuda_callable_adapter_matches_cpu(cuda_device, name):
    outs = []
    for batch, dev in zip(both(seed=1), ("cuda", "cpu")):
        fn = {"dust3r": lambda: FK.posed_depth_scene_fn(batch),
              "must3r": lambda: FK.must3r_scene_fn(batch),
              "pow3r": lambda: FK.pow3r_pair_fn(batch)[0],
              "anycalib": lambda: FK.anycalib_calib_fn(H, W)}[name]()
        cls = {"dust3r": PA.DUSt3RAdapter, "must3r": PA.MUSt3RAdapter,
               "pow3r": PA.Pow3RAdapter, "anycalib": PA.AnyCalibAdapter}[name]
        adapter = cls(fn, device=dev)
        assert adapter.device.type == dev
        with full_fp32():
            outs.append(adapter(batch["views"]))
    assert_card_matches_cpu(*outs)


@pytest.mark.cuda
def test_cuda_pow3r_recovers_the_scale(cuda_device):
    batch = make_synthetic_batch(1, 2, H, W, seed=2, device="cuda")
    pair_fn, w2c0, _ = FK.pow3r_pair_fn(batch)
    preds = PA.Pow3RAdapter(pair_fn, geom_cfg=GeometricInputConfig())(
        batch["views"])
    want = (np.einsum("bij,bhwj->bhwi", w2c0[:, :3, :3],
                      batch["gt"]["pts3d"][:, 1].cpu().numpy())
            + w2c0[:, None, None, :3, 3])
    np.testing.assert_allclose(preds["pts3d"][:, 1].cpu().numpy(), want,
                               rtol=5e-3, atol=5e-3)


@pytest.mark.cuda
def test_cuda_vggt_stand_in_launches_the_flash_forward(cuda_device):
    batch = make_synthetic_batch(1, 2, H, W, seed=3, device="cuda")
    adapter = PA.VGGTAdapter(FK.VGGTStandIn(dim=128, heads=2,
                                            dtype=torch.bfloat16).cuda())
    fa.reset_launch_counts()
    with torch.inference_mode():
        preds = adapter(batch["views"])
    assert fa.flash_attention.kernel_counts["fwd"] == 4
    assert fa.flash_attention.plain_launches == 0
    assert all(torch.isfinite(v).all() for v in preds.values()
               if v.is_floating_point())


@pytest.mark.cuda
def test_cuda_pseudo_depth_cli_matches_cpu(cuda_device, tmp_path):
    write_scannetpp_raw(tmp_path / "raw", "scene0", room_cameras(2), W, H)
    ckpt = tmp_path / "moge.pt"
    torch.save(FK.MoGeStandIn(), ckpt)
    roots = []
    for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        with full_fp32():
            roots += CLI.main(["scannetppv2", str(tmp_path / "raw"),
                               str(tmp_path / tag), "--undistort",
                               "--pseudo-depth", str(ckpt), *extra])
    keys = ["pred_depth/moge2", "pred_mask/moge2"]
    meta = load_scene_meta(roots[0] / "scene_meta.json")
    for i in range(len(meta["frames"])):
        card, cpu = (load_frame(root, i, keys) for root in roots)
        np.testing.assert_allclose(card[keys[0]], cpu[keys[0]], rtol=LIMIT,
                                   atol=LIMIT)
        np.testing.assert_array_equal(card[keys[1]], cpu[keys[1]])
