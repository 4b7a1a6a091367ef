"""The evaluation slice's kernel shapes and device code on the card.

This file imports no JAX, so it also runs on the GPU machine:
``python -m pytest tests/test_torch_eval_cuda.py -m cuda --noconftest``.
Every test needs a card and skips without one.

  * the flash forward kernel against its plain version at the DUSt3R-L
    shapes (12 heads, no class token, 768 tokens at 512x384), on the
    cross-attention's layout (q from one projection, k and v the strided
    halves of one (B, M, 2, H, D) tensor) and at the dense N-view
    batches: max-abs over the plain's max-abs and rel-L2 over the real
    rows within 1e-2 each, as chip_smoke.py phase 2;
  * rigid_points_registration on the card against the CPU within 1e-4;
  * the dense N-view normalisation on the card against the CPU, fp32,
    within 1e-4 of each output's largest magnitude;
  * the three benchmark CLIs with no --device and no --checkpoint (their
    seeded tiny models, bf16 on the card): finite metrics.
"""

import json

import numpy as np
import pytest
import torch

from mapanything_tpu_torch import benchmark_calibration as CalCLI
from mapanything_tpu_torch import benchmark_dense_n_view as DenseCLI
from mapanything_tpu_torch import benchmark_rmvd as RmvdCLI
from mapanything_tpu_torch.benchmarks.dense_n_view import (
    _normalize_for_metrics,
)
from mapanything_tpu_torch.data.wai import write_scene
from mapanything_tpu_torch.data.synthetic import make_synthetic_batch
from mapanything_tpu_torch.geometry import rigid_points_registration
from mapanything_tpu_torch.ops import flash_attention as fa

LIMIT = 1e-2


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_valid", [
    ((2, 768, 16, 64), None),  # DUSt3R-L encoder, one pair
    ((1, 768, 12, 64), None),  # decoder self-attention
    ((20, 1152, 16, 64), 1037),  # encoder at (batch, views) = (10, 2)
    ((10, 4224, 16, 64), 4145),  # 4-view global layer, online softmax
])
def test_cuda_forward_on_fused_qkv(cuda_device, shape, n_valid):
    b, n, h, d = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((b, n, 3, h, d), generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    if n_valid is not None:
        qkv[:, n_valid:] = 0
    q, k, v = qkv.unbind(2)
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v, n_valid=n_valid)
    assert fa.flash_attention.kernel_counts["fwd"] == 1
    real = n if n_valid is None else n_valid
    ref = fa.flash_attention_plain(q, k, v, n_valid)
    assert max(errors(out[:, :real], ref[:, :real])) <= LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(1, 768, 768), (2, 640, 768)])
def test_cuda_forward_on_cross_attention_layout(cuda_device, b, n, m):
    """q (B, N, 12, 64) of its own, k and v the strided halves of one
    (B, M, 2, 12, 64) tensor: q's token stride 768, k's and v's 1536."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn((b, n, 12, 64), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    kv = torch.randn((b, m, 2, 12, 64), generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    k, v = kv.unbind(2)
    assert q.stride(1) == 768 and k.stride(1) == v.stride(1) == 1536
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v)
    assert fa.flash_attention.kernel_counts["fwd"] == 1
    assert max(errors(out, fa.flash_attention_plain(q, k, v))) <= LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("with_scale", [False, True])
def test_cuda_rigid_registration_matches_cpu(cuda_device, with_scale):
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.normal(size=(8, 1024, 3)).astype(np.float32))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    r = torch.from_numpy((q * np.sign(np.linalg.det(q))).astype(np.float32))
    b = 1.7 * a @ r.T + torch.tensor([0.3, -1.0, 2.0])
    w = torch.from_numpy(rng.uniform(0.1, 1.0, (8, 1024)).astype(np.float32))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # must not reach it
    try:
        card = rigid_points_registration(a.to(cuda_device), b.to(cuda_device),
                                         w.to(cuda_device), with_scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    cpu = rigid_points_registration(a, b, w, with_scale)
    for got, ref in zip(card, cpu):
        np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=1e-4)


@pytest.mark.cuda
def test_cuda_normalize_for_metrics_matches_cpu(cuda_device):
    batch = make_synthetic_batch(2, 4, 42, 56, seed=3, device="cpu")
    gt = batch["gt"]
    rng = np.random.default_rng(4)
    preds = {
        "pts3d": gt["pts3d"] * 1.3 + 0.01 * torch.from_numpy(
            rng.normal(size=gt["pts3d"].shape).astype(np.float32)),
        "pts3d_cam": gt["pts3d_cam"] * 1.3,
        "cam_quats": gt["camera_pose_quats"],
        "cam_trans": gt["camera_pose_trans"] * 1.3,
        "metric_scaling_factor": torch.tensor([1.3, 0.7]),
    }
    cpu = _normalize_for_metrics(gt, preds)
    card = _normalize_for_metrics(
        {k: x.to(cuda_device) for k, x in gt.items()},
        {k: x.to(cuda_device) for k, x in preds.items()})
    for key, ref in cpu.items():
        got = card[key].cpu()
        if ref.dtype == torch.bool:
            assert torch.equal(got, ref)
        else:
            err = float((got - ref).abs().max() / ref.abs().max())
            assert err <= 1e-4, key


@pytest.mark.cuda
def test_cuda_rmvd_selftest_runs_by_default(cuda_device, capsys):
    """The bare --selftest: no --device, no --checkpoint, no rmvd."""
    assert RmvdCLI.main(["--selftest"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["num_samples"] == 2 and np.isfinite(out["depth_abs_rel"])


@pytest.fixture
def small_wai_root(tmp_path):
    """One scene of four 64 x 80 frames, a camera moving along x."""
    rng = np.random.default_rng(5)
    frames = []
    for i in range(4):
        pose = np.eye(4)
        pose[0, 3] = 0.1 * i
        frames.append({
            "frame_name": f"f{i}",
            "image": rng.integers(0, 255, (64, 80, 3), dtype=np.uint8),
            "depth": rng.uniform(2.0, 3.0, (64, 80)).astype(np.float32),
            "transform_matrix": pose})
    covis = np.ones((4, 4), np.float32)
    write_scene(str(tmp_path / "wai" / "scene_a"), frames,
                dict(fx=60.0, fy=60.0, cx=40.0, cy=32.0, w=80, h=64), covis,
                depth_format="npy")
    return str(tmp_path / "wai")


@pytest.mark.cuda
def test_cuda_tiny_benchmark_clis_run_by_default(cuda_device, small_wai_root,
                                                 tmp_path):
    flags = ["--wai_root", small_wai_root, "--tiny", "--resolution", "56",
             "42"]
    dense = DenseCLI.main(flags + [
        "--views", "2", "--batch_sizes", "2", "--num_sets", "2",
        "--output_dir", str(tmp_path / "dense")])
    assert dense[2]["num_sets"] == 2
    assert np.isfinite(dense[2]["pointmaps_abs_rel"])
    calib = CalCLI.main(flags + ["--batch_size", "2", "--num_sets", "2",
                                 "--output_dir", str(tmp_path / "calib")])
    assert calib["num_images"] == 2
    assert np.isfinite(calib["ray_angular_error_deg_mean"])
