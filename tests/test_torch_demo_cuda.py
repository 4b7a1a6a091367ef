"""The COLMAP demo's tracker and bundle adjustment on the card against the
same functions on the CPU.

This file imports no JAX, so it also runs on the GPU machine:
``python -m pytest tests/test_torch_demo_cuda.py -m cuda --noconftest``.
Every test needs a card and skips without one. Tolerances as the CPU
parity tests against JAX (tests/test_torch_tracking.py,
tests/test_torch_ba.py): tracks within 1e-4 px, scores within 1e-5, the
query points equal; 5 LM steps within 1e-4 of each output's largest
magnitude (fp32 with TF32 off on the card).
"""

import numpy as np
import pytest
import torch

from mapanything_tpu_torch.utils import ba as PB
from mapanything_tpu_torch.utils import tracking as PT
from torch_demo_scenes import ba_problem, grid_points, plane_views


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the test holds the card against "
                    "the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_tracking_matches_cpu(cuda_device):
    views, _ = plane_views(0, 4, 96, 128, 120.0)
    query = torch.from_numpy(grid_points(96, 128, 8, 8))
    images = torch.from_numpy(views)
    tracks, vis = PT.track_points(images.to(cuda_device),
                                  query.to(cuda_device))
    assert tracks.device.type == vis.device.type == "cuda"
    ref_tracks, ref_vis = PT.track_points(images, query)
    np.testing.assert_allclose(tracks.cpu().numpy(), ref_tracks.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(vis.cpu().numpy(), ref_vis.numpy(), atol=1e-5)
    gray = PT.to_gray(images[0])
    conf = torch.ones_like(gray)
    pts, vals = PT.select_query_points(conf.to(cuda_device),
                                       gray.to(cuda_device), 20)
    ref_pts, ref_vals = PT.select_query_points(conf, gray, 20)
    assert torch.equal(pts.cpu(), ref_pts)
    np.testing.assert_allclose(vals.cpu().numpy(), ref_vals.numpy(),
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("optimize_intrinsics", [True, False])
def test_cuda_bundle_adjust_matches_cpu(cuda_device, optimize_intrinsics):
    arrays, _ = ba_problem(2, drop=0.2, outliers=((1, 3, 50.0),
                                                  (2, 7, -40.0)))
    cpu = PB.BAProblem(*(torch.from_numpy(np.array(a)) for a in arrays))
    card = PB.BAProblem(*(t.to(cuda_device) for t in cpu))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = PB.bundle_adjust(card, iters=5,
                               optimize_intrinsics=optimize_intrinsics)
        assert torch.backends.cuda.matmul.allow_tf32  # restored
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = PB.bundle_adjust(cpu, iters=5,
                           optimize_intrinsics=optimize_intrinsics)
    for key, want in ref.items():
        got = out[key]
        assert got.device.type == "cuda", key
        want = want.double().numpy()
        err = np.abs(got.double().cpu().numpy() - want).max()
        assert err <= 1e-4 * max(1.0, np.abs(want).max()), (key, err)
