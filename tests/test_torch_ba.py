"""The port's bundle adjustment (utils/ba.py) against the JAX package's, on
the CPU, on tests/test_ba.py-style problems: F = 5 frames, P = 60 points,
masked holes, two outlier observations, intrinsics optimised and fixed.

Tolerances (each output's error over max(1, its largest magnitude), fp32
on both sides): rms_before within 1e-5; after 1 and 5 LM steps within
1e-4, after 20 within 1e-3. A step solves the damped Schur system, whose
conditioning (the 7-dof gauge is held by the damping alone) turns fp32
rounding into ~1e-4 of a translation: on the problem of seed 1 one step
differs from JAX by 1.01e-4, 9.4e-5 of it JAX's own rounding (against an
fp64 run of the port). Where a late step changes the cost by less than
fp32 rounding, the two packages can take different accept decisions and
then drift apart along the gauge at the same reprojection error;
`test_late_accept_flip_keeps_the_fit` holds that case to the
gauge-invariant outputs. The port's own counterparts of test_ba.py's
convergence, fixed-intrinsics and outlier tests follow.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mapanything_tpu.utils import ba as JB
from mapanything_tpu_torch.utils import ba as PB
from torch_demo_scenes import INTRINSICS, ba_problem, quat_mul


def _port(arrays):
    return PB.BAProblem(*(torch.from_numpy(np.array(a)) for a in arrays))


def _jax(arrays):
    return JB.BAProblem(*(jnp.asarray(a) for a in arrays))


def _run_both(arrays, iters, optimize_intrinsics):
    with jax.default_matmul_precision("highest"):
        ref = JB.bundle_adjust(_jax(arrays), iters=iters,
                               optimize_intrinsics=optimize_intrinsics)
    out = PB.bundle_adjust(_port(arrays), iters=iters,
                           optimize_intrinsics=optimize_intrinsics)
    return out, {k: np.asarray(v) for k, v in ref.items()}


def _rel_err(got, want):
    got, want = got.double().numpy(), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


OUTLIERS = ((1, 3, 50.0), (2, 7, -40.0))


@pytest.mark.parametrize("iters,tol", [(1, 1e-4), (5, 1e-4), (20, 1e-3)])
@pytest.mark.parametrize("seed,optimize_intrinsics",
                         [(2, True), (2, False), (3, True), (3, False)])
def test_matches_jax(seed, optimize_intrinsics, iters, tol):
    arrays, _ = ba_problem(seed, drop=0.2, outliers=OUTLIERS)
    out, ref = _run_both(arrays, iters, optimize_intrinsics)
    assert _rel_err(out["rms_before"], ref["rms_before"]) <= 1e-5
    for key in ("cam_quats", "cam_trans", "intrinsics", "points",
                "rms_after"):
        err = _rel_err(out[key], ref[key])
        assert err <= tol, f"{key}: {err:.3g} > {tol}"


def test_late_accept_flip_keeps_the_fit():
    """Seed 0: the fit plateaus at the outliers' cost and step 13 changes it
    by ~1e-5 relative, where the two packages' accept decisions part. The
    reprojection error and the intrinsics, which the gauge does not move,
    still agree."""
    arrays, _ = ba_problem(0, drop=0.2, outliers=OUTLIERS)
    out, ref = _run_both(arrays, 20, True)
    assert _rel_err(out["rms_after"], ref["rms_after"]) <= 1e-5
    assert _rel_err(out["intrinsics"], ref["intrinsics"]) <= 1e-5


def _rel_angle(qa, qb, qa0, qb0):
    """The angle between the rotations qa qa0^-1 and qb qb0^-1."""
    conj = np.array([-1, -1, -1, 1], np.float32)
    ra, rb = quat_mul(qa, qa0 * conj), quat_mul(qb, qb0 * conj)
    return 2 * np.arccos(min(abs(float(np.dot(ra, rb))), 1.0))


def test_convergence():
    arrays, qs_true = ba_problem(0)
    out = PB.bundle_adjust(_port(arrays), iters=25)
    before, after = float(out["rms_before"]), float(out["rms_after"])
    assert after < 0.25 and after < before / 8, (before, after)
    np.testing.assert_allclose(out["intrinsics"].numpy(), INTRINSICS,
                               rtol=0.01)
    q = out["cam_quats"].numpy()
    for f in range(1, len(q)):  # relative rotations: the gauge is free
        assert _rel_angle(q[f], qs_true[f], q[0], qs_true[0]) < np.deg2rad(
            0.5), f


def test_fixed_intrinsics():
    arrays, _ = ba_problem(1)
    out = PB.bundle_adjust(_port(arrays), iters=15, optimize_intrinsics=False)
    np.testing.assert_array_equal(out["intrinsics"].numpy(), arrays[4])
    assert float(out["rms_after"]) < float(out["rms_before"])


def test_outliers_downweighted():
    arrays, qs_true = ba_problem(2, noise_px=0.05)
    rng = np.random.default_rng(2)
    tracks = arrays[0].copy()
    tracks[rng.uniform(size=tracks.shape[:2]) < 0.05] += 50.0
    out = PB.bundle_adjust(_port((tracks,) + arrays[1:]), iters=25,
                           huber_px=2.0)
    assert float(out["rms_after"]) < float(out["rms_before"])
    q = out["cam_quats"].numpy()
    for f in range(1, len(q)):
        assert _rel_angle(q[f], qs_true[f], q[0], qs_true[0]) < np.deg2rad(
            1.0), f


def test_outputs_stay_on_the_device_of_the_tracks():
    arrays, _ = ba_problem(4)
    out = PB.bundle_adjust(_port(arrays), iters=2)
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               and v.dtype == torch.float32 for v in out.values())
    assert out["rms_before"].dim() == out["rms_after"].dim() == 0
