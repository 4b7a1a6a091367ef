"""Bundle adjustment by Levenberg-Marquardt with a Schur complement, in
torch on the device of its inputs; counterpart of
mapanything_tpu/utils/ba.py.

It stands in for the reference's pycolmap bundle adjustment and refines
per-frame poses, shared pinhole intrinsics and 3D points against 2D tracks:

  * residuals: the Huber-weighted reprojection error of every (frame,
    point) observation, masked by the track's visibility;
  * Jacobians: forward-mode autodiff (torch.func.jacfwd) vmapped over the
    observations, no hand derivatives;
  * solver: the Hessian [[B, E], [E^T, C]] has C block-diagonal (3x3 a
    point), so the points are eliminated and only the camera system of
    6F + 4 unknowns is solved densely; the points follow by
    back-substitution.

The LM loop accepts or rejects each step with torch.where on device
tensors: nothing returns to the host until the caller reads the RMS. The
fp32 products run with TF32 off (restored after), as the JAX package's
precision="highest" does.

Parameterisation: the cam-from-world rotation as a rotation-vector
increment applied to a base quaternion (xyzw), a translation increment,
and the shared (fx, fy, cx, cy).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch.func import jacfwd, vmap

from .device import full_fp32


def _quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    u = q[..., :3]
    uv = _cross(u, v)
    return v + 2.0 * (q[..., 3:] * uv + _cross(u, uv))


def _axis_angle_quat(a: torch.Tensor) -> torch.Tensor:
    """Small-angle rotation vector -> unit quaternion (xyzw), to second
    order."""
    theta2 = (a * a).sum(-1, keepdim=True)
    q = torch.cat([a * (0.5 - theta2 / 48.0), 1.0 - theta2 / 8.0], dim=-1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


class BAProblem(NamedTuple):
    tracks: torch.Tensor      # (F, P, 2) observed (x, y) pixels
    track_mask: torch.Tensor  # (F, P) bool
    base_quats: torch.Tensor  # (F, 4) cam-from-world xyzw
    base_trans: torch.Tensor  # (F, 3)
    intrinsics: torch.Tensor  # (4,) fx fy cx cy (shared)
    points: torch.Tensor      # (P, 3) world


def _project(cam_rot_vec, cam_dt, base_q, base_t, intr, pt):
    """One observation: world point -> pixel (x, y)."""
    q = _quat_mul(_axis_angle_quat(cam_rot_vec), base_q)
    pc = _quat_rotate(q, pt) + base_t + cam_dt
    z = pc[2].clamp_min(1e-6)
    return torch.stack([intr[0] * pc[0] / z + intr[2],
                        intr[1] * pc[1] / z + intr[3]])


def _residual(cam6, intr, pt, base_q, base_t, obs):
    return _project(cam6[:3], cam6[3:6], base_q, base_t, intr, pt) - obs


def _huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """sqrt of the Huber weight of each residual (..., 2)."""
    nrm = torch.linalg.norm(r, dim=-1) + 1e-12
    return torch.sqrt(torch.where(nrm <= delta, 1.0, delta / nrm))


@torch.no_grad()
def bundle_adjust(problem: BAProblem, iters: int = 20, huber_px: float = 2.0,
                  lm_init: float = 1e-3,
                  optimize_intrinsics: bool = True) -> Dict[str, torch.Tensor]:
    """Run `iters` LM steps of bundle adjustment on the device of
    `problem.tracks`.

    Returns {cam_quats (F, 4) cam-from-world xyzw, cam_trans (F, 3),
    intrinsics (4,), points (P, 3), rms_before, rms_after (0-d)}: the masked
    RMS reprojection error in pixels before and after, as device tensors.
    """
    with full_fp32():
        return _bundle_adjust(problem, iters, huber_px, lm_init,
                              optimize_intrinsics)


def _bundle_adjust(problem, iters, huber_px, lm_init, optimize_intrinsics):
    f32 = torch.float32
    dev = problem.tracks.device
    n_f, n_p, _ = problem.tracks.shape
    base_q = problem.base_quats.to(dev, f32)
    base_t = problem.base_trans.to(dev, f32)
    obs = problem.tracks.to(f32)
    mask = problem.track_mask.to(dev, f32)
    # one row per observation, frame-major: (F * P, ...)
    bq = base_q[:, None].expand(n_f, n_p, 4).reshape(-1, 4)
    bt = base_t[:, None].expand(n_f, n_p, 3).reshape(-1, 3)
    ob = obs.reshape(-1, 2)

    def per_obs(cam, pts):
        return (cam[:, None].expand(n_f, n_p, 6).reshape(-1, 6),
                pts[None].expand(n_f, n_p, 3).reshape(-1, 3))

    res_all = vmap(_residual, in_dims=(0, None, 0, 0, 0, 0))
    jac_all = vmap(jacfwd(_residual, argnums=(0, 1, 2)),
                   in_dims=(0, None, 0, 0, 0, 0))

    def residuals(cam, intr, pts):
        c, x = per_obs(cam, pts)
        return res_all(c, intr, x, bq, bt, ob).reshape(n_f, n_p, 2)

    def masked_rms(r):
        w = mask[..., None]
        return torch.sqrt((r * r * w).sum()
                          / torch.clamp_min(w.sum() * 2, 1.0))

    cam = torch.zeros((n_f, 6), dtype=f32, device=dev)
    intr = problem.intrinsics.to(dev, f32)
    pts = problem.points.to(dev, f32)
    lam = torch.tensor(lm_init, dtype=f32, device=dev)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye_f = torch.eye(n_f, dtype=f32, device=dev)[:, :, None, None]
    rms_before = masked_rms(residuals(cam, intr, pts))

    for _ in range(iters):
        r = residuals(cam, intr, pts)
        w = (mask * _huber_weight(r, huber_px))[..., None]  # (F, P, 1)
        rw = r * w
        c, x = per_obs(cam, pts)
        jc, ji, jx = (j.reshape(n_f, n_p, 2, -1) for j in
                      jac_all(c, intr, x, bq, bt, ob))
        if not optimize_intrinsics:
            ji = ji * 0.0
        jc, ji, jx = (j * w[..., None] for j in (jc, ji, jx))

        bcc = torch.einsum("fpri,fprj->fij", jc, jc)  # (F, 6, 6)
        bci = torch.einsum("fpri,fprj->fij", jc, ji)  # (F, 6, 4)
        bii = torch.einsum("fpri,fprj->ij", ji, ji)  # (4, 4)
        cpp = torch.einsum("fpri,fprj->pij", jx, jx)  # (P, 3, 3)
        ecp = torch.einsum("fpri,fprj->fpij", jc, jx)  # (F, P, 6, 3)
        eip = torch.einsum("fpri,fprj->pij", ji, jx)  # (P, 4, 3)
        gc = -torch.einsum("fpri,fpr->fi", jc, rw)  # (F, 6)
        gi = -torch.einsum("fpri,fpr->i", ji, rw)  # (4,)
        gx = -torch.einsum("fpri,fpr->pi", jx, rw)  # (P, 3)

        # LM damping of the point blocks by their mean diagonal
        scale = torch.diagonal(cpp, dim1=-2, dim2=-1).mean(-1).clamp_min(1e-6)
        cinv = torch.linalg.inv(cpp + lam * eye3 * scale[:, None, None])

        # the Schur complement onto the cameras, S = B - E C^-1 E^T
        ec = torch.einsum("fpij,pjk->fpik", ecp, cinv)  # (F, P, 6, 3)
        scc = -torch.einsum("fpik,gpjk->fgij", ec, ecp) + eye_f * bcc[:, None]
        sci = bci - torch.einsum("fpik,pjk->fij", ec, eip)  # (F, 6, 4)
        eic = torch.einsum("pij,pjk->pik", eip, cinv)  # (P, 4, 3)
        sii = bii - torch.einsum("pik,pjk->ij", eic, eip)  # (4, 4)
        vc = gc - torch.einsum("fpik,pk->fi", ec, gx)  # (F, 6)
        vi = gi - torch.einsum("pik,pk->i", eic, gx)  # (4,)

        sci_flat = sci.reshape(6 * n_f, 4)
        s = torch.cat([
            torch.cat([scc.permute(0, 2, 1, 3).reshape(6 * n_f, 6 * n_f),
                       sci_flat], dim=1),
            torch.cat([sci_flat.T, sii], dim=1)])
        s = s + lam * torch.diag(torch.diagonal(s).clamp_min(1e-6))
        delta = torch.linalg.solve(s, torch.cat([vc.reshape(-1), vi]))
        dc = delta[:6 * n_f].reshape(n_f, 6)
        di = delta[6 * n_f:]
        # back-substitution: dx = C^-1 (gx - E^T dc - Eip^T di)
        rhs_x = (gx - torch.einsum("fpij,fi->pj", ecp, dc)
                 - torch.einsum("pij,i->pj", eip, di))
        dx = torch.einsum("pij,pj->pi", cinv, rhs_x)

        cam_new, intr_new, pts_new = cam + dc, intr + di, pts + dx
        improved = (masked_rms(residuals(cam_new, intr_new, pts_new))
                    < masked_rms(r))
        cam = torch.where(improved, cam_new, cam)
        intr = torch.where(improved, intr_new, intr)
        pts = torch.where(improved, pts_new, pts)
        lam = torch.where(improved, lam * 0.5, lam * 4.0).clamp(1e-9, 1e6)

    return {
        "cam_quats": _quat_mul(_axis_angle_quat(cam[:, :3]), base_q),
        "cam_trans": base_t + cam[:, 3:6],
        "intrinsics": intr,
        "points": pts,
        "rms_before": rms_before,
        "rms_after": masked_rms(residuals(cam, intr, pts)),
    }
