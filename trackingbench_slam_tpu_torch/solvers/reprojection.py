"""The reprojection error of a pose and its robust cost: the residuals, their
chi2, the Huber weight and cost, and the motion-only normal equations with
their damped 6x6 solve.

The pose solve's plain round (ops/cuda/pose_kernel.py `lm_pose_iterations`)
is built from them, and the bundle adjusters (solvers/local_ba.py,
parallel/dist_ba.py) share the Huber terms.
"""

from __future__ import annotations

import torch

from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.ops.linalg import (cholesky, cholesky_apply,
                                                     fixed_sum)


def residuals(cam, T_cw, pts_w, obs_px):
    """(observed - projected pixels (N, 2), camera-frame points (N, 3))."""
    pc = se3.transform_points(T_cw, pts_w)
    return obs_px - cam_mod.world2cam(cam, pc), pc


def chi2(r, inv_sigma2):
    return (r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1]) * inv_sigma2


def huber_weight(chi2, delta: float):
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(e <= delta, torch.ones_like(e), delta / e)


def huber_rho(chi2, delta: float):
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(e <= delta, chi2, 2.0 * delta * e - delta * delta)


def normal_equations(cam, T_cw, pts_w, obs_px, inv_sigma2, weight_mask,
                     huber_delta):
    """(H (6, 6), b (6,), robust cost) at T_cw."""
    r, pc = residuals(cam, T_cw, pts_w, obs_px)
    behind = pc[..., 2] <= 0.05
    c2 = chi2(r, inv_sigma2)
    w = inv_sigma2 * weight_mask * torch.where(behind, 0.0, 1.0)
    if huber_delta is not None:
        w = w * huber_weight(c2, huber_delta)
    J = cam_mod.project_jacobian(cam, pc)               # (N, 2, 6)
    Jw = J * w[:, None, None]
    chi2m = torch.where(behind, torch.zeros_like(c2), c2)
    rho = chi2m if huber_delta is None else huber_rho(chi2m, huber_delta)
    cost = torch.where(weight_mask > 0, rho, torch.zeros_like(rho))
    # each point's terms, then H, b and the cost summed over the points in
    # one fixed order (ops/linalg.py): the same bits at any batch size
    H = (Jw[:, 0, :, None] * J[:, 0, None, :]
         + Jw[:, 1, :, None] * J[:, 1, None, :])
    b = Jw[:, 0] * r[:, 0:1] + Jw[:, 1] * r[:, 1:2]
    sums = fixed_sum(torch.cat([H.reshape(-1, 36), b, cost[:, None]], -1))
    return sums[:36].reshape(6, 6), sums[36:42], sums[42]


def chol6_solve(A, b):
    return cholesky_apply(cholesky(A, 1e-12), b)
