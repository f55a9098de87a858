"""Motion-only bundle adjustment: Levenberg-Marquardt on SE(3).

Port of trackingbench_slam_tpu/solvers/pose_opt.py: the 4-round scheme of
LocalBA::PoseOptimization (10 LM iterations per round, chi2 gate 5.991
between rounds, Huber in all but the last round, lambda0 1e-4), with the
single-sweep LM loop whose (H, b) ride the loop state. Accept/reject is a
select on the device, so the loop never waits for the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
from trackingbench_slam_tpu_torch.geometry import se3
from trackingbench_slam_tpu_torch.ops.linalg import cholesky, cholesky_apply
from trackingbench_slam_tpu_torch.utils.config import SolverConfig


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor
    chi2: torch.Tensor


def _residuals(cam, T_cw, pts_w, obs_px):
    pc = se3.transform_points(T_cw, pts_w)
    return obs_px - cam_mod.world2cam(cam, pc), pc


def _chi2(r, inv_sigma2):
    return (r * r).sum(-1) * inv_sigma2


def _huber_weight(chi2, delta: float):
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(e <= delta, torch.ones_like(e), delta / e)


def _huber_rho(chi2, delta: float):
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(e <= delta, chi2, 2.0 * delta * e - delta * delta)


def _normal_equations(cam, T_cw, pts_w, obs_px, inv_sigma2, weight_mask,
                      huber_delta):
    """(H (6, 6), b (6,), robust cost) at T_cw."""
    r, pc = _residuals(cam, T_cw, pts_w, obs_px)
    behind = pc[..., 2] <= 0.05
    chi2 = _chi2(r, inv_sigma2)
    w = inv_sigma2 * weight_mask * torch.where(behind, 0.0, 1.0)
    if huber_delta is not None:
        w = w * _huber_weight(chi2, huber_delta)
    J = cam_mod.project_jacobian(cam, pc)               # (N, 2, 6)
    Jw = J * w[:, None, None]
    H = torch.einsum("nij,nik->jk", Jw, J)
    b = torch.einsum("nij,ni->j", Jw, r)
    chi2m = torch.where(behind, torch.zeros_like(chi2), chi2)
    rho = chi2m if huber_delta is None else _huber_rho(chi2m, huber_delta)
    cost = torch.where(weight_mask > 0, rho, torch.zeros_like(rho)).sum()
    return H, b, cost


def _chol6_solve(A, b):
    return cholesky_apply(cholesky(A, 1e-12), b)


def lm_pose_iterations(cam, T0, pts_w, obs_px, inv_sigma2, mask,
                       iters: int, huber_delta, init_lambda: float = 1e-4):
    maskf = mask.float()

    def build(T):
        return _normal_equations(cam, T, pts_w, obs_px, inv_sigma2, maskf,
                                 huber_delta)

    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    H, b, cost = build(T0)
    T = T0
    lam = torch.full((), init_lambda, dtype=T0.dtype, device=T0.device)
    for _ in range(iters):
        dx = _chol6_solve(H + lam * eye6, b)
        T_new = se3.compose(se3.exp(dx), T)
        H_t, b_t, cost_new = build(T_new)
        accept = cost_new < cost
        T = torch.where(accept, T_new, T)
        H = torch.where(accept, H_t, H)
        b = torch.where(accept, b_t, b)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
        cost = torch.where(accept, cost_new, cost)
    return se3.normalize(T), cost


def pose_optimization(cam, T_init, pts_w, obs_px, inv_sigma2, valid,
                      config: SolverConfig = SolverConfig()) -> PoseOptResult:
    inlier = valid
    T = T_init
    for rnd in range(config.rounds):
        delta = config.huber_delta if rnd < config.rounds - 1 else None
        T, _ = lm_pose_iterations(cam, T, pts_w, obs_px, inv_sigma2, inlier,
                                  iters=config.iters_per_round,
                                  huber_delta=delta,
                                  init_lambda=config.init_lambda)
        r, pc = _residuals(cam, T, pts_w, obs_px)
        chi2 = _chi2(r, inv_sigma2)
        inlier = valid & (chi2 <= config.chi2_threshold) & (pc[..., 2] > 0.05)
    r, pc = _residuals(cam, T, pts_w, obs_px)
    chi2 = _chi2(r, inv_sigma2)
    return PoseOptResult(T_cw=T, inliers=inlier,
                         num_inliers=inlier.sum().to(torch.int32), chi2=chi2)


def level_inv_sigma2(levels: torch.Tensor, scale_factor: float):
    """scale^(2 level): keypoints of level l carry sigma = (1/scale)^l."""
    base = torch.full((), scale_factor, dtype=torch.float32,
                      device=levels.device) ** 2
    return torch.pow(base, levels.float())
