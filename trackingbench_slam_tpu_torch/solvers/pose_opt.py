"""Motion-only bundle adjustment: Levenberg-Marquardt on SE(3).

Port of trackingbench_slam_tpu/solvers/pose_opt.py: the 4-round scheme of
LocalBA::PoseOptimization (10 LM iterations per round, chi2 gate 5.991
between rounds, Huber in all but the last round, lambda0 1e-4), with the
single-sweep LM loop whose (H, b) ride the loop state. Accept/reject is a
select on the device, so the loop never waits for the host.

Each round is one call of ops/cuda/pose_kernel.py `pose_round`: on the card
one launch of its CUDA kernel (for the whole batch under torch.func.vmap),
on the CPU the plain version, `lm_pose_iterations` and the round's gate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trackingbench_slam_tpu_torch.ops.cuda import pose_kernel
from trackingbench_slam_tpu_torch.solvers import reprojection as rp
from trackingbench_slam_tpu_torch.utils.config import SolverConfig
from trackingbench_slam_tpu_torch.utils.profiling import stage


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor
    chi2: torch.Tensor


def pose_optimization(cam, T_init, pts_w, obs_px, inv_sigma2, valid,
                      config: SolverConfig = SolverConfig()) -> PoseOptResult:
    camv = pose_kernel.camera_vector(cam)
    T, pts_w, obs_px, inv_sigma2, valid = (
        t.contiguous() for t in (T_init, pts_w, obs_px, inv_sigma2, valid))
    inlier = valid
    chi2 = None
    for rnd in range(config.rounds):
        delta = config.huber_delta if rnd < config.rounds - 1 else None
        with stage("track.pose_optimization.round"):
            # the round's chi2 is at its final pose: the last is the solve's
            T, inlier, chi2 = pose_kernel.pose_round(
                camv, T, pts_w, obs_px, inv_sigma2, inlier, valid, delta,
                config.iters_per_round, config.init_lambda,
                config.chi2_threshold)
    if chi2 is None:
        chi2 = rp.chi2(rp.residuals(cam, T, pts_w, obs_px)[0], inv_sigma2)
    return PoseOptResult(T_cw=T, inliers=inlier,
                         num_inliers=inlier.sum().to(torch.int32), chi2=chi2)


def level_inv_sigma2(levels: torch.Tensor, scale_factor: float):
    """scale^(2 level): keypoints of level l carry sigma = (1/scale)^l."""
    base = torch.full((), scale_factor, dtype=torch.float32,
                      device=levels.device) ** 2
    return torch.pow(base, levels.float())
