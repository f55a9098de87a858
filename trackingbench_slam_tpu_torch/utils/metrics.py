"""Trajectory evaluation: ATE-RMSE with Umeyama alignment, RPE.

The reference only ever prints estimated vs ground-truth poses for a human to
eyeball (test/test_vo.cpp:763-764); this module is the quantitative protocol
(the standard TUM/KITTI ATE definition) used by the benchmark harness.
A copy of trackingbench_slam_tpu/utils/metrics.py.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning src -> dst ((N, 3) each).
    Returns (s, R, t)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = np.trace(np.diag(D) @ S) / var_s
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def trajectory_positions(poses_cw: np.ndarray) -> np.ndarray:
    """(N, 4, 4) world->camera poses -> (N, 3) camera centers."""
    R = poses_cw[:, :3, :3]
    t = poses_cw[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)  # center = -R^T t


def ate_rmse(est_cw: np.ndarray, gt_cw: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE between two (N, 4, 4) world->camera
    pose arrays, after optional Umeyama alignment."""
    p_est = trajectory_positions(est_cw)
    p_gt = trajectory_positions(gt_cw)
    if align:
        s, R, t = umeyama_alignment(p_est, p_gt, with_scale)
        p_est = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))



def rpe_translation(est_cw: np.ndarray, gt_cw: np.ndarray,
                    delta: int = 1) -> float:
    """Relative pose error (translation RMSE) over `delta`-frame intervals."""
    errs = []
    for i in range(len(est_cw) - delta):
        de = np.linalg.inv(est_cw[i]) @ est_cw[i + delta]
        dg = np.linalg.inv(gt_cw[i]) @ gt_cw[i + delta]
        e = np.linalg.inv(dg) @ de
        errs.append(np.linalg.norm(e[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs))))
