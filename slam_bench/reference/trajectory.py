"""Trajectory errors against the rendered ground truth.

`umeyama_alignment`, `trajectory_positions` and `ate_rmse` are frozen copies
of trackingbench_slam_tpu_torch/utils/metrics.py:13-58 (the TUM / KITTI
ATE definition); `ate_sq_errors` is `ate_rmse` before its mean, and
`step_errors` the translation error of each frame-to-frame motion.
Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
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
    return -np.einsum("nji,nj->ni", R, t)


def ate_sq_errors(est_cw: np.ndarray, gt_cw: np.ndarray,
                  with_scale: bool = True) -> np.ndarray:
    """(N,) squared position errors after Umeyama alignment (similarity
    with `with_scale`)."""
    p_est = trajectory_positions(est_cw.astype(np.float64))
    p_gt = trajectory_positions(gt_cw.astype(np.float64))
    s, R, t = umeyama_alignment(p_est, p_gt, with_scale)
    p_est = (s * (R @ p_est.T)).T + t
    return ((p_est - p_gt) ** 2).sum(axis=1)


def ate_rmse(est_cw: np.ndarray, gt_cw: np.ndarray,
             with_scale: bool = True) -> float:
    return float(np.sqrt(ate_sq_errors(est_cw, gt_cw, with_scale).mean()))


def step_errors(est_cw: np.ndarray, gt_cw: np.ndarray) -> np.ndarray:
    """(N - 1,) metres by which each frame-to-frame motion's translation
    (frame i - 1's camera to frame i's) misses the true one."""
    est = est_cw.astype(np.float64)
    gt = gt_cw.astype(np.float64)
    d_est = est[1:] @ np.linalg.inv(est[:-1])
    d_gt = gt[1:] @ np.linalg.inv(gt[:-1])
    err = np.linalg.inv(d_gt) @ d_est
    return np.linalg.norm(err[:, :3, 3], axis=1)
