"""Trajectory export and import: the KITTI odometry and TUM-RGBD formats.

A copy of trackingbench_slam_tpu/utils/trajectory_io.py, so that this
package writes and reads the same files without importing the JAX package.

  KITTI:  one row per frame, 12 floats = row-major 3x4 of T_world_from_cam
          (the convention of the dataset's poses/SS.txt files).
  TUM:    "timestamp tx ty tz qx qy qz qw" per row, pose = cam->world.

All functions take and return world->camera (T_cw) 4x4 arrays, the
trackers' convention (StereoVO.poses()), and convert at the boundary.
"""

from __future__ import annotations

import numpy as np


def _as_Twc(T_cw: np.ndarray) -> np.ndarray:
    return np.linalg.inv(np.asarray(T_cw, np.float64))


def save_kitti_trajectory(path: str, T_cw: np.ndarray) -> None:
    """Write (N, 4, 4) world->camera poses as KITTI 3x4 rows."""
    T_wc = _as_Twc(T_cw)
    np.savetxt(path, T_wc[:, :3, :].reshape(len(T_wc), 12), fmt="%.9e")


def load_kitti_trajectory(path: str) -> np.ndarray:
    """Read KITTI 3x4 rows -> (N, 4, 4) world->camera poses."""
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    T_wc = np.tile(np.eye(4), (raw.shape[0], 1, 1))
    T_wc[:, :3, :] = raw
    return np.linalg.inv(T_wc)


def save_tum_trajectory(path: str, T_cw: np.ndarray,
                        timestamps: np.ndarray | None = None) -> None:
    """Write TUM-RGBD rows: t tx ty tz qx qy qz qw (cam->world)."""
    from scipy.spatial.transform import Rotation
    T_wc = _as_Twc(T_cw)
    n = len(T_wc)
    ts = np.arange(n, dtype=np.float64) if timestamps is None else (
        np.asarray(timestamps, np.float64))
    q = Rotation.from_matrix(T_wc[:, :3, :3]).as_quat()  # x y z w
    np.savetxt(path, np.column_stack([ts, T_wc[:, :3, 3], q]), fmt="%.9f")


def load_tum_trajectory(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read TUM rows -> (timestamps (N,), T_cw (N, 4, 4))."""
    from scipy.spatial.transform import Rotation
    raw = np.atleast_2d(np.loadtxt(path))
    T_wc = np.tile(np.eye(4), (raw.shape[0], 1, 1))
    T_wc[:, :3, :3] = Rotation.from_quat(raw[:, 4:8]).as_matrix()
    T_wc[:, :3, 3] = raw[:, 1:4]
    return raw[:, 0], np.linalg.inv(T_wc)
