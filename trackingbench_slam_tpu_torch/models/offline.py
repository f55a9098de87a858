"""Trajectory refinement against final keyframe poses.

Port of `refine_trajectory` (trackingbench_slam_tpu/models/offline.py:102),
used by StereoVO.poses. Plain numpy.
"""

from __future__ import annotations

import numpy as np


def refine_trajectory(T_traj: np.ndarray, kf_frame_id: np.ndarray,
                      kf_valid: np.ndarray, kf_T_cw: np.ndarray) -> np.ndarray:
    """Re-express each frame's pose relative to its reference keyframe's
    final ring pose: T_i' = T_i . T_ref^-1 . T_ref_final."""
    T = np.asarray(T_traj)
    final = {max(int(kf_frame_id[s]) - 1, 0): kf_T_cw[s]
             for s in range(len(kf_frame_id)) if kf_valid[s]}
    out = T.copy()
    ref = None
    for i in range(T.shape[0]):
        if i in final:
            ref = i
            out[i] = final[i]
        elif ref is not None:
            out[i] = (T[i] @ np.linalg.inv(T[ref])) @ final[ref]
    return out
