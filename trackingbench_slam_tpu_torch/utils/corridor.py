"""The main-path configuration, the loop bench's, and their corridor frames.

`main_path_config()` is the stereo-VO operating point that bench.py times
(bench.py:51-76: 1226x370, 2000 ORB features, 3-level x0.8 pyramid, a
keyframe every 5th frame, 16384 landmarks, 16 keyframes, windowed local BA
on every 2nd keyframe compacted to 2048 landmarks). `main_path_config_ba_off`
is the same with windowed BA off. `loop_bench_config()` is bench.py's loop
bench (bench.py:322-404): the main path with 3 LK tracking levels.
`corridor_frames()` renders bench.py's render_frames sequence (forward motion
with a continuous yaw down the multi-plane corridor) and `loop_frames()` its
loop bench's closed circle; right images on the bootstrap frame and on
keyframes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from trackingbench_slam_tpu_torch.utils.config import (CameraConfig,
                                                       ExtractorConfig,
                                                       MapConfig,
                                                       PipelineConfig,
                                                       PyramidConfig,
                                                       SolverConfig)
from trackingbench_slam_tpu_torch.utils.synthetic import (
    CorridorScene, forward_yaw_trajectory, loop_trajectory)

BASELINE = 0.54


def main_path_config() -> PipelineConfig:
    cam = CameraConfig(width=1226, height=370, fx=707.09, fy=707.09,
                       cx=601.89, cy=183.11, bf=707.09 * BASELINE)
    return PipelineConfig(
        camera=cam,
        pyramid=PyramidConfig(num_levels=3, scale_factor=0.8),
        extractor=ExtractorConfig(num_features=2000, min_threshold=12,
                                  cell_size=24),
        map=MapConfig(max_keyframes=16, max_points=16384),
        keyframe_every=5,
        local_ba_every=2,
        solver=dataclasses.replace(SolverConfig(), max_landmarks=2048),
    )


def main_path_config_ba_off() -> PipelineConfig:
    return dataclasses.replace(main_path_config(), local_ba_every=0)


def loop_bench_config() -> PipelineConfig:
    return dataclasses.replace(main_path_config(), lk_track_levels=3)


def _render(cfg: PipelineConfig, gt: np.ndarray, baseline: float):
    scene = CorridorScene(cfg.camera, width=10.0, height=5.0)

    def u8(a):
        return np.clip(a, 0, 255).astype(np.uint8)

    frames = []
    for i, T in enumerate(gt):
        if i == 0 or (i + 1) % cfg.keyframe_every == 0:
            left, right = scene.stereo_pair(T, baseline)
            frames.append((u8(left), u8(right)))
        else:
            frames.append((u8(scene.render(T)), None))
    return frames, gt, scene


def corridor_frames(cfg: PipelineConfig, n: int, baseline: float = BASELINE):
    """[(left uint8, right uint8 or None)], the (n, 4, 4) world->camera
    ground truth and the scene."""
    return _render(cfg, forward_yaw_trajectory(n, step=0.12, yaw_rate=0.01),
                   baseline)


def loop_frames(cfg: PipelineConfig, n: int = 96, radius: float = 1.5,
                baseline: float = BASELINE):
    """The loop bench's closed circle, as corridor_frames."""
    return _render(cfg, loop_trajectory(n, radius=radius), baseline)


def closing_error(poses: np.ndarray, gt: np.ndarray) -> float:
    """Distance between the last estimated and true camera centres, the VO
    world anchored at gt[0] (bench.py's loop-bench metric)."""
    c_est = np.linalg.inv(poses[-1] @ gt[0])[:3, 3]
    c_gt = np.linalg.inv(gt[-1])[:3, 3]
    return float(np.linalg.norm(c_est - c_gt))
