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
keyframes. `direct_config()` / `direct_frames()`, `mono_config()` /
`mono_frames()` and `indirect_frames()` (for utils/config.py
`euroc_stereo_config()`) are the other three trackers' configurations and
sequences, the JAX package's own gates at these widths.
`tracked_loop_config()` / `tracked_loop_frames()` are the JAX package's
own loop test's configuration and circle (at 72 frames, parity.py
TRACKED_FRAMES, both packages track it without losing a frame; the loop
bench's circle loses frames in both).

Inside `render_pool(processes)` every one of these sequences renders on one
pool of spawned processes, started once, a run of frames each; the frames
are the same as when rendered in-process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np

from trackingbench_slam_tpu_torch.utils.config import (CameraConfig,
                                                       ExtractorConfig,
                                                       MapConfig,
                                                       PipelineConfig,
                                                       PyramidConfig,
                                                       SolverConfig)
from trackingbench_slam_tpu_torch.utils.synthetic import (
    CorridorScene, forward_yaw_trajectory, lateral_trajectory,
    loop_trajectory)

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


def _u8(a):
    return np.clip(a, 0, 255).astype(np.uint8)


# (pool, processes) while render_pool is in force
_pool = None


@contextlib.contextmanager
def render_pool(processes: int):
    """While inside, the sequences of this module render on one pool of
    `processes` spawned processes (one BLAS thread each), started here; the
    frames are the same. With `processes` <= 1, or inside another
    render_pool, nothing changes."""
    global _pool
    if processes <= 1 or _pool is not None:
        yield
        return
    import multiprocessing
    names = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update({k: "1" for k in names})
    try:   # the workers start here and keep this environment
        pool = multiprocessing.get_context("spawn").Pool(processes)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _pool = (pool, processes)
    try:
        with pool:
            yield
    finally:
        _pool = None


def _stereo_at(rule: str, every: int, i: int) -> bool:
    """Whether frame i has a right image: on every frame ("all"), frame 0
    ("first"), frame 0 and every keyframe of the cadence `every`
    ("keyframes"), or none ("none")."""
    return (rule == "all" or (i == 0 and rule != "none")
            or (rule == "keyframes" and (i + 1) % every == 0))


def _render_range(job) -> list:
    """Frames lo..hi-1 of a sequence (render_sequence's job)."""
    scene, gt, baseline, u8, rule, every, lo, hi = job
    if not isinstance(scene, CorridorScene):
        camera, kw = scene
        scene = CorridorScene(camera, **kw)
    out = _u8 if u8 else (lambda a: a)
    frames = []
    for i in range(lo, hi):
        if _stereo_at(rule, every, i):
            frames.append(tuple(out(x) for x in scene.stereo_pair(gt[i],
                                                                  baseline)))
        else:
            frames.append((out(scene.render(gt[i])), None))
    return frames


def render_sequence(camera, scene_kw: dict, gt: np.ndarray,
                    baseline: float, u8: bool, rule: str, every: int = 1,
                    scene=None) -> list:
    """[(left, right or None)] of the trajectory `gt` in
    CorridorScene(camera, **scene_kw) (`scene`, where the caller built it),
    right images where _stereo_at says; uint8 with `u8`, else float32 as
    rendered. On render_pool's processes when one is in force, a run of
    frames each."""
    if _pool is None:
        return _render_range((scene or CorridorScene(camera, **scene_kw), gt,
                              baseline, u8, rule, every, 0, len(gt)))
    pool, processes = _pool
    cut = np.linspace(0, len(gt), processes + 1).astype(int)
    jobs = [((camera, scene_kw), gt, baseline, u8, rule, every, lo, hi)
            for lo, hi in zip(cut[:-1], cut[1:]) if hi > lo]
    return [f for part in pool.map(_render_range, jobs) for f in part]


def _render(cfg: PipelineConfig, gt: np.ndarray, baseline: float,
            width: float = 10.0, u8: bool = True):
    """Right images on frame 0 and on every keyframe, in a CorridorScene
    `width` m wide and 5 m high; uint8 with `u8`, else float32 as
    rendered. Returns (frames, gt, scene)."""
    kw = dict(width=width, height=5.0)
    scene = CorridorScene(cfg.camera, **kw)
    return (render_sequence(cfg.camera, kw, gt, baseline, u8, "keyframes",
                            cfg.keyframe_every, scene), gt, scene)


def corridor_frames(cfg: PipelineConfig, n: int, baseline: float = BASELINE):
    """[(left uint8, right uint8 or None)], the (n, 4, 4) world->camera
    ground truth and the scene."""
    return _render(cfg, forward_yaw_trajectory(n, step=0.12, yaw_rate=0.01),
                   baseline)


def loop_frames(cfg: PipelineConfig, n: int = 96, radius: float = 1.5,
                baseline: float = BASELINE, ease: float = 0.75):
    """The loop bench's closed circle, as corridor_frames; `ease` is
    loop_trajectory's speed profile (0.75: the turn rate ramps from a
    quarter of its mean to 1.75 times it at mid-loop; 0: constant)."""
    return _render(cfg, loop_trajectory(n, radius=radius, ease=ease),
                   baseline)


TRACKED_BASELINE = 0.25


def tracked_loop_config() -> PipelineConfig:
    """The JAX package's own loop test's configuration
    (tests/test_loop_online.py:22-37 with a keyframe every 3rd frame):
    512x384, fx 400, a 0.25 m baseline, 3 levels x0.8, 600 ORB features,
    16 keyframes, 8192 landmarks, 3 LK tracking levels, no windowed BA."""
    cam = CameraConfig(width=512, height=384, fx=400.0, fy=400.0, cx=256.0,
                       cy=192.0, bf=400.0 * TRACKED_BASELINE)
    return PipelineConfig(
        camera=cam, pyramid=PyramidConfig(num_levels=3, scale_factor=0.8),
        extractor=ExtractorConfig(num_features=600, min_threshold=10,
                                  cell_size=24),
        map=MapConfig(max_keyframes=16, max_points=8192), keyframe_every=3,
        local_ba_every=0, lk_track_levels=3)


def tracked_loop_frames(cfg: PipelineConfig, n: int = 48,
                        baseline: float = TRACKED_BASELINE,
                        width: float = 8.0, radius: float = 1.0,
                        ease: float = 0.75):
    """That test's closed circle (tests/test_loop_online.py:60-80, 48
    frames) at n frames: a 1 m circle in an 8 m wide corridor, float32
    images as rendered, a stereo pair on frame 0 and on keyframes (at
    `cfg`'s camera, whose bf is fx * `baseline`). `width`, `radius` and
    `ease` give another corridor width, circle and speed profile
    (loop_trajectory). Returns (frames, gt)."""
    frames, gt, _ = _render(cfg, loop_trajectory(n, radius=radius,
                                                 ease=ease),
                            baseline, width=width, u8=False)
    return frames, gt


def direct_config() -> PipelineConfig:
    """The direct tracker at bench.py's camera and extraction operating
    point, on the reference's direct pyramid (PyramidConfig(): 5 levels
    x0.8) with DirectConfig() defaults and a keyframe every 4th frame."""
    return dataclasses.replace(main_path_config(), pyramid=PyramidConfig(),
                               keyframe_every=4, local_ba_every=0)


def mono_config() -> PipelineConfig:
    """The monocular tracker at the main path's camera, pyramid, features
    and map, a keyframe every 4th frame, windowed BA on every 2nd."""
    return dataclasses.replace(main_path_config(), keyframe_every=4,
                               local_ba_every=2)


def direct_frames(cfg: PipelineConfig, n: int = 24,
                  baseline: float = BASELINE):
    """The direct gate's sequence at cfg's camera: forward motion with a
    slow yaw down the default corridor, a stereo pair on frame 0 and left
    images after it. Returns ([(left, right or None)], gt)."""
    gt = forward_yaw_trajectory(n, step=0.05, yaw_rate=0.006)
    return render_sequence(cfg.camera, {}, gt, baseline, True, "first"), gt


def indirect_frames(cfg: PipelineConfig, n: int = 12):
    """The indirect corridor sequence at cfg's camera: forward motion with
    a yaw, a stereo pair on every frame at the baseline bf / fx."""
    gt = forward_yaw_trajectory(n, step=0.08, yaw_rate=0.012)
    return render_sequence(cfg.camera, {}, gt,
                           cfg.camera.bf / cfg.camera.fx, True, "all"), gt


def mono_frames(cfg: PipelineConfig, n: int = 28):
    """The monocular sequence at cfg's camera: sideways motion with a
    gentle yaw (the bootstrap's parallax), left images only."""
    gt = lateral_trajectory(n, step=0.06, yaw_amp=0.01)
    return [f[0] for f in render_sequence(cfg.camera, {}, gt, 0.0, True,
                                          "none")], gt


def closing_error(poses: np.ndarray, gt: np.ndarray) -> float:
    """Distance between the last estimated and true camera centres, the VO
    world anchored at gt[0] (bench.py's loop-bench metric)."""
    c_est = np.linalg.inv(poses[-1] @ gt[0])[:3, 3]
    c_gt = np.linalg.inv(gt[-1])[:3, 3]
    return float(np.linalg.norm(c_est - c_gt))
