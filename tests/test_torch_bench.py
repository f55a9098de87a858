"""The port's bench entry point (trackingbench_slam_tpu_torch/bench.py) on
the CPU: its line carries bench.py's keys (read from bench.py itself), the
five stage_ms keys and the port's own; it raises without CUDA unless asked
for the CPU, and without benchmarks/cpu_reference.py unless told to skip
it."""

import ast
import dataclasses
import json
import os

import pytest
import torch

from trackingbench_slam_tpu_torch import bench as tb
from trackingbench_slam_tpu_torch.utils.config import (CameraConfig,
                                                       ExtractorConfig,
                                                       MapConfig,
                                                       PipelineConfig,
                                                       PyramidConfig,
                                                       SolverConfig)
from trackingbench_slam_tpu_torch.utils.corridor import corridor_frames

ROOT_BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_config():
    """bench.py's operating point at 320x240 with 256 features, windowed BA
    on every 2nd keyframe over 512 landmarks."""
    fx = 707.09 * 320 / 1226
    cam = CameraConfig(width=320, height=240, fx=fx, fy=fx, cx=160.0,
                       cy=120.0, bf=fx * 0.54)
    return PipelineConfig(
        camera=cam, pyramid=PyramidConfig(num_levels=3, scale_factor=0.8),
        extractor=ExtractorConfig(num_features=256, min_threshold=12,
                                  cell_size=24),
        map=MapConfig(max_keyframes=8, max_points=2048),
        keyframe_every=5, local_ba_every=2,
        solver=dataclasses.replace(SolverConfig(), max_landmarks=512))


def root_bench_keys():
    """bench.py's keys: the emitted line's (main's emit), `extra`'s before
    the extras (main's `extra = {...}`), and stage_timings' `out[...]`."""
    tree = ast.parse(open(ROOT_BENCH).read())
    fns = {n.name: n for n in ast.walk(tree)
           if isinstance(n, ast.FunctionDef)}

    def dict_keys(node):
        return [k.value for k in node.keys]
    line = [dict_keys(n) for n in ast.walk(fns["emit"])
            if isinstance(n, ast.Dict)][0]
    extra = [dict_keys(n.value) for n in ast.walk(fns["main"])
             if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
             and n.targets[0].id == "extra"][0]
    stages = [n.targets[0].slice.value for n in ast.walk(fns["stage_timings"])
              if isinstance(n, ast.Assign)
              and isinstance(n.targets[0], ast.Subscript)
              and isinstance(n.targets[0].slice, ast.Constant)]
    timeit = [n.args[0].value for n in ast.walk(fns["stage_timings"])
              if isinstance(n, ast.Call) and getattr(n.func, "id", "")
              == "timeit"]
    return line, extra, timeit + stages


@pytest.fixture(scope="module")
def frames():
    cfg = small_config()
    f, gt, _ = corridor_frames(cfg, 14)
    return cfg, f, gt


def test_bench_line_on_the_cpu(frames, monkeypatch):
    cfg, f, gt = frames
    line_keys, extra_keys, stage_keys = root_bench_keys()
    assert tuple(line_keys) == tb.LINE_KEYS
    assert tuple(extra_keys) == tb.EXTRA_KEYS[:len(extra_keys)]
    assert sorted(stage_keys) == sorted(tb.STAGE_KEYS)
    # without a card the entry raises unless asked for the CPU, before
    # rendering anything
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.main(["--quick", "--skip-cpu-ref"])
    # the CPU reference missing: raises unless told to skip it
    with pytest.raises(FileNotFoundError, match="--skip-cpu-ref"):
        tb.bench(cfg, f, gt, "cpu", cpu_reference="/nonexistent/cpu_ref.py")
    emitted = []
    line = tb.bench(cfg, f, gt, "cpu", quick=True,
                    emit=lambda ln: emitted.append(json.dumps(ln)))
    first, last = (json.loads(x) for x in emitted)
    assert list(last) == line_keys and list(first) == line_keys
    assert last["metric"] == "stereo_vo_frames_per_s_per_chip"
    assert last["unit"] == "frames/s" and last["value"] > 0
    extra = last["extra"]
    assert set(first["extra"]) == set(tb.EXTRA_KEYS)
    assert set(extra) == set(tb.EXTRA_KEYS) | {"stage_ms"}   # quick
    assert set(extra["stage_ms"]) == set(stage_keys)
    assert all(v > 0 for v in extra["stage_ms"].values())
    assert extra["platform"] == "cpu" and extra["card"] is None
    assert extra["cpu_reference_frames"] == len(f)
    assert extra["real_depth_oracle_median_rel_err"] is None
    assert extra["ate_rmse_m"] < 0.05
    assert last["vs_baseline"] == pytest.approx(
        last["value"] / extra["cpu_reference_fps"], abs=2e-3)
    assert line["value"] == last["value"]


def test_bench_without_the_cpu_reference(frames):
    cfg, f, gt = frames
    line = tb.bench(cfg, f[:3], gt[:3], "cpu", quick=True,
                    skip_cpu_ref=True, cpu_reference="/nonexistent")
    assert line["vs_baseline"] is None
    assert line["extra"]["cpu_reference_fps"] is None
    assert line["extra"]["cpu_reference_frames"] == 0
