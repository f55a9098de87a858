"""The harness on the CPU: cells found by name, the renderer, isolation from
JAX and the port, the battery's executions, the result line."""

from __future__ import annotations

import ast
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_bench import battery, registry, scene
from slam_bench import run as run_mod
from slam_bench.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_cell_configuration_and_metric_added_as_files_are_found(tmp_path):
    """A throwaway configuration, cell and per-layer metric, added as files
    and entries alone, are found by name and read in a run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in ("configs", "workloads", "metrics"):
        shutil.copytree(BENCH / d, tmp_path / "slam_bench" / d)
    cell = tiny.tiny_cell()
    (tmp_path / "slam_bench/configs/throwaway.json").write_text(
        json.dumps(cell["config"]))
    (tmp_path / "slam_bench/workloads/throwaway.small.json").write_text(
        json.dumps(cell["traffic"]))
    (tmp_path / "slam_bench/metrics/throwaway_executions.py").write_text(
        "def read(run):\n    return run.B\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="throwaway", source="a test",
                                 file="slam_bench/configs/throwaway.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="throwaway.small", config="throwaway",
                                   traffic="small", chips=1, why="a test"))
    bench["per_layer"].append(dict(
        name="throwaway_executions", unit="sequences", better="higher",
        source="program_counter", layer="batched step",
        moves="seq_frames_per_s", workloads=["throwaway.small"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    found = registry.find_cell(registry.load_benchmark(tmp_path),
                               "throwaway.small", tmp_path)
    assert found["config"]["camera"]["width"] == 256
    assert found["traffic"]["sequences"] == 2
    assert [m["name"] for m in found["per_layer"]] == ["throwaway_executions"]
    run = tiny.run_tiny(found)
    line = run_mod.result_line(run, found, False)
    assert set(line["metrics"]) == {"seq_frames_per_s", "ate_rmse_mm",
                                    "setup_s"}
    assert registry.metric_reader("throwaway_executions",
                                  tmp_path)(run) == 4


def test_torch_renderer_matches_the_port_numpy_renderer():
    """The torch ray cast and sampling give the port's numpy renderer's
    uint8 frames to within one grey level, on the numpy scene's own
    canvases and box blur."""
    from trackingbench_slam_tpu_torch.utils.config import CameraConfig
    from trackingbench_slam_tpu_torch.utils.corridor import _u8
    from trackingbench_slam_tpu_torch.utils.synthetic import CorridorScene
    cam = CameraConfig(width=160, height=96, fx=120.0, fy=120.0, cx=80.0,
                       cy=48.0)
    ref = CorridorScene(cam, width=10.0, height=5.0, seed=11)
    ours = scene.Corridor(dict(width=160, height=96, fx=120.0, fy=120.0,
                               cx=80.0, cy=48.0), 10.0, 5.0, 40.0, "cpu",
                          canvases=[p.canvas for p in ref.planes])
    poses = scene.swing_trajectory(40, 1.3, 0.12, 0.01, 150, 0.004, 0.35,
                                   -6.0)[::8]
    got = scene.to_u8(ours.render(poses)).numpy().astype(int)
    want = np.stack([_u8(ref.render(T)) for T in poses]).astype(int)
    assert np.abs(got - want).max() <= 1


def test_box_blur_matches_numpy_convolve():
    img = np.random.RandomState(0).uniform(0, 255, (37, 53))
    k = np.ones(3) / 3.0
    want = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 0,
                               img)
    want = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 1,
                               want)
    got = scene.box_blur(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_swing_trajectory_stays_in_the_corridor():
    """Yaw rate at most yaw_rate_max, 0.12 m a frame, the camera inside the
    10 m corridor and short of its end wall over 300 frames."""
    for phase in np.linspace(0, 2 * math.pi, 7):
        T = scene.swing_trajectory(300, phase, 0.12, 0.01, 150, 0.004, 0.35,
                                   -6.0)
        c = np.linalg.inv(T)[:, :3, 3]
        assert np.abs(np.diff(c, axis=0)).max() <= 0.12 + 1e-12
        np.testing.assert_allclose(np.linalg.norm(np.diff(c, axis=0),
                                                  axis=1), 0.12)
        assert np.abs(c[:, 0]).max() < 2.0 and c[:, 2].max() < 35.0
        fwd = np.linalg.inv(T)[:, :3, 2]
        yaw = np.arctan2(fwd[:, 0], fwd[:, 2])
        assert np.abs(np.diff(yaw)).max() <= 0.01 + 1e-9


FORBIDDEN = {"jax", "jaxlib", "flax", "trackingbench_slam_tpu"}


def test_a_tiny_pass_loads_no_jax_and_no_jax_package():
    """A tiny CPU pass of the harness in a fresh process: no module whose
    top-level name is JAX's or the JAX package's, comparing the part before
    the first dot whole (the port's name begins with the JAX package's)."""
    out = subprocess.run([sys.executable, "-m", "slam_bench.tests.tiny"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert not FORBIDDEN & set(got["modules"])
    assert "trackingbench_slam_tpu_torch" in got["modules"]
    assert got["result"]["correct"] is True


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert not _imports(path) & (FORBIDDEN
                                     | {"trackingbench_slam_tpu_torch"}), path
    code = ("import sys, slam_bench.reference.kernels, "
            "slam_bench.reference.trajectory; print(sorted({m.split('.')[0] "
            "for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    loaded = set(ast.literal_eval(out.stdout.strip()))
    assert not loaded & (FORBIDDEN | {"trackingbench_slam_tpu_torch"})


def test_no_harness_source_names_jax_or_the_benchmarks_folder():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
        if "tests" not in path.parts:
            assert "benchmarks/" not in path.read_text(), path


def test_executions_share_frames_and_draw_from_their_own_generators():
    found = tiny.tiny_cell()
    cfg = battery.pipeline_config(found["config"])
    traffic = found["traffic"]
    lefts, rights, gt = battery.render_battery(
        traffic, found["config"]["camera"], cfg.camera.bf / cfg.camera.fx,
        cfg.keyframe_every, 77, "cpu")
    assert not np.array_equal(lefts[0][0], lefts[1][0])
    _, _, gens = battery.draw_sequences(traffic, 77)
    run = battery.Run(device=torch.device("cpu"), B=4, S=2)
    bat = battery.Battery(run, cfg, lefts, rights, gens, torch.device("cpu"))
    assert run.seq_of.tolist() == [0, 0, 1, 1]
    imgs = bat._frames(lambda s: lefts[s][1])
    assert torch.equal(imgs[0], imgs[1]) and torch.equal(imgs[2], imgs[3])
    assert not torch.equal(imgs[1], imgs[2])
    assert len({g.initial_seed() for g in bat.gens}) == 4
    from trackingbench_slam_tpu_torch.parallel import dp_eval
    u = dp_eval.draw_uniform(bat.gens, cfg)
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[2], u[3])
    # the same seed draws the same frames and generators again
    again = battery.render_battery(traffic, found["config"]["camera"],
                                   cfg.camera.bf / cfg.camera.fx,
                                   cfg.keyframe_every, 77, "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(lefts, again[0]))
    assert np.array_equal(gens, battery.draw_sequences(traffic, 77)[2])
    # another seed: the dataset's same sequences, in its own order, with
    # other draws
    tex, phase, gens2 = battery.draw_sequences(dict(traffic, sequences=6),
                                               78)
    tex1, phase1, _ = battery.draw_sequences(dict(traffic, sequences=6), 77)
    assert sorted(tex) == sorted(tex1) and list(tex) != list(tex1)
    assert sorted(phase) == sorted(phase1)
    assert not np.array_equal(gens2[:4], gens)


def test_a_sound_tiny_run_is_correct_and_its_window_holds_no_bootstrap():
    found = tiny.tiny_cell()
    run = tiny.run_tiny(found, trace=True)
    line = run_mod.result_line(run, found, True)
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert all(c["ok"] for c in line["checks"].values())
    assert run.window_first == found["traffic"]["warmup_frames"] + 1
    assert run.frames_done == (max(run.window_first + len(run.window_steps),
                                   found["traffic"]["ate_frames"])
                               + run.kf_every)
    assert line["window"] == dict(
        first_frame=run.window_first, steps=len(run.window_steps),
        keyframe_steps=run.window_steps.count("keyframe"),
        seconds=run.window_s, ended_early=False)
    assert line["host"]["cpu_s"] > 0
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(line, allow_nan=False)


@pytest.mark.card
def test_each_cell_runs_correct_on_the_card(card):
    for cell in registry.load_benchmark()["workloads"]:
        out = subprocess.run(
            [sys.executable, "-m", "slam_bench.run", "--workload",
             cell["name"], "--seed", "2718281828", "--seconds", "3",
             "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
            timeout=900, check=True)
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
