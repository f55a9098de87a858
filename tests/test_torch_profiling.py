"""How the port is measured: the per-range profiler table
(profile_main_path.py `range_table`) counts a hand kernel's custom op in
the stage range around it; the fenced host-clock stage timer
(utils/profiling.py `StageTimer(fenced_host=True)`) sums per-stage host
time; chip_smoke.py takes no timed figure after a profiler session; and
the kernels' build flags."""

import os
import sys

import numpy as np
import pytest
import torch

from trackingbench_slam_tpu_torch import profile_main_path as pmp
from trackingbench_slam_tpu_torch.models import local_mapping
from trackingbench_slam_tpu_torch.models import vo as vo_mod
from trackingbench_slam_tpu_torch.ops.cuda import build, lk_kernel
from trackingbench_slam_tpu_torch.utils.profiling import StageTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def lk_call():
    """One anchored-style LK call (one level, half 4) on the CPU: the
    custom op trackingbench::lk_align over its plain version."""
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.uniform(0, 255, (64, 400)).astype(np.float32))
    pts = torch.from_numpy(np.stack([rng.uniform(20, 380, 40),
                                     rng.uniform(20, 44, 40)], -1)
                           .astype(np.float32))
    valid = torch.ones(40, dtype=torch.bool)
    return lambda: lk_kernel.lk_align((img,), (img,), pts, pts + 0.5, valid,
                                      half=4, iters=10, conv_eps=0.03)


def test_range_table_counts_the_custom_op_inside_its_range():
    call = lk_call()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("keyframe_step"):
            with torch.profiler.record_function("keyframe.anchored_align"):
                call()
            with torch.profiler.record_function("keyframe.stereo_lk"):
                call()
                call()
        call()                       # outside every range: not counted
    table = pmp.range_table(prof.events(), vo_mod.STAGE_PREFIXES)
    # the op is counted in its innermost range only, and is no range itself
    assert set(table) == {"keyframe_step", "keyframe.anchored_align",
                          "keyframe.stereo_lk"}
    anchored = table["keyframe.anchored_align"]
    assert anchored["calls"] == 1
    assert anchored["ops"] == {"trackingbench::lk_align":
                               dict(calls=1, device_ms=0.0)}
    assert table["keyframe.stereo_lk"]["ops"][
        "trackingbench::lk_align"]["calls"] == 2
    assert table["keyframe_step"]["ops"] == {}
    assert (table["keyframe_step"]["host_ms_per_call"]
            >= anchored["host_ms_per_call"] > 0)
    # on the CPU there is no device time to count
    assert all(r["device_ms_per_call"] == 0.0 for r in table.values())


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_fenced_stage_timer_sums_host_time_on_a_fake_clock():
    clock, fences = FakeClock(), []
    timer = StageTimer(device="cpu", fenced_host=True, clock=clock)
    timer._fence = fences.append
    for step in (0.010, 0.030):
        with timer.time("track_step"):
            clock.now += 0.001
            with timer.time("track.pose_optimization"):
                clock.now += step
    with timer.time("keyframe_step"):
        clock.now += 0.25
    assert timer.counts == {"track_step": 2, "track.pose_optimization": 2,
                            "keyframe_step": 1}
    ms = timer.ms_per_call()
    assert ms["track.pose_optimization"] == pytest.approx(20.0)
    assert ms["track_step"] == pytest.approx(21.0)
    assert ms["keyframe_step"] == pytest.approx(250.0)
    # every stage is fenced on entry and on exit
    assert len(fences) == 2 * 5


def test_timed_stages_swaps_the_stage_ranges_and_restores_them():
    clock = FakeClock()
    timer = StageTimer(device="cpu", fenced_host=True, clock=clock)
    real = (vo_mod._stage, local_mapping._stage)
    with pmp.timed_stages(timer):
        with vo_mod._stage("track.make_frame"):
            clock.now += 0.002
        with local_mapping._stage("keyframe.local_ba_step"):
            clock.now += 0.05
    assert (vo_mod._stage, local_mapping._stage) == real
    assert timer.ms_per_call() == pytest.approx(
        {"track.make_frame": 2.0, "keyframe.local_ba_step": 50.0})


def test_chip_smoke_profiles_only_after_its_last_timed_phase():
    kinds = [kind for _, kind in chip_smoke.PHASES]
    assert set(kinds) <= {"setup", "timed", "profiled", "child"}
    last_timed = max(i for i, k in enumerate(kinds) if k == "timed")
    first_profiled = min(i for i, k in enumerate(kinds) if k == "profiled")
    assert last_timed < first_profiled
    # the BA-on main path again is the last timed phase, the guard
    assert chip_smoke.PHASES[last_timed][0] == "main path, BA on, again"
    names = [n for n, _ in chip_smoke.PHASES]
    assert len(set(names)) == len(names)


def test_phase_order_holds_main_to_the_declared_order():
    order = chip_smoke.PhaseOrder((("a", "timed"), ("b", "timed"),
                                   ("c", "profiled")))
    order.enter("a")
    with pytest.raises(AssertionError, match="profiler session"):
        order.profiled(lambda: None)
    with pytest.raises(AssertionError, match="out of the declared order"):
        order.enter("a")
    order.enter("c")                  # a phase may be left out
    with pytest.raises(AssertionError, match="out of the declared order"):
        order.enter("b")
    assert order.kind == "profiled"


def test_kernel_build_links_the_cuda_runtime_statically():
    """nvcc's -cudart static, named: torch.profiler attributes the
    launches of the statically linked runtime to their custom op and range
    on the card (PERF.md), and a shared runtime bought nothing."""
    for name in build.SOURCES:
        flags = build._flags(name)
        i = flags.index("-cudart")
        assert flags[i + 1] == "static"
        assert "-gencode" in flags and "arch=compute_90a,code=sm_90a" in flags
