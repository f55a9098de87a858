"""How the port is measured: the stage spans and their recorder
(utils/profiling.py `stage`, `record`): on the profiler's clock, one per
stage a batched step, host syncs charged to the innermost span, nothing
kept without a recorder, consumers called at every span; the per-range
profiler table (profile_main_path.py `range_table`) counts a hand kernel's
custom op in the stage range around it; the fenced host-clock stage timer
(utils/profiling.py `StageTimer`) sums per-stage host time; chip_smoke.py
takes no timed figure after a profiler session; and the kernels' build
flags."""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

from trackingbench_slam_tpu_torch import profile_main_path as pmp
from trackingbench_slam_tpu_torch.models import vo as vo_mod
from trackingbench_slam_tpu_torch.ops.cuda import build, lk_kernel
from trackingbench_slam_tpu_torch.parallel import batch_check
from trackingbench_slam_tpu_torch.utils import profiling
from trackingbench_slam_tpu_torch.utils.device import HostCopy
from trackingbench_slam_tpu_torch.utils.profiling import (StageTimer, record,
                                                          stage)

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
    timer = StageTimer(device="cpu", clock=clock)
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


def test_a_span_and_its_profiler_range_share_a_clock():
    """A span's start and end lie inside its record_function range's, on
    the Unix-epoch clock of the profiler's events, a few us apart."""
    names = [f"span{i}" for i in range(20)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with record() as rec:
            with stage("warm"):      # a session's first range starts late
                pass
            for name in names:
                with stage(name):
                    torch.ones(8).add_(1)
    ranges = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    gaps = []
    for span in rec.spans[1:]:
        start, end = ranges[span.name]
        assert start <= span.start_ns <= span.end_ns <= end
        gaps.append(span.start_ns - start)
    assert [s.name for s in rec.spans[1:]] == names
    assert float(np.median(gaps)) < 100e3


def tiny_battery():
    """The benchmark's tiny cell (slam_bench/tests/tiny.py) as a Battery:
    2 sequences x 2 executions at 256x160, a keyframe every 3rd frame."""
    from slam_bench import battery
    from slam_bench.tests import tiny
    found = tiny.tiny_cell()
    cfg = battery.pipeline_config(found["config"])
    traffic = found["traffic"]
    lefts, rights, _ = battery.render_battery(
        traffic, found["config"]["camera"], cfg.camera.bf / cfg.camera.fx,
        cfg.keyframe_every, 5, "cpu")
    _, _, gens = battery.draw_sequences(traffic, 5)
    run = battery.Run(device=torch.device("cpu"), S=2, B=4)
    return lambda: battery.Battery(run, cfg, lefts, rights, gens,
                                   torch.device("cpu"))


TRACK_STAGES = ["track.make_frame", "track.search_by_opflow",
                "track.pose_optimization"]
KEYFRAME_STAGES = ["keyframe.anchored_align", "keyframe.extract_orb",
                   "keyframe.stereo_lk", "keyframe.search_by_projection_map",
                   "keyframe.write_anchor_patches"]


@pytest.fixture
def one_thread():
    """One intra-op thread: the test workers share the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_each_stage_span_is_entered_once_a_batched_step(one_thread):
    """Under torch.func.vmap (parallel/dp_eval.py) every stage of the
    tiny cell's batched steps is one span a step, a child of its step's
    span, with its step's id; the pose solve's 4 rounds are its children;
    the bootstraps' init.state and the uploads sit outside every step."""
    make = tiny_battery()
    with record() as rec:
        bat = make()
        kinds = [bat.step() for _ in range(3)]
    assert kinds == ["track", "keyframe", "track"]
    spans = rec.spans
    assert not rec.open and all(s.end_ns >= s.start_ns for s in spans)
    assert [s.step for s in spans if s.name == "init.state"] == [-1, -1]
    steps = [i for i, s in enumerate(spans) if s.parent < 0
             and s.name in profiling.STEP_SPANS]
    assert [spans[i].name for i in steps] == [
        "dp.track_step", "dp.track_and_keyframe_step", "dp.track_step"]
    assert [spans[i].step for i in steps] == [0, 1, 2]
    for k, (i, kind) in enumerate(zip(steps, kinds)):
        children = [j for j, s in enumerate(spans) if s.parent == i]
        want = TRACK_STAGES + (KEYFRAME_STAGES if kind == "keyframe" else [])
        assert [spans[j].name for j in children] == want
        assert all(spans[j].step == k for j in children)
        solve = children[2]
        rounds = [s for s in spans if s.parent == solve]
        assert [s.name for s in rounds] == [
            "track.pose_optimization.round"] * 4
        assert all(s.step == k for s in rounds)
        assert spans[solve].start_ns <= rounds[0].start_ns
        assert rounds[-1].end_ns <= spans[solve].end_ns
    # each frame's uploads (one a sequence, and the rights on a keyframe
    # frame) come before its step, so they carry the step before
    uploads = [s.step for s in spans
               if s.name == "feed.upload" and s.step >= 0]
    assert uploads == [0, 0, 0, 0, 1, 1]
    assert all(s.parent < 0 for s in spans if s.name.startswith("feed."))


class FakeEvent:
    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


def sync_in_nested_span(rec):
    with stage("outer"):
        warnings.warn(profiling.SYNC_WARNING)
        with stage("inner"):
            warnings.warn(profiling.SYNC_WARNING)
            warnings.warn(profiling.SYNC_WARNING)
    warnings.warn(profiling.SYNC_WARNING)        # outside every span
    return {"outer": {"host_syncs": 1}, "inner": {"host_syncs": 2}}, \
        {"host_syncs": 1}


def readback_wait(rec):
    copy = HostCopy(torch.arange(3))
    copy._event = FakeEvent()                     # the card's copy event
    with stage("track_step"):
        pass
    assert copy.numpy().tolist() == [0, 1, 2]
    assert copy._event.waits == 1
    return {"track_step": {}, "feed.readback_wait": {"host_syncs": 1}}, {}


@pytest.mark.parametrize("case", [sync_in_nested_span, readback_wait],
                         ids=["sync_warning", "readback_wait"])
def test_a_host_sync_is_counted_against_its_innermost_span(case):
    """The sync debug mode's warning (raised here by hand) and HostCopy's
    event wait each count one host sync on the innermost open span; the
    warning is not shown, and other warnings still are."""
    with pytest.warns(UserWarning, match="another warning"):
        with record() as rec:
            want, outside = case(rec)
            warnings.warn("another warning")
    assert {s.name: s.counts for s in rec.spans} == want
    assert rec.outside == outside


def test_nothing_is_kept_without_a_recorder():
    assert profiling._recorder is None
    rng = stage("track.make_frame")
    assert isinstance(rng, torch.profiler.record_function)
    with rng:
        profiling.count("host_syncs")
    with pytest.raises(KeyError):
        with record() as rec:
            with pytest.raises(RuntimeError, match="installed already"):
                with record():
                    pass
            with stage("a"):
                raise KeyError("the block fails")
    assert profiling._recorder is None
    assert [s.name for s in rec.spans] == ["a"] and not rec.open
    assert isinstance(stage("a"), torch.profiler.record_function)


def stage_timer_sees(names, clock):
    timer = StageTimer(device="cpu", clock=clock)
    with record(timer):
        with stage(names[0]):
            clock.now += 0.002
            with stage(names[1]):
                clock.now += 0.05
        with stage(names[2]):
            clock.now += 0.001
    assert timer.ms_per_call() == pytest.approx(
        {names[0]: 52.0, names[1]: 50.0, names[2]: 1.0})
    return timer.counts


def batch_check_sees(names, clock):
    rec, seen = batch_check._Recorder(), {}
    with rec.installed():
        with stage(names[0]):
            with stage(names[1]):
                seen[names[1]] = list(rec.stages)
        with stage(names[2]):
            seen[names[2]] = list(rec.stages)
    assert rec.stages == []
    assert seen == {names[1]: names[:2], names[2]: names[2:]}
    return {n: 1 for n in names}


@pytest.mark.parametrize("consumer", [stage_timer_sees, batch_check_sees],
                         ids=["stage_timer", "batch_check"])
def test_the_recorder_hands_every_stage_to_its_consumers(consumer):
    """StageTimer and batch_check's call recorder are consumers of the
    recorder: they see the stages of every module, vo.py's, the pose
    solve's rounds and the feed's alike, with no module attribute
    swapped."""
    names = ["track_step", "track.pose_optimization.round", "feed.upload"]
    assert consumer(names, FakeClock()) == {n: 1 for n in names}
    assert profiling._recorder is None


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
