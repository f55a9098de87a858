"""Where the main path's time goes, on one NVIDIA GPU.

    python3 -m trackingbench_slam_tpu_torch.profile_main_path

    python3 -m trackingbench_slam_tpu_torch.profile_main_path --ba-off

    python3 -m trackingbench_slam_tpu_torch.profile_main_path --history

Runs StereoVO at the main-path configuration (utils/corridor.py: bench.py's
operating point, windowed BA on every 2nd keyframe; `--ba-off` for the same
with windowed BA off) over 40 corridor frames. A torch.profiler session
leaves the process slower for a while after it ends (PERF.md), so
every figure timed on the host clock is taken before the first profiler
session of the process:
  1. an empty record_function range's host cost, profiler off;
  2. a fresh StereoVO over the 40 frames, frames 11-39 each fenced by
     torch.cuda.synchronize(): wall ms per frame (tracking frames,
     keyframes and BA keyframes apart) and frames/s;
  3. a fresh StereoVO over frames 0-20 with the stage ranges (the
     record_function ranges of models/vo.py and models/local_mapping.py)
     timed on the host clock, each fenced at both ends
     (utils/profiling.py `StageTimer(fenced_host=True)`), over frames
     11-20: host ms a call of each stage, unprofiled;
  4. a fresh StereoVO over frames 0-20, frames 11-20 under torch.profiler
     (frame 19 is a BA keyframe): per stage the host ms a call
     (cpu_time_total, which holds the profiler's own per-op cost) and the
     device ms a call of the kernels launched inside it, and the
     hand-kernel custom ops inside each stage with their calls and device
     ms (`range_table`); the device time of the window over the wall time
     of the same frames in step 2 (the busy share); kernel launches per
     frame; the top kernels by device time;
  5. with BA on, one local_ba_step on step 4's final state under the
     profiler: its kernel launches and device ms.
Prints one JSON line; the full result and the profiler table go to
chiprun_out/.

`--history` is the profiler-session A/B instead: a fresh StereoVO over the
40 frames, timed as chip_smoke.py's run_counted times them (frames/s over
frames 11-39), `--runs` times; then one torch.profiler session over a few
small ops (`--between profiler`), or over a fresh StereoVO's first 11
frames (`window`), or nothing (`none`, the control); then `--runs` fresh
runs again. Beside each run: the host microseconds of one small op's
launch and of an empty record_function range, the host ms of a fixed
pure-Python loop, torch.cuda.memory_stats() counts,
gc collections and the time gc.callbacks saw, and the SM clock from
nvidia-smi before and after. Writes
chiprun_out/profile_history_<between>.json.
Needs CUDA; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from trackingbench_slam_tpu_torch.models import local_mapping
from trackingbench_slam_tpu_torch.models import vo as vo_mod
from trackingbench_slam_tpu_torch.utils.corridor import (
    corridor_frames, main_path_config, main_path_config_ba_off)
from trackingbench_slam_tpu_torch.utils.profiling import StageTimer

N_FRAMES = 40
WARM = 11
PROFILED = 10
HAND_OPS = ("trackingbench::lk_align", "trackingbench::fast_score_nms",
            "trackingbench::orb_describe", "trackingbench::anchor_cells")


def range_cost_us(n: int = 20000) -> float:
    """Host microseconds of one empty record_function range, profiler off."""
    t0 = time.perf_counter()
    for _ in range(n):
        with torch.profiler.record_function("empty"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def launch_us(n: int = 20000) -> float:
    """Host microseconds of one small op's launch on the card."""
    y = torch.zeros(16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        y.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def python_ms(n: int = 1_000_000) -> float:
    """Host ms of a fixed pure-Python loop: how fast the host runs Python
    just then, apart from PyTorch."""
    t0 = time.perf_counter()
    total = 0
    for i in range(n):
        total += i & 7
    return (time.perf_counter() - t0) * 1e3


def profiled(fn):
    """(profiler, wall ms) of fn() under the profiler (CPU and CUDA
    activity)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def device_events(avgs):
    """Device-side events only: the CPU ops that launched them carry the
    same time again as their own device time."""
    return [e for e in avgs if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]


def kernel_launches(device):
    return sum(e.count for e in device
               if not e.key.startswith(("Memcpy", "Memset")))


def range_table(events, prefixes, ops=HAND_OPS):
    """Per record_function range whose name starts with one of `prefixes`,
    from the profiler's events (`prof.events()`): its calls, host ms and
    device ms a call (the kernels launched anywhere inside it), and under
    "ops" each of `ops` called inside it (its innermost enclosing range of
    those names): calls and device ms in all."""
    def is_range(e):
        return e.is_user_annotation and e.name.startswith(prefixes)

    table = {}
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if is_range(e):
            row = table.setdefault(e.name, dict(calls=0, host_ms=0.0,
                                                device_ms=0.0, ops={}))
            row["calls"] += 1
            row["host_ms"] += e.cpu_time_total / 1e3
            row["device_ms"] += e.device_time_total / 1e3
        elif e.name in ops:
            parent = e.cpu_parent
            while parent is not None and not is_range(parent):
                parent = parent.cpu_parent
            if parent is None:
                continue
            row = table.setdefault(parent.name, dict(calls=0, host_ms=0.0,
                                                     device_ms=0.0, ops={}))
            op = row["ops"].setdefault(e.name, dict(calls=0, device_ms=0.0))
            op["calls"] += 1
            op["device_ms"] += e.device_time_total / 1e3
    for row in table.values():
        n = max(row["calls"], 1)
        row["host_ms_per_call"] = row.pop("host_ms") / n
        row["device_ms_per_call"] = row.pop("device_ms") / n
    return dict(sorted(table.items()))


@contextlib.contextmanager
def timed_stages(timer, modules=(vo_mod, local_mapping)):
    """While inside, the stage ranges of `modules` (their `_stage`) time
    each stage with `timer` instead of opening a record_function range."""
    real = [m._stage for m in modules]
    for m in modules:
        m._stage = timer.time
    try:
        yield timer
    finally:
        for m, r in zip(modules, real):
            m._stage = r


def fenced_frames(cfg, frames):
    """A fresh StereoVO over `frames`; every frame from WARM on fenced:
    [(wall ms, kind)] indexed from frame WARM."""
    vo = vo_mod.StereoVO(cfg)
    for left, right in frames[:WARM]:
        vo.track(left, right)
    per_frame = []
    for i in range(WARM, len(frames)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ba_before = vo.ba_calls
        vo.track(*frames[i])
        torch.cuda.synchronize()
        kind = ("ba_keyframe" if vo.ba_calls > ba_before else "keyframe"
                if (i + 1) % cfg.keyframe_every == 0 else "track")
        per_frame.append(((time.perf_counter() - t0) * 1e3, kind))
    return per_frame


def stage_host_ms(cfg, frames):
    """Host ms a call of each stage over frames WARM..WARM+PROFILED-1 of a
    fresh StereoVO, each stage fenced, no profiler."""
    vo = vo_mod.StereoVO(cfg)
    timer = StageTimer(fenced_host=True)
    with timed_stages(timer):
        for left, right in frames[:WARM]:
            vo.track(left, right)
        timer.reset()
        for left, right in frames[WARM:WARM + PROFILED]:
            vo.track(left, right)
    return {k: dict(calls=timer.counts[k], host_ms_per_call=v)
            for k, v in timer.ms_per_call().items()}


def profile_window(cfg, frames, unprofiled_wall_ms):
    """A fresh StereoVO; frames WARM..WARM+PROFILED-1 under the profiler.
    Returns (vo, figures); the busy share is the window's device time over
    `unprofiled_wall_ms`, the same frames' wall time without the
    profiler."""
    vo = vo_mod.StereoVO(cfg)
    for left, right in frames[:WARM]:
        vo.track(left, right)
    window = frames[WARM:WARM + PROFILED]

    def run():
        for left, right in window:
            vo.track(left, right)
    prof, wall_ms = profiled(run)
    avgs = prof.key_averages()
    device = device_events(avgs)
    device_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:15]
    with open(os.path.join("chiprun_out", "profile_key_averages.txt"),
              "w") as fh:
        fh.write(avgs.table(sort_by="self_cpu_time_total", row_limit=40))
    return vo, {
        "frames": len(window), "wall_ms_profiled": wall_ms,
        "wall_ms_unprofiled": unprofiled_wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / unprofiled_wall_ms,
        "kernel_launches_per_frame": kernel_launches(device) / len(window),
        "stages": range_table(prof.events(), vo_mod.STAGE_PREFIXES),
        "top_device_ms": [[e.key[:160], e.self_device_time_total / 1e3]
                          for e in top],
    }


def profile_ba_call(vo):
    """One local_ba_step on the run's state: kernel launches and device
    ms."""
    prof, wall_ms = profiled(lambda: local_mapping.local_ba_step(
        vo.state, vo.cam, vo.cfg))
    device = device_events(prof.key_averages())
    return {"wall_ms_profiled": wall_ms,
            "kernel_launches": kernel_launches(device),
            "device_ms": sum(e.self_device_time_total for e in device) / 1e3}


def stages_main(cfg, frames):
    cost_us = range_cost_us()
    per_frame = fenced_frames(cfg, frames)
    host = stage_host_ms(cfg, frames)
    window_ms = sum(t for t, _ in per_frame[:PROFILED])
    # no host-clock figure is taken from here on: the profiler has run
    vo, window = profile_window(cfg, frames, window_ms)
    for name, row in window["stages"].items():
        row["host_ms_per_call_unprofiled"] = host.get(name, {}).get(
            "host_ms_per_call")
    result = {
        "local_ba_every": cfg.local_ba_every,
        "fenced_frames": len(per_frame),
        "fps_fenced": len(per_frame) / (sum(t for t, _ in per_frame) / 1e3),
        "record_function_us_profiler_off": cost_us,
        "stage_host_ms_unprofiled": host,
        "profile_window": window,
    }
    for kind in ("track", "keyframe", "ba_keyframe"):
        ms = [t for t, k in per_frame if k == kind]
        if ms:
            result[f"{kind}_ms_median"] = float(np.median(ms))
            result[f"{kind}_ms"] = ms
    if cfg.local_ba_every > 0:
        result["ba_call"] = profile_ba_call(vo)
    return result


def sm_clock_mhz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0])


class GcWatch:
    """Collections and seconds that gc.callbacks sees while installed."""

    def __init__(self):
        self.seconds, self.collections, self._t0 = 0.0, [0, 0, 0], None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self.collections[info["generation"]] += 1
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def timed_run(cfg, frames):
    """One fresh StereoVO over `frames`, frames/s over the frames after
    WARM (chip_smoke.py's run_counted), with what surrounds it."""
    stats0 = torch.cuda.memory_stats()
    fig = dict(launch_us=launch_us(), range_us=range_cost_us(5000),
               python_ms=python_ms(), sm_mhz_before=sm_clock_mhz())
    vo = vo_mod.StereoVO(cfg)
    with GcWatch() as watch:
        for left, right in frames[:WARM]:
            vo.track(left, right)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for left, right in frames[WARM:]:
            vo.track(left, right)
        torch.cuda.synchronize()
        fig["fps"] = (len(frames) - WARM) / (time.perf_counter() - t0)
    stats = torch.cuda.memory_stats()
    fig.update(
        sm_mhz_after=sm_clock_mhz(), gc_s=watch.seconds,
        gc_collections=watch.collections,
        allocations=stats["allocation.all.allocated"]
        - stats0.get("allocation.all.allocated", 0),
        allocations_live=stats["allocation.all.current"],
        segments_live=stats["segment.all.current"],
        reserved_mb=stats["reserved_bytes.all.current"] / 2 ** 20,
        alloc_retries=stats["num_alloc_retries"])
    return fig


def between_step(cfg, frames, between):
    """The A/B's middle step: one torch.profiler session (CPU and CUDA
    activity) over 100 small ops ("profiler") or over a fresh StereoVO's
    first WARM frames ("window", ~140,000 launches), or nothing
    ("none")."""
    if between == "profiler":
        y = torch.zeros(16, device="cuda")
        profiled(lambda: [y.add_(1.0) for _ in range(100)])
    elif between == "window":
        vo = vo_mod.StereoVO(cfg)
        profiled(lambda: [vo.track(*f) for f in frames[:WARM]])


def history(cfg, frames, runs, between):
    before = [timed_run(cfg, frames) for _ in range(runs)]
    t0 = time.perf_counter()
    between_step(cfg, frames, between)
    between_s = time.perf_counter() - t0
    after = [timed_run(cfg, frames) for _ in range(runs)]

    def side(figs):
        fps = [f["fps"] for f in figs]
        return dict(fps_median=float(np.median(fps)), fps_min=min(fps),
                    fps_max=max(fps), runs=figs)
    b, a = side(before), side(after)
    return dict(between=between, between_s=between_s, before=b, after=a,
                after_over_before=a["fps_median"] / b["fps_median"],
                ranges_overlap=a["fps_min"] <= b["fps_max"]
                and b["fps_min"] <= a["fps_max"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ba-off", action="store_true",
                    help="windowed BA off (main_path_config_ba_off)")
    ap.add_argument("--history", action="store_true",
                    help="the profiler-session A/B instead")
    ap.add_argument("--between", choices=("profiler", "window", "none"),
                    default="profiler", help="the A/B's middle step")
    ap.add_argument("--runs", type=int, default=3,
                    help="fresh runs on each side of the A/B")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a CUDA device")
    os.makedirs("chiprun_out", exist_ok=True)
    cfg = main_path_config_ba_off() if args.ba_off else main_path_config()
    frames, _, _ = corridor_frames(cfg, N_FRAMES)
    if args.history:
        name = f"profile_history_{args.between}.json"
        result = history(cfg, frames, args.runs, args.between)
    else:
        name = ("profile_main_path_ba_off.json" if args.ba_off
                else "profile_main_path.json")
        result = stages_main(cfg, frames)
    result["device"] = torch.cuda.get_device_name(0)
    result["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    with open(os.path.join("chiprun_out", name), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
