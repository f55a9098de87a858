"""Where the main path's time goes, on one NVIDIA GPU.

    python3 -m trackingbench_slam_tpu_torch.profile_main_path

    python3 -m trackingbench_slam_tpu_torch.profile_main_path --ba-off

Runs one StereoVO at the main-path configuration (utils/corridor.py:
bench.py's operating point, windowed BA on every 2nd keyframe; `--ba-off`
for the same with windowed BA off) over 40 corridor frames:
  * frames 0-10 warm up;
  * frames 11-20 run under torch.profiler (one of them, frame 19, is a BA
    keyframe): for each stage (the record_function ranges in models/vo.py
    and models/local_mapping.py) the host ms per call and the device ms of
    the kernels launched inside it; device time (kernels and copies) over
    wall time, the busy share; kernel launches per frame; the top kernels
    by device time;
  * frames 21-39 run without the profiler, each fenced by
    torch.cuda.synchronize(): wall ms per frame, tracking frames, keyframes
    and BA keyframes apart;
  * with BA on, one local_ba_step on the final state under the profiler:
    its kernel launches, device ms and host ms.
Also times an empty record_function range with the profiler off (what the
stage ranges cost the main path). Prints one JSON line; the full result and
the profiler table go to chiprun_out/. Needs CUDA; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from trackingbench_slam_tpu_torch.models import local_mapping
from trackingbench_slam_tpu_torch.models import vo as vo_mod
from trackingbench_slam_tpu_torch.utils.corridor import (
    corridor_frames, main_path_config, main_path_config_ba_off)

N_FRAMES = 40
WARM = 11
PROFILED = 10


def range_cost_us(n: int = 20000) -> float:
    """Host microseconds of one empty record_function range, profiler off."""
    t0 = time.perf_counter()
    for _ in range(n):
        with torch.profiler.record_function("empty"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def profiled(fn):
    """(key_averages, wall ms) of fn() under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof.key_averages(), wall_ms


def device_events(avgs):
    """Device-side events only: the CPU ops that launched them carry the
    same time again as their own device time."""
    return [e for e in avgs if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]


def kernel_launches(device):
    return sum(e.count for e in device
               if not e.key.startswith(("Memcpy", "Memset")))


def profile_window(vo, frames):
    """Stage, kernel and busy-share figures over `frames` under the
    profiler."""
    def run():
        for left, right in frames:
            vo.track(left, right)
    avgs, wall_ms = profiled(run)
    device = device_events(avgs)
    device_ms = sum(e.self_device_time_total for e in device) / 1e3
    stages = {e.key: {"calls": e.count,
                      "host_ms_per_call": e.cpu_time_total / e.count / 1e3,
                      "device_ms_per_call":
                          e.device_time_total / e.count / 1e3}
              for e in avgs if e.device_type == DeviceType.CPU
              and e.key.startswith(vo_mod.STAGE_PREFIXES)}
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:15]
    with open(os.path.join("chiprun_out", "profile_key_averages.txt"),
              "w") as fh:
        fh.write(avgs.table(sort_by="self_cpu_time_total", row_limit=40))
    return {
        "frames": len(frames), "wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "kernel_launches_per_frame": kernel_launches(device) / len(frames),
        "stages": dict(sorted(stages.items())),
        "top_device_ms": [[e.key[:160], e.self_device_time_total / 1e3]
                          for e in top],
    }


def profile_ba_call(vo):
    """One local_ba_step on the run's state: kernel launches, device ms and
    host ms."""
    avgs, wall_ms = profiled(lambda: local_mapping.local_ba_step(
        vo.state, vo.cam, vo.cfg))
    device = device_events(avgs)
    return {"wall_ms": wall_ms, "kernel_launches": kernel_launches(device),
            "device_ms": sum(e.self_device_time_total for e in device) / 1e3}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ba-off", action="store_true",
                    help="windowed BA off (main_path_config_ba_off)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a CUDA device")
    os.makedirs("chiprun_out", exist_ok=True)
    cfg = main_path_config_ba_off() if args.ba_off else main_path_config()
    frames, _, _ = corridor_frames(cfg, N_FRAMES)
    cost_us = range_cost_us()
    vo = vo_mod.StereoVO(cfg)
    for left, right in frames[:WARM]:
        vo.track(left, right)
    window = profile_window(vo, frames[WARM:WARM + PROFILED])
    per_frame = []
    for i in range(WARM + PROFILED, N_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ba_before = vo.ba_calls
        vo.track(*frames[i])
        torch.cuda.synchronize()
        kind = ("ba_keyframe" if vo.ba_calls > ba_before else "keyframe"
                if (i + 1) % cfg.keyframe_every == 0 else "track")
        per_frame.append(((time.perf_counter() - t0) * 1e3, kind))
    result = {
        "device": torch.cuda.get_device_name(0),
        "local_ba_every": cfg.local_ba_every,
        "ba_calls": vo.ba_calls,
        "fenced_frames": len(per_frame),
        "fps_fenced": len(per_frame) / (sum(t for t, _ in per_frame) / 1e3),
        "record_function_us_profiler_off": cost_us,
        "profile_window": window,
    }
    for kind in ("track", "keyframe", "ba_keyframe"):
        ms = [t for t, k in per_frame if k == kind]
        if ms:
            result[f"{kind}_ms_median"] = float(np.median(ms))
            result[f"{kind}_ms"] = ms
    if cfg.local_ba_every > 0:
        result["ba_call"] = profile_ba_call(vo)
    with open(os.path.join("chiprun_out", "profile_main_path.json"),
              "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
