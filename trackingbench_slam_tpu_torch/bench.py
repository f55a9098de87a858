"""bench.py's headline line for the PyTorch/CUDA port.

    python -m trackingbench_slam_tpu_torch.bench [--quick] [--frames N]
        [--ba-every K] [--max-landmarks L] [--skip-cpu-ref] [--cpu]

Times StereoVO at the main path's configuration (utils/corridor.py
`main_path_config`, bench.py's operating point) over bench.py's corridor
frames (`corridor_frames`: 40, 14 with --quick), fed by
utils/prefetch.py's DevicePrefetcher(depth=2) as bench.py's time_pipeline
feeds its tracker: a warm-up over 2 * keyframe_every + 1 frames, then the
remaining frames between two device fences. The denominator is
benchmarks/cpu_reference.py's CpuStereoVO on the same frames (all of them),
timed as bench.py's time_cpu_reference times it; the file is loaded by its
path from the checkout, and without it the entry raises unless
--skip-cpu-ref is given (then vs_baseline is null).

It prints one JSON line with bench.py's keys (`metric`
stereo_vo_frames_per_s_per_chip, `value`, `unit`, `vs_baseline`, `extra`)
once after the headline and again, last, with the extras:
`extra.stage_ms` (bench.py's stage_timings: track_step_ms,
track_and_keyframe_step_ms and local_ba_step_ms over 5 reps each
threading the state, device_put_image_ms, and
track_step_with_threaded_upload_ms) and `extra.dp_eval`
(parallel/dp_eval.py `dp_eval_bench`, left out with --quick); beside them
the card's nvidia-smi name and power limit, the torch and CUDA versions,
the main path's hand-kernel launches a frame, and `host_probe_ms`, a fixed
pure-Python loop's host ms taken before the timing (how fast the host ran).
`real_depth_oracle_median_rel_err` is null: its disparity oracle is not in
the repository. bench.py's other extras are driven by chip_smoke.py's
phases.

No extra is skipped on failure: an exception ends the process with a
non-zero exit after the early line. The module starts no torch.profiler
session (one leaves the process slower after it ends). It runs on the card
and raises without one unless --cpu is given, which runs the plain
versions on the CPU; the CUDA kernels build from the checkout's sources at
first use (ops/cuda/build.py).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

METRIC = "stereo_vo_frames_per_s_per_chip"
SCENE = "corridor+yaw (depth 4-40m)"
STAGE_REPS = 5
LINE_KEYS = ("metric", "value", "unit", "vs_baseline", "extra")
# bench.py's keys of `extra` before its extras, then the port's own
EXTRA_KEYS = ("ate_rmse_m", "platform", "cpu_reference_fps",
              "cpu_reference_ate_m", "cpu_reference_frames", "scene",
              "real_depth_oracle_median_rel_err",
              "card", "torch", "cuda", "last_frame_inliers",
              "hand_kernel_launches", "hand_kernel_launches_per_frame",
              "host_probe_ms")
STAGE_KEYS = ("track_step_ms", "track_and_keyframe_step_ms",
              "local_ba_step_ms", "device_put_image_ms",
              "track_step_with_threaded_upload_ms")
CPU_REFERENCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "benchmarks", "cpu_reference.py")


def nvidia_smi_line():
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def load_cpu_reference(path=CPU_REFERENCE):
    """benchmarks/cpu_reference.py's CpuStereoVO, loaded by its path."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"the CPU reference {path} is missing: run from a checkout of "
            "the repository, or pass --skip-cpu-ref")
    spec = importlib.util.spec_from_file_location("cpu_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.CpuStereoVO


def hand_kernel_counters():
    """The hand kernels' launch counters, by kernel: each `*_cuda` wrapper's
    `.launches`, which counts its launches on the card."""
    from trackingbench_slam_tpu_torch.ops.cuda import (fast_kernel,
                                                       lk_kernel,
                                                       patch_kernel)
    return {"lk_align": lk_kernel.lk_align_cuda,
            "fast_score_nms": fast_kernel.fast_score_nms_cuda,
            "orb_describe": patch_kernel.orb_describe_cuda,
            "anchor_cells": patch_kernel.anchor_cells_cuda}


def time_pipeline(cfg, frames, gt, device):
    """bench.py's time_pipeline: (frames/s over the frames after the
    warm-up, ATE RMSE m, last-frame inliers, hand-kernel launches of the
    run by kernel)."""
    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    from trackingbench_slam_tpu_torch.utils import metrics
    from trackingbench_slam_tpu_torch.utils.prefetch import DevicePrefetcher
    from trackingbench_slam_tpu_torch.utils.profiling import fence
    counters = hand_kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    vo = StereoVO(cfg, device=device)
    warm = min(2 * cfg.keyframe_every + 1, len(frames) - 1)
    with DevicePrefetcher(frames, depth=2, device=device) as pf:
        for i in range(warm):
            vo.track(*pf[i])
        fence(vo.state)
        t0 = time.perf_counter()
        for i in range(warm, len(frames)):
            vo.track(*pf[i])
        fence(vo.state)
        fps = (len(frames) - warm) / (time.perf_counter() - t0)
    ate = metrics.ate_rmse(vo.poses(), gt, align=True)
    return (fps, ate, int(vo.state.num_inliers),
            {k: fn.launches for k, fn in counters.items()})


def time_cpu_reference(cfg, frames, gt, cpu_stereo_vo):
    """bench.py's time_cpu_reference over every frame: (frames/s after the
    bootstrap frame, ATE RMSE m, frames)."""
    import numpy as np

    from trackingbench_slam_tpu_torch.utils import metrics
    c = cfg.camera
    vo = cpu_stereo_vo(c.width, c.height, c.fx, c.fy, c.cx, c.cy, c.bf,
                       num_features=cfg.extractor.num_features,
                       keyframe_every=cfg.keyframe_every)
    vo.track(frames[0][0].astype(np.float32),
             frames[0][1].astype(np.float32))
    t0 = time.perf_counter()
    for left, right in frames[1:]:
        vo.track(left.astype(np.float32),
                 None if right is None else right.astype(np.float32))
    fps = (len(frames) - 1) / (time.perf_counter() - t0)
    return fps, metrics.ate_rmse(vo.poses(), gt[:len(frames)],
                                 align=True), len(frames)


def stage_timings(cfg, frames, device, reps=STAGE_REPS):
    """bench.py's stage_timings: host ms a call of each step, `reps` calls
    each threading the state, fenced once after them; the upload of one
    frame; and a track step with the next frame's upload on a worker
    thread."""
    from trackingbench_slam_tpu_torch.geometry.camera import CameraParams
    from trackingbench_slam_tpu_torch.models import vo
    from trackingbench_slam_tpu_torch.models.local_mapping import \
        local_ba_step
    from trackingbench_slam_tpu_torch.utils.device import upload_image
    from trackingbench_slam_tpu_torch.utils.profiling import fence
    cam = CameraParams.from_config(cfg.camera, device)
    (L0, R0), (L1, _) = frames[0], frames[1]
    L0d, R0d, L1d = (upload_image(x, device) for x in (L0, R0, L1))
    gen = torch.Generator(device=device).manual_seed(0)
    st = vo.keyframe_step(vo.init_state(cfg, L0d), R0d, cam, cfg)
    fence(vo.track_step(st, L1d, cam, cfg, gen))
    stk = vo.track_and_keyframe_step(st, L1d, R0d, cam, cfg, gen)
    fence(local_ba_step(stk, cam, cfg))
    out = {}

    def timeit(name, fn, s0):
        s = s0
        t0 = time.perf_counter()
        for _ in range(reps):
            s = fn(s)
        fence(s)
        out[name] = (time.perf_counter() - t0) / reps * 1e3

    timeit("track_step_ms", lambda s: vo.track_step(s, L1d, cam, cfg, gen),
           st)
    timeit("track_and_keyframe_step_ms",
           lambda s: vo.track_and_keyframe_step(s, L1d, R0d, cam, cfg, gen),
           st)
    timeit("local_ba_step_ms", lambda s: local_ba_step(s, cam, cfg), stk)
    side = (torch.cuda.Stream(device=device) if device.type == "cuda"
            else None)

    def upload():
        if side is None:
            return upload_image(L1, device)
        with torch.cuda.stream(side):
            t = upload_image(L1, device)
        side.synchronize()
        return t

    t0 = time.perf_counter()
    for _ in range(reps):
        upload()
    out["device_put_image_ms"] = (time.perf_counter() - t0) / reps * 1e3
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(upload)
        s = st
        t0 = time.perf_counter()
        for _ in range(reps):
            nxt = pool.submit(upload)
            s = vo.track_step(s, L1d, cam, cfg, gen)
            fut.result()
            fut = nxt
        fence(s)
        out["track_step_with_threaded_upload_ms"] = (
            (time.perf_counter() - t0) / reps * 1e3)
        fut.result()
    return out


def bench(cfg, frames, gt, device, quick=False, skip_cpu_ref=False,
          emit=None, cpu_reference=CPU_REFERENCE):
    """The line for `frames` (bench.py's [(left uint8, right uint8 or
    None)]) and their (n, 4, 4) ground truth at `cfg` on `device`; `emit`
    is called with the line after the headline and again, last, with the
    extras. Returns the last line."""
    from trackingbench_slam_tpu_torch.parallel.dp_eval import dp_eval_bench
    from trackingbench_slam_tpu_torch.profile_main_path import python_ms
    from trackingbench_slam_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    cpu_stereo_vo = None if skip_cpu_ref else load_cpu_reference(
        cpu_reference)
    on_card = device.type == "cuda"
    probe = python_ms()
    fps, ate, inliers, launches = time_pipeline(cfg, frames, gt, device)
    print(f"[{device.type}] {len(frames)} frames: {fps:.3f} frames/s, ATE "
          f"{ate:.5f} m, inliers {inliers}, hand-kernel launches "
          f"{launches}", file=sys.stderr)
    if cpu_stereo_vo is None:
        fps_cpu, ate_cpu, n_cpu = None, None, 0
    else:
        fps_cpu, ate_cpu, n_cpu = time_cpu_reference(cfg, frames, gt,
                                                     cpu_stereo_vo)
        print(f"[cpu-reference] {n_cpu} frames: {fps_cpu:.3f} frames/s, "
              f"ATE {ate_cpu:.5f} m", file=sys.stderr)
    extra = {"ate_rmse_m": round(ate, 5),
             "platform": "gpu" if on_card else "cpu",
             "cpu_reference_fps": (None if fps_cpu is None
                                   else round(fps_cpu, 3)),
             "cpu_reference_ate_m": (None if ate_cpu is None
                                     else round(ate_cpu, 5)),
             "cpu_reference_frames": n_cpu,
             "scene": SCENE,
             "real_depth_oracle_median_rel_err": None,
             "card": nvidia_smi_line() if on_card else None,
             "torch": torch.__version__, "cuda": torch.version.cuda,
             "last_frame_inliers": inliers,
             "hand_kernel_launches": launches,
             "hand_kernel_launches_per_frame":
                 sum(launches.values()) / len(frames),
             "host_probe_ms": probe}
    line = {"metric": METRIC, "value": round(fps, 3), "unit": "frames/s",
            "vs_baseline": (None if fps_cpu is None
                            else round(fps / fps_cpu, 3)),
            "extra": extra}
    if emit is not None:
        emit(line)
    extra["stage_ms"] = stage_timings(cfg, frames, device)
    print(f"[stages] {extra['stage_ms']}", file=sys.stderr)
    if not quick:
        extra["dp_eval"] = dp_eval_bench(cfg, frames, device=device)
        print(f"[dp_eval] {extra['dp_eval']}", file=sys.stderr)
    if emit is not None:
        emit(line)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="run the plain versions on the CPU")
    p.add_argument("--quick", action="store_true",
                   help="14 frames and no dp_eval extra")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--ba-every", type=int, default=None,
                   help="override local_ba_every (0 disables local BA)")
    p.add_argument("--max-landmarks", type=int, default=None,
                   help="override solver.max_landmarks (the BA window)")
    p.add_argument("--skip-cpu-ref", action="store_true")
    args = p.parse_args(argv)
    import trackingbench_slam_tpu_torch  # noqa: F401  (precision pins)
    from trackingbench_slam_tpu_torch.utils.corridor import (
        corridor_frames, main_path_config)
    from trackingbench_slam_tpu_torch.utils.device import resolve_device
    device = resolve_device("cpu" if args.cpu else None)
    if not args.skip_cpu_ref:
        load_cpu_reference()
    cfg = main_path_config()
    if args.ba_every is not None:
        cfg = dataclasses.replace(cfg, local_ba_every=args.ba_every)
    if args.max_landmarks is not None:
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, max_landmarks=args.max_landmarks))
    n = args.frames or (14 if args.quick else 40)
    print(f"rendering {n} corridor stereo frames ({cfg.camera.width}x"
          f"{cfg.camera.height})...", file=sys.stderr)
    frames, gt, _ = corridor_frames(cfg, n)
    bench(cfg, frames, gt, device, quick=args.quick,
          skip_cpu_ref=args.skip_cpu_ref,
          emit=lambda line: print(json.dumps(line), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
