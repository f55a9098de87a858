#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (trackingbench_slam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure ends the run with a non-zero exit.
Every phase that times something on the host clock or with CUDA events
runs before the first torch.profiler session of the process (PHASES):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: every CUDA kernel (csrc/*.cu), one nvcc each, in parallel;
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, at the main path's calls on the first rendered corridor frames
     (trackingbench_slam_tpu_torch/kernel_bench.py `kernel_inputs`): FAST
     as one launch over the 3-level ORB pyramid, exact on every level; the
     ORB describe of the bootstrap keyframe's 3 levels in one launch, angles
     within 1e-5 rad and angle bins equal on >= 99.9% of valid points,
     descriptors bit-exact with the plain rBRIEF on the kernel's own angles
     and with the whole plain version where the bins agree, invalid rows
     zero; the bootstrap keyframe's anchor cells written into a 16384-slot
     atlas, bit-exact; LK as one launch per call (track 2 levels, stereo 2
     levels + back-track, bootstrap stereo 4 levels + back-track, anchored),
     xy within 1e-3 px where both converged, converged and back-track flags
     agreeing on >= 99% of points; all timed from CUDA-graph replay after a
     warm-up;
  4. main path, BA off: StereoVO at bench.py's configuration with windowed
     BA off, 40 corridor frames, frames/s after an 11-frame warm-up; the
     kernel launch counters (lk_align, fast_score_nms, orb_describe,
     anchor_cells), zeroed just before, must read 57 / 9 / 9 / 9; ATE
     < 0.01 m, > 500 pose inliers at the end;
  5. main path, BA on: the same at bench.py's configuration itself (local
     BA on every 2nd keyframe, 2048 landmarks): 4 BA calls, every counter
     moving, ATE < 0.01 m, > 500 inliers; then one BA call on the final
     state, fenced, for its time;
  6. prefetch: every frame utils/prefetch.py's DevicePrefetcher hands out
     torch.equal to the synchronous upload, and the BA-on live loop fed by
     it gives the BA-on run's poses exactly; frames/s of both feeds;
  7. offline: models/offline.py's OfflineStereoVO on the same frames,
     uploaded once: frames/s beside the live loop's, ATE < 0.01 m,
     launches equal to the BA-on run's, poses equal to it, the host syncs
     of one run counted, and the repeated-target row writes run under
     set_sync_debug_mode("error");
  8. photometric stress (bench.py's photometric_stress_bench): the 40
     frames through photometric_stress, tracked plain and with CLAHE
     (MatcherConfig.equalize), fed by the prefetcher: ATE, inliers,
     frames/s, launches; every pose finite; the CLAHE run's last track-step
     LK call (equalized pyramids) against the plain LK as in phase 3;
  9. loop bench (bench.py's loop_closing_bench): 96 frames of a closed
     circle, 3 LK tracking levels, BA on, the first and last frame
     hashing to the JAX record's (trackingbench_slam_tpu_torch/records/
     jax_full_width.npz, parity.py); a vocabulary trained on the card's
     ORB descriptors of every 12th left image; run A without a LoopCloser
     twice, whose per-frame poses must be torch.equal, and run B with it
     over the first 48 frames, in which every counter must move; then run
     C without the closer on
     the record's RANSAC draws (run A's) and run D with the closer on the
     record's vocabulary and run B's draws. Each of A-D is held to its JAX
     run frame by frame (first frame > 1 cm from JAX, lost frames,
     keyframe and BA frames, loops and relocalizations, closing errors); C
     and D must hold: until the first frame at which either package flags
     lost, keyframe and BA frames equal to the record's and positions
     within 1 cm of it. Run B's error at its last frame is printed, not
     gated: both packages lose frames 36-45 of this circle and what follows
     is amplified rounding (the record's own run B ends 316,097 m off).
     Then the tracked loop (utils/corridor.py tracked_loop_config: the JAX
     package's own loop test's circle at 512x384, at 72 frames
     (parity.TRACKED_FRAMES), which both packages track without losing a
     frame; the loop bench's circle at 96-192 frames does not), its frames
     hashing to the record's: run E with the closer on the record's
     vocabulary and draws, held to the record at every frame (within 1 cm,
     keyframe, BA, loop and relocalization frames equal, no frame lost);
     run E48 the same on the loop test's own 48 frames, held as C and D
     are (its keyframe 29 rests on 21 inliers, where F-RANSAC's inlier set
     turns on rounding); and run F on the port's own draws and the card's
     vocabulary, with the closer at RANSAC seeds 0 and 1 and without it at
     seed 0: each closer run loses no frame, closes the revisit loop (in
     the last 10 frames) and ends < 0.05 m from the start and >= 5 mm
     below the closer-less run. Then the full-width loop (the record's
     part loop_full: that circle at the loop bench's configuration,
     windowed BA on every 2nd keyframe, in a corridor wide enough that the
     JAX package tracks and closes it), its frames hashing to the
     record's: run G with the closer on the record's vocabulary and draws,
     held to the record at every frame as E is; run H on the port's own
     draws and the card's vocabulary, gated as F is, its last loop on a
     keyframe of the circle's first 10 frames. In every run of E-H every
     loop matched a keyframe whose true view overlaps the query's
     (parity.loop_views) and every counter moves;
  10. direct: DirectVO at bench.py's camera and features on the direct
     pyramid (5 levels x0.8), 24 corridor frames, stereo on the first only:
     ATE < 0.05 m, > 40 tracked, > 50 promoted seeds, LK and FAST launched;
     every frame's position within 1 cm of the JAX record's;
     sparse_image_align and features_align on the run's last call, fenced
     host ms (device ms in phase 16);
  11. indirect: IndirectVO at the EuRoC operating point (752x480), 12 stereo
     corridor frames, each of the five match strategies (BoW on the JAX
     record's vocabulary): ATE < 0.04 m, > 30 last-frame inliers, all four
     kernels launched, every frame's position within 1 cm of the JAX
     record's run of that strategy;
  12. mono: MonoVO at the main path's camera, features and map, 28 lateral
     frames, on the JAX record's RANSAC draws: bootstrapped on the
     record's frame, scale-aligned ATE after it < 0.06 m, > 150 live
     landmarks, everything finite, LK, FAST and ORB describe launched, BA
     counted, every frame's position within 1 cm of the record's;
  13. sequences, the recorded-dataset path, in a temporary directory: (a)
     40 corridor frames written by utils/datasets.py save_corridor_kitti as
     KITTI PNGs (1226x370), every frame decoded by the loader equal to the
     array written, tracked by StereoVO at the main path's configuration
     and the written camera fed by the loader: launches equal to the main
     path's, ATE < 0.05 m, > 500 inliers, poses torch.equal to the same
     frames tracked from memory (frames/s of both), the KITTI and TUM
     exports read back within 1e-5; (b) sequence_eval.real_sequence_eval
     on a 10-frame save_synthetic_kitti root (.npy, kitti_stereo_config: a
     5-level ORB pyramid): kitti00, 10 frames, ATE < 0.05 m, both
     trajectory files in chiprun_out/, every counter moving; (c) 24 frames in the EuRoC layout
     (752x480) through load_euroc: stamps 0.05 s apart, ground truth
     parsed, tracked at euroc_stereo_config with the written camera, ATE
     < 0.03 m; (d) undistort_image of (c)'s first frame and
     undistort_points on a 16x16 grid, EuRoC cam0's radtan coefficients,
     on the card within 1e-3 and 1e-4 px of the CPU; (e) the demo at its
     defaults, exit 0;
     then the kernel calls recorded in phases 10-13 against their plain
     versions as in phase 3: the direct tracker's seed LK call (half 6, 2
     levels, prior), the mono keyframe's back-track call, from the
     indirect run (match strategy nn) the last frame's FAST launch over
     the 5-level 752x480 pyramid, its ORB describe of 5 levels, its anchor
     cells, its stereo LK (2 levels + back-track, prior) and anchored LK,
     and the first frame's stereo LK (4 levels + back-track), and from
     (b) the last keyframe's FAST over the 5-level 1226x370 pyramid, its
     ORB describe and its anchor cells;
  13b. pose kernel: csrc/pose.cu's solve (a launch a round) against its
     plain version (the rounds under torch.func.vmap, as the eager batched
     step ran them) on the inputs recorded from one batched track step of
     each benchmark cell (slam_bench's battery: KITTI B 44, EuRoC B 55, N
     2000) and from the loop closer's first verification on the tracked
     loop (B 1): pose gap |log(T_kernel T_plain^-1)| <= 1e-4, inlier flags
     differing on <= 0.1% of the edges, the batch bit-equal to each
     sequence launched alone, one launch a round; the kernel's ms (CUDA
     events) beside its bound (operations counted from the plain code) and
     the plain solve's ms;
  14. batched and distributed (parallel/): 8 sequences cut from the main
     path's frames (rights rendered where missing), bootstrapped serially,
     then 3 batched track steps and one batched track-and-keyframe step
     (dp_eval) held to serial runs: every pyramid level equal after every
     step; after the keyframe step every leaf of the state equal
     (`held_to_serial`; integer and bool leaves, pyramids, ORB angles,
     FAST responses, the anchor atlas and the fresh keypoints' positions
     bit-equal, the floats a reduction could move within stated
     tolerances: poses 1e-5, landmark positions 1e-4 m), poses within
     1e-5; the same keyframe frame bisected by parallel/batch_check.py
     (every stage's calls serial against vmap on the same inputs); one
     batched keyframe step with a fresh sequence beside 7 tracked ones
     (both sides of the stereo-prior branch kept) held to serial keyframe
     steps by the same gates; hand-kernel launches of a batched step equal
     to a serial step's (the keyframe step one stereo LK more: both sides
     of the stereo-prior branch run); dp_eval.dp_eval_bench (bench.py's
     protocol), B1 and B8 sequence-frames/s; every batched kernel call
     against its plain version per sequence as in phase 3 (the anchor
     cells on the atlases from before the step's launch, and the atlases
     that launch left); BA iterations/s with benchmarks/ba_scaling.py's
     protocol (4 windows of 4096 x 16 x 16, (t(12) - t(2)) / 10), the
     median of 11 readings, one-device and distributed on a world of one
     over NCCL, alternating; both distributed solves against
     bundle_adjust_grouped / bundle_adjust: poses and points within 5e-4;
  15. main path, BA on, again, the last timed phase: frames/s beside the
     first BA-on run's, poses torch.equal to it, the same launches;
  16. bench: `python -m trackingbench_slam_tpu_torch.bench --frames 40` in
     a fresh process (bench.py's headline line for the port): bench.py's
     keys, the five stage_ms keys and the port's own, a positive rate, ATE
     < 0.01 m, the CPU reference over all 40 frames, vs_baseline equal to
     value / cpu_reference_fps within their roundings;
  17. profiles, under torch.profiler: (a) each kernel's phase-3 calls
     through its public entry point (the custom op), ATTRIBUTION_CALLS a
     case, inside the models/vo.py range that makes the call (LK track,
     stereo and anchored; FAST and ORB describe in keyframe.extract_orb;
     anchor cells): one device event a call, whose ms a call agree with
     phase 3's CUDA-event ms within ATTRIBUTION_TOL, and the custom op's
     and the range's device time each holding it; every other checked
     kernel call's device ms under the profiler; (b) a fresh BA-on
     StereoVO's frame 14 (a keyframe): every range of KERNEL_RANGES
     holds device time of its kernels' custom ops; (c) phase 10's two
     direct stages: device ms and CUDA kernels a call; (d) phase 14's
     track steps: CUDA kernels of a batched track step <= 1.5x the B = 1
     step's;
  18. profiler history: `python -m trackingbench_slam_tpu_torch.
     profile_main_path --history` in a child process on the same card
     (three fresh BA-on main-path runs, one torch.profiler session, three
     more), its frames/s on both sides;
  19. a `kernels` JSON line (launches on every path), the script's seconds,
     then the card's nvidia-smi line, then the result line
     {"ok": true, "device": {...}}.

Imports nothing of JAX. Needs the package beside it: run from a checkout.
"""

import contextlib
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
N_FRAMES = 40
LOOP_FRAMES = 96
# run B, printed and not gated, runs the loop bench's first 48 frames: the
# circle is lost from frame 36 in both packages and what follows is
# amplified rounding (PERF.md), so its tail only cost time
LOOP_B_FRAMES = 48
WARM_FRAMES = 11
WARM_DIRECT = 4
WARM_MONO = 4
BATCH = 8               # sequences of the batched phase
BATCH_TRACK_STEPS = 3   # batched track steps held to serial runs
DP_STEPS = 16           # bench.py:512-545 dp_eval_bench's timed steps
BA_REPS = 4             # benchmarks/ba_scaling.py's pre-uploaded windows
BA_SWEEPS = 11          # readings of each BA solve's iterations/s
BA_WINDOW = dict(landmarks=4096, keyframes=16, obs=16)   # and their size
# (the pose solve: 4 rounds in each frame after the first)
BA_OFF_LAUNCHES = {"lk_align": 57, "fast_score_nms": 9, "orb_describe": 9,
                   "anchor_cells": 9, "pose_round": 4 * (N_FRAMES - 1)}
# the loop bench's accuracies on the TPU (BENCH_r05.json, a TPU run of the
# JAX package); the figures the port is held to are those of the JAX
# record, trackingbench_slam_tpu_torch/records/jax_full_width.npz
TPU_LOOP_ACCURACY = dict(without_closer_m=0.7764, with_closer_m=0.0085,
                         loops_closed=2)
F_SEEDS = (0, 1)        # RANSAC generator seeds of the tracked loop's run F
# processes of the pool that renders the corridor sequences (started with
# the build, so that its start-up overlaps nvcc's)
RENDER_PROCESSES = min(os.cpu_count() or 1, 8)
ATTRIBUTION_CALLS = 5   # eager calls of each kernel case under the profiler
ATTRIBUTION_TOL = 0.25  # profiler device time a call against CUDA events
# main()'s phases in the order it runs them. "timed" phases take figures on
# the host clock or from CUDA events (frames/s, fenced ms, kernel times);
# "profiled" ones run torch.profiler in this process; "child" runs in a
# process of its own. A profiler session leaves the process slower for a
# while after it ends (PERF.md), so every timed phase comes before
# the first profiled one: `PhaseOrder.enter` holds main() to this order,
# and `PhaseOrder.profiled` runs the profiler only inside a profiled phase.
PHASES = (
    ("build", "setup"),
    ("kernel checks", "timed"),
    ("main path, BA off", "timed"),
    ("main path, BA on", "timed"),
    ("prefetch", "timed"),
    ("offline", "timed"),
    ("photometric", "timed"),
    ("loop bench", "timed"),
    ("direct", "timed"),
    ("indirect", "timed"),
    ("mono", "timed"),
    ("sequences", "timed"),
    ("recorded kernel checks", "timed"),
    ("pose kernel", "timed"),
    ("batched", "timed"),
    ("BA", "timed"),
    ("main path, BA on, again", "timed"),
    ("bench", "child"),
    ("profiles", "profiled"),
    ("profiler history", "child"),
)


class PhaseOrder:
    """main()'s position in `phases` ((name, kind) pairs). `probe()`, where
    given, is read on entering each phase; its readings are kept in
    `probes`."""

    def __init__(self, phases=PHASES, probe=None):
        self.phases = phases
        self.at = -1
        self.probe = probe
        self.probes = []
        self.t0 = time.perf_counter()

    def enter(self, name):
        names = [n for n, _ in self.phases]
        if name not in names[self.at + 1:]:
            raise AssertionError(f"phase {name!r} out of the declared order "
                                 f"(after {names[self.at]!r})")
        self.at = names.index(name, self.at + 1)
        if self.probe is not None:
            reading = dict(phase=name,
                           at_s=time.perf_counter() - self.t0,
                           **self.probe())
            self.probes.append(reading)
            log(f"[phase] {name}: " + ", ".join(
                f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in reading.items() if k != "phase"))

    @property
    def kind(self):
        return self.phases[self.at][1] if self.at >= 0 else None

    def profiled(self, fn):
        """profile_main_path.profiled(fn), only inside a profiled phase."""
        from trackingbench_slam_tpu_torch.profile_main_path import profiled
        if self.kind != "profiled":
            raise AssertionError(f"a profiler session in the {self.kind} "
                                 f"phase {self.phases[self.at][0]!r}")
        return profiled(fn)


def log(msg):
    print(msg, flush=True)


def process_probe():
    """What the process carries into a phase: one small op's launch in host
    microseconds, a fixed pure-Python loop's host ms (how fast the host
    runs just then), threads, resident MB, objects the garbage collector
    tracks, and the CUDA caching allocator's segments and reserved MB."""
    import gc
    import threading
    import torch
    from trackingbench_slam_tpu_torch.profile_main_path import (launch_us,
                                                                python_ms)
    with open("/proc/self/status") as fh:
        status = dict(line.split(":", 1) for line in fh if ":" in line)
    stats = torch.cuda.memory_stats()
    return dict(launch_us=launch_us(), python_ms=python_ms(),
                threads=int(status["Threads"]),
                python_threads=threading.active_count(),
                rss_mb=int(status["VmRSS"].split()[0]) / 1024,
                gc_objects=len(gc.get_objects()),
                segments=stats.get("segment.all.current", 0),
                reserved_mb=stats.get("reserved_bytes.all.current", 0)
                / 2 ** 20)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- bounds: the bytes and operations each function needs on this run's
# inputs (each input byte it needs read once, each output byte written once)

def covered_pixels(shape, blocks):
    """Pixels of an image of `shape` that square blocks cover, each pixel
    counted once; `blocks` is a list of (top rows, left columns, size)."""
    import torch
    h, w = shape
    mask = torch.zeros(h * w, dtype=torch.bool, device=blocks[0][0].device)
    for top, left, size in blocks:
        ar = torch.arange(size, device=top.device)
        rows = (top[:, None] + ar)[:, :, None].expand(-1, size, size)
        cols = (left[:, None] + ar)[:, None, :].expand(-1, size, size)
        inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
        mask[(rows * w + cols)[inside]] = True
    return int(mask.sum())


# FAST + NMS per pixel: 16 differences; per tap 2 threshold compares, the
# two clamped excesses (2 ops each) and their 2 running sums (128); the two
# arc tests on 16-bit masks, 2 ops a bit to build and 4 doubling steps of
# rotate-and-and (4 ops each) per mask (96); corner flag, max and select
# (3); 8 NMS compares and 8 ors (16).
FAST_OPS_PER_PIXEL = 16 + 16 * 8 + 2 * (32 + 16) + 3 + 16


def fast_flops(shapes):
    return sum(h * w for h, w in shapes) * FAST_OPS_PER_PIXEL


def lk_work(prev_pyr, cur_pyr, pts, start, valid, kw):
    """The work the LK function needs on these inputs, level by level
    (coarsest first): which points run, their template positions and last
    positions, template builds and point-iterations (forward and back),
    read off the plain version (lk_kernel.patch_align_plain and its
    iteration loop lk_kernel._run) during one call of it."""
    from trackingbench_slam_tpu_torch.ops.cuda import lk_kernel
    levels = []
    real_run, real_align = lk_kernel._run, lk_kernel.patch_align_plain

    def observed_run(*args):
        out = real_run(*args)
        levels[-1]["loops"].append((args[9], out[5]))   # (entering, iters)
        return out

    def observed_align(prev, cur, tpl_xy, init, *args):
        levels.append(dict(prev=tuple(prev.shape), cur=tuple(cur.shape),
                           tpl_xy=tpl_xy, loops=[]))
        out = real_align(prev, cur, tpl_xy, init, *args)
        levels[-1]["xy"] = out[0]
        return out

    lk_kernel._run = observed_run
    lk_kernel.patch_align_plain = observed_align
    try:
        lk_kernel.lk_align_plain(prev_pyr, cur_pyr, pts, start, valid, **kw)
    finally:
        lk_kernel._run = real_run
        lk_kernel.patch_align_plain = real_align
    for lv in levels:
        lv["run"] = lv["loops"][0][0]
    loops = [lp for lv in levels for lp in lv["loops"]]
    return dict(levels=levels, run=levels[-1]["run"],
                templates=sum(int(r.sum()) for r, _ in loops),
                iterations=sum(int(n.sum()) for _, n in loops))


# LK: a bilinear tap is 9 flops; a template pixel adds 2 gradients (4) and
# 5 sums (8); an iteration pixel a residual and 3 sums (6); the error pass
# (level 0 only: the function returns that level's error) a residual, abs
# and sum (3).
def lk_flops(work, half):
    P = 2 * half + 1
    return (work["templates"] * ((P + 2) ** 2 * 9 + P * P * 12)
            + work["iterations"] * P * P * 15
            + int(work["run"].sum()) * P * P * 12)


def lk_bytes(work, n, half, fb, offset):
    """At every level, the pixels under the run points' templates in prev
    ((P+3)^2 each) and under their last search sample in cur ((P+1)^2, and
    at level 0 the (P+3)^2 back-track template where one is built), plus
    the point I/O."""
    import torch
    P = 2 * half + 1
    px = 0
    for i, lv in enumerate(work["levels"]):
        run = lv["run"]
        t = torch.floor(lv["tpl_xy"][run]).long()
        x = torch.floor(lv["xy"][run]).long()
        blocks = [(x[:, 1] - half, x[:, 0] - half, P + 1)]
        if fb and i == len(work["levels"]) - 1:
            back = lv["loops"][1][0]   # the points the back-track ran
            xb = torch.floor(lv["xy"][back]).long()
            blocks.append((xb[:, 1] - half - 1, xb[:, 0] - half - 1, P + 3))
        px += (covered_pixels(lv["prev"], [(t[:, 1] - half - 1,
                                             t[:, 0] - half - 1, P + 3)])
               + covered_pixels(lv["cur"], blocks))
    inputs = n * (17 + (8 if offset else 0))
    return 4 * px + inputs + n * (13 + (5 if fb else 0))


def lk_terms(work, n, kw):
    """(bytes, operations) of an LK call from its work (lk_work)."""
    return (lk_bytes(work, n, kw["half"], kw.get("fb_iters", 0) > 0,
                     kw.get("offset") is not None),
            lk_flops(work, kw["half"]))


def check_fast(pyr, threshold, arc, where="main path"):
    """The batched launch over the ORB pyramid, exact on every level."""
    import torch
    from trackingbench_slam_tpu_torch.kernel_bench import time_ms
    from trackingbench_slam_tpu_torch.ops.cuda import fast_kernel
    got = fast_kernel.fast_score_nms_cuda(pyr, threshold, arc)
    levels, err = [], 0.0
    for img, g in zip(pyr, got):
        ref = fast_kernel.fast_score_nms_plain(img, threshold, arc)
        e = float((g - ref).abs().max())
        if not torch.equal(g, ref):
            raise AssertionError(f"FAST kernel differs on {tuple(img.shape)}:"
                                 f" max |diff| {e}")
        err = max(err, e)
        levels.append(dict(shape=list(img.shape), corners=int((g > 0).sum())))
    ms, host_ms = time_ms(lambda: fast_kernel.fast_score_nms_cuda(
        pyr, threshold, arc), 50)
    plain_ms, _ = time_ms(lambda: [fast_kernel.fast_score_nms_plain(
        img, threshold, arc) for img in pyr], 5)
    shapes = [tuple(img.shape) for img in pyr]
    b, by = bound(sum(h * w for h, w in shapes) * 8, fast_flops(shapes))
    return [dict(case=f"{where}: {len(pyr)}-level ORB pyramid, one launch",
                 levels=levels, max_abs_err=err, ms=ms, host_ms=host_ms,
                 plain_ms=plain_ms, bound_ms=b, bound_by=by,
                 _call=functools.partial(fast_kernel.fast_score_nms_cuda, pyr,
                                         threshold, arc))]


# ORB describe per valid point: two multiply-adds for each of the circle's
# pixels (4 ops each), atan2 (~20) and the bin (6), 256 compares and 256
# shift-ors to pack them.
def orb_ops_per_point():
    from trackingbench_slam_tpu_torch.ops import orb
    return 4 * int(orb._circle_umax_mask().sum()) + 20 + 6 + 2 * 256


def orb_describe_agreement(raw, blurred, xy, valid, counts, got=None):
    """Kernel against plain on one call (or on the kernel's output `got` of
    these inputs); returns (max wrapped angle error over valid rows, share
    of valid rows whose angle bins agree)."""
    import torch
    from trackingbench_slam_tpu_torch.ops import orb
    from trackingbench_slam_tpu_torch.ops.cuda import patch_kernel
    args = (raw, blurred, xy, valid, counts)
    got_a, got_d = patch_kernel.orb_describe_cuda(*args) if got is None \
        else got
    ref_a, ref_d = patch_kernel.orb_describe_plain(*args)
    torch.cuda.synchronize()
    d = torch.remainder(got_a - ref_a + torch.pi, 2 * torch.pi) - torch.pi
    err = float(d[valid].abs().max())
    same_bin = orb.angle_bins(got_a) == orb.angle_bins(ref_a)
    bins_agree = float(same_bin[valid].float().mean())
    own = torch.cat([orb.brief_from_patches(
        patch_kernel.extract_patches32_plain(blur, p), a, v)
        for blur, p, a, v in zip(blurred, xy.split(counts),
                                 got_a.split(counts), valid.split(counts))])
    invalid_zero = bool((got_a[~valid] == 0).all() & (got_d[~valid] == 0).all())
    if not (err <= 1e-5 and bins_agree >= 0.999 and torch.equal(got_d, own)
            and torch.equal(got_d[same_bin], ref_d[same_bin])
            and invalid_zero):
        raise AssertionError(
            f"orb_describe differs: max |d angle| {err}, bins agree "
            f"{bins_agree:.5f}, desc == brief on own angles "
            f"{torch.equal(got_d, own)}, desc == plain where bins agree "
            f"{torch.equal(got_d[same_bin], ref_d[same_bin])}, invalid rows "
            f"zero {invalid_zero}")
    return err, bins_agree


def orb_terms(raw, xy, valid, counts):
    """(bytes, operations) an ORB describe call needs: the two crops of
    every valid point, the table, the point I/O."""
    from trackingbench_slam_tpu_torch.ops.cuda import patch_kernel
    px = 0
    for img, p, v in zip(raw, xy.split(counts), valid.split(counts)):
        r0, c0 = patch_kernel.patch_origins(p[v], *img.shape)
        px += covered_pixels(img.shape, [(r0, c0, patch_kernel.PATCH)])
    table = patch_kernel.brief_pairs(xy.device)
    return (2 * 4 * px + xy.shape[0] * (8 + 1 + 4 + 32)
            + table.numel() * table.element_size(),
            int(valid.sum()) * orb_ops_per_point())


def cells_terms(img, kp_xy, slots, want, cap):
    """(bytes, operations) an anchor-cell call needs: each wanted cell's
    17x17 source block, its 16x16 cell written, the point I/O."""
    import torch
    from trackingbench_slam_tpu_torch.ops.cuda import patch_kernel
    c = patch_kernel.CELL
    ok = want & (slots >= 0) & (slots < cap)
    n, n_ok = kp_xy.shape[0], int(ok.sum())
    r0, c0 = patch_kernel.patch_origins(torch.floor(kp_xy[ok]) + 7.0,
                                        *img.shape)
    px = covered_pixels(img.shape, [(r0, c0, c + 1)])
    return 4 * px + n_ok * c * c * 4 + n * (8 + 4 + 1), n_ok * (c * c * 9 + 4)


def check_orb_describe(case, where="main path bootstrap keyframe"):
    """One extraction's describe in one launch for all levels; and the same
    call with every 7th row invalid (the main path's bootstrap has none,
    later keyframes do)."""
    import torch
    from trackingbench_slam_tpu_torch.kernel_bench import time_ms
    from trackingbench_slam_tpu_torch.ops.cuda import patch_kernel
    raw, blurred, xy, valid, counts = case
    args = (raw, blurred, xy, valid, counts)
    err, bins_agree = orb_describe_agreement(*args)
    holes = valid & (torch.arange(xy.shape[0], device=xy.device) % 7 != 0)
    orb_describe_agreement(raw, blurred, xy, holes, counts)
    ms, host_ms = time_ms(lambda: patch_kernel.orb_describe_cuda(*args), 50)
    plain_ms, _ = time_ms(lambda: patch_kernel.orb_describe_plain(*args), 10)
    n, n_valid = xy.shape[0], int(valid.sum())
    b, by = bound(*orb_terms(raw, xy, valid, counts))
    return [dict(case=f"{where}: {len(raw)}-level ORB describe, one launch",
                 shapes=[list(img.shape) for img in raw], n=n,
                 valid=n_valid, counts=list(counts), bins_agree=bins_agree,
                 also_checked="every 7th row invalid",
                 max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                 bound_ms=b, bound_by=by, library_ms=None,
                 _call=functools.partial(patch_kernel.orb_describe_cuda,
                                         *args))]


def check_anchor_cells(case, where="bootstrap keyframe"):
    """One keyframe's anchor cells written into the map's atlas."""
    import torch
    import torch.nn.functional as F
    from trackingbench_slam_tpu_torch.kernel_bench import time_ms
    from trackingbench_slam_tpu_torch.ops.cuda import patch_kernel
    img, kp_xy, slots, want = (case[k] for k in ("img", "kp_xy", "slots",
                                                 "want"))
    atlas, cap = case["atlas"], case["capacity"]
    args = (img, kp_xy, slots, want, atlas, cap)
    before = atlas.clone()
    got = patch_kernel.anchor_cells_cuda(*args)
    ref = patch_kernel.anchor_cells_plain(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not torch.equal(got, ref) or not torch.equal(atlas, before):
        raise AssertionError(f"anchor_cells differs: max |diff| {err}, input "
                             f"atlas kept {torch.equal(atlas, before)}")
    ok = want & (slots >= 0) & (slots < cap)
    n, n_ok = kp_xy.shape[0], int(ok.sum())
    scratch = atlas.clone()
    ms, _ = time_ms(lambda: patch_kernel.anchor_cells_into(
        scratch, img, kp_xy, slots, want, cap), 50)
    call_ms, host_ms = time_ms(lambda: patch_kernel.anchor_cells_cuda(*args),
                               50)
    clone_ms, _ = time_ms(lambda: atlas.clone(), 50)
    plain_ms, _ = time_ms(lambda: patch_kernel.anchor_cells_plain(*args), 10)
    # yardstick: one PyTorch call that blends the same (n_ok, 16, 16) cells
    c = patch_kernel.CELL
    h, w = img.shape
    ar = torch.arange(c, device=img.device, dtype=torch.float32) - c // 2
    xs = (kp_xy[ok, 0][:, None, None] + ar[None, None, :]).expand(-1, c, c)
    ys = (kp_xy[ok, 1][:, None, None] + ar[None, :, None]).expand(-1, c, c)
    grid = torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1],
                       -1).reshape(1, n_ok * c, c, 2)
    image = img[None, None]

    def library():
        return F.grid_sample(image, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)
    library_ms, _ = time_ms(library, 50)
    cells = patch_kernel.bilinear_cell_patches(img, kp_xy)[ok]
    library_diff = float((library().reshape(n_ok, c, c) - cells).abs().max())
    b, by = bound(*cells_terms(img, kp_xy, slots, want, cap))
    return [dict(case=f"{where}, N={n}, {n_ok} cells into a "
                      f"{atlas.shape[0]}^2 atlas",
                 n=n, cells=n_ok, max_abs_err=err, ms=ms, host_ms=host_ms,
                 call_ms=call_ms, clone_ms=clone_ms, plain_ms=plain_ms,
                 bound_ms=b, bound_by=by, library_ms=library_ms,
                 library_max_abs_diff=library_diff,
                 _call=functools.partial(patch_kernel.anchor_cells_into,
                                         scratch, img, kp_xy, slots, want,
                                         cap))]


def check_lk(cases):
    import torch
    from trackingbench_slam_tpu_torch.kernel_bench import time_ms
    from trackingbench_slam_tpu_torch.ops.cuda import lk_kernel
    out = []
    for name, _, prev, cur, pts, start, valid, kw in cases:
        args = (prev, cur, pts, start, valid)
        before = lk_kernel.lk_align_cuda.launches
        got = lk_kernel.lk_align_cuda(*args, **kw)
        launches = lk_kernel.lk_align_cuda.launches - before
        ref = lk_kernel.lk_align_plain(*args, **kw)
        torch.cuda.synchronize()
        both = got[1] & ref[1]
        agree = float((got[1] == ref[1]).float().mean())
        err = float((got[0] - ref[0])[both].abs().max()) if bool(
            both.any()) else 0.0
        if agree < 0.99 or err > 1e-3 or int(both.sum()) == 0:
            raise AssertionError(f"LK kernel differs ({name}): flags agree "
                                 f"{agree:.4f}, max |dxy| {err}")
        fb = kw.get("fb_iters", 0) > 0
        fb_agree = None
        if fb:
            fb_agree = float((got[3] == ref[3]).float().mean())
            if fb_agree < 0.99:
                raise AssertionError(f"LK fb flags differ ({name}): "
                                     f"{fb_agree:.4f}")
        n = pts.shape[0]
        ms, host_ms = time_ms(lambda: lk_kernel.lk_align_cuda(*args, **kw),
                              20)
        plain_ms, _ = time_ms(lambda: lk_kernel.lk_align_plain(*args, **kw),
                              3)
        work = lk_work(*args, kw)
        b, by = bound(*lk_terms(work, n, kw))
        out.append(dict(case=name, levels=len(prev), shape=list(cur[0].shape),
                        n=n, launches_per_call=launches,
                        converged=int(ref[1].sum()), flags_agree=agree,
                        fb_flags_agree=fb_agree, max_abs_err=err, ms=ms,
                        host_ms=host_ms, plain_ms=plain_ms, bound_ms=b,
                        bound_by=by,
                        work=dict(points_run=[int(lv["run"].sum())
                                              for lv in work["levels"]],
                                  templates=work["templates"],
                                  iterations=work["iterations"]),
                        _call=functools.partial(lk_kernel.lk_align_cuda,
                                                *args, **kw)))
    return out


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_counted(counters, device, frames, track, warm):
    """Tracks `frames` (`track(i, frame)` each) with every kernel counter
    zeroed just before; returns (frames/s over the frames after `warm`,
    launches per counter)."""
    for fn in counters.values():
        fn.launches = 0
    for i in range(warm):
        track(i, frames[i])
    sync(device)
    t0 = time.perf_counter()
    for i in range(warm, len(frames)):
        track(i, frames[i])
    sync(device)
    fps = (len(frames) - warm) / (time.perf_counter() - t0)
    return fps, {k: fn.launches for k, fn in counters.items()}


def drive(vo, frames, counters, rows=None, draws=None):
    """A StereoVO over `frames` (run_counted after an 11-frame warm-up);
    returns (frames/s, launches per counter, the timed frames after which
    the tracker flagged itself lost). `rows` (parity.StereoRows) takes
    every frame's row; with `draws` (parity.RecordedDraws) the RANSAC
    draws are the record's."""
    lost = []

    def track(i, frame):
        if draws is not None:
            draws.at = i
        if rows is not None:
            rows.before(vo)
        vo.track(*frame)
        if rows is not None:
            rows.after(vo)
        if vo.lost and i >= WARM_FRAMES:
            lost.append(i)
    with draws.installed() if draws else contextlib.nullcontext():
        return (*run_counted(counters, vo.device, frames, track,
                             WARM_FRAMES), lost)


def main_path(cfg, frames, gt, counters, device):
    """One StereoVO over the corridor frames; returns (vo, figures)."""
    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    from trackingbench_slam_tpu_torch.utils import metrics
    vo = StereoVO(cfg, device=device)
    fps, launches, lost = drive(vo, frames, counters)
    poses = vo.poses()
    if poses.shape != (len(frames), 4, 4) or not np.isfinite(poses).all():
        raise AssertionError(f"bad trajectory: {poses.shape}")
    return vo, dict(frames=len(frames), timed=len(frames) - WARM_FRAMES,
                    fps=fps, ate_m=metrics.ate_rmse(poses, gt, align=True),
                    last_inliers=int(vo.state.num_inliers),
                    landmarks=int(vo.state.map.valid.sum()),
                    ba_calls=vo.ba_calls, launches=launches,
                    lost_frames=lost)


def ba_call_ms(vo, reps=3):
    """Fenced host ms of local_ba_step on the run's final state."""
    from trackingbench_slam_tpu_torch.models.local_mapping import \
        local_ba_step
    out = []
    for _ in range(reps):
        sync(vo.device)
        t0 = time.perf_counter()
        local_ba_step(vo.state, vo.cam, vo.cfg)
        sync(vo.device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def time_methods(obj, names):
    """Wraps each named method of `obj` to sum the host seconds spent in it
    (not fenced: the run is host-bound) and count its calls; `last_args`
    keeps each method's last arguments."""
    spent = {n: [0.0, 0] for n in names}
    last_args = {}
    for name in names:
        def timed(*args, _real=getattr(obj, name), _name=name, **kwargs):
            last_args[_name] = (args, kwargs)
            t0 = time.perf_counter()
            try:
                return _real(*args, **kwargs)
            finally:
                spent[_name][0] += time.perf_counter() - t0
                spent[_name][1] += 1
        setattr(obj, name, timed)
    return spent, last_args


def first_difference(a, b):
    """The first index at which two equal-length pose stacks are not
    torch.equal (None if none), and their largest difference."""
    import torch
    first = next((i for i in range(len(a)) if not torch.equal(a[i], b[i])),
                 None)
    return first, float((a - b).abs().max())


def loop_bench(cfg, frames, gt, counters, device, rec):
    """bench.py's loop_closing_bench on the port: the same frames without
    the closer twice (the second run repeats the first, pose for pose) and
    with a LoopCloser (runs A and B, on the card's vocabulary and the
    port's own draws), then C without the closer on run A's recorded
    draws and D with the closer on the record's vocabulary and run B's
    draws. Every run is held to the JAX record (runs A and B of
    records/jax_full_width.npz) frame by frame."""
    import torch
    from trackingbench_slam_tpu_torch import parity
    from trackingbench_slam_tpu_torch.models.loop_closer import LoopCloser
    from trackingbench_slam_tpu_torch.repeat_check import train_vocabulary
    from trackingbench_slam_tpu_torch.utils.corridor import closing_error
    t0 = time.perf_counter()
    voc, n_desc = train_vocabulary(cfg, frames, device)
    out = dict(vocabulary=dict(descriptors=n_desc, words=voc.num_words,
                               seconds=time.perf_counter() - t0))
    rec_voc = parity.record_vocabulary(rec, "loop.voc", device)
    trajectories = []
    for key, run_voc, prefix, draws in (
            ("without_closer", None, "loop.A", None),
            ("without_closer_again", None, "loop.A", None),
            ("with_closer", voc, "loop.B", None),
            ("recorded_without_closer", None, "loop.A",
             parity.RecordedDraws(rec, "loop.A")),
            ("recorded_with_closer", rec_voc, "loop.B",
             parity.RecordedDraws(rec, "loop.B"))):
        with_lc = run_voc is not None
        n = LOOP_B_FRAMES if key == "with_closer" else len(frames)
        vo = parity.loop_bench_tracker(cfg, device, run_voc)
        # where the closer's host time goes, over all the run's frames
        spent, _ = time_methods(vo, ["_track_keyframe_with_loop",
                                     "_finish_loop_detect", "_close_loop",
                                     "_relocalize"] if with_lc else [])
        if key == "with_closer":
            closer_spent, closer_args = time_methods(vo.loop_closer, [
                "_issue_verify", "_finish_verify", "correct_trajectory"])
            spent.update(closer_spent)
        rows = parity.StereoRows()
        t0 = time.perf_counter()
        fps, launches, lost = drive(vo, frames[:n], counters, rows, draws)
        wall = time.perf_counter() - t0
        if key.startswith("without_closer"):
            trajectories.append(torch.stack(vo.trajectory))
        arrays = rows.arrays(vo)
        out[key] = dict(
            frames=n, fps=fps,
            closing_err_m=closing_error(arrays["poses"], gt[:n]),
            loops_closed=len(vo.loop_events), loop_events=vo.loop_events,
            reloc_events=vo.reloc_events, lost_frames=lost,
            ba_calls=vo.ba_calls, launches=launches, run_s=wall,
            host_s_in=spent,
            parity=parity.compare_stereo(rec, prefix, arrays),
            rows=dict({k: np.asarray(arrays[k]).tolist() for k in (
                "inliers", "lost", "keyframe", "ba", "landmarks")},
                centres=parity.centres(arrays["T_cw"]).tolist()))
        if draws is not None:
            out[key].update(draws_used=draws.used,
                            draws_missing=draws.missing)
    first, diff = first_difference(*trajectories)
    out["repeat"] = dict(identical=first is None, first_frame_differing=first,
                         max_pose_diff=diff)
    # the run's last pose-graph correction again, twice, fenced: the first
    # call in a process pays one-off costs that these do not
    args, kwargs = closer_args.get("correct_trajectory", (None, None))
    out["with_closer"]["correct_trajectory_again_s"] = []
    for _ in range(2 if args else 0):
        sync(device)
        t0 = time.perf_counter()
        LoopCloser.correct_trajectory(*args, **kwargs)
        sync(device)
        out["with_closer"]["correct_trajectory_again_s"].append(
            time.perf_counter() - t0)
    return out


def closed_loops(counters, device, rec, parts, own):
    """Runs around closed circles of the record (parity.part_frames), each
    loop held to ground truth (parity.loop_views): for each (key, part) of
    `parts` the part's run with the closer on the record's vocabulary and
    draws, held to the record (parity.compare_stereo, held_every_frame);
    on the first part's circle, runs on the port's own draws and a
    vocabulary trained here: `own`_without closer-less at RANSAC seed
    F_SEEDS[0] and `own`_seed<s> with the closer at each of F_SEEDS, each
    gated by parity.tracked_loop_gate against the closer-less one."""
    from trackingbench_slam_tpu_torch import parity
    from trackingbench_slam_tpu_torch.repeat_check import train_vocabulary
    from trackingbench_slam_tpu_torch.utils.corridor import closing_error
    t0 = time.perf_counter()
    circles = {key: parity.part_frames(rec, part) for key, part in parts}
    cfg, frames, gt, _ = circles[parts[0][0]]
    out = dict(frames=len(frames),
               size=f"{cfg.camera.width}x{cfg.camera.height}",
               render_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    voc, n_desc = train_vocabulary(cfg, frames, device,
                                   every=parity.VOC_EVERY["loop_tracked"])
    out["vocabulary"] = dict(descriptors=n_desc, words=voc.num_words,
                             seconds=time.perf_counter() - t0)
    runs = [(key, parity.record_vocabulary(rec, f"{part}.voc", device),
             None, *circles[key][1:]) for key, part in parts]
    runs += [(f"{own}_without", None, F_SEEDS[0], frames, gt, None)]
    runs += [(f"{own}_seed{s}", voc, s, frames, gt, None) for s in F_SEEDS]
    for key, run_voc, seed, run_frames, run_gt, prefix in runs:
        vo = parity.loop_bench_tracker(cfg, device, run_voc, seed)
        rows = parity.StereoRows()
        draws = prefix and parity.RecordedDraws(rec, prefix)
        t0 = time.perf_counter()
        fps, launches, _ = drive(vo, run_frames, counters, rows, draws)
        arrays = rows.arrays(vo)
        out[key] = dict(
            fps=fps, run_s=time.perf_counter() - t0, seed=seed,
            closing_err_m=closing_error(arrays["poses"], run_gt),
            loops=list(vo.loop_events), relocs=list(vo.reloc_events),
            lost=np.flatnonzero(arrays["lost"]).tolist(),
            min_inliers=int(arrays["inliers"][1:].min()),
            ba_frames=np.flatnonzero(arrays["ba"]).tolist(),
            ba_calls=vo.ba_calls, launches=launches,
            loop_views=parity.loop_views(run_gt, vo.loop_matches,
                                         parity.hfov(cfg)))
        if draws:
            par = parity.compare_stereo(rec, prefix, arrays)
            par["held_every_frame"] = parity.held_every_frame(par)
            par.pop("diff_m", None)
            out[key].update(parity=par, draws_used=draws.used,
                            draws_missing=draws.missing)
    for s in F_SEEDS:
        out[f"{own}_seed{s}"]["gate"] = parity.tracked_loop_gate(
            out[f"{own}_seed{s}"], out[f"{own}_without"], len(frames))
    return out


def closed_loops_checked(name, out, held, own, log, from_start=False):
    """Logs closed_loops' runs and raises unless each run held to the
    record is held as `held` asks ({key: "every frame" or "well posed"}),
    every run launched every kernel and matched keyframes whose true views
    overlap its queries', and each closer run on the port's own draws
    passes its gate and, with `from_start`, closed its last loop on a
    keyframe of the circle's start (parity.revisits_start)."""
    from trackingbench_slam_tpu_torch import parity
    for key in held:
        e = out[key]
        par = e["parity"]
        log(f"[{name} {key}] {par['frames']} frames, the record's "
            f"vocabulary and draws ({e['draws_used']} used, "
            f"{e['draws_missing']} missing): max distance from JAX "
            f"{par['max_diff_m']:.5f} m (first frame > 1 cm "
            f"{par['first_parting']}; {par['max_diff_well_posed_m']:.5f} m "
            f"over the {par['well_posed_frames']} frames before the record's"
            f" first below {parity.WELL_POSED_INLIERS} inliers), keyframes "
            f"equal {par['keyframes_equal']}, BA equal {par['ba_equal']}, "
            f"loops port {par['loops_port']} jax {par['loops_jax']}, matched "
            f"nodes port {par['loop_nodes_port']} jax "
            f"{par['loop_nodes_jax']}, relocalizations port "
            f"{par['relocs_port']} jax {par['relocs_jax']}, lost port "
            f"{par['lost_port']} jax {par['lost_jax']}; closing error port "
            f"{par['closing_err_port_m']:.4f} m jax "
            f"{par['closing_err_jax_m']:.4f} m; min inliers "
            f"{e['min_inliers']}, BA at {e['ba_frames']}; {e['fps']:.2f} "
            f"frames/s; held at every frame {par['held_every_frame']}, while "
            f"well posed {par['held']}; loops against ground truth "
            f"{e['loop_views']}")
    for key in [f"{own}_without"] + [f"{own}_seed{s}" for s in F_SEEDS]:
        f = out[key]
        log(f"[{name} {key}] seed {f['seed']}, "
            f"{'with' if 'gate' in f else 'without'} the closer: closing "
            f"error {f['closing_err_m']:.4f} m, loops {f['loops']}, "
            f"relocalizations {f['relocs']}, lost {f['lost']}, min inliers "
            f"{f['min_inliers']}, BA at {f['ba_frames']}, {f['fps']:.2f} "
            f"frames/s, launches {f['launches']}; loops against ground "
            f"truth {f['loop_views']}"
            + (f"; gate {f['gate']}" if "gate" in f else ""))
    for key, how in held.items():
        par = out[key]["parity"]
        if not par["held_every_frame" if how == "every frame" else "held"]:
            raise AssertionError(f"{name} {key}: not held to the JAX record "
                                 f"at {how}: {par}")
    keys = list(held) + [f"{own}_without"] + [f"{own}_seed{s}"
                                              for s in F_SEEDS]
    for key in keys:
        missing = [k for k, v in out[key]["launches"].items() if v == 0]
        if missing:
            raise AssertionError(f"{name} {key}: kernels not launched: "
                                 f"{missing}")
        false = [v for v in out[key]["loop_views"] if not v["overlap"]]
        if false:
            raise AssertionError(f"{name} {key}: loops whose views do not "
                                 f"overlap in ground truth: {false}")
    failed = [s for s in F_SEEDS if not out[f"{own}_seed{s}"]["gate"][
        "passed"] or (from_start and not parity.revisits_start(
            [(v["query"], v["match"]) for v in out[f"{own}_seed{s}"][
                "loop_views"]]))]
    if failed:
        raise AssertionError(f"{name} {own} failed its gates at seeds "
                             f"{failed}: {out}")


def record_frames_agree(rec, name, frames):
    """The first and last frame rendered here hash to the record's."""
    from trackingbench_slam_tpu_torch import parity
    got = [parity.frame_sha(frames[0]), parity.frame_sha(frames[-1])]
    if got != rec[f"{name}.frame_sha"].tolist():
        raise AssertionError(f"{name}: frames differ from the record's "
                             f"(sha256 {got})")


def held_poses(rec, prefix, poses):
    """parity.compare_poses of a run against its record, without the
    per-frame distances; `held` when every frame is within 1 cm."""
    from trackingbench_slam_tpu_torch import parity
    out = parity.compare_poses(poses, rec[f"{prefix}.T_cw"])
    out.pop("diff_m")
    out["held"] = (out["first_parting"] is None
                   and out["frames"] == len(rec[f"{prefix}.T_cw"]))
    return out


@contextlib.contextmanager
def watched(module, name, pick, last=False, every=False, keep=None):
    """While inside, calls of module.<name> go through unchanged; the
    arguments (args, kwargs) of the first call that `pick` accepts (with
    `last`, of the last one; with `every`, of each, in order) are kept in
    the yielded list. `keep(args, kwargs)`, where given, is what is kept,
    taken before the call (to copy an argument the call writes)."""
    real = getattr(module, name)
    kept = []

    def call(*args, **kwargs):
        if pick(args, kwargs) and (every or last or not kept):
            item = (args, kwargs) if keep is None else keep(args, kwargs)
            if every:
                kept.append(item)
            else:
                kept[:] = [item]
        return real(*args, **kwargs)

    setattr(module, name, call)
    try:
        yield kept
    finally:
        setattr(module, name, real)


def lk_case(name, call):
    """An `lk_pyramidal` call's arguments as a check_lk case (the
    `lk_align` call it makes)."""
    (prev_pyr, cur_pyr, pts, valid, scale), kw = call
    levels = min(kw.get("num_levels", 3), len(prev_pyr))
    return (name, "lk_pyramidal", tuple(prev_pyr[:levels]),
            tuple(cur_pyr[:levels]), pts, pts, valid,
            dict(scale=scale, offset=kw.get("init_offset"),
                 half=kw.get("half", 10), iters=kw.get("iters", 30),
                 conv_eps=0.01, fb_iters=kw.get("fb_iters", 0)))


def anchored_case(name, call):
    """An `anchored_align` call's arguments as a check_lk case: one level,
    the templates in the map's atlas."""
    (atlas, img, centers, init_xy, valid), kw = call
    return (name, "anchored_align", (atlas,), (img,), centers, init_xy, valid,
            dict(scale=0.5, half=kw.get("half", 4), iters=kw.get("iters", 10),
                 conv_eps=kw.get("conv_eps", 0.03)))


def gate_launches(name, launches, expected):
    missing = [k for k in expected if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels not launched: {missing}")


def fenced_ms(fn, device, reps=3):
    """fn()'s host ms a call, fenced, after one warm-up call."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / reps


def profile_call(phases, fn):
    """One call of fn() under torch.profiler, after a warm-up call: the
    device ms of the kernels it launched, their count, and the five kernels
    with the most device time (name, ms)."""
    from trackingbench_slam_tpu_torch.profile_main_path import device_events
    fn()
    prof, _ = phases.profiled(fn)
    device_ev = device_events(prof.key_averages())
    top = sorted(device_ev, key=lambda e: -e.self_device_time_total)[:5]
    return dict(device_ms=sum(e.self_device_time_total
                              for e in device_ev) / 1e3,
                cuda_kernels=sum(e.count for e in device_ev),
                top_device_ms=[[e.key[:100], e.self_device_time_total / 1e3]
                               for e in top])


def direct_phase(counters, device, rec):
    """DirectVO at bench.py's camera on the reference's direct pyramid: 24
    corridor frames, stereo on the first only, so every later landmark is a
    promoted depth-filter seed; held to the JAX record frame by frame.
    Returns (figures, the seed LK call as a check_lk case, the run's last
    sparse_image_align and features_align calls to profile)."""
    from trackingbench_slam_tpu_torch.matchers import direct
    from trackingbench_slam_tpu_torch.models import direct_vo
    from trackingbench_slam_tpu_torch.utils import metrics
    from trackingbench_slam_tpu_torch.utils.corridor import (direct_config,
                                                             direct_frames)
    cfg = direct_config()
    t0 = time.perf_counter()
    frames, gt = direct_frames(cfg, len(rec["direct.T_cw"]))
    render_s = time.perf_counter() - t0
    record_frames_agree(rec, "direct", frames)
    vo = direct_vo.DirectVO(cfg, device=device)
    with watched(direct_vo, "lk_pyramidal",
                 lambda a, k: k.get("half") == 6) as seed, \
            watched(direct, "sparse_image_align", lambda a, k: True,
                    last=True) as sia, \
            watched(direct, "features_align", lambda a, k: True,
                    last=True) as fa:
        fps, launches = run_counted(counters, device, frames,
                                    lambda i, f: vo.track(*f), WARM_DIRECT)
    poses = vo.poses()
    fig = dict(frames=len(frames), timed=len(frames) - WARM_DIRECT, fps=fps,
               render_s=render_s,
               ate_m=metrics.ate_rmse(poses, gt, align=True),
               num_tracked=vo.num_tracked, num_promoted=vo.num_promoted,
               finite=bool(np.isfinite(poses).all()), launches=launches,
               parity=dict(held_poses(rec, "direct", poses),
                           jax_tracked=int(rec["direct.tracked"][-1]),
                           jax_promoted=int(rec["direct.promoted"][-1])))
    # the two direct stages on the run's last call: fenced here, profiled
    # in the profiles phase
    stages = {}
    for key, (module_fn, call) in {"sparse_image_align": (
            direct.sparse_image_align, sia), "features_align": (
            direct.features_align, fa)}.items():
        args, kwargs = call[0]
        stages[key] = functools.partial(module_fn, *args, **kwargs)
        fig[key] = dict(host_ms=fenced_ms(stages[key], device))
    return fig, lk_case("direct seed, half 6, 2 levels, prior",
                        seed[0]), stages


def indirect_calls(stack, cfg):
    """Watches (on `stack`) the kernel calls of an IndirectVO run: the last
    frame's FAST over the full pyramid, ORB describe, anchor cells, stereo
    LK with a prior and anchored LK, and the first frame's stereo LK over
    every LK level. Returns {name: kept call list}."""
    from trackingbench_slam_tpu_torch.models import extractors
    from trackingbench_slam_tpu_torch.models import map as map_mod
    from trackingbench_slam_tpu_torch.models import vo as vo_mod
    levels = cfg.pyramid.num_levels
    return {name: stack.enter_context(watched(module, fn, pick, last))
            for name, (module, fn, pick, last) in {
                "fast": (extractors, "detect_scores",
                         lambda a, k: len(a[0]) == levels, True),
                "orb": (extractors, "orb_describe", lambda a, k: True, True),
                "anchor": (map_mod, "write_anchor_patches",
                           lambda a, k: True, True),
                "stereo_bootstrap": (vo_mod, "lk_pyramidal",
                                     lambda a, k: k.get("num_levels") != 2,
                                     False),
                "stereo": (vo_mod, "lk_pyramidal",
                           lambda a, k: k.get("num_levels") == 2, True),
                "anchored": (vo_mod, "anchored_align", lambda a, k: True,
                             True)}.items()}


def indirect_phase(counters, device, rec):
    """IndirectVO at the EuRoC operating point (752x480, 2000 features, 5
    levels x0.8), 12 stereo corridor frames, each of the five strategies;
    BoW on the JAX record's vocabulary (trained on the JAX package's ORB of
    every 3rd left image); every run held to its JAX record frame by
    frame. Returns (figures, the kernel calls of the first strategy's
    run)."""
    from trackingbench_slam_tpu_torch import parity
    from trackingbench_slam_tpu_torch.models.indirect_vo import (
        IndirectVO, MatchStrategy)
    from trackingbench_slam_tpu_torch.utils import metrics
    from trackingbench_slam_tpu_torch.utils.config import euroc_stereo_config
    from trackingbench_slam_tpu_torch.utils.corridor import indirect_frames
    cfg = euroc_stereo_config()
    t0 = time.perf_counter()
    frames, gt = indirect_frames(cfg, len(rec["indirect.nn.T_cw"]))
    out = dict(render_s=time.perf_counter() - t0)
    record_frames_agree(rec, "indirect", frames)
    voc = parity.record_vocabulary(rec, "indirect.voc", device)
    out["vocabulary"] = dict(descriptors=int(rec["indirect.voc.descriptors"]),
                             words=voc.num_words, source="JAX record")
    calls = None
    for s in MatchStrategy:
        vo = IndirectVO(cfg, s, voc=voc if s is MatchStrategy.BOW else None,
                        device=device)
        with contextlib.ExitStack() as stack:
            if calls is None:
                calls = indirect_calls(stack, cfg)
            fps, launches = run_counted(counters, device, frames,
                                        lambda i, f: vo.track(*f), 1)
        poses = vo.poses()
        out[s.value] = dict(
            frames=len(frames), timed=len(frames) - 1, fps=fps,
            ate_m=metrics.ate_rmse(poses, gt, align=True),
            last_inliers=int(vo.state.num_inliers),
            finite=bool(np.isfinite(poses).all()), launches=launches,
            parity=dict(held_poses(rec, f"indirect.{s.value}", poses),
                        jax_last_inliers=int(
                            rec[f"indirect.{s.value}.inliers"][-1])))
    missing = [k for k, v in calls.items() if not v]
    if missing:
        raise AssertionError(f"indirect: calls not seen: {missing}")
    (pyr, threshold, arc), _ = calls["fast"][0]
    (raw, blurred, xy, valid, counts), _ = calls["orb"][0]
    (m, img, kp_xy, slots, want), _ = calls["anchor"][0]
    w = f"{cfg.camera.width}x{cfg.camera.height}"
    cases = dict(
        fast=(tuple(pyr), threshold, arc),
        orb=(tuple(raw), tuple(blurred), xy, valid, list(counts)),
        anchor=dict(img=img, kp_xy=kp_xy, slots=slots, want=want,
                    capacity=m.capacity, atlas=m.anchor_atlas),
        lk=[lk_case(f"indirect stereo {w}, 2 levels + fb, prior",
                    calls["stereo"][0]),
            lk_case(f"indirect first stereo {w}, 4 levels + fb",
                    calls["stereo_bootstrap"][0]),
            anchored_case(f"indirect anchored {w}", calls["anchored"][0])])
    return out, cases


def mono_phase(counters, device, rec):
    """MonoVO at the main path's camera, pyramid, features and map: 28
    lateral corridor frames, left images only, on the JAX record's RANSAC
    draws (bootstrap and track steps); held to the record frame by
    frame."""
    from trackingbench_slam_tpu_torch import parity
    from trackingbench_slam_tpu_torch.models import mono_vo
    from trackingbench_slam_tpu_torch.utils import metrics
    from trackingbench_slam_tpu_torch.utils.corridor import (mono_config,
                                                             mono_frames)
    cfg = mono_config()
    t0 = time.perf_counter()
    frames, gt = mono_frames(cfg, len(rec["mono.T_cw"]))
    render_s = time.perf_counter() - t0
    record_frames_agree(rec, "mono", frames)
    vo = mono_vo.MonoVO(cfg, min_parallax_px=20.0, device=device)
    draws = parity.RecordedDraws(rec, "mono")

    def track(i, f):
        draws.at = i
        vo.track(f)
    with watched(mono_vo, "lk_pyramidal", lambda a, k: k.get(
            "num_levels") == 1 and k.get("iters") == 10) as back, \
            draws.installed():
        fps, launches = run_counted(counters, device, frames, track,
                                    WARM_MONO)
    poses = vo.poses()
    fig = dict(frames=len(frames), timed=len(frames) - WARM_MONO, fps=fps,
               render_s=render_s, initialized=vo.initialized,
               finite=bool(np.isfinite(poses).all()), launches=launches,
               keyframes=vo.kf_count, ba_calls=vo.ba_calls,
               parity=dict(held_poses(rec, "mono", poses),
                           draws_used=draws.used,
                           draws_missing=draws.missing,
                           jax_init_frame=int(rec["mono.init_frame"])))
    if vo.initialized:
        m = vo.state.map
        k0 = next(i for i in range(1, len(frames))
                  if not np.allclose(poses[i], np.eye(4)))
        fig.update(init_frame=k0, ate_m=metrics.ate_rmse(
            poses[k0:], gt[k0:], align=True, with_scale=True),
            landmarks=int(m.valid.sum()),
            landmarks_finite=bool(m.pos[m.valid].isfinite().all()))
    case = (lk_case("mono keyframe back-track, 1 level, 10 iterations",
                    back[0]) if back else None)
    return fig, case


def prefetch_phase(cfg, frames, gt, counters, device, live_traj):
    """The prefetcher's frames against the synchronous upload, then the BA-on
    live loop fed by it against the synchronously fed run's poses."""
    import torch
    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    from trackingbench_slam_tpu_torch.utils import metrics
    from trackingbench_slam_tpu_torch.utils.device import upload_image
    from trackingbench_slam_tpu_torch.utils.prefetch import DevicePrefetcher
    differ = []
    with DevicePrefetcher(frames, depth=2, device=device) as pf:
        for i, (left, right) in enumerate(frames):
            L, R = pf[i]
            same = torch.equal(L, upload_image(left, device)) and (
                (R is None and right is None) or (
                    R is not None and right is not None
                    and torch.equal(R, upload_image(right, device))))
            if not same:
                differ.append(i)
    vo = StereoVO(cfg, device=device)
    with DevicePrefetcher(frames, depth=2, device=device) as pf:
        fps, launches, lost = drive(vo, pf, counters)
    first, diff = first_difference(torch.stack(vo.trajectory), live_traj)
    return dict(frames=len(frames), timed=len(frames) - WARM_FRAMES, fps=fps,
                frames_differing_from_upload=differ,
                ate_m=metrics.ate_rmse(vo.poses(), gt, align=True),
                last_inliers=int(vo.state.num_inliers), launches=launches,
                poses_equal_live=first is None, first_frame_differing=first,
                max_pose_diff_from_live=diff, lost_frames=lost)


def count_syncs(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): the number of
    host syncs it made, and the ten source lines that made the most
    ("file:line": count)."""
    import collections
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return sum(where.values()), dict(where.most_common(10))


def scatter_sync_free(device):
    """The repeated-target row writes (ops/packing.py, models/map.py
    `_set_rows`) under set_sync_debug_mode("error"): they must not sync."""
    import torch
    from trackingbench_slam_tpu_torch.models import map as map_mod
    from trackingbench_slam_tpu_torch.ops import packing
    idx = torch.tensor([3, 1, 3, 9, 1, 0], device=device)
    dst = torch.zeros((8, 4), device=device)
    src = torch.arange(24, dtype=torch.float32, device=device).reshape(6, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a, = packing.scatter_rows_set([dst], idx, [src])
        b = map_mod._set_rows(dst, idx, src)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = dst.clone()
    for i, j in enumerate(idx.tolist()):
        if 0 <= j < 8:
            want[j] = src[i]
    return bool(torch.equal(a, want) and torch.equal(b, want))


def offline_phase(cfg, frames, gt, counters, device, live_traj):
    """OfflineStereoVO on the main path's frames (uploaded once): frames/s,
    launches, ATE, its poses against the live loop's, and the host syncs of
    a second run."""
    import torch
    from trackingbench_slam_tpu_torch.models.offline import OfflineStereoVO
    from trackingbench_slam_tpu_torch.utils import metrics
    vo = OfflineStereoVO(cfg, device=device)
    t0 = time.perf_counter()
    prepared = vo.prepare(frames)
    sync(device)
    upload_s = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = vo.run(prepared=prepared)
    sync(device)
    run_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    traj = torch.cat([vo._T0[None], res.T_cw])
    first, diff = first_difference(traj, live_traj)
    poses = vo.poses()
    syncs, sync_lines = count_syncs(lambda: vo.run(prepared=prepared))
    n_kf = int(prepared[2].sum())
    return dict(frames=len(frames), fps=(len(frames) - 1) / run_s,
                run_s=run_s, upload_s=upload_s,
                ate_m=metrics.ate_rmse(poses, gt, align=True),
                finite=bool(np.isfinite(poses).all()),
                last_inliers=int(res.num_inliers[-1]), launches=launches,
                poses_equal_live=first is None, first_frame_differing=first,
                max_pose_diff_from_live=diff, host_syncs_per_run=syncs,
                host_sync_lines=sync_lines,
                keyframes_in_run=n_kf,
                scatter_writes_sync_free=scatter_sync_free(device))


def photometric_phase(cfg, frames, gt, counters, device):
    """bench.py's photometric_stress_bench on the port: the main path's
    frames through photometric_stress, tracked plain and with CLAHE
    (MatcherConfig.equalize), fed by the prefetcher. Returns (figures, the
    CLAHE run's last track-step LK call as a check_lk case)."""
    import dataclasses
    from trackingbench_slam_tpu_torch.matchers import matcher
    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    from trackingbench_slam_tpu_torch.utils import metrics
    from trackingbench_slam_tpu_torch.utils.prefetch import DevicePrefetcher
    from trackingbench_slam_tpu_torch.utils.synthetic import \
        photometric_stress

    def u8(a):
        return np.clip(a, 0, 255).astype(np.uint8)
    t0 = time.perf_counter()
    stressed = [(u8(photometric_stress(L.astype(np.float32), i)),
                 None if R is None
                 else u8(photometric_stress(R.astype(np.float32), i)))
                for i, (L, R) in enumerate(frames)]
    out = dict(stress_s=time.perf_counter() - t0)
    case = None
    for eq in (False, True):
        c = dataclasses.replace(cfg, matcher=dataclasses.replace(
            cfg.matcher, equalize=eq))
        vo = StereoVO(c, device=device)
        with DevicePrefetcher(stressed, depth=2, device=device) as pf, \
                watched(matcher, "lk_pyramidal", lambda a, k: True,
                        last=True) as calls:
            fps, launches, lost = drive(vo, pf, counters)
        poses = vo.poses()
        out["clahe" if eq else "plain"] = dict(
            frames=len(frames), timed=len(frames) - WARM_FRAMES, fps=fps,
            ate_m=metrics.ate_rmse(poses, gt, align=True),
            last_inliers=int(vo.state.num_inliers),
            finite=bool(np.isfinite(poses).all()), launches=launches,
            lost_frames=lost)
        if eq:
            case = lk_case("CLAHE track, 2 levels, prior, equalized "
                           "pyramids", calls[0])
    return out, case


@contextlib.contextmanager
def written_images(datasets):
    """While inside, the uint8 array of every PNG that the dataset writers
    write is kept in the yielded dict, by path."""
    real = datasets._write_gray_png
    kept = {}

    def write(path, img):
        kept[path] = np.clip(img, 0, 255).astype(np.uint8)
        real(path, img)
    datasets._write_gray_png = write
    try:
        yield kept
    finally:
        datasets._write_gray_png = real


def decoded_exactly(seq, kept):
    """Every frame of `seq` decoded equal to the array written there."""
    loaders = [seq.left] + ([seq.right] if seq.right is not None else [])
    return len(kept) == sum(len(ld) for ld in loaders) and all(
        np.array_equal(ld[i], kept[ld.paths[i]])
        for ld in loaders for i in range(len(ld)))


def export_round_trip(poses, timestamps, d):
    """The largest difference after writing and reading back the KITTI and
    TUM files (poses and TUM timestamps)."""
    from trackingbench_slam_tpu_torch.utils import trajectory_io
    k, t = os.path.join(d, "traj.kitti.txt"), os.path.join(d, "traj.tum.txt")
    trajectory_io.save_kitti_trajectory(k, poses)
    trajectory_io.save_tum_trajectory(t, poses, timestamps)
    ts, P = trajectory_io.load_tum_trajectory(t)
    return max(float(np.abs(trajectory_io.load_kitti_trajectory(k)
                            - poses).max()),
               float(np.abs(P - poses).max()),
               float(np.abs(ts - timestamps).max()))


def sequences_phase(counters, device, out_dir):
    """The recorded-dataset path: sequences written by the package's own
    writers into a temporary directory, read back through its loaders and
    tracked. (a) the corridor in the KITTI layout at the main path's
    widths, (b) real_sequence_eval on a KITTI root, (c) the EuRoC layout,
    (d) undistortion with EuRoC cam0's radtan coefficients on the card
    against the CPU, (e) the demo. Returns (figures, the kernel calls (b)
    recorded)."""
    import dataclasses
    import tempfile
    import torch
    from trackingbench_slam_tpu_torch import demo, sequence_eval
    from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
    from trackingbench_slam_tpu_torch.models import extractors
    from trackingbench_slam_tpu_torch.models import map as map_mod
    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    from trackingbench_slam_tpu_torch.utils import datasets, metrics
    from trackingbench_slam_tpu_torch.utils.config import euroc_stereo_config
    from trackingbench_slam_tpu_torch.utils.corridor import main_path_config
    out = {}
    t_phase = time.perf_counter()

    def track(cfg, frames, gt, warm):
        vo = StereoVO(cfg, device=device)
        fps, launches = run_counted(counters, device, frames,
                                    lambda i, f: vo.track(*f), warm)
        poses = vo.poses()
        return vo, dict(frames=len(frames), timed=len(frames) - warm, fps=fps,
                        ate_m=metrics.ate_rmse(poses, gt, align=True),
                        last_inliers=int(vo.state.num_inliers),
                        finite=bool(np.isfinite(poses).all()),
                        launches=launches, ba_calls=vo.ba_calls)

    with tempfile.TemporaryDirectory() as tmp:
        # (a) the corridor as KITTI PNGs at bench.py's widths
        t0 = time.perf_counter()
        with written_images(datasets) as kept:
            seq = datasets.save_corridor_kitti(os.path.join(tmp, "kitti"),
                                               n_frames=N_FRAMES)
        render_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        exact = decoded_exactly(seq, kept)
        decode_s = time.perf_counter() - t0
        in_memory = [(kept[a], kept[b]) for a, b in zip(seq.left.paths,
                                                        seq.right.paths)]
        del kept
        # the writer's camera: bench.py's focal length, centred
        h, w = seq.left[0].shape
        cfg = main_path_config()
        cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
            cfg.camera, cx=w / 2, cy=h / 2))
        vo, fig = track(cfg, seq, seq.gt_T_cw, WARM_FRAMES)
        # the same frames from memory: what reading them from disk costs
        vo_mem, mem = track(cfg, in_memory, seq.gt_T_cw, WARM_FRAMES)
        first, _ = first_difference(torch.stack(vo.trajectory),
                                    torch.stack(vo_mem.trajectory))
        fig.update(render_s=render_s, decoded_exactly=exact,
                   decode_all_s=decode_s, fps_in_memory=mem["fps"],
                   poses_equal_in_memory=first is None,
                   export_max_diff=export_round_trip(vo.poses(),
                                                     seq.timestamps, tmp))
        out["kitti_layout"] = fig
        del vo, vo_mem, seq, in_memory

        # (b) the reference's protocol on a KITTI root of .npy frames, its
        # last keyframe's FAST, ORB describe and anchor cells recorded
        root = os.path.join(tmp, "kitti_npy")
        t0 = time.perf_counter()
        datasets.save_synthetic_kitti(root, n_frames=10)
        render_s = time.perf_counter() - t0
        for fn in counters.values():
            fn.launches = 0
        levels = 5
        with contextlib.ExitStack() as stack:
            calls = {name: stack.enter_context(watched(module, fn, pick, True))
                     for name, (module, fn, pick) in {
                         "fast": (extractors, "detect_scores",
                                  lambda a, k: len(a[0]) == levels),
                         "orb": (extractors, "orb_describe",
                                 lambda a, k: len(a[0]) == levels),
                         "anchor": (map_mod, "write_anchor_patches",
                                    lambda a, k: True)}.items()}
            res = sequence_eval.real_sequence_eval(
                kitti_root=root, max_frames=10, out_dir=out_dir,
                device=device)
        res.update(render_s=render_s, launches={
            k: fn.launches for k, fn in counters.items()},
            files=[os.path.exists(os.path.join(out_dir, f"traj_kitti00.{x}"
                                               ".txt")) for x in ("kitti",
                                                                  "tum")])
        out["real_sequence_eval"] = res
        missing = [k for k, v in calls.items() if not v]
        if missing:
            raise AssertionError(f"real_sequence_eval: calls not seen: "
                                 f"{missing}")
        (pyr, threshold, arc), _ = calls["fast"][0]
        (raw, blurred, xy, valid, counts), _ = calls["orb"][0]
        (m, img, kp_xy, slots, want), _ = calls["anchor"][0]
        cases = dict(
            fast=(tuple(pyr), threshold, arc),
            orb=(tuple(raw), tuple(blurred), xy, valid, list(counts)),
            anchor=dict(img=img, kp_xy=kp_xy, slots=slots, want=want,
                        capacity=m.capacity, atlas=m.anchor_atlas))
        del calls, m

        # (c) the EuRoC layout at its widths
        t0 = time.perf_counter()
        seq = datasets.save_synthetic_euroc(os.path.join(tmp, "euroc"),
                                            n_frames=24)
        render_s = time.perf_counter() - t0
        gt_c = np.linalg.inv(seq.gt_T_cw)[:, :3, 3]
        first_left = seq.left[0]
        h, w = first_left.shape
        ecfg = euroc_stereo_config()
        ecfg = dataclasses.replace(   # the writer's camera
            ecfg, keyframe_every=5, local_ba_every=2,
            camera=dataclasses.replace(ecfg.camera, fx=435.2, fy=435.2,
                                       cx=w / 2, cy=h / 2, bf=435.2 * 0.11))
        _, fig = track(ecfg, seq, seq.gt_T_cw, 4)
        fig.update(render_s=render_s,
                   stamp_step_s=float(seq.timestamps[1] - seq.timestamps[0]),
                   gt_step_m=float(np.linalg.norm(gt_c[1] - gt_c[0])))
        out["euroc_layout"] = fig
        del seq

    # (d) undistortion on the card against the CPU
    radtan = dict(k1=-0.28340811, k2=0.07395907, p1=1.9359e-4,
                  p2=1.76187114e-5)
    dcam = dataclasses.replace(ecfg.camera, **radtan)
    grid = torch.stack(torch.meshgrid(
        torch.linspace(0, w - 1, 16), torch.linspace(0, h - 1, 16),
        indexing="xy"), -1).reshape(-1, 2)

    def undistorted(dev):
        cam = cam_mod.CameraParams.from_config(dcam, dev)
        return (cam_mod.undistort_image(
                    cam, torch.from_numpy(first_left).to(dev)).cpu(),
                cam_mod.undistort_points(cam, grid.to(dev)).cpu())
    (card_img, card_px), (cpu_img, cpu_px) = (
        undistorted(device), undistorted(torch.device("cpu")))
    out["undistort"] = dict(
        image_max_diff=float((card_img - cpu_img).abs().max()),
        points_max_diff_px=float((card_px - cpu_px).abs().max()),
        points_max_shift_px=float((cpu_px - grid).abs().max()))

    # (e) the demo at its defaults, on the card
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    code = demo.main([])
    out["demo"] = dict(exit_code=code, seconds=time.perf_counter() - t0,
                       launches={k: fn.launches for k, fn in counters.items()})
    out["seconds"] = time.perf_counter() - t_phase
    return out, cases


# A batched keyframe step against serial ones (`held_to_serial`): the
# floats that a float reduction can move under a batch (the pose solve's
# sums, the small products of geometry/; parallel/batch_check.py names
# them), each within its tolerance: poses 1e-5, landmark positions 1e-4 m,
# their distance bounds at up to 1.25^2 times that, unit vectors (normals,
# bearings) 1e-4, pixel positions and the flow prior 1e-3 px (phase 3's LK
# agreement). Every other leaf must be equal: the pyramids, every integer
# and bool leaf, and the floats the images alone determine.
BATCH_FLOAT_TOL = {".T_cw": 1e-5, ".prev.T_cw": 1e-5, ".kfs.T_cw": 1e-5,
                   ".T_rel": 1e-5, ".map.pos": 1e-4, ".map.min_dist": 2e-4,
                   ".map.max_dist": 2e-4, ".map.normal": 1e-4,
                   ".prev.bearing": 1e-4, ".kfs.bearing": 1e-4,
                   ".prev.kp_xy": 1e-3, ".kfs.kp_xy": 1e-3,
                   ".kfs.kp_ur": 1e-3, ".flow": 1e-3}


def held_to_serial(batched, serial, before):
    """Per-sequence states after a batched keyframe step (`batched`)
    against serial keyframe steps (`serial`) from the same states
    (`before`). Gates: every leaf equal (`batch_check.tree_diff`: bit-equal,
    NaN equal to NaN) but the floats of BATCH_FLOAT_TOL, each within its
    tolerance. So these must be equal: the pyramids (.prev.pyramid[l],
    .prev.lk_pyr[l]); every integer and bool leaf (keypoint validity and
    levels .prev.valid, .prev.kp_level, descriptors .prev.desc, map and
    keyframe slot occupancy .map.valid, .kfs.valid, .kfs.kp_valid,
    observations .map.obs_kf, .map.obs_feat, .map.obs_desc, links
    .prev.map_idx, .kfs.map_idx, counters .map.n_visible, .map.n_found,
    .map.obs_count, .num_inliers, ...); the ORB angles and FAST responses
    (.prev.kp_angle, .kfs.kp_angle, .prev.kp_response) and the anchor atlas
    (.map.anchor_atlas); and, beside the tolerance of .prev.kp_xy and
    .kfs.kp_xy, the positions of the keyframe's fresh FAST keypoints (the
    rows valid after the step and not before) in .prev.kp_xy and in the new
    keyframe's row of .kfs.kp_xy. Returns the figures, `failures` empty
    when every gate holds."""
    import torch
    from trackingbench_slam_tpu_torch.parallel.batch_check import (
        leaf_equal, merge_diffs, tree_diff)
    diffs, fresh, fresh_rows = [], 0, 0
    for o, s, t in zip(batched, serial, before):
        diffs.append(tree_diff(o, s))
        rows = s.prev.valid & ~t.prev.valid
        slot = int(torch.nonzero(s.kfs.valid & ~t.kfs.valid)[0, 0])
        for x, y in ((o.prev.kp_xy[rows], s.prev.kp_xy[rows]),
                     (o.kfs.kp_xy[slot][rows], s.kfs.kp_xy[slot][rows])):
            fresh += int((~leaf_equal(x, y)).sum())
        fresh_rows += int(rows.sum())
    leaves = merge_diffs(diffs)
    failures = []
    for path, (_, _, d) in leaves.items():
        if d is None or not d <= BATCH_FLOAT_TOL.get(path, 0.0):
            failures.append(path)
    if fresh:
        failures.append("fresh keypoint positions")
    return dict(leaves_differing=leaves,
                largest={k: leaves.get(k, [0, 0, 0.0])[2]
                         for k in (".T_cw", ".map.pos")},
                fresh_rows=fresh_rows, fresh_xy_differing=fresh,
                failures=failures)


def batched_phase(cfg, frames, gt, scene, counters, device):
    """Phase 14a: BATCH sequences at the main path's width as one batched
    program (parallel/dp_eval.py), each bootstrapped serially: batched
    track steps and one batched track-and-keyframe step held to serial runs
    (every pyramid level equal after each step; after the keyframe step
    `held_to_serial`), the same keyframe frame's stages and ops bisected by
    parallel/batch_check.py on the serial states before it, the hand-kernel
    launches of a batched step against a serial step's, and
    dp_eval.dp_eval_bench (bench.py's protocol) at B = 1 and B = BATCH.
    Returns (figures, the batched kernel calls recorded, one track step at
    B = BATCH, at B = 1 and serially, for the profiles phase to count their
    CUDA kernels)."""
    import torch
    from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
    from trackingbench_slam_tpu_torch.models import vo as vo_mod
    from trackingbench_slam_tpu_torch.ops.cuda import (fast_kernel, lk_kernel,
                                                       patch_kernel)
    from trackingbench_slam_tpu_torch.parallel import batch_check, dp_eval
    from trackingbench_slam_tpu_torch.utils.device import upload_image
    t_phase = time.perf_counter()
    cam = cam_mod.CameraParams.from_config(cfg.camera, device)
    seqs = batch_check.batched_sequences(frames, gt, scene, BATCH,
                                         BATCH_TRACK_STEPS)
    up = [[tuple(None if x is None else upload_image(x, device) for x in f)
           for f in seq] for seq in seqs]

    def gens():
        return [torch.Generator(device=device).manual_seed(b)
                for b in range(BATCH)]

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        sync(device)
        return out, {k: c.launches for k, c in counters.items()}

    def pyramids(st):
        return st.prev.pyramid, st.prev.lk_pyr

    spent = {}
    t0 = time.perf_counter()
    boot = [batch_check.bootstrap(seq, cam, cfg) for seq in up]
    # serial runs, one sequence at a time, with its own generator
    serial_track, serial_kf, serial_pyr, g = [], [], [], gens()
    serial_launches = {}
    for b, seq in enumerate(up):
        st = boot[b]
        serial_pyr.append([])
        for i in range(1, BATCH_TRACK_STEPS + 1):
            st, n = counted(lambda: vo_mod.track_step(st, seq[i][0], cam, cfg,
                                                      g[b]))
            serial_launches.setdefault("track_step", n)
            serial_pyr[b].append(pyramids(st))
        serial_track.append(st)
        kf, n = counted(lambda: vo_mod.track_and_keyframe_step(
            st, seq[-1][0], seq[-1][1], cam, cfg, g[b]))
        serial_launches.setdefault("track_and_keyframe_step", n)
        serial_kf.append(kf)
    sync(device)
    spent["bootstrap_and_serial_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the same as one batched program, every batched kernel call recorded
    g = gens()
    states = dp_eval.stack_states(boot)
    batched_launches = {}
    pyr_diff = []

    def every(module, name, keep=None):
        return watched(module, name, lambda a, k: True, every=True,
                       keep=keep)

    # the anchor-cell launch writes its first argument: keep that atlas as
    # it was before the launch, and the tensor itself (the atlas after)
    with every(lk_kernel, "lk_align_cuda_batched") as lk_calls, \
            every(fast_kernel, "fast_score_nms_cuda_batched") as fast_c, \
            every(patch_kernel, "orb_describe_cuda_batched") as orb_c, \
            every(patch_kernel, "anchor_cells_into_batched", keep=lambda a, k:
                  ((a[0].clone(),) + a[1:], k, a[0])) as cells_c:
        for i in range(1, BATCH_TRACK_STEPS + 1):
            imgs = torch.stack([seq[i][0] for seq in up]).float()
            u = dp_eval.draw_uniform(g, cfg)
            states, n = counted(lambda: dp_eval.dp_track_step(
                states, imgs, cam, cfg, u))
            batched_launches.setdefault("track_step", n)
            pyr_diff.append(batch_check.merge_diffs(
                batch_check.tree_diff(pyramids(o), serial_pyr[b][i - 1])
                for b, o in enumerate(dp_eval.unstack_states(states,
                                                             BATCH))))
        batched_track = states
        u = dp_eval.draw_uniform(g, cfg)
        lefts = torch.stack([seq[-1][0] for seq in up]).float()
        rights = torch.stack([seq[-1][1] for seq in up]).float()
        batched_kf, n = counted(lambda: dp_eval.dp_track_and_keyframe_step(
            batched_track, lefts, rights, cam, cfg, u))
        batched_launches["track_and_keyframe_step"] = n
    # LK calls: one a track step, then the keyframe frame's track, anchored,
    # primed stereo and full-pyramid stereo calls
    kf_lk = lk_calls[BATCH_TRACK_STEPS:]
    track_err = max(float((batched_track.T_cw[b] - serial_track[b].T_cw)
                          .abs().max()) for b in range(BATCH))
    kf_err = max(float((batched_kf.T_cw[b] - serial_kf[b].T_cw).abs().max())
                 for b in range(BATCH))
    batched_tracked = dp_eval.unstack_states(batched_track, BATCH)
    held = held_to_serial(dp_eval.unstack_states(batched_kf, BATCH),
                          serial_kf, serial_track)
    # the batched tracked states against the serial ones: where the
    # keyframe frame's inputs already differ
    track_state_diff = batch_check.merge_diffs(
        batch_check.tree_diff(o, s)
        for o, s in zip(batched_tracked, serial_track))
    inliers = [int(x) for x in batched_kf.num_inliers]
    serial_inliers = [int(s.num_inliers) for s in serial_kf]
    distinct = not torch.allclose(serial_kf[0].T_cw, serial_kf[-1].T_cw,
                                  atol=1e-4)
    spent["batched_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the keyframe frame's stages and ops, serial against batched on the
    # same inputs: which ops still round differently under the batch
    bisect = batch_check.batch_check(serial_track, lefts, rights, cam, cfg,
                                     u)
    spent["batch_check_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mixed = mixed_branch_keyframe(cfg, cam, up, serial_track, gens())
    spent["mixed_branch_s"] = time.perf_counter() - t0
    # one track step at B = BATCH, at B = 1 and serially, for the profiles
    # phase to count their CUDA kernels
    u8 = dp_eval.draw_uniform(gens(), cfg)
    imgs8 = torch.stack([seq[1][0] for seq in up]).float()
    st8 = dp_eval.stack_states(boot)
    st1 = dp_eval.stack_states(boot[:1])
    track_steps = dict(
        batched=lambda: dp_eval.dp_track_step(st8, imgs8, cam, cfg, u8),
        b1=lambda: dp_eval.dp_track_step(st1, imgs8[:1], cam, cfg, u8[:1]),
        serial=lambda: vo_mod.track_step(boot[0], up[0][1][0], cam, cfg,
                                         uniform=u8[0]))
    t0 = time.perf_counter()
    rates = dp_eval.dp_eval_bench(cfg, frames, B=BATCH, steps=DP_STEPS,
                                  device=device)
    spent["dp_eval_bench_s"] = time.perf_counter() - t0
    calls = dict(lk=[("batched track", lk_calls[0]),
                     ("batched keyframe anchored", kf_lk[1]),
                     ("batched keyframe stereo, 2 primed levels", kf_lk[2]),
                     ("batched keyframe stereo, full pyramid", kf_lk[3])],
                 fast=fast_c, orb=orb_c, cells=cells_c)
    fig = dict(batch=BATCH, track_steps=BATCH_TRACK_STEPS,
               starts=[4 * b for b in range(BATCH)],
               track_pose_max_diff=track_err, kf_pose_max_diff=kf_err,
               pyramids_differing_after_track_steps=pyr_diff,
               track_state_leaves_differing=track_state_diff,
               held=held, batch_check=bisect, inliers=inliers,
               serial_inliers=serial_inliers, sequences_distinct=distinct,
               mixed_branch=mixed,
               serial_launches=serial_launches,
               batched_launches=batched_launches, dp_eval_bench=rates,
               spent=spent, seconds=time.perf_counter() - t_phase)
    return fig, calls, track_steps


def mixed_branch_keyframe(cfg, cam, up, tracked, generators):
    """One batched keyframe step whose sequences take both sides of the
    stereo-prior branch: sequence 0 a fresh state (no landmark, the full
    pyramid), the others tracked on to their keyframe frame (the 2 primed
    levels); held per sequence to its serial keyframe step from the same
    state with `held_to_serial`. Returns the figures."""
    import torch
    from trackingbench_slam_tpu_torch.models import vo as vo_mod
    from trackingbench_slam_tpu_torch.parallel import dp_eval
    states = [vo_mod.init_state(cfg, up[0][-1][0])] + [
        vo_mod.track_step(tracked[b], up[b][-1][0], cam, cfg, generators[b])
        for b in range(1, len(up))]
    rights = [seq[-1][1] for seq in up]
    serial = [vo_mod.keyframe_step(s, r, cam, cfg)
              for s, r in zip(states, rights)]
    batched = torch.func.vmap(
        lambda s, r: vo_mod.keyframe_step(s, r, cam, cfg,
                                          both_branches=True),
        randomness="error")(dp_eval.stack_states(states),
                            torch.stack(rights).float())
    fig = held_to_serial(dp_eval.unstack_states(batched, len(up)), serial,
                         states)
    fig["serial_landmarks"] = [int(s.map.valid.sum()) for s in serial]
    # the branch decides the right-image u: rows of each new keyframe that
    # have one
    fig["with_ur"] = [
        int((s.kfs.kp_ur[int(torch.nonzero(s.kfs.valid & ~t.kfs.valid)[0, 0])]
             >= 0).sum()) for s, t in zip(serial, states)]
    return fig


def batched_cells_library(img, kp_xy, slots, want, cap):
    """The yardstick of the batched anchor-cell call: one F.grid_sample over
    the (B, 1, H, W) images that blends every sequence's wanted 16x16
    cells, each sequence's grid padded to the largest count with centres
    outside the image (zeros). Returns (the call, a function giving each
    sequence's (n_ok_b, 16, 16) cells)."""
    import torch
    import torch.nn.functional as F
    from trackingbench_slam_tpu_torch.ops.cuda import patch_kernel
    c = patch_kernel.CELL
    B, (h, w) = img.shape[0], img.shape[1:]
    ok = want & (slots >= 0) & (slots < cap)
    counts = ok.sum(1)
    m = max(int(counts.max()), 1)
    first = torch.argsort((~ok).to(torch.int8), dim=1, stable=True)[:, :m]
    xy = torch.gather(kp_xy, 1, first[..., None].expand(-1, -1, 2))
    live = torch.arange(m, device=img.device)[None] < counts[:, None]
    xy = torch.where(live[..., None], xy, torch.full_like(xy, -1e4))
    ar = torch.arange(c, device=img.device, dtype=torch.float32) - c // 2
    xs = (xy[..., 0, None, None] + ar[None, None, None, :]).expand(
        -1, -1, c, c)
    ys = (xy[..., 1, None, None] + ar[None, None, :, None]).expand(
        -1, -1, c, c)
    grid = torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1],
                       -1).reshape(B, m * c, c, 2)
    images = img[:, None].float()

    def library():
        return F.grid_sample(images, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    def cells():
        got = library().reshape(B, m, c, c)
        return [got[b, :int(counts[b])] for b in range(B)]
    return library, cells


def check_batched(calls):
    """Every batched kernel call the batched phase recorded, rerun on the
    card and held per sequence to the plain version with phase 3's
    criteria; timed from CUDA-graph replay, bound summed over the
    sequences."""
    import torch
    from trackingbench_slam_tpu_torch.kernel_bench import time_ms
    from trackingbench_slam_tpu_torch.ops.cuda import (fast_kernel, lk_kernel,
                                                       patch_kernel)
    out = dict(lk=[], fast=[], orb=[], cells=[])

    def pick(xs, b):
        return [x[b] for x in xs]

    for name, ((prev, cur, pts, start, valid), kw) in calls["lk"]:
        B, n = pts.shape[:2]
        args = (prev, cur, pts, start, valid)
        got = lk_kernel.lk_align_cuda_batched(*args, **kw)
        err, agree, terms, n_both = 0.0, 1.0, [0, 0], 0
        for b in range(B):
            kb = dict(kw, offset=None if kw.get("offset") is None
                      else kw["offset"][b])
            ab = (pick(prev, b), pick(cur, b), pts[b], start[b], valid[b])
            ref = lk_kernel.lk_align_plain(*ab, **kb)
            both = got[1][b] & ref[1]
            agree = min(agree, float((got[1][b] == ref[1]).float().mean()))
            if kw.get("fb_iters", 0) > 0:
                agree = min(agree, float((got[3][b] == ref[3]).float().mean()))
            n_both += int(both.sum())
            if bool(both.any()):
                err = max(err, float((got[0][b] - ref[0])[both].abs().max()))
            t = lk_terms(lk_work(*ab, kb), n, kb)
            terms = [terms[0] + t[0], terms[1] + t[1]]
        if agree < 0.99 or err > 1e-3 or n_both == 0:
            raise AssertionError(f"batched LK differs ({name}): flags agree "
                                 f"{agree:.4f}, max |dxy| {err}")
        ms, host_ms = time_ms(
            lambda: lk_kernel.lk_align_cuda_batched(*args, **kw), 20)
        plain_ms, _ = time_ms(lambda: [lk_kernel.lk_align_plain(
            pick(prev, b), pick(cur, b), pts[b], start[b], valid[b],
            **dict(kw, offset=None if kw.get("offset") is None
                   else kw["offset"][b])) for b in range(B)], 1)
        bms, by = bound(*terms)
        out["lk"].append(dict(
            case=f"{name}, B={B} x {len(prev)} levels, N={n} each, one "
                 "launch", batch=B, n=n, levels=len(prev), converged=n_both,
            flags_agree=agree,
            max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=None,
            _call=functools.partial(lk_kernel.lk_align_cuda_batched, *args,
                                    **kw)))
    for (imgs, threshold, arc), _ in calls["fast"]:
        B = imgs[0].shape[0]
        got = fast_kernel.fast_score_nms_cuda_batched(imgs, threshold, arc)
        for lvl, img in enumerate(imgs):
            for b in range(B):
                ref = fast_kernel.fast_score_nms_plain(img[b], threshold, arc)
                if not torch.equal(got[lvl][b], ref):
                    raise AssertionError(f"batched FAST differs, sequence "
                                         f"{b} level {lvl}")
        ms, host_ms = time_ms(lambda: fast_kernel.fast_score_nms_cuda_batched(
            imgs, threshold, arc), 50)
        plain_ms, _ = time_ms(lambda: [fast_kernel.fast_score_nms_plain(
            img[b], threshold, arc) for img in imgs for b in range(B)], 2)
        shapes = [tuple(img.shape[1:]) for img in imgs]
        bms, by = bound(B * sum(h * w for h, w in shapes) * 8,
                        B * fast_flops(shapes))
        out["fast"].append(dict(
            case=f"batched keyframe, B={B} x {len(imgs)}-level ORB pyramid, "
                 "one launch", batch=B, max_abs_err=0.0, ms=ms,
            host_ms=host_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=None,
            _call=functools.partial(fast_kernel.fast_score_nms_cuda_batched,
                                    imgs, threshold, arc)))
    for (raw, blurred, xy, valid, counts), _ in calls["orb"]:
        B, n = xy.shape[:2]
        got_a, got_d = patch_kernel.orb_describe_cuda_batched(
            raw, blurred, xy, valid, counts)
        err, bins, terms = 0.0, 1.0, [0, 0]
        for b in range(B):
            ab = (pick(raw, b), pick(blurred, b), xy[b], valid[b], counts)
            e, agree = orb_describe_agreement(*ab, got=(got_a[b], got_d[b]))
            err, bins = max(err, e), min(bins, agree)
            t = orb_terms(ab[0], xy[b], valid[b], counts)
            terms = [terms[0] + t[0], terms[1] + t[1]]
        ms, host_ms = time_ms(lambda: patch_kernel.orb_describe_cuda_batched(
            raw, blurred, xy, valid, counts), 50)
        plain_ms, _ = time_ms(lambda: [patch_kernel.orb_describe_plain(
            pick(raw, b), pick(blurred, b), xy[b], valid[b], counts)
            for b in range(B)], 2)
        bms, by = bound(*terms)
        out["orb"].append(dict(
            case=f"batched keyframe, B={B} x {len(raw)}-level ORB describe, "
                 f"N={n} each, one launch", batch=B, n=n,
            valid=int(valid.sum()), bins_agree=bins, max_abs_err=err, ms=ms,
            host_ms=host_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=None,
            _call=functools.partial(patch_kernel.orb_describe_cuda_batched,
                                    raw, blurred, xy, valid, counts)))
    for (atlas, img, kp_xy, slots, want, cap), _, after in calls["cells"]:
        # `atlas`: the atlases as they were before the batched step's
        # launch; `after`: as that launch left them
        B, n = kp_xy.shape[:2]
        got = patch_kernel.anchor_cells_into_batched(atlas.clone(), img,
                                                     kp_xy, slots, want, cap)
        terms = [0, 0]
        for b in range(B):
            ref = patch_kernel.anchor_cells_plain(img[b], kp_xy[b], slots[b],
                                                  want[b], atlas[b], cap)
            if not (torch.equal(got[b], ref) and torch.equal(after[b], ref)):
                raise AssertionError(
                    f"batched anchor cells differ, sequence {b}: rerun "
                    f"{torch.equal(got[b], ref)}, the step's launch "
                    f"{torch.equal(after[b], ref)}")
            t = cells_terms(img[b], kp_xy[b], slots[b], want[b], cap)
            terms = [terms[0] + t[0], terms[1] + t[1]]
        scratch = atlas.clone()
        ms, host_ms = time_ms(lambda: patch_kernel.anchor_cells_into_batched(
            scratch, img, kp_xy, slots, want, cap), 50)
        call_ms, _ = time_ms(lambda: patch_kernel.anchor_cells_into_batched(
            atlas.clone(), img, kp_xy, slots, want, cap), 50)
        plain_ms, _ = time_ms(lambda: [patch_kernel.anchor_cells_plain(
            img[b], kp_xy[b], slots[b], want[b], atlas[b], cap)
            for b in range(B)], 2)
        library, library_cells = batched_cells_library(img, kp_xy, slots,
                                                       want, cap)
        library_ms, _ = time_ms(library, 50)
        # held where the kernel's 32 x 32 crop is not clamped into the
        # padded image (as the reference's, near the bottom and left edges)
        library_diff, clamped = 0.0, 0
        for b, cells in enumerate(library_cells()):
            ok_b = want[b] & (slots[b] >= 0) & (slots[b] < cap)
            corner = torch.floor(kp_xy[b][ok_b]) - 8.0
            r0, c0 = patch_kernel.patch_origins(corner + 15.0, *img.shape[1:])
            free = ((r0 == corner[:, 1]) & (c0 == corner[:, 0])
                    & (r0 + 17 <= img.shape[1]) & (c0 + 17 <= img.shape[2]))
            clamped += int((~free).sum())
            plain = patch_kernel.bilinear_cell_patches(img[b], kp_xy[b])[ok_b]
            library_diff = max(library_diff,
                               float((cells - plain)[free].abs().max()))
        if library_diff > 0.05:
            raise AssertionError(f"batched grid_sample cells differ from the "
                                 f"plain cells by {library_diff}")
        bms, by = bound(*terms)
        ok = want & (slots >= 0) & (slots < cap)
        out["cells"].append(dict(
            case=f"batched keyframe, B={B}, N={n} each, {int(ok.sum())} "
                 f"cells into B {atlas.shape[-1]}^2 atlases, one launch",
            batch=B, n=n, cells=int(ok.sum()), max_abs_err=0.0, ms=ms,
            host_ms=host_ms, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=library_ms,
            library_max_abs_diff=library_diff,
            library_rows_not_compared=clamped,
            _call=functools.partial(patch_kernel.anchor_cells_into_batched,
                                    scratch, img, kp_xy, slots, want, cap)))
    return out


def ba_problem(seed, device, landmarks, keyframes, obs):
    """benchmarks/ba_scaling.py's grouped window, made with numpy from
    `seed`: K poses 0.1 m apart with small rotations, L landmarks 4-40 m
    deep, each seen by the first O poses, points perturbed by 5 cm."""
    import torch
    from trackingbench_slam_tpu_torch.geometry import se3
    from trackingbench_slam_tpu_torch.solvers import local_ba
    K, L, O = keyframes, landmarks, obs
    r = np.random.RandomState(seed)
    xi = np.stack([np.concatenate([[0.1 * k, 0, 0], r.randn(3) * 0.005])
                   for k in range(K)]).astype(np.float32)
    T_cw = se3.exp(torch.from_numpy(xi)).numpy()
    X = r.uniform(-8, 8, (L, 3)).astype(np.float32)
    X[:, 2] = r.uniform(4, 40, L)
    kf = np.tile(np.arange(K, dtype=np.int32)[None, :O] % K, (L, 1))
    pc = np.einsum("kij,lj->lki", T_cw[:, :3, :3], X) + T_cw[None, :, :3, 3]
    pc = np.take_along_axis(pc, kf[..., None].astype(np.int64), axis=1)
    px = np.stack([pc[..., 0] / pc[..., 2] * 707.0 + 613.0,
                   pc[..., 1] / pc[..., 2] * 707.0 + 185.0], axis=-1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return local_ba.GroupedBAProblem(
        T_cw=t(T_cw.astype(np.float32)),
        points=t(X + r.randn(L, 3).astype(np.float32) * 0.05),
        obs_kf=t(kf), obs_px=t(px.astype(np.float32)),
        obs_inv_sigma2=t(np.ones((L, O), np.float32)),
        obs_valid=t(np.ones((L, O), bool)))


def ba_phase(device):
    """Phase 14b: BA iterations/s with benchmarks/ba_scaling.py's protocol
    ((t(12) - t(2)) / 10 over BA_REPS pre-uploaded 4096 x 16 x 16 windows,
    one fence per sweep), for the one-device grouped solve and the
    distributed one on a torch.distributed world of one over NCCL; then
    both distributed solves held to bundle_adjust_grouped / bundle_adjust
    within 5e-4 in pose (se3 log) and in the points (m)."""
    import socket
    import torch
    import torch.distributed as dist
    from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
    from trackingbench_slam_tpu_torch.geometry import se3
    from trackingbench_slam_tpu_torch.parallel import dist_ba
    from trackingbench_slam_tpu_torch.solvers import local_ba
    from trackingbench_slam_tpu_torch.utils.config import CameraConfig
    t_phase = time.perf_counter()
    cam = cam_mod.CameraParams.from_config(
        CameraConfig(width=1226, height=370, fx=707.0, fy=707.0, cx=613.0,
                     cy=185.0, bf=707.0 * 0.54), device)
    problems = [ba_problem(s, device, **BA_WINDOW) for s in range(BA_REPS)]
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        world = dist.group.WORLD
        solvers = dict(
            one_device=lambda gp, it: local_ba.bundle_adjust_grouped(
                cam, gp, iters=it, num_fixed=1),
            distributed_world1=lambda gp, it:
                dist_ba.distributed_bundle_adjust_grouped(
                    world, cam, gp, iters=it, num_fixed=1))

        def sweep(solve, iters):
            outs = [solve(gp, iters) for gp in problems]     # warm
            sync(device)
            t0 = time.perf_counter()
            outs = [solve(gp, iters) for gp in problems]
            for T, _ in outs:
                T.cpu()
            return (time.perf_counter() - t0) / len(problems)

        # BA_SWEEPS readings of each solve, the two solves alternating so
        # that a slow spell of the host falls on both
        readings = {name: [] for name in solvers}
        for _ in range(BA_SWEEPS):
            for name, solve in solvers.items():
                t_lo, t_hi = sweep(solve, 2), sweep(solve, 12)
                readings[name].append(1.0 / max((t_hi - t_lo) / 10, 1e-9))
        rates = {}
        for name, r in readings.items():
            med = float(np.median(r))
            rates[name] = dict(iters_per_s=med, ms_per_iter=1e3 / med,
                               min=min(r), max=max(r), readings=r)
        one, dist1 = rates["one_device"], rates["distributed_world1"]
        gap = dict(median_ratio=dist1["iters_per_s"] / one["iters_per_s"],
                   ranges_overlap=(dist1["max"] >= one["min"]
                                   and one["max"] >= dist1["min"]))

        def pose_err(T_a, T_b):
            return float(se3.log(se3.compose(T_a, se3.inverse(T_b))).abs()
                         .max())
        gp = problems[0]
        T_s, X_s = local_ba.bundle_adjust_grouped(cam, gp, iters=10,
                                                  num_fixed=1)
        T_d, X_d = dist_ba.distributed_bundle_adjust_grouped(
            world, cam, gp, iters=10, num_fixed=1)
        L, O = gp.obs_kf.shape
        flat = local_ba.BAProblem(
            T_cw=gp.T_cw, points=gp.points, obs_kf=gp.obs_kf.reshape(-1),
            obs_lm=torch.arange(L, dtype=torch.int32, device=device
                                ).repeat_interleave(O),
            obs_px=gp.obs_px.reshape(-1, 2),
            obs_inv_sigma2=gp.obs_inv_sigma2.reshape(-1),
            obs_valid=gp.obs_valid.reshape(-1))
        ref = local_ba.bundle_adjust(cam, flat, iters=10, num_fixed=1)
        sp = dist_ba.partition_problem(flat, 1)
        T_f, X_f = dist_ba.distributed_bundle_adjust(
            world, cam, dist_ba.local_shard(sp, 1, 0), iters=10, num_fixed=1)
        moved = float((X_s - gp.points).abs().max())
        fig = dict(landmarks=L, keyframes=gp.T_cw.shape[0],
                   obs_per_landmark=O, reps=BA_REPS, sweeps=BA_SWEEPS,
                   iters=rates, distributed_vs_one_device=gap,
                   grouped_pose_err=pose_err(T_d, T_s),
                   grouped_points_max_diff=float((X_d - X_s).abs().max()),
                   flat_pose_err=pose_err(T_f, ref.T_cw),
                   flat_points_max_diff=float(
                       (X_f[:L] - ref.points).abs().max()),
                   points_moved=moved, backend=dist.get_backend(world),
                   world_size=dist.get_world_size())
    finally:
        dist.destroy_process_group()
    fig["seconds"] = time.perf_counter() - t_phase
    return fig


# each hand kernel's device events, by the start of their name ("void "
# dropped: the profiler names a template kernel with its return type)
KERNEL_EVENTS = {"lk_align": "lk_kernel<", "fast_score_nms": "fast_nms_kernel",
                 "orb_describe": "orb_describe_kernel",
                 "anchor_cells": "anchor_cells_kernel"}
# the stage ranges of models/vo.py that call each hand kernel's custom op
KERNEL_RANGES = {"track.search_by_opflow": ("lk_align",),
                 "keyframe.extract_orb": ("fast_score_nms", "orb_describe"),
                 "keyframe.anchored_align": ("lk_align",),
                 "keyframe.stereo_lk": ("lk_align",),
                 "keyframe.write_anchor_patches": ("anchor_cells",)}


def attribution_cases(lk_inputs, lk_cases, pyr, fast_args, fast_case,
                      orb_case, orb_check, anchor_case, anchor_check):
    """Phase 3's main-path calls through each kernel's public entry point,
    as (kernel, the models/vo.py range that makes the call, call, phase 3's
    CUDA-event ms a call)."""
    from trackingbench_slam_tpu_torch.ops.cuda import (fast_kernel,
                                                       lk_kernel,
                                                       patch_kernel)

    def lk(i):
        _, _, prev, cur, pts, start, valid, kw = lk_inputs[i]
        return lambda: lk_kernel.lk_align(prev, cur, pts, start, valid, **kw)
    a = anchor_case
    return [
        ("lk_align", "track.search_by_opflow", lk(0), lk_cases[0]["ms"]),
        ("lk_align", "keyframe.stereo_lk", lk(1), lk_cases[1]["ms"]),
        ("lk_align", "keyframe.anchored_align", lk(3), lk_cases[3]["ms"]),
        ("fast_score_nms", "keyframe.extract_orb",
         lambda: fast_kernel.fast_score_nms_levels(pyr, *fast_args),
         fast_case["ms"]),
        ("orb_describe", "keyframe.extract_orb",
         lambda: patch_kernel.orb_describe(*orb_case), orb_check["ms"]),
        ("anchor_cells", "keyframe.write_anchor_patches",
         lambda: patch_kernel.anchor_cells(a["img"], a["kp_xy"], a["slots"],
                                           a["want"], a["atlas"],
                                           a["capacity"]),
         anchor_check["ms"])]


def kernel_events(avgs, kernel):
    """(events, device ms in all) of `kernel`'s launches among the
    profiler's key averages."""
    from torch.autograd import DeviceType
    ev = [e for e in avgs if e.device_type == DeviceType.CUDA
          and not e.is_user_annotation
          and e.key.removeprefix("void ").startswith(KERNEL_EVENTS[kernel])]
    return (sum(e.count for e in ev),
            sum(e.self_device_time_total for e in ev) / 1e3)


def profiled_cases(phases, cases, reps=ATTRIBUTION_CALLS):
    """Every checked call of every kernel ({kernel: cases}; each case's
    `_call`, taken off it here) made `reps` times under torch.profiler:
    the kernel's device ms a call as the profiler reads it
    (`profiled_ms`), beside the case's CUDA-event `ms`."""
    for kernel, rows in cases.items():
        for c in rows:
            call = c.pop("_call")
            call()
            prof, _ = phases.profiled(lambda: [call() for _ in range(reps)])
            n, ms = kernel_events(prof.key_averages(), kernel)
            c["profiled_ms"] = ms / max(n, 1)
            c["profiled_events_per_call"] = n / reps


def attribution(phases, cases, reps=ATTRIBUTION_CALLS):
    """Each case's call made `reps` times inside its range, under
    torch.profiler: the kernel's device events (one a call) and their ms a
    call, within ATTRIBUTION_TOL of the case's CUDA-event ms; the custom
    op's device time and the range's must each hold the kernel's."""
    import torch
    from torch.autograd import DeviceType
    out = []
    for kernel, rng, call, event_ms in cases:
        def run(call=call, rng=rng):
            for _ in range(reps):
                with torch.profiler.record_function(rng):
                    call()
        call()
        prof, _ = phases.profiled(run)
        avgs = prof.key_averages()
        n, kernel_ms = kernel_events(avgs, kernel)

        def cpu_ms(key):
            return sum(e.device_time_total for e in avgs
                       if e.device_type == DeviceType.CPU
                       and e.key == key) / 1e3
        row = dict(kernel=kernel, range=rng, calls=reps, kernel_events=n,
                   profiled_ms=kernel_ms / max(n, 1), event_ms=event_ms,
                   op_ms=cpu_ms(f"trackingbench::{kernel}") / reps,
                   range_ms=cpu_ms(rng) / reps)
        row["ratio"] = row["profiled_ms"] / event_ms
        row["ok"] = (n == reps and abs(row["ratio"] - 1) <= ATTRIBUTION_TOL
                     and row["op_ms"] * reps >= 0.99 * kernel_ms > 0
                     and row["range_ms"] * reps >= 0.99 * kernel_ms)
        out.append(row)
    return out


def attributed_window(phases, cfg, frames, device):
    """A fresh StereoVO over frames 0-14, frame 14 (a keyframe: a track
    step and a keyframe step) under torch.profiler: the per-range table of
    profile_main_path, and whether every range of KERNEL_RANGES holds
    device time of each of its kernels' custom ops, and at least as much
    device time as they do."""
    from trackingbench_slam_tpu_torch.models import vo as vo_mod
    from trackingbench_slam_tpu_torch.profile_main_path import range_table
    vo = vo_mod.StereoVO(cfg, device=device)
    for left, right in frames[:14]:
        vo.track(left, right)
    prof, _ = phases.profiled(lambda: vo.track(*frames[14]))
    table = range_table(prof.events(), vo_mod.STAGE_PREFIXES)
    missing = []
    for rng, kernels in KERNEL_RANGES.items():
        row = table.get(rng, dict(ops={}, calls=0, device_ms_per_call=0.0))
        ops_ms = 0.0
        for k in kernels:
            ms = row["ops"].get(f"trackingbench::{k}", {}).get("device_ms", 0)
            ops_ms += ms
            if not ms > 0:
                missing.append((rng, k))
        if not row["device_ms_per_call"] * row["calls"] >= 0.99 * ops_ms:
            missing.append((rng, "range below its ops"))
    return dict(stages=table, missing=missing)


# --- the pose solve's round kernel (csrc/pose.cu) against its plain version

POSE_CELLS = ("kitti-stereo.dataset", "euroc-stereo.dataset")
POSE_SEED = 2 ** 31 + 17     # the battery's order and RANSAC draws
POSE_STEP = 3                # the battery step whose solve is recorded
POSE_REPS = 20               # kernel solves timed a case
POSE_GAP_MAX = 1e-4          # |log(T_kernel T_plain^-1)|
POSE_FLAGS_MAX = 1e-3        # inlier flags differing, share of the edges


# Operations a round needs (products, sums, divisions, roots, sines and
# cosines; compares and selects not counted), counted on the kernel's own
# expressions with each shared factor counted once:
POSE_POINT_OPS = (18     # the camera-frame point: 3x3 product and translation
                  + 35   # pinhole and distortion to a pixel, the residual
                  + 4)   # chi2
POSE_TERM_OPS = (24      # the ten non-zero Jacobian entries
                 + 10    # Jacobian times weight
                 + 40    # H's upper triangle: 30 products, 10 sums
                 + 14)   # b: 10 products, 4 sums
POSE_HUBER_OPS = 6       # the weight's root, reciprocal, 2 products; cost 2
POSE_SUMS = 28           # H's 21 independent entries, b's 6, the cost
POSE_ITER_OPS = (6 + 91 + 72   # damping, 6x6 Cholesky, two triangular solves
                 + 146         # se3 exp
                 + 63 + 1)     # compose of two rigid transforms, lambda
POSE_NORMALIZE_OPS = 216       # two Newton polar steps on a 3x3 rotation


def pose_round_ops(m, n, iters, huber):
    """Operations one round needs on one sequence of n points, m of them in
    the round's weight mask: 1 + iters builds of (H, b, cost) over the m
    (the others' terms are zero), the iterations' 6x6 solves, exp and
    compose, the normalization, and the gate's projection of all n."""
    per_point = POSE_POINT_OPS + POSE_TERM_OPS + (POSE_HUBER_OPS if huber
                                                  else 0)
    build = m * per_point + POSE_SUMS * max(m - 1, 0)
    return ((1 + iters) * build + iters * POSE_ITER_OPS + POSE_NORMALIZE_OPS
            + n * POSE_POINT_OPS)


def battery_pose_case(workload, device):
    """The pose solve's inputs in one batched track step of a benchmark
    cell (slam_bench's battery at POSE_SEED, step POSE_STEP): the first
    round's launch, recorded, and the cell's solver configuration."""
    import dataclasses
    import torch
    from slam_bench import battery, registry
    from trackingbench_slam_tpu_torch.ops.cuda import pose_kernel
    found = registry.find_cell(registry.load_benchmark(), workload)
    traffic = found["traffic"]
    run = battery.Run(device=device)
    cfg = battery.pipeline_config(found["config"])
    run.S = traffic["sequences"]
    run.B = run.S * traffic["executions"]
    lefts, rights, _ = battery.render_battery(
        traffic, dataclasses.asdict(cfg.camera),
        cfg.camera.bf / cfg.camera.fx, cfg.keyframe_every, POSE_SEED, device)
    _, _, gen_seeds = battery.draw_sequences(traffic, POSE_SEED)
    bat = battery.Battery(run, cfg, lefts, rights, gen_seeds, device)
    for _ in range(POSE_STEP - 1):
        bat.step()
    with watched(pose_kernel, "pose_round_cuda_batched", lambda a, kw: True,
                 keep=lambda a, kw: [x.clone() if isinstance(
                     x, torch.Tensor) else x for x in a]) as kept:
        bat.step()
    camv, T, pts, obs, s2, mask, valid = kept[0][:7]
    del bat
    torch.cuda.empty_cache()
    return dict(case=f"{workload} step {POSE_STEP}, B {run.B}",
                camv=camv[0].contiguous(), T=T, pts=pts, obs=obs, s2=s2,
                valid=valid, config=cfg.solver)


def closer_pose_case(rec, device):
    """The first pose solve of the loop closer's verification
    (models/loop_closer.py `_verify_candidates_device`) on the tracked loop
    with the record's vocabulary and draws: a serial call, B 1."""
    import torch
    from trackingbench_slam_tpu_torch import parity
    from trackingbench_slam_tpu_torch.ops.cuda import pose_kernel
    from trackingbench_slam_tpu_torch.solvers import pose_opt
    cfg, frames, _, prefix = parity.part_frames(rec, "loop_tracked")
    vo = parity.loop_bench_tracker(
        cfg, device, parity.record_vocabulary(rec, "loop_tracked.voc",
                                              device))
    draws = parity.RecordedDraws(rec, prefix)

    def from_closer(a, kw):
        return sys._getframe(2).f_code.co_name == "_verify_candidates_device"
    with draws.installed(), watched(pose_opt, "pose_optimization",
                                    from_closer) as kept:
        for i, frame in enumerate(frames):
            draws.at = i
            vo.track(*frame)
            if kept:
                break
    if not kept:
        raise AssertionError("the tracked loop made no closer verification")
    (cam, T0, pts, obs, s2, valid, config), _ = kept[0]
    return dict(case=f"loop closer verification at frame {i}, B 1",
                camv=pose_kernel.camera_vector(cam), T=T0[None].contiguous(),
                pts=pts[None].contiguous(), obs=obs[None].contiguous(),
                s2=s2[None].contiguous(), valid=valid[None].contiguous(),
                config=config)


def check_pose(case):
    """The kernel's solve (a launch a round, the batch in one) against the
    plain solve (its rounds under torch.func.vmap, as the eager batched
    step ran them) on one recorded case: the largest pose gap, inlier flags
    differing, bit-equal poses, the batch against each sequence launched
    alone, and the kernel's and the plain solve's ms (CUDA events)."""
    import torch
    from trackingbench_slam_tpu_torch.geometry import se3
    from trackingbench_slam_tpu_torch.ops.cuda import pose_kernel
    camv, T0, pts, obs, s2, valid, config = (
        case[k] for k in ("camv", "T", "pts", "obs", "s2", "valid",
                          "config"))
    B, n = pts.shape[:2]
    rounds = [(config.huber_delta if r < config.rounds - 1 else None,
               config.iters_per_round, config.init_lambda,
               config.chi2_threshold) for r in range(config.rounds)]

    masks = []   # each round's weight mask: its points in the mask

    def kernel(b=slice(None), keep=False):
        T, inl, chi2 = T0[b], valid[b], None
        for sc in rounds:
            if keep:
                masks.append(inl.sum(-1))
            T, inl, chi2 = pose_kernel.pose_round_cuda_batched(
                camv.expand(T.shape[0], 9), T, pts[b], obs[b], s2[b], inl,
                valid[b], *sc)
        return T, inl, chi2

    def plain_one(T, p, o, s, v):
        inl = v
        for sc in rounds:
            T, inl, chi2 = pose_kernel.pose_round_plain(camv, T, p, o, s,
                                                        inl, v, *sc)
        return T, inl, chi2
    plain = torch.func.vmap(plain_one)

    def events_ms(fn, reps):
        fn()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps
    before = pose_kernel.pose_round_cuda.launches
    got = kernel(keep=True)
    launches = pose_kernel.pose_round_cuda.launches - before
    ref = plain(T0, pts, obs, s2, valid)
    alone = [kernel(slice(b, b + 1)) for b in range(B)]
    batch_equal = all(torch.equal(x[b], y[0]) for b, one in enumerate(alone)
                      for x, y in zip(got, one))
    d = got[0].double() @ torch.linalg.inv(ref[0].double())
    gap = float(se3.log(d).norm(dim=-1).max())
    edges = int(valid.sum())
    differing = int((got[1] != ref[1]).sum())
    ms = events_ms(kernel, POSE_REPS)
    plain_ms = events_ms(lambda: plain(T0, pts, obs, s2, valid), 2)
    ops = sum(pose_round_ops(int(m), n, sc[1], sc[0] is not None)
              for sc, ms in zip(rounds, masks) for m in ms.tolist())
    nbytes = len(rounds) * B * (n * (12 + 8 + 4 + 1 + 1 + 1 + 4) + 9 * 4
                                + 2 * 64)
    b_ms, by = bound(nbytes, ops)
    out = dict(case=case["case"], B=B, n=n, edges=edges,
               inliers=int(got[1].sum()), pose_gap=gap,
               flags_differing=differing,
               bit_equal_poses=sum(torch.equal(got[0][b], ref[0][b])
                                   for b in range(B)) / B,
               batch_equals_alone=batch_equal, launches=launches, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               x_bound=ms / b_ms, ops=ops, bytes=nbytes)
    if not (gap <= POSE_GAP_MAX and differing <= POSE_FLAGS_MAX * edges
            and out["bit_equal_poses"] == 1 and batch_equal
            and launches == config.rounds):
        raise AssertionError(f"pose kernel off its plain version: {out}")
    return out


def pose_phase(rec, device):
    """Phase 13b: the pose kernel on two benchmark cells' battery steps and
    one loop-closer verification, against the plain solve."""
    cases = [battery_pose_case(w, device) for w in POSE_CELLS]
    cases.append(closer_pose_case(rec, device))
    out = []
    for case in cases:
        out.append(check_pose(case))
        c = out[-1]
        log(f"[check] pose_round on {c['case']} N={c['n']}: gap "
            f"{c['pose_gap']:.2e}, flags differing {c['flags_differing']} "
            f"of {c['edges']} edges, poses bit-equal "
            f"{c['bit_equal_poses']:.3f}, batch = alone "
            f"{c['batch_equals_alone']}, {c['launches']} launches, "
            f"{c['ms']:.4f} ms (bound {c['bound_ms']:.5f} by "
            f"{c['bound_by']}, x{c['x_bound']:.1f}), plain "
            f"{c['plain_ms']:.1f} ms")
    return out


def bench_child(here):
    """python -m trackingbench_slam_tpu_torch.bench --frames N_FRAMES in a
    fresh process on the same card: its last line, parsed, with the
    child's seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "trackingbench_slam_tpu_torch.bench", "--frames",
                           str(N_FRAMES)], cwd=here, check=True, timeout=900,
                          stdout=subprocess.PIPE, text=True)
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    line["seconds"] = time.perf_counter() - t0
    return line


def bench_gate(line):
    """The bench child's line: bench.py's keys and the port's, a positive
    rate, ATE < 0.01 m, the CPU reference over all N_FRAMES frames, and
    vs_baseline equal to value / cpu_reference_fps within the roundings of
    the three (each to 3 decimals)."""
    from trackingbench_slam_tpu_torch.bench import (EXTRA_KEYS, LINE_KEYS,
                                                    STAGE_KEYS)
    ex = line["extra"]
    if not (set(line) - {"seconds"} == set(LINE_KEYS)
            and set(ex) == set(EXTRA_KEYS) | {"stage_ms", "dp_eval"}
            and set(ex["stage_ms"]) == set(STAGE_KEYS)
            and set(ex["dp_eval"]) == {"B1_seq_frames_per_s",
                                       "B8_seq_frames_per_s",
                                       "batch_speedup"}):
        raise AssertionError(f"bench: the line's keys: {line}")
    value, cpu = line["value"], ex["cpu_reference_fps"]
    ratio = value / cpu
    rounding = 5e-4 + ratio * (5e-4 / value + 5e-4 / cpu)
    if not (value > 0 and ex["ate_rmse_m"] < 0.01
            and ex["cpu_reference_frames"] == N_FRAMES
            and abs(line["vs_baseline"] - ratio) <= rounding):
        raise AssertionError(f"bench failed its gates: {line}")


def profiler_history(here):
    """python -m trackingbench_slam_tpu_torch.profile_main_path --history
    in a child process on the same card: three fresh BA-on main-path runs,
    one torch.profiler session, three more; its result."""
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m",
                    "trackingbench_slam_tpu_torch.profile_main_path",
                    "--history"], cwd=here, check=True, timeout=600,
                   stdout=subprocess.DEVNULL)
    with open(os.path.join(here, "chiprun_out",
                           "profile_history_profiler.json")) as fh:
        out = json.load(fh)
    out["seconds"] = time.perf_counter() - t0
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import trackingbench_slam_tpu_torch  # noqa: F401  (precision pins)
    from trackingbench_slam_tpu_torch.utils.corridor import render_pool
    with render_pool(RENDER_PROCESSES):
        return run(here)


def run(here):
    """main()'s phases, with the render pool in force."""
    import torch
    from trackingbench_slam_tpu_torch import parity
    from trackingbench_slam_tpu_torch.bench import hand_kernel_counters
    from trackingbench_slam_tpu_torch.kernel_bench import kernel_inputs
    from trackingbench_slam_tpu_torch.ops.cuda import build
    from trackingbench_slam_tpu_torch.utils.corridor import (
        corridor_frames, loop_bench_config, loop_frames, main_path_config,
        main_path_config_ba_off)

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    phases = PhaseOrder(probe=process_probe)
    phases.enter("build")
    rec = parity.load_record()
    build_s, reports = build.timed_build_all()
    for name in build.SOURCES:
        build.load(name)
    out_dir = os.path.join(here, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    if reports:   # empty when an earlier command of the run built them
        with open(os.path.join(out_dir, "ptxas.txt"), "w") as fh:
            for name, rep in reports.items():
                fh.write(f"--- {name}.cu\n{rep}\n")
    log(f"[build] {len(build.SOURCES)} kernels for sm_90a in {build_s:.1f} s "
        f"({', '.join(build.SOURCES)})")

    cfg = main_path_config()
    t0 = time.perf_counter()
    frames, gt, scene = corridor_frames(cfg, N_FRAMES)
    log(f"[frames] {N_FRAMES} corridor frames {cfg.camera.width}x"
        f"{cfg.camera.height} rendered in {time.perf_counter() - t0:.1f} s")

    phases.enter("kernel checks")
    pyr, lk_inputs, orb_case, anchor_case, budgets = kernel_inputs(
        cfg, frames, scene, gt)
    fast_args = (float(cfg.extractor.min_threshold), cfg.extractor.fast_arc)
    fast_cases = check_fast(pyr, *fast_args)
    log("[check] fast_score_nms exact on "
        + ", ".join(f"{lv['shape'][0]}x{lv['shape'][1]}"
                    for lv in fast_cases[0]["levels"])
        + f" in one launch ({fast_cases[0]['ms']:.4f} ms, plain "
          f"{fast_cases[0]['plain_ms']:.3f} ms)")
    orb_cases = check_orb_describe(orb_case)
    c = orb_cases[0]
    log(f"[check] orb_describe on {c['case']}, N={c['n']} ({c['valid']} "
        f"valid): max |d angle| {c['max_abs_err']:.2e} rad, bins agree "
        f"{c['bins_agree']:.5f}, descriptors exact ({c['ms']:.4f} ms, plain "
        f"{c['plain_ms']:.3f} ms)")
    anchor_cases = check_anchor_cells(anchor_case)
    c = anchor_cases[0]
    log(f"[check] anchor_cells exact on {c['case']} ({c['ms']:.4f} ms, with "
        f"the atlas copy {c['call_ms']:.4f} ms, copy alone "
        f"{c['clone_ms']:.4f} ms, plain {c['plain_ms']:.3f} ms, grid_sample "
        f"{c['library_ms']:.4f} ms)")
    lk_cases = check_lk(lk_inputs)
    log("[check] lk_align within 1e-3 px on "
        + ", ".join(f"{c['case']} N={c['n']} conv {c['converged']} agree "
                    f"{c['flags_agree']:.4f} err {c['max_abs_err']:.2e} "
                    f"{c['launches_per_call']} launch ({c['ms']:.4f} ms, "
                    f"plain {c['plain_ms']:.3f} ms)" for c in lk_cases))

    counters = hand_kernel_counters()
    dev = torch.device("cuda")

    def gate(name, fig, launch_ok):
        missing = [k for k, v in fig["launches"].items() if v == 0]
        if missing:
            raise AssertionError(f"{name}: kernels not launched: {missing}")
        if not launch_ok:
            raise AssertionError(f"{name}: launches {fig['launches']}")
        if not fig["ate_m"] < 0.01:
            raise AssertionError(f"{name}: ATE {fig['ate_m']} m >= 0.01 m")
        if not fig["last_inliers"] > 500:
            raise AssertionError(f"{name}: last-frame inliers "
                                 f"{fig['last_inliers']} <= 500")

    phases.enter("main path, BA off")
    _, ba_off = main_path(main_path_config_ba_off(), frames, gt, counters,
                          dev)
    log(f"[main path, BA off] {N_FRAMES} frames, {ba_off['timed']} timed: "
        f"{ba_off['fps']:.2f} frames/s, ATE {ba_off['ate_m']:.5f} m, "
        f"last-frame inliers {ba_off['last_inliers']}, live landmarks "
        f"{ba_off['landmarks']}, launches {ba_off['launches']}")
    gate("main path, BA off", ba_off,
         ba_off["launches"] == BA_OFF_LAUNCHES)

    phases.enter("main path, BA on")
    vo, ba_on = main_path(cfg, frames, gt, counters, dev)
    ba_on["ba_call_ms"] = ba_call_ms(vo)
    log(f"[main path, BA on] {N_FRAMES} frames, {ba_on['timed']} timed: "
        f"{ba_on['fps']:.2f} frames/s, ATE {ba_on['ate_m']:.5f} m, "
        f"last-frame inliers {ba_on['last_inliers']}, live landmarks "
        f"{ba_on['landmarks']}, BA calls {ba_on['ba_calls']}, BA "
        f"{', '.join(f'{t:.1f}' for t in ba_on['ba_call_ms'])} ms a call "
        f"(fenced, on the final state), launches {ba_on['launches']}")
    gate("main path, BA on", ba_on, ba_on["ba_calls"] == 4)
    launches = ba_on["launches"]
    live_traj = torch.stack(vo.trajectory)
    del vo

    phases.enter("prefetch")
    prefetch = prefetch_phase(cfg, frames, gt, counters, dev, live_traj)
    log(f"[prefetch] every frame equal to the synchronous upload: "
        f"{not prefetch['frames_differing_from_upload']}; the BA-on live "
        f"loop fed by the prefetcher {prefetch['fps']:.2f} frames/s "
        f"(synchronous upload {ba_on['fps']:.2f}), ATE "
        f"{prefetch['ate_m']:.5f} m, poses equal to the synchronous run "
        f"{prefetch['poses_equal_live']} (first differing frame "
        f"{prefetch['first_frame_differing']}, max |diff| "
        f"{prefetch['max_pose_diff_from_live']:.3e}), launches "
        f"{prefetch['launches']}")
    if prefetch["frames_differing_from_upload"]:
        raise AssertionError(f"prefetch: frames differ from the upload: "
                             f"{prefetch['frames_differing_from_upload']}")
    if not prefetch["poses_equal_live"]:
        raise AssertionError(f"prefetch-fed poses differ: {prefetch}")

    phases.enter("offline")
    offline = offline_phase(cfg, frames, gt, counters, dev, live_traj)
    log(f"[offline] OfflineStereoVO, {offline['frames']} frames uploaded "
        f"once in {offline['upload_s']:.2f} s: {offline['fps']:.2f} frames/s"
        f" over frames 1-{offline['frames'] - 1} (live loop "
        f"{ba_on['fps']:.2f} over its timed frames), ATE "
        f"{offline['ate_m']:.5f} m, last-frame inliers "
        f"{offline['last_inliers']}, poses equal to the live loop "
        f"{offline['poses_equal_live']} (first differing frame "
        f"{offline['first_frame_differing']}, max |diff| "
        f"{offline['max_pose_diff_from_live']:.3e}), launches "
        f"{offline['launches']}, host syncs in a run "
        f"{offline['host_syncs_per_run']} ({offline['keyframes_in_run']} "
        f"keyframes; by line {offline['host_sync_lines']}), "
        f"repeated-target row writes sync-free "
        f"{offline['scatter_writes_sync_free']}")
    if not (offline["ate_m"] < 0.01 and offline["finite"]
            and offline["launches"] == launches
            and offline["poses_equal_live"]
            and offline["scatter_writes_sync_free"]):
        raise AssertionError(f"offline failed its gates: {offline}")

    phases.enter("photometric")
    photometric, clahe_case = photometric_phase(cfg, frames, gt, counters,
                                                dev)
    for k in ("plain", "clahe"):
        fig = photometric[k]
        log(f"[photometric {k}] {fig['frames']} stressed frames, "
            f"{fig['timed']} timed: {fig['fps']:.2f} frames/s, ATE "
            f"{fig['ate_m']:.5f} m, last-frame inliers "
            f"{fig['last_inliers']}, launches {fig['launches']}, lost after "
            f"frames {fig['lost_frames']}")
        if not fig["finite"]:
            raise AssertionError(f"photometric {k}: poses not finite")
    clahe_lk = check_lk([clahe_case])
    lk_cases += clahe_lk
    c = clahe_lk[0]
    log(f"[check] lk_align within 1e-3 px on {c['case']} N={c['n']} conv "
        f"{c['converged']} agree {c['flags_agree']:.4f} err "
        f"{c['max_abs_err']:.2e} ({c['ms']:.4f} ms, plain "
        f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.5f} ms)")

    phases.enter("loop bench")
    lcfg = loop_bench_config()
    t0 = time.perf_counter()
    lframes, lgt, _ = loop_frames(lcfg, LOOP_FRAMES)
    record_frames_agree(rec, "loop", lframes)
    loop = loop_bench(lcfg, lframes, lgt, counters, dev, rec)
    loop["render_s"] = time.perf_counter() - t0 - loop["vocabulary"][
        "seconds"]
    wo, wi = loop["without_closer"], loop["with_closer"]
    log(f"[loop bench] {LOOP_FRAMES} frames, vocabulary of "
        f"{loop['vocabulary']['words']} words from "
        f"{loop['vocabulary']['descriptors']} descriptors; without the "
        f"closer {wo['fps']:.2f} frames/s, closing error "
        f"{wo['closing_err_m']:.4f} m; with it over the first "
        f"{wi['frames']} frames {wi['fps']:.2f} frames/s, error at its last "
        f"frame {wi['closing_err_m']:.4f} m, loops closed "
        f"{wi['loops_closed']} at frames {wi['loop_events']}, "
        f"relocalizations {wi['reloc_events']}, lost after frames "
        f"{wi['lost_frames']} (without: {wo['lost_frames']}), launches "
        f"{wi['launches']}; the run took {wo['run_s']:.1f} s without and "
        f"{wi['run_s']:.1f} s with the closer, host s (calls) in "
        + ", ".join(f"{k} {v[0]:.2f} ({v[1]})"
                    for k, v in wi["host_s_in"].items())
        + "; the last correct_trajectory again: "
        + ", ".join(f"{t:.3f}" for t in wi["correct_trajectory_again_s"])
        + " s (JAX record: "
        f"{float(rec['loop.A.closing_err_m']):.4f} m without, "
        f"{float(rec['loop.B.closing_err_m']):.4f} m with, loops at "
        f"{rec['loop.B.loops'].tolist()}; the TPU's accuracies "
        f"(BENCH_r05.json): {TPU_LOOP_ACCURACY['without_closer_m']} m "
        f"without, {TPU_LOOP_ACCURACY['with_closer_m']} m with, "
        f"{TPU_LOOP_ACCURACY['loops_closed']} loops)")
    for key, run in (("without_closer", "A"), ("with_closer", "B"),
                     ("recorded_without_closer", "C"),
                     ("recorded_with_closer", "D")):
        fig, par = loop[key], loop[key]["parity"]
        log(f"[loop parity {run}] {key.replace('_', ' ')}"
            + (f" on the record's draws ({fig['draws_used']} used, "
               f"{fig['draws_missing']} missing)" if "draws_used" in fig
               else "")
            + f": first frame > 1 cm from JAX {par['first_parting']}, "
            f"first lost frame (either) {par['first_lost']}, max distance "
            f"until then {par['max_diff_until_lost_m']:.5f} m (over the "
            f"run {par['max_diff_m']:.4f} m); keyframes equal until lost "
            f"{par['keyframes_equal_until_lost']} (all "
            f"{par['keyframes_equal']}), BA equal until lost "
            f"{par['ba_equal_until_lost']} (all {par['ba_equal']}); lost "
            f"port {par['lost_port']} jax {par['lost_jax']}; loops port "
            f"{par['loops_port']} jax {par['loops_jax']}; relocalizations "
            f"port {par['relocs_port']} jax {par['relocs_jax']}; closing "
            f"error port {par['closing_err_port_m']:.4f} m (at frame "
            f"{fig['frames'] - 1}) jax {par['closing_err_jax_m']:.4f} m; "
            f"held {par['held']}")
    for key in ("recorded_without_closer", "recorded_with_closer"):
        if not loop[key]["parity"]["held"]:
            raise AssertionError(f"loop bench {key}: not held to the JAX "
                                 f"record: {loop[key]['parity']}")
    rep = loop["repeat"]
    wo2 = loop["without_closer_again"]
    log(f"[loop bench repeat] the closer-less run again on the same frames: "
        f"poses identical {rep['identical']} (first differing frame "
        f"{rep['first_frame_differing']}, max |diff| "
        f"{rep['max_pose_diff']:.3e}); closing error "
        f"{wo['closing_err_m']:.4f} m and {wo2['closing_err_m']:.4f} m")
    if not rep["identical"]:
        raise AssertionError(f"loop bench: the closer-less run did not "
                             f"repeat: {rep}")
    missing = [k for k, v in wi["launches"].items() if v == 0]
    if missing:
        raise AssertionError(f"loop bench: kernels not launched: {missing}")
    # run B is not gated: after the frames both packages lose at 36-45 its
    # outcome is amplified rounding, which a RANSAC seed moved from 0.0168
    # m to 253 m at the circle's end (PERF.md) and with which the JAX
    # record's own run B ends far off; the tracked and full-width loops
    # below gate the closer instead
    log(f"[loop bench B] not gated: {wi['frames']} frames, error at the "
        f"last {wi['closing_err_m']:.4f} m, loops {wi['loop_events']} "
        f"(the JAX record's run B over 96 frames: "
        f"{float(rec['loop.B.closing_err_m']):.1f} m, loops "
        f"{rec['loop.B.loops'].tolist()}; the loop is lost at frames 36-45 "
        f"in both packages)")
    t0 = time.perf_counter()
    tracked = closed_loops(counters, dev, rec, [("E", "loop_tracked"),
                                               ("E48", "loop_tracked48")],
                           "F")
    tracked["seconds"] = time.perf_counter() - t0
    loop["tracked"] = tracked
    log(f"[loop tracked] {tracked['frames']} frames {tracked['size']} of "
        f"the JAX package's loop test's circle, rendered in "
        f"{tracked['render_s']:.1f} s; vocabulary of "
        f"{tracked['vocabulary']['words']} words from "
        f"{tracked['vocabulary']['descriptors']} descriptors; "
        f"{tracked['seconds']:.1f} s in all")
    closed_loops_checked("loop tracked", tracked, {
        "E": "every frame", "E48": "well posed"}, "F", log)
    t0 = time.perf_counter()
    full = closed_loops(counters, dev, rec, [("G", "loop_full")], "H")
    full["seconds"] = time.perf_counter() - t0
    loop["full"] = full
    width, radius, ease = rec["loop_full.scene"].tolist()
    log(f"[loop full] {full['frames']} frames {full['size']} of the tracked "
        f"circle in a {width} m corridor (radius {radius} m, ease {ease}), "
        f"windowed BA on, rendered in {full['render_s']:.1f} s; vocabulary "
        f"of {full['vocabulary']['words']} words from "
        f"{full['vocabulary']['descriptors']} descriptors; "
        f"{full['seconds']:.1f} s in all")
    closed_loops_checked("loop full", full, {"G": "every frame"}, "H", log,
                         from_start=True)

    phases.enter("direct")
    direct, seed_case, direct_stages = direct_phase(counters, dev, rec)
    log(f"[direct] {direct['frames']} frames 1226x370, stereo on the first "
        f"only, {direct['timed']} timed: {direct['fps']:.2f} frames/s, ATE "
        f"{direct['ate_m']:.5f} m, tracked {direct['num_tracked']}, promoted "
        f"{direct['num_promoted']}, launches {direct['launches']}; "
        f"sparse_image_align {direct['sparse_image_align']['host_ms']:.1f} ms"
        f" host, features_align {direct['features_align']['host_ms']:.1f} ms "
        f"host a call (fenced; device ms in the profiles phase)")
    dp = direct["parity"]
    log(f"[direct parity] against the JAX record: first frame > 1 cm "
        f"{dp['first_parting']}, max distance {dp['max_diff_m']:.5f} m over "
        f"{dp['frames']} frames; tracked {direct['num_tracked']} (JAX "
        f"{dp['jax_tracked']}), promoted {direct['num_promoted']} (JAX "
        f"{dp['jax_promoted']}); held {dp['held']}")
    gate_launches("direct", direct["launches"],
                  ("lk_align", "fast_score_nms"))
    if not dp["held"]:
        raise AssertionError(f"direct: not held to the JAX record: {dp}")
    if not (direct["ate_m"] < 0.05 and direct["num_tracked"] > 40
            and direct["num_promoted"] > 50 and direct["finite"]):
        raise AssertionError(f"direct failed its gates: {direct}")

    phases.enter("indirect")
    indirect, indirect_cases = indirect_phase(counters, dev, rec)
    for s, fig in indirect.items():
        if s in ("render_s", "vocabulary"):
            continue
        log(f"[indirect {s}] {fig['frames']} stereo frames 752x480, "
            f"{fig['timed']} timed: {fig['fps']:.2f} frames/s, ATE "
            f"{fig['ate_m']:.5f} m, last-frame inliers {fig['last_inliers']},"
            f" launches {fig['launches']}")
        ip = fig["parity"]
        log(f"[indirect {s} parity] against the JAX record: first frame "
            f"> 1 cm {ip['first_parting']}, max distance "
            f"{ip['max_diff_m']:.5f} m over {ip['frames']} frames; "
            f"last-frame inliers JAX {ip['jax_last_inliers']}; held "
            f"{ip['held']}")
        gate_launches(f"indirect {s}", fig["launches"], tuple(counters))
        if not ip["held"]:
            raise AssertionError(f"indirect {s}: not held to the JAX "
                                 f"record: {ip}")
        if not (fig["ate_m"] < 0.04 and fig["last_inliers"] > 30
                and fig["finite"]):
            raise AssertionError(f"indirect {s} failed its gates: {fig}")

    phases.enter("mono")
    mono, back_case = mono_phase(counters, dev, rec)
    log(f"[mono] {mono['frames']} frames 1226x370, {mono['timed']} timed: "
        f"{mono['fps']:.2f} frames/s, initialized {mono['initialized']} at "
        f"frame {mono.get('init_frame')}, scale-aligned ATE "
        f"{mono.get('ate_m', float('nan')):.5f} m, live landmarks "
        f"{mono.get('landmarks')}, keyframes {mono['keyframes']}, BA calls "
        f"{mono['ba_calls']}, launches {mono['launches']}")
    mp = mono["parity"]
    log(f"[mono parity] on the record's draws ({mp['draws_used']} used, "
        f"{mp['draws_missing']} missing), against the JAX record: "
        f"bootstrapped at frame {mono.get('init_frame')} (JAX "
        f"{mp['jax_init_frame']}), first frame > 1 cm "
        f"{mp['first_parting']}, max distance {mp['max_diff_m']:.5f} m over "
        f"{mp['frames']} frames; held {mp['held']}")
    gate_launches("mono", mono["launches"], ("lk_align", "fast_score_nms",
                                             "orb_describe"))
    if not (mp["held"] and mono.get("init_frame") == mp["jax_init_frame"]):
        raise AssertionError(f"mono: not held to the JAX record: {mp}")
    if not mono["initialized"]:
        raise AssertionError(f"mono never bootstrapped: {mono}")
    if not (mono["ate_m"] < 0.06
            and mono["landmarks"] > 150 and mono["finite"]
            and mono["landmarks_finite"]):
        raise AssertionError(f"mono failed its gates: {mono}")

    if not mono["ba_calls"] > 0:
        raise AssertionError(f"mono ran no BA: {mono}")

    phases.enter("sequences")
    seqs, seq_cases = sequences_phase(counters, dev, out_dir)
    sk = seqs["kitti_layout"]
    log(f"[sequences kitti] {sk['frames']} corridor frames written as KITTI "
        f"PNGs (1226x370) in {sk['render_s']:.1f} s, decoded exactly "
        f"{sk['decoded_exactly']} ({2 * sk['frames']} images in "
        f"{sk['decode_all_s']:.2f} s); StereoVO at the main path's "
        f"configuration "
        f"fed by the loader, {sk['timed']} timed: {sk['fps']:.2f} frames/s "
        f"(the same frames from memory {sk['fps_in_memory']:.2f}, poses "
        f"equal {sk['poses_equal_in_memory']}), "
        f"ATE {sk['ate_m']:.5f} m (main path {ba_on['ate_m']:.5f} m), "
        f"last-frame inliers {sk['last_inliers']}, BA calls {sk['ba_calls']}, "
        f"launches {sk['launches']}; KITTI/TUM export round trip max |diff| "
        f"{sk['export_max_diff']:.2e}")
    if not (sk["decoded_exactly"] and sk["poses_equal_in_memory"]
            and sk["launches"] == launches
            and sk["ate_m"] < 0.05 and sk["last_inliers"] > 500
            and sk["finite"] and sk["export_max_diff"] < 1e-5):
        raise AssertionError(f"sequences kitti failed its gates: {sk}")
    sr = seqs["real_sequence_eval"]
    log(f"[sequences real_sequence_eval] {sr['dataset']}, {sr['frames']} "
        f".npy plane frames 1226x370 written in {sr['render_s']:.1f} s, at "
        f"kitti_stereo_config (1241x376 intrinsics, 5-level ORB): "
        f"{sr['fps']:.2f} frames/s, ATE {sr['ate_rmse_m']:.5f} m, launches "
        f"{sr['launches']}, trajectory files written {sr['files']}")
    if not (sr["dataset"] == "kitti00" and sr["frames"] == 10
            and sr["ate_rmse_m"] < 0.05 and all(sr["files"])):
        raise AssertionError(f"real_sequence_eval failed its gates: {sr}")
    gate_launches("real_sequence_eval", sr["launches"], tuple(counters))
    se = seqs["euroc_layout"]
    log(f"[sequences euroc] {se['frames']} corridor frames written in the "
        f"EuRoC layout (752x480) in {se['render_s']:.1f} s, stamps "
        f"{se['stamp_step_s']:.9f} s apart, ground-truth step "
        f"{se['gt_step_m']:.4f} m; StereoVO at euroc_stereo_config, "
        f"{se['timed']} timed: {se['fps']:.2f} frames/s, ATE "
        f"{se['ate_m']:.5f} m, last-frame inliers {se['last_inliers']}, "
        f"BA calls {se['ba_calls']}, launches {se['launches']}")
    if not (abs(se["stamp_step_s"] - 0.05) < 1e-6
            and 0.04 < se["gt_step_m"] < 0.12 and se["ate_m"] < 0.03
            and se["finite"]):
        raise AssertionError(f"sequences euroc failed its gates: {se}")
    gate_launches("sequences euroc", se["launches"], tuple(counters))
    su = seqs["undistort"]
    log(f"[sequences undistort] EuRoC cam0 radtan: undistort_image of the "
        f"first EuRoC frame on the card against the CPU max |diff| "
        f"{su['image_max_diff']:.2e}, undistort_points on a 16x16 grid "
        f"{su['points_max_diff_px']:.2e} px (largest shift "
        f"{su['points_max_shift_px']:.1f} px)")
    if not (su["image_max_diff"] <= 1e-3 and su["points_max_diff_px"] <= 1e-4):
        raise AssertionError(f"undistortion: card differs from CPU: {su}")
    sd = seqs["demo"]
    log(f"[sequences demo] demo.main([]) exit {sd['exit_code']} in "
        f"{sd['seconds']:.1f} s, launches {sd['launches']}; the phase took "
        f"{seqs['seconds']:.1f} s")
    if sd["exit_code"] != 0:
        raise AssertionError(f"the demo failed: {sd}")

    phases.enter("recorded kernel checks")
    c = check_fast(*indirect_cases["fast"], where="indirect last frame")[0]
    fast_cases.append(c)
    log("[check] fast_score_nms exact on "
        + ", ".join(f"{lv['shape'][0]}x{lv['shape'][1]}" for lv in c["levels"])
        + f" ({c['case']}; {c['ms']:.4f} ms, plain {c['plain_ms']:.3f} ms)")
    c = check_orb_describe(indirect_cases["orb"],
                           where="indirect last frame")[0]
    orb_cases.append(c)
    log(f"[check] orb_describe on {c['case']}, N={c['n']} ({c['valid']} "
        f"valid): max |d angle| {c['max_abs_err']:.2e} rad, bins agree "
        f"{c['bins_agree']:.5f}, descriptors exact ({c['ms']:.4f} ms, plain "
        f"{c['plain_ms']:.3f} ms)")
    c = check_anchor_cells(indirect_cases["anchor"],
                           where="indirect last keyframe")[0]
    anchor_cases.append(c)
    log(f"[check] anchor_cells exact on {c['case']} ({c['ms']:.4f} ms, plain "
        f"{c['plain_ms']:.3f} ms)")
    where = "KITTI real_sequence_eval last keyframe"
    c = check_fast(*seq_cases["fast"], where=where)[0]
    fast_cases.append(c)
    log("[check] fast_score_nms exact on "
        + ", ".join(f"{lv['shape'][0]}x{lv['shape'][1]}" for lv in c["levels"])
        + f" ({c['case']}; {c['ms']:.4f} ms, plain {c['plain_ms']:.3f} ms)")
    c = check_orb_describe(seq_cases["orb"], where=where)[0]
    orb_cases.append(c)
    log(f"[check] orb_describe on {c['case']}, N={c['n']} ({c['valid']} "
        f"valid): max |d angle| {c['max_abs_err']:.2e} rad, bins agree "
        f"{c['bins_agree']:.5f}, descriptors exact ({c['ms']:.4f} ms, plain "
        f"{c['plain_ms']:.3f} ms)")
    c = check_anchor_cells(seq_cases["anchor"], where=where)[0]
    anchor_cases.append(c)
    log(f"[check] anchor_cells exact on {c['case']} ({c['ms']:.4f} ms, plain "
        f"{c['plain_ms']:.3f} ms)")
    new_lk = check_lk([seed_case, back_case] + indirect_cases["lk"])
    lk_cases += new_lk
    log("[check] lk_align within 1e-3 px on "
        + ", ".join(f"{c['case']} N={c['n']} conv {c['converged']} agree "
                    f"{c['flags_agree']:.4f} err {c['max_abs_err']:.2e} "
                    f"({c['ms']:.4f} ms, plain {c['plain_ms']:.3f} ms, bound "
                    f"{c['bound_ms']:.5f} ms)" for c in new_lk))

    phases.enter("pose kernel")
    pose = pose_phase(rec, dev)

    phases.enter("batched")
    batched, batched_calls, track_steps = batched_phase(
        cfg, frames, gt, scene, counters, dev)
    bl, sl = batched["batched_launches"], batched["serial_launches"]
    held, mixed = batched["held"], batched["mixed_branch"]
    bisect, rates = batched["batch_check"], batched["dp_eval_bench"]
    log(f"[batched] {BATCH} sequences at {cfg.camera.width}x"
        f"{cfg.camera.height} (from frames {batched['starts']}), "
        f"{BATCH_TRACK_STEPS} batched track steps and one batched "
        f"track-and-keyframe step against serial runs: pyramid levels "
        f"differing after each track step "
        f"{batched['pyramids_differing_after_track_steps']}; max |d pose| "
        f"{batched['track_pose_max_diff']:.2e} after tracking (tracked "
        f"state leaves differing, [entries, of, max |diff|]: "
        f"{batched['track_state_leaves_differing']}), "
        f"{batched['kf_pose_max_diff']:.2e} after the keyframe; after it "
        f"the leaves differing {held['leaves_differing']}, largest "
        f"{held['largest']}, fresh keypoint positions differing "
        f"{held['fresh_xy_differing']} of {held['fresh_rows']} rows, gates "
        f"failed {held['failures']}; inliers {batched['inliers']} (serial "
        f"{batched['serial_inliers']}); launches a step batched {bl} "
        f"against serial {sl}; the phase took {batched['seconds']:.1f} s")
    log(f"[batched: mixed branch] a fresh sequence beside {BATCH - 1} "
        f"tracked ones, one batched keyframe step against serial ones: "
        f"leaves differing {mixed['leaves_differing']}, fresh keypoint "
        f"positions differing {mixed['fresh_xy_differing']} of "
        f"{mixed['fresh_rows']} rows, rows with a right-image u "
        f"{mixed['with_ur']}, gates failed {mixed['failures']}")
    log(f"[batched: batch_check] the keyframe frame's calls on the serial "
        f"states, serial against vmap on the same inputs: differing by "
        f"stage {bisect['differing_by_stage']}; image side differing "
        f"{bisect['image_side_differing']}; not repeatable "
        f"{bisect['not_repeatable']}; whole steps "
        f"{bisect['steps']}")
    log(f"[batched: dp_eval_bench] {DP_STEPS} steps: B1 "
        f"{rates['B1_seq_frames_per_s']:.2f}, B{BATCH} "
        f"{rates[f'B{BATCH}_seq_frames_per_s']:.2f} sequence-frames/s "
        f"(x{rates['batch_speedup']:.2f})")
    kf_expected = dict(sl["track_and_keyframe_step"])
    kf_expected["lk_align"] += 1   # both sides of the stereo-prior branch
    if not (batched["track_pose_max_diff"] <= 1e-5
            and batched["kf_pose_max_diff"] <= 1e-5
            and not any(batched["pyramids_differing_after_track_steps"])
            and not held["failures"] and not mixed["failures"]
            and min(mixed["with_ur"]) >= 50
            and batched["sequences_distinct"]
            and bl["track_step"] == sl["track_step"]
            and bl["track_and_keyframe_step"] == kf_expected):
        raise AssertionError(f"batched tracking failed its gates: "
                             f"{ {k: v for k, v in batched.items() if k != 'batch_check'} }")
    bcases = check_batched(batched_calls)
    lk_cases += bcases["lk"]
    fast_cases += bcases["fast"]
    orb_cases += bcases["orb"]
    anchor_cases += bcases["cells"]
    log("[check] batched kernel calls against their plain versions per "
        "sequence: " + "; ".join(
            f"{c['case']}: err {c['max_abs_err']:.2e} ({c['ms']:.4f} ms, "
            f"plain {c['plain_ms']:.3f} ms, bound {c['bound_ms']:.5f} ms)"
            for k in ("lk", "fast", "orb", "cells") for c in bcases[k]))

    phases.enter("BA")
    ba = ba_phase(dev)
    gap = ba["distributed_vs_one_device"]
    log(f"[BA] {ba['landmarks']} landmarks x {ba['keyframes']} keyframes x "
        f"{ba['obs_per_landmark']} observations, {ba['reps']} windows, "
        f"median of {ba['sweeps']} readings (min-max): "
        + ", ".join(f"{k} {v['iters_per_s']:.1f} iterations/s "
                    f"({v['min']:.1f}-{v['max']:.1f}; "
                    f"{v['ms_per_iter']:.3f} ms)"
                    for k, v in ba["iters"].items())
        + f", distributed / one device {gap['median_ratio']:.3f} (ranges "
          f"{'overlap' if gap['ranges_overlap'] else 'apart'})"
        + f"; distributed at world {ba['world_size']} over {ba['backend']}"
          f" against the one-device solves: grouped poses "
          f"{ba['grouped_pose_err']:.2e}, points "
          f"{ba['grouped_points_max_diff']:.2e} m, flat poses "
          f"{ba['flat_pose_err']:.2e}, points "
          f"{ba['flat_points_max_diff']:.2e} m (the solve moved points by "
          f"up to {ba['points_moved']:.3f} m); the phase took "
          f"{ba['seconds']:.1f} s")
    if not (ba["grouped_pose_err"] < 5e-4 and ba["flat_pose_err"] < 5e-4
            and ba["grouped_points_max_diff"] < 5e-4
            and ba["flat_points_max_diff"] < 5e-4
            and ba["points_moved"] > 1e-2):
        raise AssertionError(f"distributed BA failed its gates: {ba}")

    phases.enter("main path, BA on, again")
    vo, again = main_path(cfg, frames, gt, counters, dev)
    again["poses_equal_first_run"] = torch.equal(torch.stack(vo.trajectory),
                                                  live_traj)
    again["fps_over_first_run"] = again["fps"] / ba_on["fps"]
    del vo
    probe = {p["phase"]: p for p in phases.probes}
    log(f"[main path, BA on, again] the last timed phase: {again['fps']:.2f} "
        f"frames/s against {ba_on['fps']:.2f} in the first run "
        f"(x{again['fps_over_first_run']:.3f}; the host's pure-Python loop "
        f"{probe['main path, BA on, again']['python_ms']:.1f} ms against "
        f"{probe['main path, BA on']['python_ms']:.1f} ms before the first "
        f"run); poses equal to the first run "
        f"{again['poses_equal_first_run']}, launches {again['launches']}")
    if not (again["poses_equal_first_run"] and again["launches"] == launches):
        raise AssertionError(f"the BA-on main path did not repeat: {again}")

    phases.enter("bench")
    line = bench_child(here)
    ex = line["extra"]
    log(f"[bench] python -m trackingbench_slam_tpu_torch.bench --frames "
        f"{N_FRAMES} in a fresh process ({line['seconds']:.1f} s): "
        + json.dumps({k: v for k, v in line.items() if k != "seconds"}))
    log(f"[bench] {line['value']} frames/s against the CPU reference's "
        f"{ex['cpu_reference_fps']} on the same {ex['cpu_reference_frames']} "
        f"frames: vs_baseline {line['vs_baseline']} (BASELINE.json asks for "
        f"2); ATE {ex['ate_rmse_m']} m (CPU reference "
        f"{ex['cpu_reference_ate_m']} m)")
    bench_gate(line)

    phases.enter("profiles")
    t0 = time.perf_counter()
    attributed = attribution(phases, attribution_cases(
        lk_inputs, lk_cases, pyr, fast_args, fast_cases[0], orb_case,
        orb_cases[0], anchor_case, anchor_cases[0]))
    log("[profiles: attribution] each kernel's calls inside its models/vo.py "
        f"range, {ATTRIBUTION_CALLS} a case, under torch.profiler: " + "; ".join(
            f"{r['kernel']} in {r['range']}: {r['kernel_events']} events, "
            f"{r['profiled_ms']:.5f} ms a call against {r['event_ms']:.5f} "
            f"from CUDA events (x{r['ratio']:.3f}), custom op "
            f"{r['op_ms']:.5f} ms, range {r['range_ms']:.5f} ms"
            for r in attributed))
    bad = [r for r in attributed if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels not attributed to their op and range "
                             f"within {ATTRIBUTION_TOL:.0%}: {bad}")
    kernel_cases = dict(lk_align=lk_cases, fast_score_nms=fast_cases,
                        orb_describe=orb_cases, anchor_cells=anchor_cases)
    profiled_cases(phases, kernel_cases)
    log("[profiles: kernel cases] every checked kernel call, "
        f"{ATTRIBUTION_CALLS} a case, device ms a call under torch.profiler "
        "against CUDA events: " + "; ".join(
            f"{c['case']}: {c['profiled_ms']:.5f} / {c['ms']:.5f}"
            for rows in kernel_cases.values() for c in rows))
    window = attributed_window(phases, cfg, frames, dev)
    log("[profiles: main path] frame 14 (a keyframe) under "
        "torch.profiler, device ms a call of each range and of the hand "
        "kernels' custom ops inside it: " + "; ".join(
            f"{r} {window['stages'][r]['device_ms_per_call']:.4f} ("
            + ", ".join(f"{k.split('::')[1]} {v['device_ms']:.4f} in "
                        f"{v['calls']}"
                        for k, v in window["stages"][r]["ops"].items()) + ")"
            for r in KERNEL_RANGES if r in window["stages"]))
    if window["missing"]:
        raise AssertionError(f"main path: kernels not inside their ranges: "
                             f"{window['missing']}")
    for key, fn in direct_stages.items():
        direct[key].update(profile_call(phases, fn))
    log(f"[profiles: direct] sparse_image_align "
        f"{direct['sparse_image_align']['device_ms']:.3f} ms device in "
        f"{direct['sparse_image_align']['cuda_kernels']:.0f} kernels, "
        f"features_align {direct['features_align']['device_ms']:.3f} ms in "
        f"{direct['features_align']['cuda_kernels']:.0f} kernels a call")
    prof = {k: profile_call(phases, fn)
            for k, fn in track_steps.items()}
    ck = {k: v["cuda_kernels"] for k, v in prof.items()}
    batched.update(cuda_kernels_per_track_step=ck, track_step_profile=prof)
    log(f"[profiles: batched] CUDA kernels a track step B={BATCH} "
        f"{ck['batched']:.0f}, B=1 {ck['b1']:.0f}, serial "
        f"{ck['serial']:.0f}; the phase took "
        f"{time.perf_counter() - t0:.1f} s")
    if not ck["batched"] <= 1.5 * ck["b1"]:
        raise AssertionError(f"batched track step: {ck} CUDA kernels")

    phases.enter("profiler history")
    history = profiler_history(here)
    hb, ha = history["before"], history["after"]
    log(f"[profiler history] profile_main_path --history in a child process:"
        f" {len(hb['runs'])} fresh BA-on main-path runs "
        f"{hb['fps_median']:.2f} frames/s ({hb['fps_min']:.2f}-"
        f"{hb['fps_max']:.2f}), one torch.profiler session, then "
        f"{len(ha['runs'])} more {ha['fps_median']:.2f} ({ha['fps_min']:.2f}-"
        f"{ha['fps_max']:.2f}): x{history['after_over_before']:.3f}, ranges "
        f"{'overlap' if history['ranges_overlap'] else 'apart'}; small-op "
        f"launch " + ", ".join(f"{r['launch_us']:.2f}"
                               for r in hb["runs"] + ha["runs"])
        + f" us; {history['seconds']:.1f} s")

    paths = {"main_path_ba_off": ba_off["launches"],
             "main_path": launches,
             "main_path_prefetch": prefetch["launches"],
             "offline": offline["launches"],
             "photometric_plain": photometric["plain"]["launches"],
             "photometric_clahe": photometric["clahe"]["launches"],
             "loop_bench_without_closer": wo["launches"],
             "loop_bench_without_closer_again": wo2["launches"],
             "loop_bench_with_closer": wi["launches"],
             "loop_bench_recorded_without_closer":
                 loop["recorded_without_closer"]["launches"],
             "loop_bench_recorded_with_closer":
                 loop["recorded_with_closer"]["launches"],
             **{f"loop_tracked_{k}": loop["tracked"][k]["launches"]
                for k in ["E", "E48", "F_without"]
                + [f"F_seed{s}" for s in F_SEEDS]},
             **{f"loop_full_{k}": loop["full"][k]["launches"]
                for k in ["G", "H_without"]
                + [f"H_seed{s}" for s in F_SEEDS]},
             "direct": direct["launches"],
             **{f"indirect_{s}": fig["launches"]
                for s, fig in indirect.items()
                if s not in ("render_s", "vocabulary")},
             "mono": mono["launches"],
             "sequences_kitti": sk["launches"],
             "sequences_real_sequence_eval": sr["launches"],
             "sequences_euroc": se["launches"], "demo": sd["launches"],
             f"batched_track_step_B{BATCH}": bl["track_step"],
             f"batched_track_and_keyframe_step_B{BATCH}":
                 bl["track_and_keyframe_step"]}

    def entry(name, source, replaces, primary, cases, err="max_abs_err",
              case_err="max_abs_err"):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name],
                    launches_by_path={p: v[name] for p, v in paths.items()},
                    **{err: max(c[case_err] for c in cases)},
                    ms=primary["ms"], plain_ms=primary["plain_ms"],
                    bound_ms=primary["bound_ms"],
                    bound_by=primary["bound_by"],
                    library_ms=primary.get("library_ms"),
                    cases=cases)

    kernels = [
        entry("lk_align", "trackingbench_slam_tpu_torch/csrc/lk.cu",
              "trackingbench_slam_tpu/ops/pallas/lk_kernel.py:347",
              lk_cases[0], lk_cases),
        entry("fast_score_nms", "trackingbench_slam_tpu_torch/csrc/fast.cu",
              "trackingbench_slam_tpu/ops/pallas/fast_kernel.py:126",
              fast_cases[0], fast_cases),
        entry("orb_describe", "trackingbench_slam_tpu_torch/csrc/patch.cu",
              "trackingbench_slam_tpu/ops/pallas/patch_kernel.py:103",
              orb_cases[0], orb_cases),
        entry("anchor_cells", "trackingbench_slam_tpu_torch/csrc/patch.cu",
              "trackingbench_slam_tpu/ops/pallas/patch_kernel.py:103",
              anchor_cases[0], anchor_cases),
        entry("pose_round", "trackingbench_slam_tpu_torch/csrc/pose.cu",
              None, pose[0], pose, err="max_pose_gap", case_err="pose_gap"),
    ]
    result = {"kernels": kernels, "main_path": ba_on,
              "main_path_again": again, "attribution": attributed,
              "attributed_window": window, "profiler_history": history,
              "phase_probes": phases.probes,
              "main_path_ba_off": dict(ba_off, orb_budgets=budgets),
              "prefetch": prefetch, "offline": offline,
              "photometric": photometric,
              "loop_bench": dict(loop, tpu_accuracy=TPU_LOOP_ACCURACY),
              "direct": direct, "indirect": indirect, "mono": mono,
              "sequences": seqs, "batched": batched, "ba": ba,
              "bench": line,
              "seconds": time.perf_counter() - t_start}
    log(f"[time] the whole script took {result['seconds']:.1f} s")
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(dict(result, device=kind, nvidia_smi=smi), fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
