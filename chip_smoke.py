#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (trackingbench_slam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure ends the run with a non-zero exit:
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
     circle, 3 LK tracking levels, BA on; a vocabulary trained on the card's
     ORB descriptors of every 12th left image; the run without a
     LoopCloser twice, whose per-frame poses must be torch.equal, and one
     with it: the closer must close >= 1 loop, its closing error must be
     < 0.05 m and below the closer-less run's, and every counter must move
     in the run with the closer;
  10. direct: DirectVO at bench.py's camera and features on the direct
     pyramid (5 levels x0.8), 24 corridor frames, stereo on the first only:
     ATE < 0.05 m, > 40 tracked, > 50 promoted seeds, LK and FAST launched;
     sparse_image_align and features_align on the run's last call, fenced
     host ms and profiled device ms;
  11. indirect: IndirectVO at the EuRoC operating point (752x480), 12 stereo
     corridor frames, each of the five match strategies (BoW on a
     vocabulary trained on the card's ORB of every 3rd left image): ATE
     < 0.04 m, > 30 last-frame inliers, all four kernels launched;
  12. mono: MonoVO at the main path's camera, features and map, 28 lateral
     frames: bootstrapped, scale-aligned ATE after it < 0.06 m, > 150 live
     landmarks, everything finite, LK, FAST and ORB describe launched,
     BA counted;
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
  14. a `kernels` JSON line (launches on every path), the script's seconds,
     then the card's nvidia-smi line, then the result line
     {"ok": true, "device": {...}}.

Imports nothing of JAX. Needs the package beside it: run from a checkout.
"""

import contextlib
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
WARM_FRAMES = 11
WARM_DIRECT = 4
WARM_MONO = 4
BA_OFF_LAUNCHES = {"lk_align": 57, "fast_score_nms": 9, "orb_describe": 9,
                   "anchor_cells": 9}
# the JAX package's loop-bench accuracy record (BENCH_r05.json)
LOOP_RECORD = dict(without_closer_m=0.7764, with_closer_m=0.0085,
                   loops_closed=2)


def log(msg):
    print(msg, flush=True)


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
                 plain_ms=plain_ms, bound_ms=b, bound_by=by)]


# ORB describe per valid point: two multiply-adds for each of the circle's
# pixels (4 ops each), atan2 (~20) and the bin (6), 256 compares and 256
# shift-ors to pack them.
def orb_ops_per_point():
    from trackingbench_slam_tpu_torch.ops import orb
    return 4 * int(orb._circle_umax_mask().sum()) + 20 + 6 + 2 * 256


def orb_describe_agreement(raw, blurred, xy, valid, counts):
    """Kernel against plain on one call; returns (max wrapped angle error
    over valid rows, share of valid rows whose angle bins agree)."""
    import torch
    from trackingbench_slam_tpu_torch.ops import orb
    from trackingbench_slam_tpu_torch.ops.cuda import patch_kernel
    args = (raw, blurred, xy, valid, counts)
    got_a, got_d = patch_kernel.orb_describe_cuda(*args)
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
    px = 0
    for img, p, v in zip(raw, xy.split(counts), valid.split(counts)):
        r0, c0 = patch_kernel.patch_origins(p[v], *img.shape)
        px += covered_pixels(img.shape, [(r0, c0, patch_kernel.PATCH)])
    n, n_valid = xy.shape[0], int(valid.sum())
    table = patch_kernel.brief_pairs(xy.device)
    b, by = bound(2 * 4 * px + n * (8 + 1 + 4 + 32)
                  + table.numel() * table.element_size(),
                  n_valid * orb_ops_per_point())
    return [dict(case=f"{where}: {len(raw)}-level ORB describe, one launch",
                 shapes=[list(img.shape) for img in raw], n=n,
                 valid=n_valid, counts=list(counts), bins_agree=bins_agree,
                 also_checked="every 7th row invalid",
                 max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                 bound_ms=b, bound_by=by, library_ms=None)]


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
    x0 = torch.floor(kp_xy[ok])
    r0, c0 = patch_kernel.patch_origins(x0 + 7.0, h, w)
    px = covered_pixels(img.shape, [(r0, c0, c + 1)])
    b, by = bound(4 * px + n_ok * c * c * 4 + n * (8 + 4 + 1),
                  n_ok * (c * c * 9 + 4))
    return [dict(case=f"{where}, N={n}, {n_ok} cells into a "
                      f"{atlas.shape[0]}^2 atlas",
                 n=n, cells=n_ok, max_abs_err=err, ms=ms, host_ms=host_ms,
                 call_ms=call_ms, clone_ms=clone_ms, plain_ms=plain_ms,
                 bound_ms=b, bound_by=by, library_ms=library_ms,
                 library_max_abs_diff=library_diff)]


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
        b, by = bound(lk_bytes(work, n, kw["half"], fb,
                               kw.get("offset") is not None),
                      lk_flops(work, kw["half"]))
        out.append(dict(case=name, levels=len(prev), shape=list(cur[0].shape),
                        n=n, launches_per_call=launches,
                        converged=int(ref[1].sum()), flags_agree=agree,
                        fb_flags_agree=fb_agree, max_abs_err=err, ms=ms,
                        host_ms=host_ms, plain_ms=plain_ms, bound_ms=b,
                        bound_by=by,
                        work=dict(points_run=[int(lv["run"].sum())
                                              for lv in work["levels"]],
                                  templates=work["templates"],
                                  iterations=work["iterations"])))
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


def drive(vo, frames, counters):
    """A StereoVO over `frames` (run_counted after an 11-frame warm-up);
    returns (frames/s, launches per counter, the timed frames after which
    the tracker flagged itself lost)."""
    lost = []

    def track(i, frame):
        vo.track(*frame)
        if vo.lost and i >= WARM_FRAMES:
            lost.append(i)
    return (*run_counted(counters, vo.device, frames, track, WARM_FRAMES),
            lost)


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


def loop_bench(cfg, frames, gt, counters, device):
    """bench.py's loop_closing_bench on the port: the same frames without
    the closer twice (the second run repeats the first, pose for pose) and
    with a LoopCloser."""
    import torch
    from trackingbench_slam_tpu_torch.models.loop_closer import LoopCloser
    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    from trackingbench_slam_tpu_torch.repeat_check import train_vocabulary
    from trackingbench_slam_tpu_torch.utils.corridor import closing_error
    t0 = time.perf_counter()
    voc, n_desc = train_vocabulary(cfg, frames, device)
    out = dict(vocabulary=dict(descriptors=n_desc, words=voc.num_words,
                               seconds=time.perf_counter() - t0))
    trajectories = []
    for key, with_lc in (("without_closer", False),
                         ("without_closer_again", False),
                         ("with_closer", True)):
        vo = StereoVO(cfg, device=device)
        if with_lc:
            vo.loop_closer = LoopCloser(voc, vo.cam, min_score=0.015,
                                        min_inliers=40, exclude_recent=5)
        # where the closer's host time goes, over all 96 frames
        spent, _ = time_methods(vo, ["_track_keyframe_with_loop",
                                     "_finish_loop_detect", "_close_loop",
                                     "_relocalize"] if with_lc else [])
        if with_lc:
            closer_spent, closer_args = time_methods(vo.loop_closer, [
                "_issue_verify", "_finish_verify", "correct_trajectory"])
            spent.update(closer_spent)
        t0 = time.perf_counter()
        fps, launches, lost = drive(vo, frames, counters)
        wall = time.perf_counter() - t0
        if not with_lc:
            trajectories.append(torch.stack(vo.trajectory))
        out[key] = dict(
            fps=fps, closing_err_m=closing_error(vo.poses(), gt),
            loops_closed=len(vo.loop_events), loop_events=vo.loop_events,
            reloc_events=vo.reloc_events, lost_frames=lost,
            ba_calls=vo.ba_calls, launches=launches, run_s=wall,
            host_s_in=spent)
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


@contextlib.contextmanager
def watched(module, name, pick, last=False):
    """While inside, calls of module.<name> go through unchanged; the
    arguments (args, kwargs) of the first call that `pick` accepts (with
    `last`, of the last one) are kept in the yielded list."""
    real = getattr(module, name)
    kept = []

    def call(*args, **kwargs):
        if pick(args, kwargs) and (last or not kept):
            kept[:] = [(args, kwargs)]
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


def profile_calls(fn, device, reps=3):
    """fn()'s fenced host ms, device ms (the kernels it launched, under
    torch.profiler), CUDA kernels, and the five kernels with the most
    device time (name, ms), each per call."""
    from trackingbench_slam_tpu_torch.profile_main_path import (
        device_events, profiled)
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    avgs, _ = profiled(lambda: [fn() for _ in range(reps)])
    device_ev = device_events(avgs)
    top = sorted(device_ev, key=lambda e: -e.self_device_time_total)[:5]
    return dict(host_ms=host_ms,
                device_ms=sum(e.self_device_time_total
                              for e in device_ev) / 1e3 / reps,
                cuda_kernels=sum(e.count for e in device_ev) / reps,
                top_device_ms=[[e.key[:100], e.self_device_time_total / 1e3
                                / reps] for e in top])


def direct_phase(counters, device):
    """DirectVO at bench.py's camera on the reference's direct pyramid: 24
    corridor frames, stereo on the first only, so every later landmark is a
    promoted depth-filter seed."""
    from trackingbench_slam_tpu_torch.matchers import direct
    from trackingbench_slam_tpu_torch.models import direct_vo
    from trackingbench_slam_tpu_torch.utils import metrics
    from trackingbench_slam_tpu_torch.utils.corridor import (direct_config,
                                                             direct_frames)
    cfg = direct_config()
    t0 = time.perf_counter()
    frames, gt = direct_frames(cfg)
    render_s = time.perf_counter() - t0
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
               finite=bool(np.isfinite(poses).all()), launches=launches)
    # the two direct stages on the run's last call, fenced and profiled
    for key, (module_fn, call) in {"sparse_image_align": (
            direct.sparse_image_align, sia), "features_align": (
            direct.features_align, fa)}.items():
        args, kwargs = call[0]
        fig[key] = profile_calls(lambda: module_fn(*args, **kwargs), device)
    return fig, lk_case("direct seed, half 6, 2 levels, prior", seed[0])


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


def indirect_phase(counters, device):
    """IndirectVO at the EuRoC operating point (752x480, 2000 features, 5
    levels x0.8), 12 stereo corridor frames, each of the five strategies;
    BoW on a vocabulary trained on the card's ORB of every 3rd left image.
    Returns (figures, the kernel calls of the first strategy's run)."""
    from trackingbench_slam_tpu_torch.models.indirect_vo import (
        IndirectVO, MatchStrategy)
    from trackingbench_slam_tpu_torch.repeat_check import train_vocabulary
    from trackingbench_slam_tpu_torch.utils import metrics
    from trackingbench_slam_tpu_torch.utils.config import euroc_stereo_config
    from trackingbench_slam_tpu_torch.utils.corridor import indirect_frames
    cfg = euroc_stereo_config()
    t0 = time.perf_counter()
    frames, gt = indirect_frames(cfg)
    out = dict(render_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    voc, n_desc = train_vocabulary(cfg, frames, device, every=3)
    out["vocabulary"] = dict(descriptors=n_desc, words=voc.num_words,
                             seconds=time.perf_counter() - t0)
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
            finite=bool(np.isfinite(poses).all()), launches=launches)
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


def mono_phase(counters, device):
    """MonoVO at the main path's camera, pyramid, features and map: 28
    lateral corridor frames, left images only."""
    from trackingbench_slam_tpu_torch.models import mono_vo
    from trackingbench_slam_tpu_torch.utils import metrics
    from trackingbench_slam_tpu_torch.utils.corridor import (mono_config,
                                                             mono_frames)
    cfg = mono_config()
    t0 = time.perf_counter()
    frames, gt = mono_frames(cfg)
    render_s = time.perf_counter() - t0
    vo = mono_vo.MonoVO(cfg, min_parallax_px=20.0, device=device)
    with watched(mono_vo, "lk_pyramidal", lambda a, k: k.get(
            "num_levels") == 1 and k.get("iters") == 10) as back:
        fps, launches = run_counted(counters, device, frames,
                                    lambda i, f: vo.track(f), WARM_MONO)
    poses = vo.poses()
    fig = dict(frames=len(frames), timed=len(frames) - WARM_MONO, fps=fps,
               render_s=render_s, initialized=vo.initialized,
               finite=bool(np.isfinite(poses).all()), launches=launches,
               keyframes=vo.kf_count, ba_calls=vo.ba_calls)
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import trackingbench_slam_tpu_torch  # noqa: F401  (precision pins)
    from trackingbench_slam_tpu_torch.kernel_bench import kernel_inputs
    from trackingbench_slam_tpu_torch.ops.cuda import (build, fast_kernel,
                                                       lk_kernel,
                                                       patch_kernel)
    from trackingbench_slam_tpu_torch.utils.corridor import (
        corridor_frames, loop_bench_config, loop_frames, main_path_config,
        main_path_config_ba_off)

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

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

    pyr, lk_inputs, orb_case, anchor_case, budgets = kernel_inputs(
        cfg, frames, scene, gt)
    fast_cases = check_fast(pyr, float(cfg.extractor.min_threshold),
                            cfg.extractor.fast_arc)
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

    counters = {"lk_align": lk_kernel.lk_align_cuda,
                "fast_score_nms": fast_kernel.fast_score_nms_cuda,
                "orb_describe": patch_kernel.orb_describe_cuda,
                "anchor_cells": patch_kernel.anchor_cells_cuda}
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

    _, ba_off = main_path(main_path_config_ba_off(), frames, gt, counters,
                          dev)
    log(f"[main path, BA off] {N_FRAMES} frames, {ba_off['timed']} timed: "
        f"{ba_off['fps']:.2f} frames/s, ATE {ba_off['ate_m']:.5f} m, "
        f"last-frame inliers {ba_off['last_inliers']}, live landmarks "
        f"{ba_off['landmarks']}, launches {ba_off['launches']}")
    gate("main path, BA off", ba_off,
         ba_off["launches"] == BA_OFF_LAUNCHES)

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

    lcfg = loop_bench_config()
    t0 = time.perf_counter()
    lframes, lgt, _ = loop_frames(lcfg, LOOP_FRAMES)
    loop = loop_bench(lcfg, lframes, lgt, counters, dev)
    loop["render_s"] = time.perf_counter() - t0 - loop["vocabulary"][
        "seconds"]
    wo, wi = loop["without_closer"], loop["with_closer"]
    log(f"[loop bench] {LOOP_FRAMES} frames, vocabulary of "
        f"{loop['vocabulary']['words']} words from "
        f"{loop['vocabulary']['descriptors']} descriptors; without the "
        f"closer {wo['fps']:.2f} frames/s, closing error "
        f"{wo['closing_err_m']:.4f} m; with it {wi['fps']:.2f} frames/s, "
        f"closing error {wi['closing_err_m']:.4f} m, loops closed "
        f"{wi['loops_closed']} at frames {wi['loop_events']}, "
        f"relocalizations {wi['reloc_events']}, lost after frames "
        f"{wi['lost_frames']} (without: {wo['lost_frames']}), launches "
        f"{wi['launches']}; the run took {wo['run_s']:.1f} s without and "
        f"{wi['run_s']:.1f} s with the closer, host s (calls) in "
        + ", ".join(f"{k} {v[0]:.2f} ({v[1]})"
                    for k, v in wi["host_s_in"].items())
        + "; the last correct_trajectory again: "
        + ", ".join(f"{t:.3f}" for t in wi["correct_trajectory_again_s"])
        + " s "
        f"(JAX record: {LOOP_RECORD['without_closer_m']} m without, "
        f"{LOOP_RECORD['with_closer_m']} m with, "
        f"{LOOP_RECORD['loops_closed']} loops)")
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
    if not (wi["loops_closed"] >= 1 and wi["closing_err_m"] < 0.05
            and wi["closing_err_m"] < wo["closing_err_m"]):
        raise AssertionError(f"loop bench failed its gates: {loop}")

    direct, seed_case = direct_phase(counters, dev)
    log(f"[direct] {direct['frames']} frames 1226x370, stereo on the first "
        f"only, {direct['timed']} timed: {direct['fps']:.2f} frames/s, ATE "
        f"{direct['ate_m']:.5f} m, tracked {direct['num_tracked']}, promoted "
        f"{direct['num_promoted']}, launches {direct['launches']}; "
        f"sparse_image_align {direct['sparse_image_align']['host_ms']:.1f} ms"
        f" host / {direct['sparse_image_align']['device_ms']:.3f} ms device "
        f"in {direct['sparse_image_align']['cuda_kernels']:.0f} kernels, "
        f"features_align {direct['features_align']['host_ms']:.1f} / "
        f"{direct['features_align']['device_ms']:.3f} ms in "
        f"{direct['features_align']['cuda_kernels']:.0f} kernels a call")
    gate_launches("direct", direct["launches"],
                  ("lk_align", "fast_score_nms"))
    if not (direct["ate_m"] < 0.05 and direct["num_tracked"] > 40
            and direct["num_promoted"] > 50 and direct["finite"]):
        raise AssertionError(f"direct failed its gates: {direct}")

    indirect, indirect_cases = indirect_phase(counters, dev)
    for s, fig in indirect.items():
        if s in ("render_s", "vocabulary"):
            continue
        log(f"[indirect {s}] {fig['frames']} stereo frames 752x480, "
            f"{fig['timed']} timed: {fig['fps']:.2f} frames/s, ATE "
            f"{fig['ate_m']:.5f} m, last-frame inliers {fig['last_inliers']},"
            f" launches {fig['launches']}")
        gate_launches(f"indirect {s}", fig["launches"], tuple(counters))
        if not (fig["ate_m"] < 0.04 and fig["last_inliers"] > 30
                and fig["finite"]):
            raise AssertionError(f"indirect {s} failed its gates: {fig}")

    mono, back_case = mono_phase(counters, dev)
    log(f"[mono] {mono['frames']} frames 1226x370, {mono['timed']} timed: "
        f"{mono['fps']:.2f} frames/s, initialized {mono['initialized']} at "
        f"frame {mono.get('init_frame')}, scale-aligned ATE "
        f"{mono.get('ate_m', float('nan')):.5f} m, live landmarks "
        f"{mono.get('landmarks')}, keyframes {mono['keyframes']}, BA calls "
        f"{mono['ba_calls']}, launches {mono['launches']}")
    gate_launches("mono", mono["launches"], ("lk_align", "fast_score_nms",
                                             "orb_describe"))
    if not mono["initialized"]:
        raise AssertionError(f"mono never bootstrapped: {mono}")
    if not (mono["ate_m"] < 0.06
            and mono["landmarks"] > 150 and mono["finite"]
            and mono["landmarks_finite"]):
        raise AssertionError(f"mono failed its gates: {mono}")

    if not mono["ba_calls"] > 0:
        raise AssertionError(f"mono ran no BA: {mono}")

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

    paths = {"main_path_ba_off": ba_off["launches"],
             "main_path": launches,
             "main_path_prefetch": prefetch["launches"],
             "offline": offline["launches"],
             "photometric_plain": photometric["plain"]["launches"],
             "photometric_clahe": photometric["clahe"]["launches"],
             "loop_bench_without_closer": wo["launches"],
             "loop_bench_without_closer_again": wo2["launches"],
             "loop_bench_with_closer": wi["launches"],
             "direct": direct["launches"],
             **{f"indirect_{s}": fig["launches"]
                for s, fig in indirect.items()
                if s not in ("render_s", "vocabulary")},
             "mono": mono["launches"],
             "sequences_kitti": sk["launches"],
             "sequences_real_sequence_eval": sr["launches"],
             "sequences_euroc": se["launches"], "demo": sd["launches"]}

    def entry(name, source, replaces, primary, cases):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name],
                    launches_by_path={p: v[name] for p, v in paths.items()},
                    max_abs_err=max(c["max_abs_err"] for c in cases),
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
    ]
    result = {"kernels": kernels, "main_path": ba_on,
              "main_path_ba_off": dict(ba_off, orb_budgets=budgets),
              "prefetch": prefetch, "offline": offline,
              "photometric": photometric,
              "loop_bench": dict(loop, jax_record=LOOP_RECORD),
              "direct": direct, "indirect": indirect, "mono": mono,
              "sequences": seqs,
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
