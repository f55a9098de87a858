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
  6. loop bench (bench.py's loop_closing_bench): 96 frames of a closed
     circle, 3 LK tracking levels, BA on; a vocabulary trained on the card's
     ORB descriptors of every 12th left image; one run without and one with
     a LoopCloser: the closer must close >= 1 loop, its closing error must
     be < 0.05 m and below the closer-less run's, and every counter must
     move in the run with the closer;
  7. a `kernels` JSON line, then the card's nvidia-smi line, then the
     result line {"ok": true, "device": {...}}.

Imports nothing of JAX. Needs the package beside it: run from a checkout.
"""

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
N_FRAMES = 40
LOOP_FRAMES = 96
WARM_FRAMES = 11
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


def check_fast(pyr, threshold, arc):
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
    return [dict(case=f"{len(pyr)}-level ORB pyramid, one launch",
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


def check_orb_describe(case):
    """The bootstrap keyframe's describe in one launch for all levels; and
    the same call with every 7th row invalid (the bootstrap has none, later
    keyframes do)."""
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
    return [dict(case=f"{len(raw)}-level ORB describe, one launch",
                 shapes=[list(img.shape) for img in raw], n=n,
                 valid=n_valid, counts=list(counts), bins_agree=bins_agree,
                 also_checked="every 7th row invalid",
                 max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                 bound_ms=b, bound_by=by, library_ms=None)]


def check_anchor_cells(case):
    """The bootstrap keyframe's anchor cells into a 16384-slot atlas."""
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
    return [dict(case=f"bootstrap keyframe, N={n}, {n_ok} cells into a "
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


def drive(vo, frames, counters):
    """Tracks `frames` with every kernel counter zeroed just before; returns
    (frames/s after the warm-up, launches per counter, the frames after
    which the tracker flagged itself lost)."""
    for fn in counters.values():
        fn.launches = 0
    lost = []
    for i in range(WARM_FRAMES):
        vo.track(*frames[i])
    sync(vo.device)
    t0 = time.perf_counter()
    for i in range(WARM_FRAMES, len(frames)):
        vo.track(*frames[i])
        if vo.lost:
            lost.append(i)
    sync(vo.device)
    fps = (len(frames) - WARM_FRAMES) / (time.perf_counter() - t0)
    return fps, {k: fn.launches for k, fn in counters.items()}, lost


def main_path(cfg, frames, gt, counters, device):
    """One StereoVO over the corridor frames; returns (vo, figures)."""
    import numpy as np
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


def train_vocabulary(cfg, frames, device):
    """bench.py's in-domain vocabulary: ORB of every 12th left image, the
    first 4000 valid descriptors, k = 6, L = 3, seed 0."""
    import numpy as np
    import torch
    from trackingbench_slam_tpu_torch.bow import vocabulary as bow
    from trackingbench_slam_tpu_torch.geometry import camera as cam_mod
    from trackingbench_slam_tpu_torch.models.extractors import extract_orb
    from trackingbench_slam_tpu_torch.models.frame import make_frame
    cam = cam_mod.CameraParams.from_config(cfg.camera, device)
    descs = []
    for i in range(0, len(frames), 12):
        f = make_frame(torch.from_numpy(frames[i][0]).to(device),
                       cfg.extractor.num_features, cfg.pyramid.num_levels,
                       cfg.pyramid.scale_factor)
        f = extract_orb(f, cam, cfg.extractor, cfg.pyramid)
        descs.append(f.desc[f.valid].cpu().numpy())
    descs = np.concatenate(descs)[:4000]
    return bow.train(descs, branching=6, depth=3, seed=0,
                     device=device), len(descs)


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


def loop_bench(cfg, frames, gt, counters, device):
    """bench.py's loop_closing_bench on the port: the same frames without
    and with a LoopCloser."""
    from trackingbench_slam_tpu_torch.models.loop_closer import LoopCloser
    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    from trackingbench_slam_tpu_torch.utils.corridor import closing_error
    t0 = time.perf_counter()
    voc, n_desc = train_vocabulary(cfg, frames, device)
    out = dict(vocabulary=dict(descriptors=n_desc, words=voc.num_words,
                               seconds=time.perf_counter() - t0))
    for with_lc in (False, True):
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
        key = "with_closer" if with_lc else "without_closer"
        out[key] = dict(
            fps=fps, closing_err_m=closing_error(vo.poses(), gt),
            loops_closed=len(vo.loop_events), loop_events=vo.loop_events,
            reloc_events=vo.reloc_events, lost_frames=lost,
            ba_calls=vo.ba_calls, launches=launches, run_s=wall,
            host_s_in=spent)
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
    del vo

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
    missing = [k for k, v in wi["launches"].items() if v == 0]
    if missing:
        raise AssertionError(f"loop bench: kernels not launched: {missing}")
    if not (wi["loops_closed"] >= 1 and wi["closing_err_m"] < 0.05
            and wi["closing_err_m"] < wo["closing_err_m"]):
        raise AssertionError(f"loop bench failed its gates: {loop}")

    paths = {"main_path_ba_off": ba_off["launches"],
             "main_path": launches,
             "loop_bench_without_closer": wo["launches"],
             "loop_bench_with_closer": wi["launches"]}

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
              "loop_bench": dict(loop, jax_record=LOOP_RECORD),
              "seconds": time.perf_counter() - t_start}
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
