#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (trackingbench_slam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure ends the run with a non-zero exit:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: every CUDA kernel (csrc/*.cu), one nvcc each, in parallel;
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, at the main path's shapes on the first rendered corridor frames
     (FAST and patch crop exact; LK xy within 1e-3 px where both converged
     and converged flags agreeing on >= 99% of points), both timed with CUDA
     events after a warm-up;
  4. main path: StereoVO at bench.py's configuration with windowed BA off,
     40 corridor frames, frames/s after an 11-frame warm-up; every kernel's
     launch counter must move, ATE < 0.01 m, > 500 pose inliers at the end;
  5. a `kernels` JSON line, then the card's nvidia-smi line, then the
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
WARM_FRAMES = 11


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _events_ms(run, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_ms(fn, reps):
    """(device ms, host ms) per call. Device: `reps` calls captured in one
    CUDA graph and replayed, so the host's launch cost is out of the
    measurement. Host: the same calls launched eagerly, timed with CUDA
    events (what the eager main path pays per call)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()

    def eager():
        for _ in range(reps):
            fn()

    host = _events_ms(eager, reps)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eager()
    graph.replay()
    torch.cuda.synchronize()
    device = _events_ms(graph.replay, reps)
    del graph
    return device, host


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


def fast_flops(h, w):
    return h * w * FAST_OPS_PER_PIXEL


def lk_work(prev, cur, pts, init, valid, kw):
    """The work the LK function needs on these inputs: which points run,
    their template builds and their point-iterations (forward and back),
    read off the plain version's iteration loop (lk_kernel._run) during one
    call of it."""
    from trackingbench_slam_tpu_torch.ops.cuda import lk_kernel
    loops = []
    real_run = lk_kernel._run

    def observed(*args):
        out = real_run(*args)
        loops.append((args[9], out[5]))   # (points entering, iterations)
        return out

    lk_kernel._run = observed
    try:
        lk_kernel.patch_align_plain(prev, cur, pts, init, valid, **kw)
    finally:
        lk_kernel._run = real_run
    return dict(run=loops[0][0],
                templates=sum(int(r.sum()) for r, _ in loops),
                iterations=sum(int(n.sum()) for _, n in loops))


# LK: a bilinear tap is 9 flops; a template pixel adds 2 gradients (4) and
# 5 sums (8); an iteration pixel a residual and 3 sums (6); the error pass
# a residual, abs and sum (3).
def lk_flops(work, half):
    P = 2 * half + 1
    return (work["templates"] * ((P + 2) ** 2 * 9 + P * P * 12)
            + work["iterations"] * P * P * 15
            + int(work["run"].sum()) * P * P * 12)


def lk_bytes(prev, cur, pts, xy, conv, work, half, fb):
    """Pixels under the run points' templates in prev ((P+3)^2 each) and
    under their last search sample in cur ((P+1)^2, or the (P+3)^2
    back-track template where one is built), plus the point I/O."""
    import torch
    P = 2 * half + 1
    run = work["run"]
    t = torch.floor(pts[run]).long()
    x = torch.floor(xy[run]).long()
    blocks = [(x[:, 1] - half, x[:, 0] - half, P + 1)]
    if fb:
        xb = torch.floor(xy[run & conv]).long()
        blocks.append((xb[:, 1] - half - 1, xb[:, 0] - half - 1, P + 3))
    px = (covered_pixels(prev.shape, [(t[:, 1] - half - 1, t[:, 0] - half - 1,
                                       P + 3)])
          + covered_pixels(cur.shape, blocks))
    n = pts.shape[0]
    return 4 * px + n * 17 + n * (13 + (5 if fb else 0))


def check_fast(pyr, threshold, arc):
    import torch
    from trackingbench_slam_tpu_torch.ops.cuda import fast_kernel
    cases = []
    for img in pyr:
        got = fast_kernel.fast_score_nms_cuda(img, threshold, arc)
        ref = fast_kernel.fast_score_nms_plain(img, threshold, arc)
        err = float((got - ref).abs().max())
        if not torch.equal(got, ref):
            raise AssertionError(f"FAST kernel differs on {tuple(img.shape)}:"
                                 f" max |diff| {err}")
        h, w = img.shape
        ms, host_ms = time_ms(lambda: fast_kernel.fast_score_nms_cuda(
            img, threshold, arc), 50)
        plain_ms, _ = time_ms(lambda: fast_kernel.fast_score_nms_plain(
            img, threshold, arc), 5)
        b, by = bound(h * w * 8, fast_flops(h, w))
        cases.append(dict(shape=[h, w], max_abs_err=err, ms=ms,
                          host_ms=host_ms, plain_ms=plain_ms, bound_ms=b,
                          bound_by=by, corners=int((got > 0).sum())))
    return cases


def check_patch(named_inputs):
    import torch
    from trackingbench_slam_tpu_torch.ops.cuda import patch_kernel
    cases = []
    for name, img, centers in named_inputs:
        got = patch_kernel.extract_patches32_cuda(img, centers)
        ref = patch_kernel.extract_patches32_plain(img, centers)
        err = float((got - ref).abs().max())
        if not torch.equal(got, ref):
            raise AssertionError(f"patch kernel differs ({name}): {err}")
        n = centers.shape[0]
        ms, host_ms = time_ms(lambda: patch_kernel.extract_patches32_cuda(
            img, centers), 50)
        plain_ms, _ = time_ms(lambda: patch_kernel.extract_patches32_plain(
            img, centers), 10)
        r0, c0 = patch_kernel.patch_origins(centers, *img.shape)
        px = covered_pixels(img.shape, [(r0, c0, patch_kernel.PATCH)])
        b, by = bound(px * 4 + n * 8 + n * 32 * 32 * 4, 0)
        cases.append(dict(case=name, shape=list(img.shape), n=n,
                          max_abs_err=err, ms=ms, host_ms=host_ms,
                          plain_ms=plain_ms, bound_ms=b, bound_by=by))
    return cases


def check_lk(named_inputs):
    import torch
    from trackingbench_slam_tpu_torch.ops.cuda import lk_kernel
    cases = []
    for name, prev, cur, pts, init, valid, kw in named_inputs:
        got = lk_kernel.patch_align_cuda(prev, cur, pts, init, valid, **kw)
        ref = lk_kernel.patch_align_plain(prev, cur, pts, init, valid, **kw)
        both = got[1] & ref[1]
        agree = float((got[1] == ref[1]).float().mean())
        err = float((got[0] - ref[0])[both].abs().max()) if bool(
            both.any()) else 0.0
        if agree < 0.99 or err > 1e-3 or int(both.sum()) == 0:
            raise AssertionError(f"LK kernel differs ({name}): flags agree "
                                 f"{agree:.4f}, max |dxy| {err}")
        fb_agree = None
        if kw.get("fb_iters", 0):
            fb_agree = float((got[3] == ref[3]).float().mean())
            if fb_agree < 0.99:
                raise AssertionError(f"LK fb flags differ ({name}): "
                                     f"{fb_agree:.4f}")
        n = pts.shape[0]
        ms, host_ms = time_ms(lambda: lk_kernel.patch_align_cuda(
            prev, cur, pts, init, valid, **kw), 20)
        plain_ms, _ = time_ms(lambda: lk_kernel.patch_align_plain(
            prev, cur, pts, init, valid, **kw), 3)
        work = lk_work(prev, cur, pts, init, valid, kw)
        fb = kw.get("fb_iters", 0) > 0
        b, by = bound(lk_bytes(prev, cur, pts, ref[0], ref[1], work,
                               kw["half"], fb),
                      lk_flops(work, kw["half"]))
        cases.append(dict(case=name, shape=list(cur.shape), n=n,
                          converged=int(ref[1].sum()), flags_agree=agree,
                          fb_flags_agree=fb_agree,
                          max_abs_err=err, ms=ms, host_ms=host_ms,
                          plain_ms=plain_ms, bound_ms=b, bound_by=by,
                          work=dict(points_run=int(work["run"].sum()),
                                    templates=work["templates"],
                                    iterations=work["iterations"])))
    return cases


def kernel_inputs(cfg, frames, scene, gt):
    """Main-path inputs: the bootstrap keyframe's state and the next frame."""
    import torch
    from trackingbench_slam_tpu_torch.models import map as map_mod
    from trackingbench_slam_tpu_torch.models.frame import make_frame
    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    from trackingbench_slam_tpu_torch.ops.align import lk_pyramidal
    dev = torch.device("cuda")
    vo = StereoVO(cfg)
    state = vo.track(*frames[0])
    f0 = state.prev
    f1 = make_frame(torch.from_numpy(frames[1][0]).to(dev),
                    cfg.extractor.num_features, cfg.pyramid.num_levels,
                    cfg.pyramid.scale_factor)
    right = make_frame(torch.from_numpy(frames[0][1]).to(dev), 1,
                       cfg.pyramid.num_levels, cfg.pyramid.scale_factor)
    pts, valid = f0.kp_xy, f0.valid
    lk = dict(half=10, iters=30, conv_eps=0.01)
    # track, 2 levels: level 1 from pts, level 0 from the level-1 result
    lvl1 = lk_pyramidal(f0.lk_pyr, f1.lk_pyr, pts, valid, 0.5, num_levels=2)
    init1 = pts * 0.5
    xy1 = lk_pyramidal(f0.lk_pyr[1:], f1.lk_pyr[1:], pts * 0.5, valid, 0.5,
                       num_levels=1).xy
    # stereo level 0: start from the true disparity of the rendered scene
    depth = torch.from_numpy(scene.depth_map(gt[0])).to(dev)
    xi = pts[:, 0].round().clamp(0, cfg.camera.width - 1).long()
    yi = pts[:, 1].round().clamp(0, cfg.camera.height - 1).long()
    z = torch.clamp(depth[yi, xi], min=0.5)
    init_st = pts - torch.stack([cfg.camera.bf / z, torch.zeros_like(z)], -1)
    # anchored: atlas templates of the bootstrap landmarks, searched in the
    # next frame from the tracked positions
    m = state.map
    mp = f0.map_idx.clamp(0, m.capacity - 1).long()
    has_anchor = (f0.map_idx >= 0) & valid & m.valid[mp]
    centers = map_mod.atlas_cell_centers(mp, m.atlas_grid)
    lk_inputs = [
        ("track level 1", f0.lk_pyr[1], f1.lk_pyr[1], pts * 0.5, init1,
         valid, lk),
        ("track level 0", f0.lk_pyr[0], f1.lk_pyr[0], pts, xy1 * 2.0, valid,
         lk),
        ("stereo level 0 + fb", f0.lk_pyr[0], right.lk_pyr[0], pts, init_st,
         valid, dict(lk, fb_iters=10)),
        ("anchored", m.anchor_atlas, f1.lk_pyr[0], centers, lvl1.xy,
         has_anchor & lvl1.converged, dict(half=4, iters=10, conv_eps=0.03)),
    ]
    budgets = [int((f0.kp_level == lvl).sum()) for lvl in range(3)]
    patch_inputs = []
    for lvl, img in enumerate(f0.pyramid):
        s = cfg.pyramid.scale_factor ** lvl
        sel = f0.kp_level == lvl
        patch_inputs.append((f"ORB level {lvl}", img,
                             (pts[sel] * s).contiguous()))
    x0 = torch.floor(pts)
    patch_inputs.append(("anchor capture", f0.lk_pyr[0],
                         (x0 + 7.0).contiguous()))
    return f0.pyramid, lk_inputs, patch_inputs, budgets


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import numpy as np
    import trackingbench_slam_tpu_torch  # noqa: F401  (precision pins)
    from trackingbench_slam_tpu_torch.ops.cuda import (build, fast_kernel,
                                                       lk_kernel,
                                                       patch_kernel)
    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    from trackingbench_slam_tpu_torch.utils import metrics
    from trackingbench_slam_tpu_torch.utils.corridor import (
        corridor_frames, main_path_config)

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

    pyr, lk_inputs, patch_inputs, budgets = kernel_inputs(
        cfg, frames, scene, gt)
    fast_cases = check_fast(pyr, float(cfg.extractor.min_threshold),
                            cfg.extractor.fast_arc)
    log("[check] fast_score_nms exact on "
        + ", ".join(f"{c['shape'][0]}x{c['shape'][1]} ({c['ms']:.4f} ms, "
                    f"plain {c['plain_ms']:.3f} ms)" for c in fast_cases))
    patch_cases = check_patch(patch_inputs)
    log("[check] extract_patches32 exact on "
        + ", ".join(f"{c['case']} N={c['n']} ({c['ms']:.4f} ms, plain "
                    f"{c['plain_ms']:.3f} ms)" for c in patch_cases))
    lk_cases = check_lk(lk_inputs)
    log("[check] lk_align within 1e-3 px on "
        + ", ".join(f"{c['case']} N={c['n']} conv {c['converged']} agree "
                    f"{c['flags_agree']:.4f} err {c['max_abs_err']:.2e} "
                    f"({c['ms']:.4f} ms, plain {c['plain_ms']:.3f} ms)"
                    for c in lk_cases))

    counters = {"lk_align": lk_kernel.patch_align_cuda,
                "fast_score_nms": fast_kernel.fast_score_nms_cuda,
                "extract_patches32": patch_kernel.extract_patches32_cuda}
    for fn in counters.values():
        fn.launches = 0
    vo = StereoVO(cfg)
    for i in range(WARM_FRAMES):
        vo.track(*frames[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARM_FRAMES, N_FRAMES):
        vo.track(*frames[i])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    fps = (N_FRAMES - WARM_FRAMES) / dt
    poses = vo.poses()
    if poses.shape != (N_FRAMES, 4, 4) or not np.isfinite(poses).all():
        raise AssertionError(f"bad trajectory: {poses.shape}")
    ate = metrics.ate_rmse(poses, gt, align=True)
    inliers = int(vo.state.num_inliers)
    landmarks = int(vo.state.map.valid.sum())
    log(f"[main path] {N_FRAMES} frames (BA off), {N_FRAMES - WARM_FRAMES} "
        f"timed: {fps:.2f} frames/s, ATE {ate:.5f} m, last-frame inliers "
        f"{inliers}, live landmarks {landmarks}, launches {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    if not ate < 0.01:
        raise AssertionError(f"ATE {ate} m >= 0.01 m")
    if not inliers > 500:
        raise AssertionError(f"last-frame inliers {inliers} <= 500")

    def entry(name, source, replaces, primary, cases):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name],
                    max_abs_err=max(c["max_abs_err"] for c in cases),
                    ms=primary["ms"], plain_ms=primary["plain_ms"],
                    bound_ms=primary["bound_ms"],
                    bound_by=primary["bound_by"], library_ms=None,
                    cases=cases)

    kernels = [
        entry("lk_align", "trackingbench_slam_tpu_torch/csrc/lk.cu",
              "trackingbench_slam_tpu/ops/pallas/lk_kernel.py:347",
              lk_cases[1], lk_cases),
        entry("fast_score_nms", "trackingbench_slam_tpu_torch/csrc/fast.cu",
              "trackingbench_slam_tpu/ops/pallas/fast_kernel.py:126",
              fast_cases[0], fast_cases),
        entry("extract_patches32", "trackingbench_slam_tpu_torch/csrc/patch.cu",
              "trackingbench_slam_tpu/ops/pallas/patch_kernel.py:103",
              patch_cases[0], patch_cases),
    ]
    result = {"kernels": kernels,
              "main_path": dict(frames=N_FRAMES, timed=N_FRAMES - WARM_FRAMES,
                                fps=fps, ate_m=ate, last_inliers=inliers,
                                landmarks=landmarks, orb_budgets=budgets),
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
