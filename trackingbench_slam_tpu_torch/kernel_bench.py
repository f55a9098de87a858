"""Kernel cases of the main path, their timing, and a side-by-side timing of
two checkouts of this package on one NVIDIA GPU.

    python3 -m trackingbench_slam_tpu_torch.kernel_bench --other DIR

DIR is another checkout of the repository (for example the parent commit,
unpacked with `git archive` into a git-ignored directory). The command
renders the first corridor frames, builds the main path's kernel inputs
with this checkout (`kernel_inputs`, which chip_smoke.py uses too) and saves
them; then it times, in four child processes in turn (other, this, this,
other), each checkout's public entry points on those same inputs:
`ops.align.lk_pyramidal` and `ops.align.anchored_align` for LK; the FAST
score maps of the 3-level ORB pyramid (one batched call where the checkout
has it, else one call per level, as its `extract_orb` makes them); the ORB
describe of the 3 levels' keypoints (`orb_describe` where the checkout has
it, else, as its `extract_orb` does, per level two patch crops,
`ic_angle_from_patches` and `brief_from_patches`); and
`models.map.write_anchor_patches` for the anchor capture. Per case: device
ms per call (CUDA-graph replay), host ms per eager call, launches per call
of the checkout's hand-written kernel (its own counters) and of all CUDA
kernels (torch.profiler's count). Writes chiprun_out/kernel_bench.json and
prints one JSON line. Needs CUDA.

Only `time_ms` and `kernel_inputs` are imported by other code; the child
mode puts the checkout it times first on sys.path, so this file imports
nothing of the package at module level.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

REPS = 50
THIS = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(THIS))


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


@contextlib.contextmanager
def _recorded(module, name, calls):
    """While inside, calls of module.<name> append their arguments to
    `calls`."""
    real = getattr(module, name)

    def record(*args):
        calls.append(args)
        return real(*args)

    setattr(module, name, record)
    try:
        yield
    finally:
        setattr(module, name, real)


def kernel_inputs(cfg, frames, scene, gt, device="cuda"):
    """Main-path inputs on `device`: the bootstrap keyframe's state and the
    next frame. Returns (ORB pyramid, LK cases, ORB-describe case, anchor
    case, ORB budgets). An LK case is (name, entry, prev_pyr, cur_pyr, pts,
    start, valid, kw): the arguments of `lk_align` for one call of `entry`
    on the main path (lk_pyramidal: start = pts, the prior in kw["offset"];
    anchored_align: one level, start = the tracked positions). The
    ORB-describe case is the bootstrap keyframe's `orb_describe` arguments
    (raw levels, blurred levels, xy, valid, counts); the anchor case is its
    `write_anchor_patches` arguments as dict(img, kp_xy, slots, want,
    capacity, max_obs) plus `atlas`, a seeded random atlas of the map's
    shape to write into."""
    import torch
    from trackingbench_slam_tpu_torch.models import extractors
    from trackingbench_slam_tpu_torch.models import map as map_mod
    from trackingbench_slam_tpu_torch.models.frame import make_frame
    from trackingbench_slam_tpu_torch.models.vo import StereoVO
    from trackingbench_slam_tpu_torch.ops.align import lk_pyramidal
    dev = torch.device(device)
    vo = StereoVO(cfg, device=dev)
    orb_calls, anchor_calls = [], []
    with _recorded(extractors, "orb_describe", orb_calls), \
            _recorded(map_mod, "write_anchor_patches", anchor_calls):
        state = vo.track(*frames[0])
    f0 = state.prev
    f1 = make_frame(torch.from_numpy(frames[1][0]).to(dev),
                    cfg.extractor.num_features, cfg.pyramid.num_levels,
                    cfg.pyramid.scale_factor)
    right = make_frame(torch.from_numpy(frames[0][1]).to(dev), 1,
                       cfg.pyramid.num_levels, cfg.pyramid.scale_factor)
    pts, valid = f0.kp_xy, f0.valid
    lk = dict(scale=0.5, half=10, iters=30, conv_eps=0.01)
    # stereo prior: the true disparity of the rendered scene
    depth = torch.from_numpy(scene.depth_map(gt[0])).to(dev)
    xi = pts[:, 0].round().clamp(0, cfg.camera.width - 1).long()
    yi = pts[:, 1].round().clamp(0, cfg.camera.height - 1).long()
    z = torch.clamp(depth[yi, xi], min=0.5)
    prior = torch.stack([-cfg.camera.bf / z, torch.zeros_like(z)], -1)
    # anchored: atlas templates of the bootstrap landmarks, searched in the
    # next frame from the tracked positions
    tracked = lk_pyramidal(f0.lk_pyr, f1.lk_pyr, pts, valid, 0.5,
                           num_levels=cfg.lk_track_levels)
    m = state.map
    mp = f0.map_idx.clamp(0, m.capacity - 1).long()
    has_anchor = (f0.map_idx >= 0) & valid & m.valid[mp]
    centers = map_mod.atlas_cell_centers(mp, m.atlas_grid)
    nt = cfg.lk_track_levels
    lk_cases = [
        ("track, 2 levels", "lk_pyramidal", f0.lk_pyr[:nt], f1.lk_pyr[:nt],
         pts, pts, valid, dict(lk, offset=torch.zeros_like(pts))),
        ("stereo, 2 levels + fb", "lk_pyramidal", f0.lk_pyr[:2],
         right.lk_pyr[:2], pts, pts, valid,
         dict(lk, offset=prior, fb_iters=10)),
        ("bootstrap stereo, 4 levels + fb", "lk_pyramidal", f0.lk_pyr,
         right.lk_pyr, pts, pts, valid, dict(lk, fb_iters=10)),
        ("anchored", "anchored_align", (m.anchor_atlas,), f1.lk_pyr[:1],
         centers, tracked.xy, has_anchor & tracked.converged,
         dict(scale=0.5, half=4, iters=10, conv_eps=0.03)),
    ]
    budgets = [int((f0.kp_level == lvl).sum()) for lvl in range(3)]
    raw, blurred, xy, orb_valid, counts = orb_calls[0]
    orb_case = (tuple(raw), tuple(blurred), xy, orb_valid, list(counts))
    m_pre, img, kp_xy, slots, want = anchor_calls[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    anchor_case = dict(img=img, kp_xy=kp_xy, slots=slots, want=want,
                       capacity=m_pre.capacity,
                       max_obs=m_pre.obs_kf.shape[1],
                       atlas=torch.rand(m_pre.anchor_atlas.shape,
                                        generator=gen, device=dev) * 255.0)
    return tuple(f0.pyramid), lk_cases, orb_case, anchor_case, budgets


def _counter(module, *names):
    for name in names:
        fn = getattr(module, name, None)
        if fn is not None and hasattr(fn, "launches"):
            return fn
    raise AttributeError(f"no launch counter among {names}")


def _launches_per_call(counter, fn):
    before = counter.launches
    fn()
    return counter.launches - before


def _device_ops_per_call(fn):
    """(CUDA kernels, all device operations incl. copies and memsets) that
    one call of fn puts on the device, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    kernels = [e for e in device if not e.key.startswith(("Memcpy", "Memset"))]
    return sum(e.count for e in kernels), sum(e.count for e in device)


def child(root, inputs_path):
    """Time the checkout at `root` on the saved inputs."""
    sys.path.insert(0, root)
    import torch
    import trackingbench_slam_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {pkg.__file__}, not the checkout at "
                           f"{root}")
    from trackingbench_slam_tpu_torch.models import map as map_mod
    from trackingbench_slam_tpu_torch.ops import align
    from trackingbench_slam_tpu_torch.ops.cuda import (build, fast_kernel,
                                                       lk_kernel,
                                                       patch_kernel)
    build.build_all()
    data = torch.load(inputs_path)
    cuda = torch.device("cuda")

    def dev(x):
        if isinstance(x, torch.Tensor):
            return x.to(cuda)
        if isinstance(x, (tuple, list)):
            return type(x)(dev(v) for v in x)
        if isinstance(x, dict):
            return {k: dev(v) for k, v in x.items()}
        return x

    data = dev(data)
    lk_counter = _counter(lk_kernel, "lk_align_cuda", "patch_align_cuda")
    fast_counter = _counter(fast_kernel, "fast_score_nms_cuda")
    out = {"root": root, "lk": [], "fast": [], "orb": [], "anchor": []}

    def case(name, fn, counter):
        ms, host_ms = time_ms(fn, REPS)
        kernels, ops = _device_ops_per_call(fn)
        return dict(case=name, ms=ms, host_ms=host_ms,
                    launches_per_call=_launches_per_call(counter, fn),
                    cuda_kernels_per_call=kernels,
                    device_ops_per_call=ops)

    for name, entry, prev, cur, pts, start, valid, kw in data["lk"]:
        if entry == "anchored_align":
            def fn(prev=prev, cur=cur, pts=pts, start=start, valid=valid,
                   kw=kw):
                return align.anchored_align(prev[0], cur[0], pts, start,
                                            valid, half=kw["half"],
                                            iters=kw["iters"],
                                            conv_eps=kw["conv_eps"])
        else:
            def fn(prev=prev, cur=cur, pts=pts, valid=valid, kw=kw):
                return align.lk_pyramidal(
                    prev, cur, pts, valid, kw["scale"], half=kw["half"],
                    iters=kw["iters"], num_levels=len(prev),
                    init_offset=kw.get("offset"),
                    fb_iters=kw.get("fb_iters", 0))
        out["lk"].append(case(name, fn, lk_counter))
    pyr, th, arc = data["fast"]
    if hasattr(fast_kernel, "fast_score_nms_levels"):
        def fast_fn():
            return fast_kernel.fast_score_nms_levels(pyr, th, arc)
    else:
        def fast_fn():
            return [fast_kernel.fast_score_nms(img, th, arc) for img in pyr]
    out["fast"].append(case(f"{len(pyr)}-level ORB pyramid", fast_fn,
                            fast_counter))
    raw, blurred, xy, valid, counts = data["orb"]
    if hasattr(patch_kernel, "orb_describe"):
        def orb_fn():
            return patch_kernel.orb_describe(raw, blurred, xy, valid, counts)
    else:
        from trackingbench_slam_tpu_torch.ops import orb as orb_ops

        def orb_fn():
            described = []
            for img, blur, p, v in zip(raw, blurred, xy.split(counts),
                                       valid.split(counts)):
                ang = orb_ops.ic_angle_from_patches(
                    patch_kernel.extract_patches32(img, p))
                ang = torch.where(v, ang, torch.zeros_like(ang))
                described.append((ang, orb_ops.brief_from_patches(
                    patch_kernel.extract_patches32(blur, p), ang, v)))
            return described
    out["orb"].append(case(
        f"{len(raw)}-level ORB describe, N={xy.shape[0]}", orb_fn,
        _counter(patch_kernel, "orb_describe_cuda",
                 "extract_patches32_cuda")))
    a = data["anchor"]
    m = map_mod.empty_map(a["capacity"], a["max_obs"], cuda)._replace(
        anchor_atlas=a["atlas"])

    def anchor_fn():
        return map_mod.write_anchor_patches(m, a["img"], a["kp_xy"],
                                            a["slots"], a["want"])
    out["anchor"].append(case(
        f"write_anchor_patches, N={a['kp_xy'].shape[0]}, "
        f"{int(a['want'].sum())} wanted", anchor_fn,
        _counter(patch_kernel, "anchor_cells_cuda",
                 "extract_patches32_cuda")))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout to time beside this")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    ap.add_argument("--result", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        with open(args.result, "w") as fh:
            json.dump(child(args.child, args.inputs), fh)
        return 0
    if not args.other:
        ap.error("--other is required")
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench needs a CUDA device")
    from trackingbench_slam_tpu_torch.utils.corridor import (
        corridor_frames, main_path_config)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    cache = os.path.join(ROOT, ".bench_cache")
    os.makedirs(cache, exist_ok=True)
    cfg = main_path_config()
    frames, gt, scene = corridor_frames(cfg, 2)
    pyr, lk_cases, orb_case, anchor_case, _ = kernel_inputs(cfg, frames,
                                                            scene, gt)

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if isinstance(x, (tuple, list)):
            return type(x)(host(v) for v in x)
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        return x

    inputs = os.path.join(cache, "kernel_bench_inputs.pt")
    torch.save(host(dict(
        lk=lk_cases, orb=orb_case, anchor=anchor_case,
        fast=(pyr, float(cfg.extractor.min_threshold),
              cfg.extractor.fast_arc))), inputs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    runs = []
    for label, root in (("other", args.other), ("this", ROOT),
                        ("this", ROOT), ("other", args.other)):
        res = os.path.join(cache, f"kernel_bench_{len(runs)}.json")
        subprocess.run([sys.executable, THIS, "--child",
                        os.path.abspath(root), "--inputs", inputs,
                        "--result", res],
                       check=True, timeout=900)
        with open(res) as fh:
            runs.append(dict(json.load(fh), label=label))
    result = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                  order=[r["label"] for r in runs], runs=runs)
    with open(os.path.join(out_dir, "kernel_bench.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
