"""The port's stage spans over one run of a benchmark cell.

    python3 tools/stage_spans.py --workload kitti-stereo.dataset \
        --seed 7 --seconds 40 --trace 1 [--no-recorder]

    python3 tools/stage_spans.py --off-cost

Runs one cell as `python3 -m slam_bench.run` does (the same host pinning,
one intra-op thread, `battery.run_cell`, `run.result_line`), with the
port's span recorder (trackingbench_slam_tpu_torch/utils/profiling.py
`record`) installed over the whole run unless --no-recorder. The window's
and the sample's bounds are read on the recorder's clock by wrapping
`slam_bench.host.steady` and `slam_bench.battery.profiled`. From the spans:

  window   host_ms.pose_optimization and host_ms.search_by_opflow (those
           spans' ms summed over the window, a window step), host_ms.keyframe
           (the outermost keyframe.* spans of the window's keyframe steps, a
           keyframe step), host_ms.upload (feed.upload, a window step),
           host_syncs_per_step (every window span's host_syncs, a window
           step), pose_kernel_launches_per_step (the pose solve's round
           launches, ops/cuda/pose_kernel.py, a window step), and each span
           name's ms, calls and host syncs a step;
  setup    the spans before the first batched step (the serial
           bootstraps), ms summed by name;
  sample   (--trace 1) device ms and kernel launches a step of the pose
           solve and of each of its LM rounds, the kernels matched to the
           round spans by their launch time on the profiler's clock, what
           slam_bench/trace.py's match reads for the solve, the SM clock
           (nvidia-smi) before and after the sample, and how far each span
           starts after its profiler range.

--off-cost times an empty stage on this host instead: a bare
record_function range, `stage` with no recorder, and `stage` recorded;
`stage`'s own work with no recorder, over a range that costs nothing (its
off-cost); and a host sync's warning counted by the recorder.
The last line of standard output is one JSON object (the cell's result
line under "result"); a run's whole object also goes to
chiprun_out/stage_spans_<workload>_<seed>_<recorder|none>.json.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KEYFRAME_STEP = "dp.track_and_keyframe_step"


def nvidia_smi(query: str):
    """nvidia-smi's reading of `query` (csv, no header), or None."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def per_name(spans, steps: int) -> dict:
    """Each span name's ms, calls and host syncs over `steps` steps."""
    out = {}
    for s in spans:
        row = out.setdefault(s.name, dict(ms=0.0, calls=0, host_syncs=0))
        row["ms"] += s.ms
        row["calls"] += 1
        row["host_syncs"] += s.counts.get("host_syncs", 0)
    return {k: {f"{f}_per_step": v / steps for f, v in row.items()}
            for k, row in sorted(out.items(), key=lambda kv: -kv[1]["ms"])}


def window_readings(all_spans, window, steps: int) -> dict:
    """The readings over the spans that start in `window` (ns)."""
    t0, t1 = window
    spans = [s for s in all_spans if t0 <= s.start_ns < t1]
    top = [s for s in spans if s.parent < 0 and s.name.startswith("dp.")]
    kf_steps = {s.step for s in top if s.name == KEYFRAME_STEP}

    def ms(name):
        return sum(s.ms for s in spans if s.name == name)

    def outer_keyframe(s):
        return (s.name.startswith("keyframe.") and s.step in kf_steps
                and not (s.parent >= 0 and all_spans[s.parent].name
                         .startswith("keyframe.")))
    return {
        "steps": steps, "step_spans": len(top),
        "keyframe_steps": len(kf_steps),
        "host_ms.pose_optimization": ms("track.pose_optimization") / steps,
        "host_ms.search_by_opflow": ms("track.search_by_opflow") / steps,
        "host_ms.keyframe": (sum(s.ms for s in spans if outer_keyframe(s))
                             / len(kf_steps) if kf_steps else None),
        "host_ms.upload": ms("feed.upload") / steps,
        "host_syncs_per_step": sum(s.counts.get("host_syncs", 0)
                                   for s in spans) / steps,
        "pose_kernel_launches_per_step": sum(
            s.counts.get("pose_kernel_launches", 0) for s in spans) / steps,
        "spans": per_name(spans, steps),
    }


def launched_kernels(run):
    """[(launch ns, duration ns, name)] of the profiler window's device
    events, each placed at the CUDA API call that launched it, and the
    count of device events with no such call. The two share CUPTI's
    correlation id; a torch op's `correlation_id()` is the profiler's own
    op counter, another sequence whose values collide with CUPTI's, so
    ops are left out of the match."""
    from torch.autograd import DeviceType
    launch_at, device, ranges = {}, [], set()
    for e in run.profile["prof"].profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.correlation_id(), e.end_ns() - e.start_ns(),
                               e.name()))
        elif e.is_user_annotation():
            ranges.add(e.name())
        elif e.name().startswith("cu"):
            launch_at[e.correlation_id()] = e.start_ns()
    device = [d for d in device if d[2] not in ranges]
    kernels = sorted((launch_at[c], d, n) for c, d, n in device
                     if c in launch_at)
    return kernels, len(device) - len(kernels)


def sample_readings(run, all_spans, sample) -> dict:
    """The pose solve's device ms and launches a sample step, whole and
    per LM round, from the profiler's kernels matched by launch time; and
    what slam_bench/trace.py's match (launch times keyed by the
    correlation ids of ops too) gives for the solve."""
    from slam_bench import trace
    t = trace.tables(run)
    t0, t1 = sample
    spans = [s for s in all_spans if t0 <= s.start_ns < t1]
    kernels, unmatched = launched_kernels(run)
    starts = [k[0] for k in kernels]

    def inside(span):
        i = bisect.bisect_left(starts, span.start_ns)
        j = bisect.bisect_right(starts, span.end_ns)
        return kernels[i:j]

    def tally(ks):
        return dict(device_ms=sum(d for _, d, _ in ks) / 1e6,
                    launches=sum(1 for *_, n in ks if trace.is_kernel(n)))
    index = {id(s): i for i, s in enumerate(all_spans)}
    steps = []
    for s in spans:
        if s.name != "track.pose_optimization":
            continue
        ks = inside(s)
        me = index[id(s)]
        rounds = [r for r in spans if r.parent == me]
        steps.append(dict(step=s.step, host_ms_profiled=s.ms, **tally(ks),
                          rounds=[dict(host_ms_profiled=r.ms,
                                       **tally(inside(r)))
                                  for r in rounds]))
    n = len(steps)
    per_round = []
    for k in range(max((len(st["rounds"]) for st in steps), default=0)):
        rs = [st["rounds"][k] for st in steps if len(st["rounds"]) > k]
        per_round.append({f: sum(r[f] for r in rs) / len(rs)
                          for f in ("device_ms", "launches",
                                    "host_ms_profiled")})
    gaps = []
    for s in spans:
        cands = [a for a, _ in t["ranges"].get(s.name, [])
                 if a <= s.start_ns]
        if cands:
            gaps.append((s.start_ns - max(cands)) / 1e3)
    harness_ms, calls = trace.range_device_ms(run, "track.pose_optimization")
    return {
        "steps": n, "device_events_unmatched": unmatched,
        "harness_pose_device_ms_per_step": harness_ms / max(calls, 1),
        "pose_device_ms_per_step": (sum(st["device_ms"] for st in steps) / n
                                    if n else None),
        "pose_launches_per_step": (sum(st["launches"] for st in steps) / n
                                   if n else None),
        "per_round": per_round, "per_step": steps,
        "span_after_range_us": dict(
            median=statistics.median(gaps) if gaps else None,
            max=max(gaps) if gaps else None, spans=len(gaps)),
    }


def off_cost(n: int = 100_000, reps: int = 11) -> dict:
    """ns an empty stage costs the host: a bare range, `stage` with no
    recorder, `stage` recorded; the variants in turn, the least of `reps`
    readings of each."""
    import torch
    from trackingbench_slam_tpu_torch.utils import profiling

    def once(make):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with make("empty"):
                pass
        return (time.perf_counter_ns() - t0) / n

    null = contextlib.nullcontext()

    def stub(name):   # a range that costs nothing, to time stage's own work
        return null
    readings = dict(record_function_ns=[], stage_ns=[],
                    stage_recorded_ns=[], stub_ns=[], stage_on_stub_ns=[])
    for _ in range(reps):
        readings["record_function_ns"].append(
            once(torch.profiler.record_function))
        readings["stage_ns"].append(once(profiling.stage))
        with profiling.record():
            readings["stage_recorded_ns"].append(once(profiling.stage))
        readings["stub_ns"].append(once(stub))
        profiling.record_function = stub
        try:
            readings["stage_on_stub_ns"].append(once(profiling.stage))
        finally:
            profiling.record_function = torch.profiler.record_function
    with profiling.record():   # a counted sync's warning, intercepted
        t0 = time.perf_counter_ns()
        for _ in range(n // 10):
            warnings.warn(profiling.SYNC_WARNING)
        readings["sync_warning_counted_ns"] = [
            (time.perf_counter_ns() - t0) / (n // 10)]
    out = {k: min(v) for k, v in readings.items()}
    out["stage_off_cost_ns"] = out["stage_on_stub_ns"] - out["stub_ns"]
    out["stage_on_cost_ns"] = (out["stage_recorded_ns"]
                               - out["record_function_ns"])
    out["host"] = dict(cpu=os.cpu_count(), torch=torch.__version__,
                       cuda=torch.cuda.is_available())
    return out


def run_recorded(workload: str, seed: int, seconds: float, trace: bool,
                 recorder: bool) -> dict:
    """One run of the cell (slam_bench.run's set-up and battery), the
    recorder installed over it if `recorder`: dict(run, rec (or None),
    found, marks (window and sample bounds, ns), clocks (SM MHz))."""
    started = time.time()
    from slam_bench import battery, host, registry
    from slam_bench import run as run_mod
    run_mod.cache_env(ROOT)
    found = registry.find_cell(registry.load_benchmark(ROOT), workload,
                               ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("stage_spans needs a CUDA device")
    from trackingbench_slam_tpu_torch.utils import profiling
    torch.set_num_threads(1)
    host.pin_to_card(torch)
    marks, clocks = {}, {}
    steady, profiled = host.steady, battery.profiled

    @contextlib.contextmanager
    def marked_steady():
        with steady():
            marks["window"] = [time.time_ns(), None]
            yield
            marks["window"][1] = time.time_ns()

    def marked_profiled(fn, device):
        clocks["sm_mhz_before_sample"] = nvidia_smi("clocks.sm")
        t0 = time.time_ns()
        out = profiled(fn, device)
        marks["sample"] = [t0, time.time_ns()]
        clocks["sm_mhz_after_sample"] = nvidia_smi("clocks.sm")
        return out
    host.steady, battery.profiled = marked_steady, marked_profiled
    try:
        with (profiling.record() if recorder
              else contextlib.nullcontext()) as rec:
            run = battery.run_cell(found, seed, seconds, trace, "cuda",
                                   started, lambda m: print(
                                       m, file=sys.stderr, flush=True))
    finally:
        host.steady, battery.profiled = steady, profiled
    return dict(run=run, rec=rec, found=found, marks=marks, clocks=clocks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--no-recorder", action="store_true")
    p.add_argument("--off-cost", action="store_true")
    args = p.parse_args(argv)
    if args.off_cost:
        print(json.dumps(off_cost()), flush=True)
        return 0
    got = run_recorded(args.workload, args.seed, args.seconds,
                       bool(args.trace), not args.no_recorder)
    run, rec, marks = got["run"], got["rec"], got["marks"]
    from slam_bench import run as run_mod
    out = dict(workload=args.workload, seed=args.seed,
               recorder=not args.no_recorder,
               card=nvidia_smi("name,power.limit"), **got["clocks"])
    if rec is not None:
        spans = rec.spans
        first = next((s.start_ns for s in spans if s.step >= 0), None)
        out["window"] = window_readings(spans, marks["window"],
                                        len(run.window_steps))
        out["setup_spans_ms"] = {
            k: v["ms_per_step"] for k, v in per_name(
                [s for s in spans if first is None or s.start_ns < first],
                1).items()}
        out["outside_spans"] = rec.outside
        if args.trace:
            out["sample"] = sample_readings(run, spans, marks["sample"])
    out["result"] = run_mod.result_line(run, got["found"], bool(args.trace))
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    name = (f"stage_spans_{args.workload}_{args.seed}_"
            f"{'none' if args.no_recorder else 'recorder'}.json")
    with open(ROOT / "chiprun_out" / name, "w") as fh:
        json.dump(out, fh, indent=1)
    if "sample" in out:   # the per-step rows stay in the file
        out["sample"] = {k: v for k, v in out["sample"].items()
                         if k != "per_step"}
    if "window" in out:
        out["window"] = {k: v for k, v in out["window"].items()
                         if k != "spans"}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
