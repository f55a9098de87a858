"""Runs one cell of the port's benchmark once and prints its result line.

    python -m slam_bench.run --workload kitti-stereo.dataset --seed 7 \
        --seconds 20 --trace 0

from the checkout's root, on a machine with the cards the cell asks for.
The cell, its configuration, traffic and metrics are found by name
(registry.py); battery.py runs it. The last line of standard output is one
JSON object: `correct`, `attempted` (sequence-frames in the window),
`failed` (of those, frames tracked on fewer than 15 pose inliers),
`metrics` (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), `device`, with --trace 1 `breakdown`, `window` (its first frame,
steps, keyframe steps, seconds, and whether the sequences ran out of frames
before its time was up, which a faster program needs longer sequences
for), `host` (what the issuing thread and the allocator did in the window,
host.py), and last `checks`, each number that decided `correct` beside its
limit; the same numbers are the last lines of standard error. Exits non-zero, with no result, without the cards
the cell asks for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "trackingbench_slam_tpu")


def process_start() -> float:
    """Wall-clock time this process started (/proc), or now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def cache_env(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's nvcc builds already land in trackingbench_slam_tpu_torch/build/),
    the interpreter's bytecode included, where it writes any."""
    cache = root / ".slam_bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"   # host.py: one intra-op thread
    sys.pycache_prefix = str(cache / "pycache")


def result_line(run, found: dict, trace: bool) -> dict:
    """The result object, `checks` last."""
    from slam_bench import check as check_mod
    from slam_bench import registry
    from slam_bench import trace as trace_mod
    metrics = {}
    for m in found["per_layer" if trace else "end_to_end"]:
        v = registry.metric_reader(m["name"], Path(found["root"]))(run)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    first = run.window_first
    dev = run.device
    device = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                  kind=(__import__("torch").cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
                  count=1, memory_peak_bytes=run.memory_peak_bytes)
    out = dict(correct=all(c["ok"] for c in run.checks.values()),
               attempted=run.B * len(run.window_steps),
               failed=check_mod.lost_frames(run, first, first
                                            + len(run.window_steps) - 1),
               metrics=metrics, device=device)
    if trace:
        t = trace_mod.tables(run)
        device["busy_s"] = t["busy_ms"] / 1e3
        device["window_s"] = t["wall_ms"] / 1e3
        out["breakdown"] = trace_mod.breakdown(run)
    out["window"] = dict(first_frame=first, steps=len(run.window_steps),
                         keyframe_steps=run.window_steps.count("keyframe"),
                         seconds=run.window_s,
                         ended_early=run.window_ended_early)
    out["host"] = run.host
    out["checks"] = run.checks
    return out


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from slam_bench import registry
    root = registry.ROOT
    cache_env(root)
    sys.path.insert(0, str(root))
    found = registry.find_cell(registry.load_benchmark(root), args.workload,
                               root)
    import torch
    chips = found["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slam_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 3

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    from slam_bench import host
    torch.set_num_threads(1)
    log(f"[bench] cores {host.pin_to_card(torch)} of "
        f"{os.cpu_count()}; card {torch.cuda.get_device_name(0)}")

    from slam_bench import battery
    run = battery.run_cell(found, args.seed, args.seconds, bool(args.trace),
                           "cuda", started, log)
    out = result_line(run, found, bool(args.trace))
    log("[bench] phases: " + json.dumps(run.phases))
    if run.operand_gaps:
        log("[bench] recorded operands against the reference's rebuilt "
            "ones: " + json.dumps(run.operand_gaps))
    bad = forbidden_modules()
    if bad:
        log(f"slam_bench: loaded in this process: {', '.join(bad)}")
        return 4
    for name, c in run.checks.items():
        log(f"check {name} {c['value']} limit {c['limit']} "
            f"{'ok' if c['ok'] else 'FAILED'}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
