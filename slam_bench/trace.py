"""Readings of a traced run's profiler window, computed once and shared by
the metric readers (slam_bench/metrics/) and the result line's
`breakdown` and `device` figures.

They are read off the profiler's raw events (`kineto_results.events()`):
building torch.profiler's FunctionEvent tree for a window of some 10^5
events takes minutes of host time, the raw list well under a second. A
device kernel belongs to the ranges open on the host when its launch was
issued (matched by correlation id), as profile_main_path.py's
`range_table` (profile_main_path.py:134-169) counts a range's device
time; the busy share is profile_main_path.py:219-248's, a profiled
window's device time over the unprofiled wall time of the same work.
"""

from __future__ import annotations

import bisect

HOST_RANGES = ("bench.", "dp.", "track", "keyframe")


def tables(run) -> dict | None:
    """None for an untraced run, else run.profile with: kernels [(start ns,
    end ns, name, launch ns or None)] on the device (memcpy and memset
    included), intervals (merged busy intervals, ns), busy_ms, ranges
    {name: [(start ns, end ns)]} of the host's record_function ranges."""
    p = run.profile
    if p is None:
        return None
    if "kernels" in p:
        return p
    from torch.autograd import DeviceType
    raw = p["prof"].profiler.kineto_results.events()
    device, launch_at, ranges = [], {}, {}
    for e in raw:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns(), e.name(),
                               e.correlation_id()))
        elif e.is_user_annotation():
            ranges.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.end_ns()))
        elif e.correlation_id():
            launch_at[e.correlation_id()] = e.start_ns()
    device = [ev for ev in device if ev[2] not in ranges]
    p["kernels"] = [(s, e, n, launch_at.get(c)) for s, e, n, c in device]
    merged = []
    for s, e, *_ in sorted(p["kernels"]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    p["intervals"] = merged
    p["busy_ms"] = sum(e - s for s, e in merged) / 1e6
    p["ranges"] = {k: sorted(v) for k, v in ranges.items()}
    return p


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def range_device_ms(run, name: str):
    """(device ms of the kernels launched inside the host range `name`,
    times the range was entered)."""
    t = tables(run)
    spans = t["ranges"].get(name, [])
    starts = [s for s, _ in spans]
    ns = 0
    for s, e, _, at in t["kernels"]:
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= spans[i][1]:
            ns += e - s
    return ns / 1e6, len(spans)


def kernel_device_ms(run, name: str):
    """(device ms, launches) of the device kernels whose name holds
    `name`, over the profiler window."""
    hits = [e - s for s, e, n, _ in tables(run)["kernels"] if name in n]
    return sum(hits) / 1e6, len(hits)


def launches(run) -> int:
    return sum(1 for *_, n, _ in tables(run)["kernels"] if is_kernel(n))


def unprofiled_wall_ms(run) -> float:
    """The unprofiled wall time of the window's steps, as many as the
    profiler window holds: the window's mean step time times that count."""
    return run.window_s * 1e3 / len(run.window_steps) * run.profile["steps"]


def breakdown(run) -> dict:
    """The ten device operations that took the most time (summed by name),
    and the ten host ranges under which the device sat idle longest: each
    idle stretch goes to the innermost bench or port range open on the host
    across its middle (seconds)."""
    t = tables(run)
    by_name = {}
    for s, e, n, _ in t["kernels"]:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(([n[:120], ns / 1e9] for n, ns in by_name.items()),
                 key=lambda kv: -kv[1])[:10]
    hosts = sorted((s, e, n) for n, spans in t["ranges"].items()
                   if n.startswith(HOST_RANGES) for s, e in spans)
    gaps = {}
    iv = t["intervals"]
    stack, nxt = [], 0   # the host ranges open at the sweep's time, nested
    for (_, end), (start, _) in zip(iv[:-1], iv[1:]):
        mid = (end + start) / 2
        while nxt < len(hosts) and hosts[nxt][0] <= mid:
            while stack and stack[-1][1] < hosts[nxt][0]:
                stack.pop()
            stack.append(hosts[nxt])
            nxt += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = (stack[-1][2] if stack
                else "host outside the bench's and the port's ranges")
        gaps[name] = gaps.get(name, 0.0) + (start - end) / 1e9
    idle = sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])
    return dict(device_ops=ops, idle_gaps=idle[:10])
