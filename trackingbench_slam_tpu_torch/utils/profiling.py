"""Stage timing and profiler capture.

Port of trackingbench_slam_tpu/utils/profiling.py `fence`, `StageTimer` and
`trace`. Kernels run asynchronously, so a host clock around a stage
measures its enqueue unless the stage is fenced. `fence` waits for the
devices of a result; `StageTimer` on the card brackets each stage with two
CUDA events on the current stream and reads their elapsed times only when
asked (`totals`, `report`), so timing adds no sync inside the loop; on the
CPU it uses the host clock. `trace` records torch.profiler (CPU and CUDA
activity) around a region and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any

import torch

from trackingbench_slam_tpu_torch.utils.device import resolve_device


def _tensors(tree: Any):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def fence(tree: Any) -> None:
    """Waits until every CUDA device holding a tensor of `tree` (a tensor
    or nested tuples, NamedTuples, lists and dicts of them) has finished
    its queued work; a tree on the CPU is already complete."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Time per named stage, summed over calls.

    >>> t = StageTimer()                   # device="cpu" for the CPU
    >>> with t.time("extract"):
    ...     out = extract(...)
    >>> print(t.report())
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._seconds = defaultdict(float)
        self._counts = defaultdict(int)
        self._events: list = []   # (name, start, end) not yet read

    @contextlib.contextmanager
    def time(self, name: str):
        if self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._events.append((name, start, end))
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._seconds[name] += seconds
        self._counts[name] += 1

    def _resolve(self) -> None:
        if self._events:
            self._events[-1][2].synchronize()
        for name, start, end in self._events:
            self.add(name, start.elapsed_time(end) / 1e3)
        self._events.clear()

    @property
    def totals(self) -> dict:
        """Seconds per stage (waits for the recorded stages to finish)."""
        self._resolve()
        return dict(self._seconds)

    @property
    def counts(self) -> dict:
        self._resolve()
        return dict(self._counts)

    def report(self) -> str:
        totals, counts = self.totals, self.counts
        lines = []
        for name in sorted(totals, key=lambda n: -totals[n]):
            n, tot = counts[name], totals[name]
            lines.append(f"{name:30s} {tot * 1000:10.1f} ms total "
                         f"{tot / max(n, 1) * 1000:8.2f} ms/call x{n}")
        return "\n".join(lines)

    def reset(self) -> None:
        self._events.clear()
        self._seconds.clear()
        self._counts.clear()


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """torch.profiler over the region (CPU activity, and CUDA activity on
    the card); on exit the Chrome trace goes to `log_dir`/trace.json.
    Yields the profiler (its key_averages() for sums by op)."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
