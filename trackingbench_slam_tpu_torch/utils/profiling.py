"""Stage spans, their recorder, and fenced stage timing.

Every stage of the port opens `stage(name)`: a torch.profiler
record_function range under that name, which the profiler reads (device
time per range, `profile_main_path.range_table`, the benchmark's
breakdown). While a recorder is installed (`with record() as rec:`) each
stage is also kept as a `Span` in `rec.spans`: its name, start and end in
Unix-epoch ns (`time.time_ns()`, the clock the profiler's events carry, so
a span sits beside the device trace), the index of its parent span, and
its step: a top-level span named in STEP_SPANS begins a step, and every
span takes the step begun last (-1 before the first). With no recorder
installed a stage costs one global read and one branch over its range.

Counters go to the innermost open span (`count`). While recording on
CUDA, the synchronizations that torch.cuda's sync debug mode reports are
counted as `host_syncs` and not printed; a wait that mode does not see (an
event's, an explicit device synchronize: `fence`, `StageTimer`) counts
itself.

A recorder also calls its consumers at every span's enter and exit
(`consumer.enter(span)`, `consumer.exit(span)`): `StageTimer` is one,
which times each stage on the host clock between two device fences.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from collections import defaultdict
from typing import Any

import torch
from torch.profiler import record_function

STEP_SPANS = ("dp.track_step", "dp.track_and_keyframe_step", "track_step")
SYNC_WARNING = "called a synchronizing CUDA operation"

_recorder = None   # the installed Recorder, or None


def stage(name: str):
    """The context manager of one stage: a record_function range named
    `name`, and a Span while a recorder is installed."""
    rec = _recorder
    if rec is None:
        return record_function(name)
    return Span(rec, name)


def count(counter: str) -> None:
    """Adds one to `counter` of the innermost open span of the installed
    recorder (its `outside` counts where no span is open)."""
    rec = _recorder
    if rec is not None:
        rec.count(counter)


class Span:
    """One stage's span; `parent` and `step` as the module docstring says,
    `counts` its counters ({} until one is charged)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "step", "counts",
                 "_rec", "_range")

    def __init__(self, rec: "Recorder", name: str):
        self.name = name
        self._rec = rec

    def __enter__(self):
        rec = self._rec
        self._range = record_function(self.name)
        self._range.__enter__()
        self.parent = rec.open[-1] if rec.open else -1
        if self.parent < 0 and self.name in STEP_SPANS:
            rec.step += 1
        self.step = rec.step
        self.counts = {}
        self.end_ns = None
        rec.open.append(len(rec.spans))
        rec.spans.append(self)
        for c in rec.consumers:
            c.enter(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        rec, rng = self._rec, self._range
        for c in reversed(rec.consumers):
            c.exit(self)
        rec.open.pop()
        self._rec = self._range = None
        return rng.__exit__(*exc)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Recorder:
    """The spans of one recording, in order of entry."""

    def __init__(self, consumers=()):
        self.consumers = tuple(consumers)
        self.spans: list = []
        self.open: list = []    # indices of the open spans, innermost last
        self.step = -1
        self.outside: dict = {}

    def count(self, counter: str) -> None:
        counts = self.spans[self.open[-1]].counts if self.open else \
            self.outside
        counts[counter] = counts.get(counter, 0) + 1

    def _showwarning(self, message, category, *args, **kwargs):
        if SYNC_WARNING in str(message):
            self.count("host_syncs")
        else:
            self._show(message, category, *args, **kwargs)


@contextlib.contextmanager
def record(*consumers):
    """Installs a Recorder (calling `consumers` at every span's enter and
    exit) for the block; yields it. On CUDA the sync debug mode warns for
    the block and is set back after it."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a recorder is installed already")
    rec = Recorder(consumers)
    cuda = torch.cuda.is_available()
    with warnings.catch_warnings():
        rec._show = warnings.showwarning
        warnings.showwarning = rec._showwarning
        warnings.filterwarnings("always", message=f".*{SYNC_WARNING}")
        warnings.filterwarnings("ignore", message="Synchronization debug "
                                "mode is a prototype")
        mode = torch.cuda.get_sync_debug_mode() if cuda else 0
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        _recorder = rec
        try:
            yield rec
        finally:
            _recorder = None
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)


def _tensors(tree: Any):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _synchronize(device) -> None:
    count("host_syncs")
    torch.cuda.synchronize(device)


def fence(tree: Any) -> None:
    """Waits until every CUDA device holding a tensor of `tree` (a tensor
    or nested tuples, NamedTuples, lists and dicts of them) has finished
    its queued work; a tree on the CPU is already complete."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        _synchronize(dev)


class StageTimer:
    """Host time per named stage, summed over calls, each stage fenced at
    both ends on the card (nothing is left queued from before the stage,
    and its own work is done): its host time and the device time the host
    waited for. A recorder consumer, or used directly:

    >>> t = StageTimer()                   # device="cpu" for the CPU
    >>> with profiling.record(t):          # every stage of the block
    ...     vo.track(left, right)
    >>> with t.time("extract"):
    ...     out = extract(...)
    >>> print(t.report())
    """

    def __init__(self, device=None, clock=time.perf_counter):
        from trackingbench_slam_tpu_torch.utils.device import resolve_device
        self.device = resolve_device(device)
        self._fence = (_synchronize
                       if self.device.type == "cuda" else lambda _: None)
        self._clock = clock
        self._seconds = defaultdict(float)
        self._counts = defaultdict(int)
        self._started: list = []   # clock readings of the open stages

    def enter(self, span) -> None:
        self._fence(self.device)
        self._started.append(self._clock())

    def exit(self, span) -> None:
        self._stop(span.name)

    def _stop(self, name: str) -> None:
        self._fence(self.device)
        self.add(name, self._clock() - self._started.pop())

    @contextlib.contextmanager
    def time(self, name: str):
        self.enter(None)
        try:
            yield
        finally:
            self._stop(name)

    def add(self, name: str, seconds: float) -> None:
        self._seconds[name] += seconds
        self._counts[name] += 1

    @property
    def totals(self) -> dict:
        """Seconds per stage."""
        return dict(self._seconds)

    @property
    def counts(self) -> dict:
        return dict(self._counts)

    def ms_per_call(self) -> dict:
        """Milliseconds a call of each stage."""
        return {n: self._seconds[n] / self._counts[n] * 1e3
                for n in sorted(self._seconds)}

    def report(self) -> str:
        lines = []
        for name in sorted(self._seconds, key=lambda n: -self._seconds[n]):
            n, tot = self._counts[name], self._seconds[name]
            lines.append(f"{name:30s} {tot * 1000:10.1f} ms total "
                         f"{tot / max(n, 1) * 1000:8.2f} ms/call x{n}")
        return "\n".join(lines)

    def reset(self) -> None:
        self._seconds.clear()
        self._counts.clear()
