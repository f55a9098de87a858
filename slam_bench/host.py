"""The host side of a run kept steady, and what it did in the window.

The batched step is paced by the host: one Python thread issues some
15,000 launches a step. So the harness

  * runs the process on the card's NUMA-local cores (`pin_to_card`, read
    from /sys), with one intra-op thread (`torch.set_num_threads(1)`, and
    `OMP_NUM_THREADS=1` for the libraries loaded before torch);
  * in the window (`steady()`), keeps the issuing thread alone on one of
    those cores and every other thread of the process on the rest, and
    holds the garbage collector: everything made in set-up is frozen out
    of its generations and no collection runs until the window closes;
  * counts, around the window (`counters()`), the issuing thread's CPU
    seconds, the collector's runs, and the card allocator's retries and
    device allocations, so that a slow run shows whether it waited or
    worked.
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
import time

CPUS = None   # the cores the run keeps to, set by pin_to_card


def _cpulist(text: str) -> set:
    out = set()
    for part in text.strip().split(","):
        if "-" in part:
            a, b = part.split("-")
            out.update(range(int(a), int(b) + 1))
        elif part:
            out.add(int(part))
    return out


def _tasks() -> list:
    try:
        return [int(t) for t in os.listdir("/proc/self/task")]
    except OSError:
        return []


def _set(tid: int, cpus) -> None:
    try:
        os.sched_setaffinity(tid, cpus)
    except OSError:
        pass


def pin_to_card(torch, device_index: int = 0) -> list:
    """Every thread of the process onto the card's NUMA-local cores (all
    allowed cores where /sys does not say); returns them."""
    global CPUS
    allowed = os.sched_getaffinity(0)
    cpus = allowed
    p = torch.cuda.get_device_properties(device_index)
    bus = getattr(p, "pci_bus_id", None)
    if bus is not None:
        addr = (f"{getattr(p, 'pci_domain_id', 0):04x}:{bus:02x}:"
                f"{getattr(p, 'pci_device_id', 0):02x}.0")
        try:
            with open(f"/sys/bus/pci/devices/{addr}/local_cpulist") as fh:
                cpus = (_cpulist(fh.read()) & allowed) or allowed
        except OSError:
            pass
    CPUS = sorted(cpus)
    for tid in _tasks():
        _set(tid, CPUS)
    return CPUS


@contextlib.contextmanager
def steady():
    """The window's host: the issuing thread alone on the last of the
    run's cores, the other threads on the rest, no garbage collection."""
    me = threading.get_native_id()
    cpus = CPUS
    if cpus and len(cpus) >= 2:
        _set(me, [cpus[-1]])
        for tid in _tasks():
            if tid != me:
                _set(tid, cpus[:-1])
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()
        if cpus and len(cpus) >= 2:
            for tid in _tasks():
                _set(tid, cpus)


def counters(torch, device) -> dict:
    """The issuing thread's and the allocator's counters now."""
    out = dict(wall_s=time.perf_counter(), cpu_s=time.thread_time(),
               gc_collections=sum(s["collections"] for s in gc.get_stats()))
    if device.type == "cuda":
        st = torch.cuda.memory_stats(device)
        out["alloc_retries"] = st.get("num_alloc_retries", 0)
        out["device_allocs"] = st.get("num_device_alloc", 0)
    return out


def delta(before: dict, after: dict) -> dict:
    """What the window added to each counter, and the run's cores."""
    return dict({k: after[k] - before[k] for k in before}, cores=CPUS)
