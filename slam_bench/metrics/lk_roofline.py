"""LK's share of its roofline (%): the least time the H100 could take for
the window's LK launches (arith.bound on the bytes and operations that
reference/kernels.py `lk_align` counts on each launch's own inputs: points
run, templates, iterations) over the device time of those launches
(`lk_kernel`), summed over the profiler window."""

from slam_bench import trace


def read(run):
    t = trace.tables(run)
    if t is None:
        return None
    calls = [c for c in run.calls if c["kind"] == "lk" and "bound_ms" in c]
    ms, launches = trace.kernel_device_ms(run, "lk_kernel")
    if not calls or launches != len(calls) or ms <= 0:
        return None
    return 100.0 * sum(c["bound_ms"] for c in calls) / ms
