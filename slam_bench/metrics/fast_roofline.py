"""FAST's share of its roofline (%): the least time the H100 could take
for the window's FAST + NMS launches (arith.fast_terms: a float32 read and
a score written a pixel, arith.FAST_OPS_PER_PIXEL operations) over the
device time of those launches (`fast_nms_kernel`)."""

from slam_bench import trace


def read(run):
    t = trace.tables(run)
    if t is None:
        return None
    calls = [c for c in run.calls if c["kind"] == "fast" and "bound_ms" in c]
    ms, launches = trace.kernel_device_ms(run, "fast_nms_kernel")
    if not calls or launches != len(calls) or ms <= 0:
        return None
    return 100.0 * sum(c["bound_ms"] for c in calls) / ms
