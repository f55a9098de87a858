"""CUDA kernels launched a batched step, over the profiler window (memcpy
and memset left out)."""

from slam_bench import trace


def read(run):
    if trace.tables(run) is None:
        return None
    return trace.launches(run) / run.profile["steps"]
