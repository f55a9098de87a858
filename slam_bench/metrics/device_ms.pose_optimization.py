"""Device ms a batched step of the kernels launched inside the port's
`track.pose_optimization` range (models/vo.py), over the traced run's
profiler window (one keyframe cadence of steps after the window): the
range is entered once a batched step, under torch.func.vmap too."""

from slam_bench import trace


def read(run):
    if trace.tables(run) is None:
        return None
    ms, calls = trace.range_device_ms(run, "track.pose_optimization")
    if calls != run.profile["steps"] or ms <= 0:
        return None
    return ms / calls
