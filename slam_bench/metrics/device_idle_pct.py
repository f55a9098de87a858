"""100 minus the device's busy share (%): the time some operation ran on
the device in the profiler window (one keyframe cadence of steps after the
window) over the unprofiled wall time of as many window steps
(profile_main_path.py's arithmetic: the profiler slows the host, not the
device)."""

from slam_bench import trace


def read(run):
    t = trace.tables(run)
    if t is None or not run.window_steps or t["busy_ms"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_ms"] / trace.unprofiled_wall_ms(run))
