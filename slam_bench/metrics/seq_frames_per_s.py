"""Sequence-frames completed in the window over the window's time (host
clock, the window fenced at both ends)."""


def read(run):
    if not run.window_steps:
        return None
    return run.B * len(run.window_steps) / run.window_s
