"""Seconds from the process's start to the window's start: imports, the
kernel build, rendering, the serial bootstraps and the warm-up steps."""


def read(run):
    return run.setup_s
