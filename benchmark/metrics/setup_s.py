"""Seconds from the process's start to the window's start: imports,
kernel builds or loads, the system's set-up and the warm-up."""


def read(run):
    return run.setup_s
