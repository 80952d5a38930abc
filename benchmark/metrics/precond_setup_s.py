"""Seconds of the driver's fenced set-up scope ``setup::preconditioner``
(the GMG levels' spaces, operators and transfers)."""


def read(run):
    return run.timers.get("setup::preconditioner")
