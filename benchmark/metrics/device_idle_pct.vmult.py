"""Share of the traced stretch in which no operation ran on the device:
1 - (union of the device operations' intervals) / (stretch), in %."""


def read(run):
    if run.trace is None or run.loop != "apply":
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
