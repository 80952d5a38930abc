"""Wall seconds of the window over the driver steps completed in it (a
stationary configuration's step is its whole solve)."""


def read(run):
    if run.loop != "solve" or not run.units:
        return None
    return run.window_s / run.units
