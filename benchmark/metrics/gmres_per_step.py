"""GMRES iterations a driver step, over the window's steps
(``Driver.step_stats``)."""


def read(run):
    if not run.step_stats:
        return None
    return sum(s["gmres"] for s in run.step_stats) / len(run.step_stats)
