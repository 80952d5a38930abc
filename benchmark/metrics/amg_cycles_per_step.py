"""AMG cycles a driver step: the program's ``amg_cycle`` counter (one each
``PreconditionerAMG.vmult``: once a coarse solve where it is not
iterated, once a coarse GMRES iteration and more where it is), from the
per-step counters of ``Driver.step_stats``, over the window's steps."""

from benchmark.harness.program import per_step


def read(run):
    return per_step(run, "amg_cycle")
