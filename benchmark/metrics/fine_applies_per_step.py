"""Applies of the fine operator a driver step: the program's
``fine_apply`` counter (one each ``vmult`` of the operator GMRES
applies), from the per-step counters of ``Driver.step_stats``, over the
window's steps."""

from benchmark.harness.program import per_step


def read(run):
    return per_step(run, "fine_apply")
