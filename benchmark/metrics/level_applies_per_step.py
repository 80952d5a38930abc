"""Applies of the multigrid level operators a driver step: the program's
``level_apply`` counter (one each ``vmult`` of a GMG level, in the
V-cycle's smoothing and residuals, the power iterations and the coarse
AMG's level 0), from the per-step counters of ``Driver.step_stats``,
over the window's steps."""

from benchmark.harness.program import per_step


def read(run):
    return per_step(run, "level_apply")
