"""GMRES iterations of the iterated coarse solve a driver step: the
program's ``coarse_gmres_it`` counter (the iterations of each GMRES on the
coarsest GMG level, ``precond/gmg.py`` ``_coarse_solve``), from the
per-step counters of ``Driver.step_stats``, over the window's steps."""

from benchmark.harness.program import per_step


def read(run):
    return per_step(run, "coarse_gmres_it")
