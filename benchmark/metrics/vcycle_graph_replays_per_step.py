"""V-cycles a driver step served by a replay of the captured CUDA graphs:
the program's ``vcycle_graph_replay`` counter (one each V-cycle replayed,
whole or in two legs; ``ns_gls_tpu_torch/precond/gmg.py``), from the
per-step counters of ``Driver.step_stats``, over the window's steps.
Over ``vcycle``, the V-cycles a step, it is the replays' share; a program
without the counter reports nothing."""

from benchmark.harness.program import per_step


def read(run):
    return per_step(run, "vcycle_graph_replay")
