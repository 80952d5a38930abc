"""Millions of DoFs applied a second: DoFs times the applies completed in
the window over the window's seconds (``performance.cc``'s figure)."""


def read(run):
    if run.loop != "apply" or not run.units:
        return None
    return run.n_dofs * run.units / run.window_s / 1e6
