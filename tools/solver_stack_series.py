"""Stored solver-stack driver runs from the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/solver_stack_series.py \
        --out validation/solver_stack_series.json.gz

Runs the JAX ``Driver`` (f64 outer solve, output off) on the cases the
port's ``tests/test_torch_nonlinear.py``, ``tests/test_torch_ilu_amg.py``,
``tests/test_torch_matrix_based.py`` and ``tests/test_torch_checkpoint.py``
hold its driver to: ``input/channel.json`` at refinement 1 (2 GMG levels)
under the ILU preconditioner, the ILU GMG coarse solver, Richardson,
Picard, the linearized solve and the matrix-based operator (f64 levels,
``"mg precision": "f64"``, where the f32 levels' rounding would decide
the iteration counts), and ``input/turek_2d_re100.json`` in Q1 at
refinement 0 for 4 BDF-2 steps with its state after step 2 (the
checkpoint cases).

Writes, per run, the configuration, the nonlinear and linear iterations
of every step and the final solution, with the command and the wall time,
as gzipped JSON.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def config(name: str, **extra) -> dict:
    """``input/<name>`` with output off and ``extra`` on top."""
    with open(os.path.join(ROOT, "input", name)) as f:
        raw = json.load(f)
    return raw | {"paraview prefix": "", "output granularity": 0.0} | extra


def channel(ref: int, **extra) -> dict:
    return config("channel.json", **{"n global refinements": ref}, **extra)


F64 = {"mg precision": "f64"}
# Picard solves for the whole solution, so its increment cannot fall
# below the linear solve's tolerance times the solution: tight solves,
# and the relative criterion (tolerance times ||u||)
PICARD = {"nonlinear solver": "Picard", "lin relative tolerance": 1e-10,
          "nonlinear tolerance relative": True}
# the checkpoint cases: Turek 2D in Q1 at refinement 0, BDF-2 as given
TUREK_Q1 = config("turek_2d_re100.json", **{"fe degree": 1,
                                            "n global refinements": 0})

# (name, configuration, steps)
RUNS = (
    ("ilu", channel(1, preconditioner="ILU"), 2),
    ("gmg_ilu_coarse", channel(1, **{"gmg coarse grid solver": "ILU"},
                               **F64), 2),
    ("richardson", channel(1, **{"linear solver": "Richardson"}, **F64), 2),
    ("picard", channel(1, **PICARD, **F64), 2),
    ("linearized", channel(1, **{"nonlinear solver": "linearized"},
                           **F64), 2),
    ("matrix_based", channel(1, **{"nonlinear solver": "linearized",
                                   "use matrix free ns operator": False},
                             **F64), 2),
    ("turek_q1", TUREK_Q1, 4),
)
# the runs whose state after this many steps is stored too
STATE_AFTER = {"turek_q1": 2}


def counted_driver(cfg: dict):
    """A set-up JAX driver whose nonlinear and linear iterations are
    recorded per step: (driver, nonlinear, linear)."""
    from ns_gls_tpu.config import Parameters
    from ns_gls_tpu.driver import Driver

    drv = Driver(Parameters.from_dict(cfg))
    drv.setup()
    drv._setup_done = True
    nl = drv.nonlinear_solver
    solve_j, solve = nl.solve_with_jacobian, nl.solve
    nonlinear, linear = [], []

    def counted_solve_j(rhs):
        x = solve_j(rhs)
        linear[-1] += drv.linear_solver._last_it
        return x

    def counted_solve(u):
        linear.append(0)
        out = solve(u)
        nonlinear.append(getattr(nl, "last_iterations", 1))
        return out

    nl.solve_with_jacobian = counted_solve_j
    nl.solve = counted_solve
    return drv, nonlinear, linear


def run(name: str, cfg: dict, steps: int) -> dict:
    """One JAX driver run: iterations per step and the final solution
    (and, for the checkpoint cases, the state after fewer steps)."""
    import numpy as np

    t0 = time.perf_counter()
    drv, nonlinear, linear = counted_driver(cfg)
    drv.run(max_steps=steps)
    out = dict(config=cfg, steps=steps,
               wall_seconds=time.perf_counter() - t0,
               nonlinear=nonlinear, linear=linear,
               solution=np.asarray(drv.solution.current).tolist())
    if name in STATE_AFTER:
        k = STATE_AFTER[name]
        drv, _, _ = counted_driver(cfg)
        drv.run(max_steps=k)
        dts = [float(x) for x in drv.time_integrator._dt]
        out["state"] = dict(
            steps=k, t=sum(dts[:k]), counter=k + 1, dt_history=dts,
            vectors=[np.asarray(v).tolist() for v in drv.solution.vectors])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import ns_gls_tpu.utils.logging as jlog

    jlog.set_verbose(False)
    out = dict(
        command=("JAX_PLATFORMS=cpu python tools/solver_stack_series.py "
                 f"--out {a.out}"),
        package="ns_gls_tpu (JAX, CPU, f64 outer solve)",
        host=f"{platform.processor() or platform.machine()}, "
             f"{os.cpu_count()} CPUs",
        runs={},
    )
    for name, cfg, steps in RUNS:
        res = run(name, cfg, steps)
        out["runs"][name] = res
        print(name, res["nonlinear"], res["linear"],
              f"wall {res['wall_seconds']:.1f} s", flush=True)
    with gzip.open(os.path.join(ROOT, a.out), "wt") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
