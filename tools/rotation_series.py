"""Stored rotation-slice driver runs from the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/rotation_series.py \
        --out validation/rotation_ref2_series.json.gz

Runs the JAX ``Driver`` (f64 outer solve, output off) on the cases the
port's ``tests/test_torch_gmg_ls.py`` and ``tests/test_torch_adaptive_gmg.py``
hold its driver to:

- ``input/rotation.json`` at refinement 2 (the JAX package's
  ``tests/test_rotation.py`` setting) under GMG-LS, as given (f32
  levels), 3 steps;
- the same with f64 levels (``"mg precision": "f64"``), 3 steps;
- the same under GMG (f32 levels, several patch families), 3 steps;
- the adaptive cylinder of the JAX package's ``tests/test_gmg_ls.py``
  (``_adaptive_channel_driver``) under GMG, 1 step.

Writes, per run, the configuration, the Newton and GMRES iterations of
every step and the final solution, with the command and the wall time,
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

# the JAX package's tests/test_gmg_ls.py adaptive channel: the cylinder
# with an extra length, refined in the wake only
CYLINDER = {
    "dim": 2, "fe degree": 2, "n global refinements": 2,
    "simulation name": "cylinder", "cfl": 0.1, "t final": 0.1,
    "bdf order": 1, "time intration": "bdf", "nu": 0.001,
    "consider time derivative": True, "lin relative tolerance": 1e-8,
    "gmg coarse grid solver": "direct", "nonlinear solver": "Newton",
    "output granularity": 0.0, "paraview prefix": "",
    "preconditioner": "GMG", "simulation u max": 0.3,
    "simulation geometry extra length": 0.8, "nonlinear tolerance": 1e-5,
}


def rotation(preconditioner: str, **extra) -> dict:
    """``input/rotation.json`` at refinement 2 under ``preconditioner``,
    output off."""
    with open(os.path.join(ROOT, "input", "rotation.json")) as f:
        raw = json.load(f)
    return raw | {"n global refinements": 2, "paraview prefix": "",
                  "output granularity": 0.0,
                  "preconditioner": preconditioner} | extra


# (name, configuration, steps)
RUNS = (
    ("rotation_ls", rotation("GMG-LS"), 3),
    ("rotation_ls_f64", rotation("GMG-LS", **{"mg precision": "f64"}), 3),
    ("rotation_gmg", rotation("GMG"), 3),
    ("cylinder_gmg", CYLINDER, 1),
)


def run(cfg: dict, steps: int) -> dict:
    """One JAX driver run: iterations per step and the final solution."""
    import numpy as np

    from ns_gls_tpu.config import Parameters
    from ns_gls_tpu.driver import Driver

    drv = Driver(Parameters.from_dict(cfg))
    drv.setup()
    drv._setup_done = True
    nl = drv.nonlinear_solver
    solve_j, solve = nl.solve_with_jacobian, nl.solve
    newton, gmres = [], []

    def counted_solve_j(rhs):
        x = solve_j(rhs)
        gmres[-1] += drv.linear_solver._last_it
        return x

    def counted_solve(u):
        gmres.append(0)
        out = solve(u)
        newton.append(nl.last_iterations)
        return out

    nl.solve_with_jacobian = counted_solve_j
    nl.solve = counted_solve
    t0 = time.perf_counter()
    drv.run(max_steps=steps)
    wall = time.perf_counter() - t0
    return dict(config=cfg, steps=steps, wall_seconds=wall, newton=newton,
                gmres=gmres,
                solution=np.asarray(drv.solution.current).tolist())


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
        command=("JAX_PLATFORMS=cpu python tools/rotation_series.py "
                 f"--out {a.out}"),
        package="ns_gls_tpu (JAX, CPU, f64 outer solve)",
        host=f"{platform.processor() or platform.machine()}, "
             f"{os.cpu_count()} CPUs",
        runs={},
    )
    for name, cfg, steps in RUNS:
        res = run(cfg, steps)
        out["runs"][name] = res
        print(name, res["newton"], res["gmres"],
              f"wall {res['wall_seconds']:.1f} s", flush=True)
    with gzip.open(os.path.join(ROOT, a.out), "wt") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
