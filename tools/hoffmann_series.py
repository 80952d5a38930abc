"""Stored Hoffmann/ReInf reference series from the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/hoffmann_series.py \
        --out validation/hoffmann_2d_reinf_ref1_q1_series.json

Runs the weak-outflow cylinder configuration of the JAX package's slow
test ``tests/test_hoffmann.py`` (its ``BASE``: ``input/hoffmann_2d_reinf.json``
at Q1 and refinement 1, slip cylinder and walls, nu = 0, BDF-2, inexact
Newton to an absolute 1e-5, GMG with a direct coarse solve) through the
JAX ``Driver`` (f64 outer solve, f32 GMG levels on the general sweep),
with the Nitsche outflow for 3 steps and with the directional do-nothing
("cut") outflow for 2, output off.  Writes, per variant, the Newton and
GMRES iterations of every step, the drag / lift / pressure-drop records
and the final solution, with the command, the configuration and the wall
time.

The JAX operator caches its Nitsche targets at the first linearization
for good (``ns_gls_tpu/ops/navier_stokes.py`` ``_update_face_targets``),
when the ramped inflow is still zero; the port takes them at the
functions' current time, once per time value, as the reference does.
This script runs the JAX driver under the port's rule (the operator's
cache dropped whenever the functions' time moves; the package itself is
not changed), so that the two drivers solve the same problem.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# tests/test_hoffmann.py BASE (the JAX package's Hoffmann smoke config)
BASE = {
    "dim": 2, "fe degree": 1, "mapping degree": 0,
    "n global refinements": 1, "simulation name": "cylinder", "cfl": 1.0,
    "t final": 1.0, "bdf order": 2, "time intration": "bdf", "c1": 1.0,
    "c2": 1.0, "nu": 0.0, "consider time derivative": True,
    "cell wise stabilization": True, "lin relative tolerance": 1e-2,
    "preconditioner": "GMG", "gmg coarse grid solver": "direct",
    "nonlinear solver": "Newton", "newton inexact": True,
    "output granularity": 0.0, "simulation no slip cylinder": False,
    "simulation no slip wall": False,
    "simulation geometry cylinder shift": 0.0, "simulation t init": 0.05,
    "simulation reset manifold level": 0, "simulation u max": 39.0,
    "simulation use outflow bc weak nitsche": True,
    "nonlinear tolerance": 1e-5,
}
# (variant, outflow overrides, steps): the JAX test's two runs
VARIANTS = (
    ("nitsche", {}, 3),
    ("cut", {"simulation use outflow bc weak nitsche": False,
             "simulation use outflow bc weak cut": True}, 2),
)


def targets_per_time():
    """Let every JAX operator re-evaluate its Nitsche targets whenever the
    target functions' time has moved since it last did (the port's rule);
    the package's own code is unchanged."""
    from ns_gls_tpu.ops.navier_stokes import NavierStokesOperator

    orig = NavierStokesOperator._update_face_targets

    def update(op, t=None):
        key = tuple(getattr(fn, "time", None)
                    for fn in op.outflow_bcs_nitsche.values())
        if getattr(op, "_targets_time", None) != key:
            op._face_targets_cache = None
            op._targets_time = key
        return orig(op, t)

    NavierStokesOperator._update_face_targets = update


def run(cfg: dict, steps: int) -> dict:
    """One JAX driver run: iterations per step, records, final solution."""
    import numpy as np

    from ns_gls_tpu.config import Parameters
    from ns_gls_tpu.driver import Driver

    drv = Driver(Parameters.from_dict(cfg))
    drv.setup()
    drv._setup_done = True
    nl = drv.nonlinear_solver
    solve = nl.solve_with_jacobian
    gmres = [0]

    def counted_solve(rhs):
        x = solve(rhs)
        gmres[-1] += drv.linear_solver._last_it
        return x

    nl.solve_with_jacobian = counted_solve
    post = drv.sim.postprocess
    newton = []

    def recorded_post(t, sol):
        newton.append(nl.last_iterations)
        gmres.append(0)
        return post(t, sol)

    drv.sim.postprocess = recorded_post
    t0 = time.perf_counter()
    recs = drv.run(max_steps=steps)
    wall = time.perf_counter() - t0
    u = np.asarray(drv.solution.current)
    return dict(
        steps=steps, wall_seconds=wall,
        newton=newton[1:], gmres=gmres[1:-1],
        series=[{k: float(r[k]) for k in ("t", "drag", "lift", "p_diff")}
                for r in recs],
        solution=u.tolist(),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import ns_gls_tpu.utils.logging as jlog

    jlog.set_verbose(False)
    targets_per_time()
    out = dict(
        command=("JAX_PLATFORMS=cpu python tools/hoffmann_series.py "
                 f"--out {a.out}"),
        config=BASE,
        source="tests/test_hoffmann.py BASE (input/hoffmann_2d_reinf.json "
               "at Q1, refinement 1, nonlinear tolerance 1e-5)",
        package="ns_gls_tpu (JAX, CPU, f64 outer, f32 GMG levels on the "
                "general sweep, direct coarse solve), its Nitsche targets "
                "re-evaluated whenever the inflow's time moves",
        host=f"{platform.processor() or platform.machine()}, "
             f"{os.cpu_count()} CPUs",
        variants={},
    )
    for name, overrides, steps in VARIANTS:
        res = run(BASE | overrides, steps)
        out["variants"][name] = dict(overrides=overrides, **res)
        print(name, res["newton"], res["gmres"],
              json.dumps(res["series"][-1]),
              f"wall {res['wall_seconds']:.1f} s", flush=True)
    with open(os.path.join(ROOT, a.out), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
