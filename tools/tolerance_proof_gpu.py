#!/usr/bin/env python3
"""Tolerance proof of the PyTorch/CUDA port on one NVIDIA GPU: Newton at
the reference's absolute 1e-7 (``solver_nl.cc:27``) on the Turek 3D
Re100 benchmark config with the f32 outer solve, against the JAX
package's stored CPU-f64 run.

    python3 tools/tolerance_proof_gpu.py [--ref 1] [--steps 4]
        [--tol 1e-7] [--device cpu] [--out FILE]

The counterpart of the JAX package's ``tools/tolerance_proof.py`` (its
settings: Q2, BDF-2, CFL 1, GMG with the direct coarse solve and no
coarse iteration, inexact Newton, the preconditioner rebuilt once a step,
``"precision": "f32"``): ``--steps`` steps at refinement ``--ref``,
compared with ``validation/tolerance_cpu_f64_ref<R>.json`` over the
steps both ran (Newton iterations at most one above the f64 run's each
step, drag within 1e-4 relative to the f64 run's max-abs).  Writes
``validation/tolerance_gpu_f32_ref<R>.json`` (never a JAX run's file)
and prints the verdict as one JSON line; exit code 0 iff it holds.  A
step whose Newton solve does not reach the tolerance ends the run and
fails the verdict, with its error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
VAL = os.path.join(ROOT, "validation")


def run(ref, n_steps, tol, device):
    from ns_gls_tpu_torch.config import Parameters
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.solvers.nonlinear import NonlinearSolverError
    from ns_gls_tpu_torch.utils import logging as nslog

    nslog.set_verbose(False)
    p = Parameters.from_dict({
        "dim": 3, "fe degree": 2, "mapping degree": 0,
        "n global refinements": ref, "simulation name": "cylinder",
        "cfl": 1.0, "t final": 10.0, "bdf order": 2,
        "time intration": "bdf", "c1": 2.0, "c2": 1.0, "nu": 0.001,
        "consider time derivative": True,
        "cell wise stabilization": False,
        "lin relative tolerance": 1e-2, "preconditioner": "GMG",
        "gmg coarse grid solver": "direct",
        "gmg coarse grid iterate": False,
        "preconditioner update granularity": "step",
        "nonlinear solver": "Newton", "newton inexact": True,
        "output granularity": 0.0,
        "simulation no slip cylinder": True,
        "simulation no slip wall": True,
        "simulation geometry cylinder shift": 0.005,
        "simulation t init": 0.01, "simulation u max": 2.25,
        "precision": "f32",
        "nonlinear tolerance": tol,
    })
    drv = Driver(p, device=device)
    error = None
    try:
        drv.run(max_steps=n_steps)
    except NonlinearSolverError as e:   # the claim under test failed
        error = str(e)
    recs = drv.sim._history
    return {
        "ref": ref, "precision": "f32", "tol": tol, "device": device,
        "error": error,
        "newton_iterations": [s["newton"] for s in drv.step_stats],
        "final_residuals": [s["newton_residual"] for s in drv.step_stats],
        "gmres": [s["gmres"] for s in drv.step_stats],
        "s_per_step": [s["seconds"] for s in drv.step_stats],
        "drag": [r["drag"] for r in recs],
        "lift": [r["lift"] for r in recs],
        "t": [r["t"] for r in recs],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tolerance_proof_gpu.py")
    ap.add_argument("--ref", type=int, default=1)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    import torch

    if a.device != "cpu" and not torch.cuda.is_available():
        print("tolerance_proof_gpu: no CUDA device", file=sys.stderr)
        return 2
    out = run(a.ref, a.steps, a.tol, a.device)
    ti = out["newton_iterations"]
    verdict = dict(mode="gpu_f32" if a.device != "cpu" else "cpu_f32",
                   newton_iterations=ti, error=out["error"],
                   final_residuals=out["final_residuals"],
                   gmres=out["gmres"], s_per_step=out["s_per_step"])
    base_path = os.path.join(VAL, f"tolerance_cpu_f64_ref{a.ref}.json")
    if os.path.exists(base_path):
        base = json.load(open(base_path))
        bi = base["newton_iterations"]
        n = min(len(bi), len(ti))
        it_ok = all(ti[k] <= bi[k] + 1 for k in range(n))
        nd = min(len(base["drag"]), len(out["drag"]))
        dragb = np.array(base["drag"][:nd])
        drag_err = float(np.abs(np.array(out["drag"][:nd]) - dragb).max()
                         / max(np.abs(dragb).max(), 1e-12))
        verdict.update(baseline_iterations=bi, steps_compared=n,
                       iterations_ok=bool(it_ok), drag_rel_err=drag_err,
                       ok=bool(out["error"] is None and it_ok
                               and drag_err < 1e-4))
    else:
        verdict.update(baseline_iterations=None,
                       ok=out["error"] is None)
    path = a.out or os.path.join(VAL, f"tolerance_gpu_f32_ref{a.ref}.json")
    with open(path, "w") as f:
        json.dump(dict(out, verdict=verdict), f)
    print(json.dumps(verdict), flush=True)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
