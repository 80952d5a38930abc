#!/usr/bin/env python3
"""Turek 2D-2 (Re 100, unsteady shedding) corridor run of the PyTorch/CUDA
port on one NVIDIA GPU, against the stored JAX CPU-f64 series and the
published Schäfer-Turek windows (reference physics:
``simulation.cc:433-640``).

    python3 tools/corridor_gpu.py [--ref 2] [--t-end 35] [--steps N]
        [--max-wall SECONDS] [--device cpu] [--out FILE]

The counterpart of the JAX package's ``tools/corridor_tpu.py``, with its
settings: Q2 at refinement ``--ref``, c1 = 2, c2 = 1 (the corridor
stabilization the stored series was run with), BDF-2, CFL 1, GMG with
the direct coarse solve and no coarse iteration, inexact Newton at the
per-step relative tolerance 1e-4, the preconditioner rebuilt once a
step, f32 outer solve, output off.  It runs to ``--t-end``, for
``--steps`` steps, or until the step that ends past ``--max-wall``
seconds, whichever comes first, and compares:

- over the steps run: drag and lift against
  ``validation/turek_2d_re100_ref2_q2_series.json`` (refinement 2 only),
  interpolated to the port's times (max abs difference, and at the last
  step);
- where the run reached the shedding (t > 10 plus the 8-unit tail):
  max drag, max and min lift and the Strouhal number against the stored
  series' (|d drag_max| < 0.02, |d lift_max| < 0.08, |d St| < 0.004)
  and the Schäfer-Turek windows (3.12 < drag_max < 3.32, 0.90 < lift_max
  < 1.18, 0.286 < St < 0.306, lift_min < -0.85).

Writes the series and the verdict to ``validation/corridor_gpu_ref<R>.json``
(never a JAX run's file) and prints the verdict as one JSON line; exit
code 0 iff every comparison the run reached holds.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
STORED = os.path.join(ROOT, "validation",
                      "turek_2d_re100_ref2_q2_series.json")
T_TAIL = 8.0


def shedding_stats(t, drag, lift, t_tail=T_TAIL):
    m = t > t[-1] - t_tail
    tt, ll = t[m], lift[m]
    up = tt[1:][(ll[:-1] < 0) & (ll[1:] >= 0)]
    period = float(np.diff(up).mean()) if len(up) > 2 else float("nan")
    return {"drag_max": float(drag[m].max()),
            "lift_max": float(lift[m].max()),
            "lift_min": float(lift[m].min()),
            "strouhal": 0.1 / period}


def stop_after(drv, seconds: float) -> None:
    """End ``drv``'s time loop after the first step that ends past
    ``seconds`` of wall time from now (the series so far is kept)."""
    deadline = time.perf_counter() + seconds
    post = drv.sim.postprocess

    def postprocess(t, u):
        rec = post(t, u)
        if time.perf_counter() > deadline:
            drv.params.t_final = min(drv.params.t_final, t)
        return rec

    drv.sim.postprocess = postprocess


def params(ref, t_end):
    from ns_gls_tpu_torch.config import Parameters

    return Parameters.from_dict({
        "dim": 2, "fe degree": 2, "mapping degree": 0,
        "n global refinements": ref, "simulation name": "cylinder",
        "cfl": 1.0, "t final": t_end, "bdf order": 2,
        "time intration": "bdf", "c1": 2.0, "c2": 1.0, "nu": 0.001,
        "consider time derivative": True,
        "cell wise stabilization": False,
        "lin relative tolerance": 1e-2, "preconditioner": "GMG",
        "gmg coarse grid solver": "direct",
        "gmg coarse grid iterate": False,
        "nonlinear solver": "Newton", "newton inexact": True,
        "output granularity": 0.0,
        "simulation no slip cylinder": True,
        "simulation no slip wall": True,
        "simulation geometry cylinder shift": 0.005,
        "simulation t init": 0.01, "simulation u max": 1.5,
        "precision": "f32",
        "nonlinear tolerance": 1e-4,
        "nonlinear tolerance relative": True,
        "preconditioner update granularity": "step",
    })


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="corridor_gpu.py")
    ap.add_argument("--ref", type=int, default=2)
    ap.add_argument("--t-end", type=float, default=35.0)
    ap.add_argument("--steps", type=int, default=10**9)
    ap.add_argument("--max-wall", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    import torch

    if a.device != "cpu" and not torch.cuda.is_available():
        print("corridor_gpu: no CUDA device", file=sys.stderr)
        return 2
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.utils import logging as nslog

    nslog.set_verbose(False)
    drv = Driver(params(a.ref, a.t_end), device=a.device)
    t0 = time.perf_counter()
    drv.setup()
    drv._setup_done = True
    if a.max_wall is not None:
        stop_after(drv, a.max_wall - (time.perf_counter() - t0))
    recs = drv.run(max_steps=a.steps)
    wall = time.perf_counter() - t0
    t = np.array([r["t"] for r in recs])
    drag = np.array([r["drag"] for r in recs])
    lift = np.array([r["lift"] for r in recs])
    finite = bool(np.isfinite(drag).all() and np.isfinite(lift).all())
    verdict = dict(metric="turek_2d2_corridor", device=a.device,
                   ref=a.ref, steps=len(recs) - 1, t_reached=float(t[-1]),
                   wall_s=wall, finite=finite,
                   newton=[s["newton"] for s in drv.step_stats],
                   gmres=[s["gmres"] for s in drv.step_stats])
    ok = finite
    if a.ref == 2:
        vals = json.load(open(STORED))
        rt = np.array([r["t"] for r in vals])
        rdrag = np.array([r["drag"] for r in vals])
        rlift = np.array([r["lift"] for r in vals])
        m = (t > 0) & (t <= rt[-1])
        dd = np.abs(drag[m] - np.interp(t[m], rt, rdrag))
        dl = np.abs(lift[m] - np.interp(t[m], rt, rlift))
        verdict.update(
            stored_drag_max_abs_diff=float(dd.max()) if dd.size else None,
            stored_lift_max_abs_diff=float(dl.max()) if dl.size else None,
            stored_drag_last_abs_diff=float(dd[-1]) if dd.size else None)
        if t[-1] > 10.0 + T_TAIL:
            s, r = shedding_stats(t, drag, lift), shedding_stats(
                rt, rdrag, rlift)
            verdict.update(stats=s, stored_stats=r)
            ok &= abs(s["drag_max"] - r["drag_max"]) < 0.02
            ok &= abs(s["lift_max"] - r["lift_max"]) < 0.08
            ok &= abs(s["strouhal"] - r["strouhal"]) < 0.004
    if t[-1] > 10.0 + T_TAIL:
        s = shedding_stats(t, drag, lift)
        verdict["stats"] = s
        windows = (3.12 < s["drag_max"] < 3.32
                   and 0.90 < s["lift_max"] < 1.18
                   and 0.286 < s["strouhal"] < 0.306
                   and s["lift_min"] < -0.85)
        verdict["windows_ok"] = bool(windows)
        ok &= windows
    else:
        verdict["windows_ok"] = None       # the shedding was not reached
    verdict["ok"] = bool(ok)
    out = a.out or os.path.join(ROOT, "validation",
                                f"corridor_gpu_ref{a.ref}.json")
    with open(out, "w") as f:
        json.dump(dict(verdict, series=[
            dict(t=float(r["t"]), drag=float(r["drag"]),
                 lift=float(r["lift"]), p_diff=float(r["p_diff"]))
            for r in recs]), f)
    print(json.dumps({k: (None if isinstance(v, float) and math.isnan(v)
                          else v) for k, v in verdict.items()}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
