#!/usr/bin/env python3
"""Re 3900 wake run of the PyTorch/CUDA port on one NVIDIA GPU: the
Strouhal number and drag coefficient of ``input/hoffmann_2d_re3900.json``
(slip walls, uniform inflow 39).

    python3 tools/wake_re3900_gpu.py [--ref 3] [--t-end 0.45] [--steps N]
        [--max-wall SECONDS] [--resume] [--device cpu] [--out FILE]

The counterpart of the JAX package's ``tools/wake_re3900.py``, with its
on-chip settings: the config as given at refinement ``--ref``, output
off, the f32 outer solve with the per-step relative Newton tolerance
1e-6 and at most 100 Newton iterations.  It starts at t = 0: the JAX
runs' stored checkpoints are orbax, which the port does not read.  It
writes its own npz checkpoints (``<out>.ckpt``, every 0.001 time units;
``--resume`` continues from them) and runs to ``--t-end``, for
``--steps`` steps, or until the step that ends past ``--max-wall``
seconds, whichever comes first.  A Newton failure ends the run
(the JAX tool's restart ladder of tighter tolerances and smaller CFL is
not carried over): the series reached so far is written all the same,
with the error.

Writes ``validation/wake_re3900_gpu_ref<R>.json`` (never a JAX run's
file): the drag/lift series, the wake statistics over its trailing half
(at most ~10 periods of St 0.21; the Strouhal number from the mean
period between upward zero crossings of the lift, St = f D / u), and,
where ``validation/wake_re3900_ref<R>.json.partial`` holds the JAX run's
series, the drag and lift differences against it over the port's times.
Kravchenko & Moin's 3D LES gives St = 0.210, c_D = 1.04; 2D runs at Re
3900 give St 0.21-0.26 and c_D 1.2-1.7.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

D = 0.1            # cylinder diameter (grid_cylinder.h geometry)
U_BAR = 39.0       # the uniform free-stream inflow (u max 39.0)


def wake_stats(t, drag, lift, t_tail):
    """Shedding statistics over the trailing ``t_tail`` of the series."""
    m = t > t[-1] - t_tail
    tt, ll = t[m], lift[m]
    up = tt[1:][(ll[:-1] < 0) & (ll[1:] >= 0)]
    period = float(np.diff(up).mean()) if len(up) > 2 else None
    return {
        "n_periods": max(0, len(up) - 1),
        "period": period,
        "strouhal": D / (period * U_BAR) if period else None,
        "drag_mean": float(drag[m].mean()),
        "drag_max": float(drag[m].max()),
        "lift_rms": float(np.sqrt((ll ** 2).mean())),
        "t_window": [float(tt[0]), float(tt[-1])],
    }


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="wake_re3900_gpu.py")
    ap.add_argument("--ref", type=int, default=3)
    ap.add_argument("--t-end", type=float, default=0.45)
    ap.add_argument("--steps", type=int, default=10**9)
    ap.add_argument("--max-wall", type=float, default=None)
    ap.add_argument("--nl-tol", type=float, default=1e-6)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    import torch

    if a.device != "cpu" and not torch.cuda.is_available():
        print("wake_re3900_gpu: no CUDA device", file=sys.stderr)
        return 2
    from ns_gls_tpu_torch.config import Parameters
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.utils import logging as nslog

    nslog.set_verbose(False)
    out = a.out or os.path.join(ROOT, "validation",
                                f"wake_re3900_gpu_ref{a.ref}.json")
    with open(os.path.join(ROOT, "input", "hoffmann_2d_re3900.json")) as f:
        cfg = json.load(f)
    cfg.update({
        "n global refinements": a.ref, "t final": a.t_end,
        "output granularity": 0.0, "paraview prefix": "",
        "checkpoint prefix": out + ".ckpt", "checkpoint granularity": 0.001,
        "precision": "f32", "nonlinear tolerance relative": True,
        "nonlinear tolerance": a.nl_tol, "nonlinear max iterations": 100,
    })
    drv = Driver(Parameters.from_dict(cfg), device=a.device)
    t0 = time.perf_counter()
    drv.setup()
    drv._setup_done = True
    if a.max_wall is not None:
        stop_after(drv, a.max_wall - (time.perf_counter() - t0))
    error = None
    try:
        drv.run(max_steps=a.steps, resume=a.resume)
    except Exception as e:          # a Newton failure ends the run
        error = f"{type(e).__name__}: {e}"
    wall = time.perf_counter() - t0
    recs = drv.sim._history
    t = np.array([r["t"] for r in recs])
    drag = np.array([r["drag"] for r in recs])
    lift = np.array([r["lift"] for r in recs])
    t_tail = min(0.5 * (t[-1] - t[0]), max(10 * D / (0.21 * U_BAR), 0.05))
    res = dict(config="input/hoffmann_2d_re3900.json", device=a.device,
               ref=a.ref, t_end=a.t_end, t_reached=float(t[-1]),
               steps=len(drv.step_stats), wall_s=wall, error=error,
               finite=bool(np.isfinite(drag).all()
                           and np.isfinite(lift).all()),
               stats=wake_stats(t, drag, lift, t_tail),
               newton=[s["newton"] for s in drv.step_stats],
               gmres=[s["gmres"] for s in drv.step_stats])
    jax_run = os.path.join(ROOT, "validation",
                           f"wake_re3900_ref{a.ref}.json.partial")
    if os.path.exists(jax_run):
        ref = json.load(open(jax_run))["records"]
        rt = np.array([r["t"] for r in ref])
        # only where the two runs' times overlap (the stored run may hold a
        # resumed segment alone)
        m = (t > 0) & (t >= rt[0]) & (t <= rt[-1])
        if m.any():
            res.update(
                jax_t_reached=float(rt[-1]),
                jax_drag_max_abs_diff=float(np.abs(drag[m] - np.interp(
                    t[m], rt, [r["drag"] for r in ref])).max()),
                jax_lift_max_abs_diff=float(np.abs(lift[m] - np.interp(
                    t[m], rt, [r["lift"] for r in ref])).max()))
    with open(out, "w") as f:
        json.dump(dict(res, series={"t": t.tolist(), "drag": drag.tolist(),
                                    "lift": lift.tolist()}), f)
    print(json.dumps(res), flush=True)
    return 0 if error is None and res["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
