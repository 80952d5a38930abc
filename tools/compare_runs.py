#!/usr/bin/env python3
"""Run the port's driver on the CPU under one or two sets of overrides of
a config and compare the results.

    python3 tools/compare_runs.py input/turek_2d_re100.json --steps 3 \
        --a '{"n global refinements": 1}' \
        --b '{"n global refinements": 1, "nonlinear solver": "Picard",
              "lin relative tolerance": 1e-12}'

Each run prints its nonlinear and linear iterations and seconds per step
and the l2 norm of its solution; with two runs, the relative l2 and the
max-abs gap between the final solutions.  Output is off in every run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run(config: str, overrides: dict, steps: int):
    """The port's driver on the CPU: (driver, seconds)."""
    from ns_gls_tpu_torch.config import Parameters, _load_json
    from ns_gls_tpu_torch.driver import Driver

    raw = _load_json(config)
    raw.update({"paraview prefix": "", "output granularity": 0.0})
    raw.update(overrides)
    drv = Driver(Parameters.from_dict(raw), device="cpu")
    t0 = time.perf_counter()
    drv.run(max_steps=steps)
    return drv, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--a", default="{}", help="JSON overrides of run A")
    ap.add_argument("--b", default=None, help="JSON overrides of run B")
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()

    import torch

    from ns_gls_tpu_torch.utils.device import torch_threads
    from ns_gls_tpu_torch.utils.logging import set_verbose

    set_verbose(False)
    sols = []
    with torch_threads(args.threads):
        for name, over in (("A", args.a), ("B", args.b)):
            if over is None:
                continue
            drv, secs = run(args.config, json.loads(over), args.steps)
            u = drv.solution.current
            sols.append(u)
            print(f"{name} {over}: (nonlinear, linear) per step "
                  f"{[(s['newton'], s['gmres']) for s in drv.step_stats]}, "
                  f"seconds per step "
                  f"{[round(s['seconds'], 3) for s in drv.step_stats]}, "
                  f"{secs:.1f} s in all; |u| {float(u.norm()):.10g}",
                  flush=True)
    if len(sols) == 2:
        a, b = sols
        rel = float(torch.linalg.vector_norm(b - a)
                    / torch.linalg.vector_norm(a))
        print(f"gap: relative l2 {rel:.4e}, max abs "
              f"{float((b - a).abs().max()):.4e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
