#!/usr/bin/env python3
"""Step on the GPU the configs of ``input/`` that no other script runs.

    python3 tools/step_configs_gpu.py [--configs a,b,...] [--steps N]
        [--refinements R] [--device cpu] [--out FILE]

Runs each config as given (output off) through the port's ``Driver``:
``--steps`` time steps (default 2), or one solve for a stationary config
("time intration": "none"); ``--refinements`` overrides "n global
refinements" (the CPU rehearsal's smaller sizes).  For each config it
checks that every Newton solve converged (the solver raises where not)
and that the solution is finite, and prints one JSON line: the set-up
seconds, seconds per step (or per solve), Newton and GMRES counts per
step, and the launches of each fused kernel while the steps ran (counted
by the kernel wrappers, ``chip_smoke.py`` ``kernel_counts``).  A config
that fails prints its error and the run goes on to the next; the exit
code is non-zero if any failed.  Prints the card's name and power limit
first; ``--out`` also writes the JSON lines to a file.

The default configs are those that built on the CPU but had never run on
the card: ``cylinder``, ``hoffmann_2d_re3900``, ``hoffmann_3d_re3900``,
``sphere_direct``, ``turek_2d_re20``, ``turek_2d_re20_stationary`` and
``turek_3d_re20_stationary``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIGS = ("cylinder", "hoffmann_2d_re3900", "hoffmann_3d_re3900",
           "sphere_direct", "turek_2d_re20", "turek_2d_re20_stationary",
           "turek_3d_re20_stationary")


def run_config(name: str, steps: int, refinements, device: str) -> dict:
    """One config through ``Driver.run``: its numbers, or raises."""
    import torch

    from chip_smoke import kernel_counts, reset_kernel_counts
    from ns_gls_tpu_torch.config import Parameters
    from ns_gls_tpu_torch.driver import Driver

    with open(os.path.join(ROOT, "input", f"{name}.json")) as f:
        raw = json.load(f)
    over = {"output granularity": 0.0}
    if refinements is not None:
        over["n global refinements"] = refinements
    params = Parameters.from_dict(raw | over)
    drv = Driver(params, device=device)
    t0 = time.perf_counter()
    drv.setup()
    drv._setup_done = True
    setup_s = time.perf_counter() - t0
    reset_kernel_counts()
    t0 = time.perf_counter()
    drv.run(max_steps=steps)
    if device != "cpu":
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: v for k, v in kernel_counts().items() if v}
    stats = drv.step_stats
    u = drv.solution.current
    if not (stats and bool(torch.isfinite(u).all())
            and all(math.isfinite(s["newton_residual"]) for s in stats)):
        raise RuntimeError(f"{name}: no step, or a non-finite solution or "
                           "residual")
    stationary = drv.time_integrator.order == 0
    return dict(
        config=name, ok=True, device=device,
        n_refinements=params.n_global_refinements,
        degree=params.fe_degree, dim=params.dim,
        n_dofs=drv.space.n_nodes * drv.op.n_comp,
        stationary=stationary, setup_s=setup_s, run_s=run_s,
        s_per_step=[s["seconds"] for s in stats],
        newton=[s["newton"] for s in stats],
        newton_residual=[s["newton_residual"] for s in stats],
        gmres=[s["gmres"] for s in stats],
        launches=launches,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="step_configs_gpu.py")
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--refinements", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("step_configs_gpu: no CUDA device (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ns_gls_tpu_torch.utils import logging as nslog

    nslog.set_verbose(False)
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0], flush=True)
    lines = []
    for name in args.configs.split(","):
        try:
            res = run_config(name, args.steps, args.refinements,
                             args.device)
        except Exception as e:
            traceback.print_exc()
            res = dict(config=name, ok=False,
                       error=f"{type(e).__name__}: {e}")
        line = json.dumps(res)
        print(line, flush=True)
        lines.append(line)
        if args.device != "cpu":
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0 if all(json.loads(x)["ok"] for x in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
