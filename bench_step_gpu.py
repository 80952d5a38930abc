#!/usr/bin/env python3
"""Time-per-step benchmark of the PyTorch/CUDA port on one NVIDIA GPU: the
``BASELINE.md`` metric, seconds per step of Turek 3D Re100.

    python3 bench_step_gpu.py [n_refinements] [n_steps] [--config FILE]
        [--device cpu]

The counterpart of the JAX package's ``bench_step.py``: the port's
``Driver`` on ``input/turek_3d_re100.json`` (Q2, BDF-2, CFL 1, GMG with
the direct coarse solve, inexact Newton, linear tolerance 1e-2) at
``n_refinements`` (default 2, as ``bench_step.py``), output off, for one
warm-up step and then ``n_steps`` (default 3) timed steps through
``Driver.run``.  Prints the card's name and power limit and one JSON
line: the fastest timed step's seconds (the metric, as ``bench_step.py``
takes its fastest cycle), their mean, the warm-up step's, and the Newton
and GMRES counts of every step.  A failure raises: there is no retry
with another kernel.  ``--config`` runs another config the same way
(e.g. ``input/turek_2d_re100.json 0 1 --device cpu``, the quick
rehearsal: Turek 3D's first step takes minutes on the CPU).  Needs a
CUDA device (``--device cpu`` rehearses the control flow and prints no
device metric).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "input", "turek_3d_re100.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_step_gpu.py")
    ap.add_argument("n_refinements", nargs="?", type=int, default=2)
    ap.add_argument("n_steps", nargs="?", type=int, default=3)
    ap.add_argument("--config", default=CONFIG)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.n_steps < 1:
        ap.error("n_steps must be at least 1")

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("bench_step_gpu: no CUDA device (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ns_gls_tpu_torch.config import Parameters
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.utils import logging as nslog

    nslog.set_verbose(False)
    with open(args.config) as f:
        raw = json.load(f)
    params = Parameters.from_dict(raw | {
        "n global refinements": args.n_refinements,
        "output granularity": 0.0,
    })
    drv = Driver(params, device=args.device)
    t0 = time.perf_counter()
    drv.setup()
    drv._setup_done = True
    setup_s = time.perf_counter() - t0
    n_dofs = drv.space.n_nodes * drv.op.n_comp
    drv.run(max_steps=args.n_steps + 1)
    stats = drv.step_stats
    if len(stats) != args.n_steps + 1:
        raise RuntimeError(f"ran {len(stats)} steps, asked for "
                           f"{args.n_steps + 1}")
    # the Newton solver raises where a step does not converge
    if not (all(math.isfinite(s["newton_residual"]) for s in stats)
            and bool(torch.isfinite(drv.solution.current).all())):
        raise RuntimeError("a step left a non-finite residual or solution")
    timed = [s["seconds"] for s in stats[1:]]
    out = dict(
        metric=("turek3d_re100_time_per_step" if args.config == CONFIG
                else "time_per_step"),
        config=os.path.relpath(args.config, ROOT),
        s_per_step=min(timed),
        s_per_step_mean=sum(timed) / len(timed),
        warmup_s=stats[0]["seconds"],
        setup_s=setup_s,
        n_refinements=args.n_refinements,
        n_dofs=n_dofs,
        step_s=[s["seconds"] for s in stats],
        newton=[s["newton"] for s in stats],
        gmres=[s["gmres"] for s in stats],
        device=args.device,
    )
    if args.device == "cpu":
        print("CPU rehearsal: device metrics: not measured")
        out.pop("s_per_step")
        out.pop("s_per_step_mean")
        out.pop("warmup_s")
        out.pop("step_s")
    else:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        print(card)
        out["card"] = card
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
