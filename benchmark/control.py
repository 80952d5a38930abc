#!/usr/bin/env python3
"""The controls of ``correct``: each cell run with its lower precision in
the program's place, which the comparison has to find not correct.

    python3 benchmark/control.py --workload NAME --seeds N,N,... \
        [--seconds S] [--program] [--out FILE]

The cell's configuration file says what its control is (``"control"``):
overrides of the configuration that switch on the program's own path in
the lower precision (``turek3d-re20``: float32 below the float64 it
states), or the plain reference put in the program's place in the lower
precision (``glsvmult-q2``: float32 with TF32 products, below the float32
with TF32 off that it states).

With ``--program`` each seed is also run as the cell is.  Prints one JSON
line per run (``control`` or ``program``, the seed, ``correct`` and the
compared numbers) and appends them to ``--out``.  Runs on the card; the
benchmark's own runs never run it.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
sys.path.insert(0, ROOT)

def control_of(config, device):
    """(overrides, wrap_system) of ``run_cell`` for the configuration's
    control (its ``"control"`` entry): ``"overrides"`` are merged into the
    configuration; ``"reference_in_place"`` puts the plain reference, in
    its lower precision, in the program's place through the system
    module's ``reference_in_place``."""
    from benchmark.harness import spec

    ctl = config["control"]
    overrides = {"config": ctl["overrides"]} if "overrides" in ctl else None
    wrap = None
    if "reference_in_place" in ctl:
        wrap = spec.system_module(config["system"]).reference_in_place(
            config, device)
    return overrides, wrap


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import torch

    from benchmark.harness import spec
    from benchmark.harness.cell import run_cell

    if not torch.cuda.is_available():
        print("the controls run on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs = spec.cell_spec(spec.load_benchmark(ROOT), args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        kinds = (["program"] if args.program else []) + ["control"]
        for kind in kinds:
            ov, wrap = None, None
            if kind == "control":
                ov, wrap = control_of(cs["config"], dev)
            t0 = time.perf_counter()
            line, _ = run_cell(ROOT, args.workload, seed, args.seconds, 0,
                               t0, overrides=ov, wrap_system=wrap)
            rec = dict(kind=kind, workload=args.workload, seed=seed,
                       correct=line["correct"], attempted=line["attempted"],
                       failed=line["failed"],
                       checks={k: v["value"]
                               for k, v in line["checks"].items()},
                       metrics={k: v["value"]
                                for k, v in line["metrics"].items()})
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
