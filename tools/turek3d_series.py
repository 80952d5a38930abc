"""Stored Turek 3D reference series from the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/turek3d_series.py --refinements 1 \
        --steps 4 --out validation/turek_3d_re100_ref1_series.json

Runs ``input/turek_3d_re100.json`` through the JAX ``Driver`` (f64 outer
solve, f32 GMG levels on the general sweep, aggregation-AMG coarse solve
iterated by GMRES: the coarse level has 16,704 DoFs, above the dense-LU
limit of 8000) with output off, and writes the drag / lift / pressure-drop
records with the command, the parameters and the wall time.
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--refinements", type=int, default=1)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from ns_gls_tpu.config import Parameters
    from ns_gls_tpu.driver import Driver
    import ns_gls_tpu.utils.logging as jlog

    jlog.set_verbose(False)
    with open(os.path.join(ROOT, "input", "turek_3d_re100.json")) as f:
        raw = json.load(f)
    overrides = {"n global refinements": a.refinements,
                 "paraview prefix": "", "output granularity": 0.0}
    raw.update(overrides)
    drv = Driver(Parameters.from_dict(raw))
    t0 = time.perf_counter()
    recs = drv.run(max_steps=a.steps)
    wall = time.perf_counter() - t0
    out = dict(
        command=("JAX_PLATFORMS=cpu python tools/turek3d_series.py "
                 f"--refinements {a.refinements} --steps {a.steps} "
                 f"--out {a.out}"),
        config="input/turek_3d_re100.json",
        overrides=overrides,
        package="ns_gls_tpu (JAX, CPU, f64 outer, f32 GMG levels, "
                "AMG coarse iterated by GMRES)",
        steps=a.steps,
        wall_seconds=wall,
        host=f"{platform.processor() or platform.machine()}, "
             f"{os.cpu_count()} CPUs",
        series=[{k: float(r[k]) for k in ("t", "drag", "lift", "p_diff")}
                for r in recs],
    )
    with open(os.path.join(ROOT, a.out), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["series"][-1]), f"wall {wall:.1f} s")


if __name__ == "__main__":
    main()
