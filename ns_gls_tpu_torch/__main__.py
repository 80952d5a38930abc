"""Run a simulation from a reference-style JSON config:

    python -m ns_gls_tpu_torch input/turek_2d_re100.json --max-steps 5
    python -m ns_gls_tpu_torch input/turek_3d_re100.json --refinements 0 \
        --max-steps 3 --device cpu
    python -m ns_gls_tpu_torch input/channel.json --dim 3 --degree 2 \
        --refinements 1 --max-steps 3

Runs on the CUDA device unless ``--device cpu`` is given;
``--refinements``, ``--dim`` and ``--degree`` override the config's
"n global refinements", "dim" and "fe degree".  Records of cases with
functionals (drag, lift, pressure drop) are printed per step; every case
prints its Newton and GMRES counts and seconds per step at the end.
"""

from __future__ import annotations

import argparse

from ns_gls_tpu_torch.config import Parameters, _load_json
from ns_gls_tpu_torch.driver import Driver
from ns_gls_tpu_torch.utils.timer import print_wall_time_statistics


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ns_gls_tpu_torch")
    ap.add_argument("config", help="JSON parameter file")
    ap.add_argument("--max-steps", type=int, default=10**9)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--refinements", type=int, default=None,
                    help="override the config's 'n global refinements'")
    ap.add_argument("--dim", type=int, default=None,
                    help="override the config's 'dim'")
    ap.add_argument("--degree", type=int, default=None,
                    help="override the config's 'fe degree'")
    args = ap.parse_args(argv)

    raw = _load_json(args.config)
    for key, value in (("n global refinements", args.refinements),
                       ("dim", args.dim), ("fe degree", args.degree)):
        if value is not None:
            raw[key] = value
    params = Parameters.from_dict(raw)
    drv = Driver(params, device=args.device)
    for rec in drv.run(max_steps=args.max_steps):
        print(f"t = {rec['t']:.6g}  drag = {rec['drag']:.10g}  "
              f"lift = {rec['lift']:.10g}  p_diff = {rec['p_diff']:.10g}",
              flush=True)
    for i, st in enumerate(drv.step_stats, 1):
        print(f"step {i}: newton = {st['newton']}  gmres = {st['gmres']}  "
              f"residual = {st['newton_residual']:.3e}  "
              f"seconds = {st['seconds']:.3f}", flush=True)
    print_wall_time_statistics()


if __name__ == "__main__":
    main()
