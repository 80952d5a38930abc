"""Run a simulation from a reference-style JSON config:

    python -m ns_gls_tpu_torch input/turek_2d_re100.json --max-steps 5

Runs on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from ns_gls_tpu_torch.config import Parameters
from ns_gls_tpu_torch.driver import Driver
from ns_gls_tpu_torch.utils.timer import print_wall_time_statistics


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ns_gls_tpu_torch")
    ap.add_argument("config", help="JSON parameter file")
    ap.add_argument("--max-steps", type=int, default=10**9)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    params = Parameters.from_file(args.config)
    drv = Driver(params, device=args.device)
    for rec in drv.run(max_steps=args.max_steps):
        print(f"t = {rec['t']:.6g}  drag = {rec['drag']:.10g}  "
              f"lift = {rec['lift']:.10g}  p_diff = {rec['p_diff']:.10g}",
              flush=True)
    print_wall_time_statistics()


if __name__ == "__main__":
    main()
