"""Run a simulation from a reference-style JSON config:

    python -m ns_gls_tpu_torch input/turek_2d_re100.json --max-steps 5
    python -m ns_gls_tpu_torch input/turek_3d_re100.json --refinements 0 \
        --max-steps 3 --device cpu

Runs on the CUDA device unless ``--device cpu`` is given;
``--refinements`` overrides the config's "n global refinements".
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
    args = ap.parse_args(argv)

    raw = _load_json(args.config)
    if args.refinements is not None:
        raw["n global refinements"] = args.refinements
    params = Parameters.from_dict(raw)
    drv = Driver(params, device=args.device)
    for rec in drv.run(max_steps=args.max_steps):
        print(f"t = {rec['t']:.6g}  drag = {rec['drag']:.10g}  "
              f"lift = {rec['lift']:.10g}  p_diff = {rec['p_diff']:.10g}",
              flush=True)
    print_wall_time_statistics()


if __name__ == "__main__":
    main()
