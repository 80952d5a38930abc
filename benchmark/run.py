#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (``ns_gls_tpu_torch``): one run of
one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout.  Builds the cell's system from its
configuration, warms up every shape its traffic uses (set-up), runs the
traffic for ``--seconds``, judges what the timed path produced against
the plain reference in ``benchmark/reference``, and prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``, the
cell's end-to-end metrics (``--trace 0``) or per-layer metrics
(``--trace 1``, with ``breakdown``), ``device``, and ``checks``, each
compared number beside its limit (also the last lines on standard
error).  Exits non-zero with no result line without a CUDA device,
with fewer devices than the cell asks for, or when the process has
loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
BUILD = os.path.join(ROOT, "build")
# every build and kernel cache at a fixed place inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from benchmark.harness.cell import forbidden_modules, power_limit, run_cell
    from benchmark.harness.spec import load_benchmark

    bench = load_benchmark(ROOT)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    need = chips.get(args.workload)
    if need is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, setup = run_cell(ROOT, args.workload, args.seed, args.seconds,
                           args.trace, T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port "
              f"alone", file=sys.stderr)
        return 3
    from ns_gls_tpu_torch.utils.cuda_build import build_info

    builds = {k: round(v["seconds"], 3) for k, v in build_info.items()}
    print(f"card: {power_limit()}", file=sys.stderr)
    print(f"set-up: {json.dumps(setup)}; kernel builds (s, 0 = already "
          f"built): {json.dumps(builds)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
