#!/usr/bin/env python3
"""Time the first build of the port's CUDA kernels (``nvcc``, one process
per source, all started together, as ``chip_smoke.py`` builds them) into
an empty build directory.

    python3 tools/kernel_build_time.py [--csrc DIR ...] [--repeat N]

Each ``--csrc`` is a directory of kernel sources (``*.cu``, ``*.cuh``),
e.g. another revision's ``ns_gls_tpu_torch/csrc`` unpacked with ``git
archive``; the default is this checkout's.  The directories are built in
turn, ``--repeat`` rounds, each into a fresh temporary directory; prints
the wall time of each build, each source's own seconds and the card's
name and power limit.  Needs the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_once(csrc: str) -> tuple[float, dict]:
    """Wall seconds of one build of every ``*.cu`` in ``csrc`` into an
    empty directory, and each source's seconds."""
    from ns_gls_tpu_torch.utils import cuda_build

    names = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    saved = cuda_build.CSRC, cuda_build.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        cuda_build.CSRC, cuda_build.BUILD_DIR = csrc, tmp
        try:
            t0 = time.perf_counter()
            cuda_build.build_libraries(names)
            wall = time.perf_counter() - t0
        finally:
            cuda_build.CSRC, cuda_build.BUILD_DIR = saved
    return wall, {n: cuda_build.build_info[n]["seconds"] for n in names}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", default=None,
                    help="a directory of kernel sources (repeatable)")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    dirs = args.csrc or [os.path.join(ROOT, "ns_gls_tpu_torch", "csrc")]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {smi}", flush=True)
    for r in range(args.repeat):
        for d in dirs:
            wall, per = build_once(os.path.abspath(d))
            each = ", ".join(f"{n} {s:.1f} s" for n, s in per.items())
            print(f"round {r}: {d}: {wall:.1f} s wall ({each})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
