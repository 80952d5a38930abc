#!/usr/bin/env python3
"""Where the prism kernel's time goes, stage by stage, on the card.

    python3 tools/prism_stage_clocks.py [config]

Builds a copy of ``ns_gls_tpu_torch/csrc/prism.cu`` in which thread 0 of
every block reads ``clock64()`` after each barrier of the slab loop (and
after one more barrier behind the last stage, I1), sums the cycles per
stage over all blocks, and runs it once on every prism level of
``config`` (default ``input/turek_3d_re100.json``) in the timing case of
``chip_smoke.py`` phase 6 (increment flavor, history), with q-wise and
with cell-wise delta.  Prints each stage's share of the summed cycles:

    top  the next slab's copies issued, this slab's awaited, the barrier
    E1   along z          E2  along x          E3a |u*|^2 (cell-wise only)
    E3b  along y and the physics               I3  along y
    I2   along x          I1  along z and the output writes

The extra barrier makes the instrumented kernel a little slower than the
real one; the shares, not the cycles, are the result.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SC = dict(weight=187.5, stau=100.0, nu=0.001, c1=2.0, c2=1.0)
STAGES = ("top", "E1", "E2", "E3a", "E3b", "I3", "I2", "I1")
MARK = ("    if (threadIdx.x == 0) {{ long long t1 = clock64(); "
        "st[{k}] += t1 - t0; t0 = t1; }}")


def instrumented_source(src: str) -> str:
    """``prism.cu`` with a cycle count per stage of the slab loop."""
    out, k, in_loop = [], 0, False
    for line in src.split("\n"):
        if "// the next iteration's barrier orders" in line:
            out += ["    __syncthreads();", MARK.format(k=k)]
            k += 1
        out.append(line)
        if "for (int s = 0; s < n_slabs; ++s) {" in line:
            in_loop = True
            continue
        if in_loop and line.strip() == "__syncthreads();":
            out.append(MARK.format(k=k))
            k += 1
    if k != len(STAGES):
        raise RuntimeError(f"found {k} stage barriers, want {len(STAGES)}: "
                           "csrc/prism.cu no longer has the stages this "
                           "tool knows")
    s = "\n".join(out)
    s = s.replace(
        "  const int n_slabs = (ze - lo + ZS - 1) / ZS;",
        "  const int n_slabs = (ze - lo + ZS - 1) / ZS;\n"
        "  long long st[8] = {0};\n  long long t0 = clock64();", 1)
    end = s.index("template <int P, int NQ>\nint launch_tp")
    body = s[:end].rstrip()
    assert body.endswith("}")
    s = (body[:-1] + "  if (threadIdx.x == 0)\n    for (int q = 0; q < 8; ++q)"
         "\n      atomicAdd(&g_stage[q], (unsigned long long)st[q]);\n}\n\n"
         + s[end:])
    return s.replace("namespace {\n", (
        "__device__ unsigned long long g_stage[8];\n"
        "extern \"C\" int stage_read(unsigned long long* h) {\n"
        "  return (int)cudaMemcpyFromSymbol(h, g_stage, sizeof(g_stage));\n}\n"
        "extern \"C\" int stage_zero() {\n  unsigned long long z[8] = {0};\n"
        "  return (int)cudaMemcpyToSymbol(g_stage, z, sizeof(z));\n}\n"
        "namespace {\n"), 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prism_stage_clocks.py")
    ap.add_argument("config", nargs="?",
                    default=os.path.join(ROOT, "input", "turek_3d_re100.json"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("prism_stage_clocks: no CUDA device", file=sys.stderr)
        return 2
    from ns_gls_tpu_torch.config import Parameters, _load_json
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.ops import prism as pr
    from ns_gls_tpu_torch.utils import cuda_build as cb
    from ns_gls_tpu_torch.utils.logging import set_verbose

    with open(os.path.join(cb.CSRC, "prism.cu")) as f:
        src = instrumented_source(f.read())
    os.makedirs(cb.BUILD_DIR, exist_ok=True)
    cu = os.path.join(cb.BUILD_DIR, "prism_stage_clocks.cu")
    so = os.path.join(cb.BUILD_DIR, "libprism_stage_clocks.so")
    with open(cu, "w") as f:
        f.write(src)
    out = subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-I", cb.CSRC, "-o",
                          so, cu], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(so)
    fn = lib.prism_sweep_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 10 + [ci] * 8 + [cf] * 5 + [ci] * 3 + [vp]
    fn.restype = ci

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    raw = _load_json(args.config)
    raw.update({"paraview prefix": "", "output granularity": 0.0})
    set_verbose(False)
    drv = Driver(Parameters.from_dict(raw), device="cuda")
    drv.setup()
    for op in drv.mg_ops:
        if not isinstance(op._fast, pr.PrismSweep):
            continue
        T = op._fast.tables
        n_p = T.jinv.shape[0]
        Xn, Nzn = T.P * T.m + 1, T.P * T.nz + 1
        rng = np.random.default_rng(1)

        def tile(lead):
            return torch.as_tensor(
                rng.standard_normal((lead, n_p, Xn, Xn, Nzn)),
                dtype=torch.float32, device="cuda")

        u, ul, vo = tile(4), tile(4), tile(3)
        pl = T.plan
        out = torch.empty((4, n_p, T.m, pl.nbx, T.P + 1, T.P * pl.xb + 1,
                           Nzn), dtype=torch.float32, device="cuda")
        for cw in (False, True):
            lib.stage_zero()
            err = fn(u.data_ptr(), ul.data_ptr(), vo.data_ptr(),
                     T.jinv.data_ptr(), T.jxw.data_ptr(), T.h.data_ptr(),
                     T.S1.data_ptr(), T.D1.data_ptr(), T.wz.data_ptr(),
                     out.data_ptr(), n_p, T.P, T.NQ, T.m, T.nz,
                     pr.FLAVORS.index("increment"), 1, int(cw),
                     *(SC[k] for k in ("weight", "stau", "nu", "c1", "c2")),
                     pl.xb, pl.zs, pl.nzb,
                     torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"instrumented launch failed: {err}")
            cycles = (ctypes.c_ulonglong * 8)()
            lib.stage_read(cycles)
            total = sum(cycles)
            print(json.dumps(dict(
                card=card, m=T.m, cell_wise=cw, mcycles=total / 1e6,
                shares={name: round(100.0 * c / total, 1)
                        for name, c in zip(STAGES, cycles)
                        if cw or name != "E3a"})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
