#!/usr/bin/env python3
"""Time the prism kernel on every GMG level of a Turek 3D configuration.

    python3 tools/prism_levels.py [config] [--baseline FILE.cu] [--sweep]
                                  [--reps N]

Sets up the port's driver for ``config`` (default
``input/turek_3d_re100.json``: refinement 3, prism levels m = 1, 2, 4, 8)
on the card and, on each prism level, at the timing case of
``chip_smoke.py`` phase 6 (increment flavor, BDF history, q-wise delta,
random tiles from ``numpy.random.default_rng(1)``):

- holds ``csrc/prism.cu`` to the plain version (max relative error, tol
  1e-5) and relaunches it for bit-identity,
- times it by CUDA events (``us``: launches back to back, which at the
  coarse levels also holds the host's launch rate) and by the profiler's
  device time of the kernel alone (``device_us``), beside the sweep's
  bound (``utils/roofline.py`` ``prism_cost``),
- with ``--baseline FILE.cu``: builds FILE (another revision of
  ``csrc/prism.cu`` whose launcher takes a slab depth and z chunks, 0 for
  its own choice, but no x brick, e.g. from ``git show
  <commit>:ns_gls_tpu_torch/csrc/prism.cu`` of the commit before the
  bricks), holds it to the plain version and times it on the same inputs
  in the same process, at levels whose plan takes the whole cell row as
  one brick (the layout that revision writes),
- with ``--sweep``: also times the kernel at other slab depths and z-chunk
  counts than ``ops/prism.py`` ``prism_plan``'s.

Prints the card's name and power limit, the kernel's register use, and one
JSON line per level.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REL_TOL = 1e-5
SC = dict(weight=187.5, stau=100.0, nu=0.001, c1=2.0, c2=1.0)


def build_baseline(path: str):
    """ctypes function of the launcher in ``path``, built like the port's
    own kernels (same flags, the port's headers)."""
    from ns_gls_tpu_torch.utils import cuda_build as cb

    with open(path, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    os.makedirs(cb.BUILD_DIR, exist_ok=True)
    so = os.path.join(cb.BUILD_DIR, f"libprism_baseline-{digest}.so")
    if not os.path.exists(so):
        out = subprocess.run(
            [cb._nvcc(), *cb.NVCC_FLAGS, "-I", cb.CSRC, "-o", so, path],
            capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed on {path}:\n{out.stdout}"
                               f"{out.stderr}")
        for line in (out.stdout + out.stderr).splitlines():
            if "registers" in line or "spill" in line:
                print(f"baseline: {line.strip()}", flush=True)
    fn = ctypes.CDLL(so).prism_sweep_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 10 + [ci] * 8 + [cf] * 5 + [ci] * 2 + [vp]
    fn.restype = ci
    return fn


def baseline_launch(fn, tables, sc, u, ul, vo, flavor, cdt, cw):
    import torch

    from ns_gls_tpu_torch.ops.prism import FLAVORS

    P, m = tables.P, tables.m
    out = torch.empty((4, tables.jinv.shape[0], m, 1, P + 1, P * m + 1,
                       P * tables.nz + 1), dtype=torch.float32,
                      device=u.device)
    err = fn(u.data_ptr(), ul.data_ptr(), vo.data_ptr(),
             tables.jinv.data_ptr(), tables.jxw.data_ptr(),
             tables.h.data_ptr(), tables.S1.data_ptr(), tables.D1.data_ptr(),
             tables.wz.data_ptr(), out.data_ptr(), tables.jinv.shape[0], P,
             tables.NQ, m, tables.nz, FLAVORS.index(flavor), int(cdt),
             int(cw), *(sc[k] for k in ("weight", "stau", "nu", "c1", "c2")),
             0, 0, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline launch failed: CUDA error {err}")
    return out


def launch_split(tables, sc, u, ul, vo, flavor, cdt, cw, zs, nzb):
    """The port's kernel with ``zs`` cell layers per slab and ``nzb`` z
    chunks per column in place of the plan's (the result does not depend
    on them)."""
    from ns_gls_tpu_torch.ops.prism import PrismKernel

    zc = -(-tables.nz // nzb)
    plan = tables.plan._replace(zs=zs, zc=zc, nzb=-(-tables.nz // zc))
    return PrismKernel.launch(tables, sc, u, ul, vo, flavor, cdt, cw,
                              plan=plan)


def rel_err(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prism_levels.py")
    ap.add_argument("config", nargs="?",
                    default=os.path.join(ROOT, "input", "turek_3d_re100.json"))
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("prism_levels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from ns_gls_tpu_torch.config import Parameters, _load_json
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.ops import prism as pr
    from ns_gls_tpu_torch.utils import cuda_build
    from ns_gls_tpu_torch.utils.logging import set_verbose
    from ns_gls_tpu_torch.utils.roofline import bound, prism_cost
    from ns_gls_tpu_torch.utils.timer import device_time_us, time_cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cuda_build.build_libraries(["prism"])
    for line in cuda_build.build_info["prism"]["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"prism: {line.strip()}", flush=True)
    base = build_baseline(args.baseline) if args.baseline else None

    raw = _load_json(args.config)
    raw.update({"paraview prefix": "", "output granularity": 0.0})
    set_verbose(False)
    drv = Driver(Parameters.from_dict(raw), device="cuda")
    drv.setup()
    for op in drv.mg_ops:
        if not isinstance(op._fast, pr.PrismSweep):
            continue
        tables = op._fast.tables
        n_p = tables.jinv.shape[0]
        Xn, Nzn = tables.P * tables.m + 1, tables.P * tables.nz + 1
        rng = np.random.default_rng(1)

        def tile(lead):
            return torch.as_tensor(
                rng.standard_normal((lead, n_p, Xn, Xn, Nzn)),
                dtype=torch.float32, device="cuda")

        u, ul, vo = tile(4), tile(4), tile(3)
        case = (tables, SC, u, ul, vo, "increment", True, False)
        ref = pr.prism_sweep_plain(*case)
        a = pr.PrismKernel.launch(*case)
        b = pr.PrismKernel.launch(*case)
        torch.cuda.synchronize()
        rec = dict(card=card, m=tables.m, nz=tables.nz, n_p=n_p,
                   plan=list(tables.plan),
                   cells=n_p * tables.m ** 2 * tables.nz,
                   max_rel_err=rel_err(a, ref),
                   bit_identical=bool(torch.equal(a, b)))
        if not (rec["max_rel_err"] <= REL_TOL and rec["bit_identical"]):
            print(json.dumps(rec), flush=True)
            raise AssertionError(f"m={tables.m}: kernel disagrees with the "
                                 "plain version or with itself")
        rec["us"] = 1e3 * time_cuda(lambda: pr.PrismKernel.launch(*case),
                                    args.reps, warmup=5)
        rec["device_us"] = device_time_us(lambda: pr.PrismKernel.launch(*case),
                                     "prism_kernel")
        nbytes, flops = prism_cost(tables, "increment", True, False)
        bms, by = bound(nbytes, flops)
        rec.update(bound_us=1e3 * bms, bound_by=by)
        if base is not None and tables.plan.nbx == 1:
            c = baseline_launch(base, *case)
            rec["baseline_max_rel_err"] = rel_err(c, ref)
            rec["baseline_bit_identical"] = bool(torch.equal(c, a))
            rec["baseline_us"] = 1e3 * time_cuda(
                lambda: baseline_launch(base, *case), args.reps, warmup=5)
            rec["baseline_device_us"] = device_time_us(
                lambda: baseline_launch(base, *case), "prism_kernel")
            rec["us_again"] = 1e3 * time_cuda(
                lambda: pr.PrismKernel.launch(*case), args.reps, warmup=5)
        if args.sweep:
            rec["sweep"] = {}
            for zs in (1, 2, 3, 4, 6, 8):
                for nzb in (1, 2, 3, 4, 8):
                    if zs > tables.nz or nzb > tables.nz:
                        continue
                    try:
                        t = 1e3 * time_cuda(
                            lambda: launch_split(*case, zs, nzb),
                            max(args.reps // 4, 10), warmup=2)
                    except RuntimeError as e:
                        t = str(e)
                    rec["sweep"][f"zs{zs}_nzb{nzb}"] = t
        print(json.dumps(rec), flush=True)
        del u, ul, vo, ref, a, b
    return 0


if __name__ == "__main__":
    sys.exit(main())
