#!/usr/bin/env python3
"""Time the patch-3D sweep on every level of the sphere configurations.

    python3 tools/patch3d_levels.py [--baseline FILE.cu] [--sweep]
                                    [--reps N] [--no-fine]

Sets up the port's driver for ``input/sphere_amg.json`` (refinement 3,
patch-3D levels m = 2, 4, 8 of Q2) on the card and, unless ``--no-fine``,
the operator of ``bench_gpu.py --sphere 4 2`` (its finest level, m = 16),
and at each of those levels, in the sphere path's own flavor (increment,
q-wise delta, no history: the config is stationary; the levels'
scalars; random node-major vectors from ``numpy.random.default_rng(1)``):

- holds ``csrc/patch3d.cu`` to the plain version (max relative error,
  tol 1e-5) and relaunches it for bit-identity,
- times the kernel by CUDA events (``us``: launches back to back) and by
  the profiler's device time (``device_us``), beside the sweep's bound
  (``utils/roofline.py`` ``patch3d_cost``), and the whole sweep (kernel
  and seam sums, ``csrc/seam_sum.cu``): ``sweep_us`` by events,
  ``sweep_device_us`` the device time of all its kernels,
- with ``--baseline FILE.cu``: builds FILE (a revision of
  ``csrc/patch3d.cu`` whose launcher reads the node-major vectors and
  takes a slab depth and z chunks but no x brick, e.g. ``git show
  <commit>:ns_gls_tpu_torch/csrc/patch3d.cu`` of the commit before the
  bricks), holds it to the plain version and times it on the same inputs
  in the same process under the same slab depth and z chunks: the kernel
  alone, and its sweep (the kernel and the seam sums); only at levels
  whose plan takes the whole cell row as one brick, the layout that
  revision writes,
- with ``--sweep``: also times the kernel under other plans (slab depth,
  z chunks) than ``ops/patch3d.py`` ``patch3d_plan``'s.

Prints the card's name and power limit, the kernels' register use, and
one JSON line per level.  Needs a CUDA device.
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


def build_baseline(path: str):
    """ctypes function of the launcher in ``path``, built like the port's
    own kernels (same flags, the port's headers)."""
    from ns_gls_tpu_torch.utils import cuda_build as cb

    with open(path, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    os.makedirs(cb.BUILD_DIR, exist_ok=True)
    so = os.path.join(cb.BUILD_DIR, f"libpatch3d_baseline-{digest}.so")
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
    fn = ctypes.CDLL(so).patch3d_sweep_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 10 + [ci] * 7 + [cf] * 5 + [ci, ci, vp]
    fn.restype = ci
    return fn


def baseline_kernel(fn, tables, plan, sc, u, ul, vo, flavor, cdt, cw):
    """The previous revision's kernel on the node-major vectors under the
    slab depth and z chunks of ``plan`` (whose brick is the whole row):
    cell-row tiles in the layout of the tables' one brick."""
    import torch

    from ns_gls_tpu_torch.ops.patch3d import FLAVORS

    t = tables
    P, m = t.P, t.m
    out = torch.empty((t.jinv.shape[0], m, 1, P * m + 1, P + 1, P * m + 1,
                       4), dtype=torch.float32, device=u.device)
    err = fn(
        u.data_ptr(), ul.data_ptr(), vo.data_ptr(),
        t.patch_nodes.data_ptr(), t.jinv.data_ptr(), t.jxw.data_ptr(),
        t.h.data_ptr(), t.S1.data_ptr(), t.D1.data_ptr(), out.data_ptr(),
        t.jinv.shape[0], P, t.NQ, m, FLAVORS.index(flavor), int(cdt),
        int(cw), *(sc[k] for k in ("weight", "stau", "nu", "c1", "c2")),
        plan.zs, plan.nzb, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline launch failed: CUDA error {err}")
    return out


def rel_err(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


def levels(no_fine):
    """(label, tables, scalars) of every patch-3D level to time."""
    from ns_gls_tpu_torch.config import Parameters, _load_json
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.utils.logging import set_verbose

    raw = _load_json(os.path.join(ROOT, "input", "sphere_amg.json"))
    raw.update({"paraview prefix": "", "output granularity": 0.0})
    set_verbose(False)
    drv = Driver(Parameters.from_dict(raw), device="cuda")
    drv.setup()
    out = []
    for level, op in enumerate(drv.mg_ops):
        if op._fast is None:
            continue
        op.update_weight()
        sw = op._fast
        out.append((f"sphere_amg level {level}", sw.tables,
                    dict(weight=op.weight_host, stau=op.stau_host,
                         nu=sw.nu, c1=sw.c1, c2=sw.c2),
                    (op.consider_time_derivative,
                     op.cell_wise_stabilization)))
    if not no_fine:
        import bench_gpu

        op, _, _ = bench_gpu.build_sphere(4, 2, "cuda")
        sw = op._fast
        out.append(("bench_gpu --sphere 4 2", sw.tables,
                    dict(weight=op.weight_host, stau=op.stau_host,
                         nu=sw.nu, c1=sw.c1, c2=sw.c2),
                    (False, op.cell_wise_stabilization)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="patch3d_levels.py")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--no-fine", action="store_true",
                    help="leave out the m = 16 level of --sphere 4 2")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("patch3d_levels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from ns_gls_tpu_torch.ops import patch3d as p3
    from ns_gls_tpu_torch.utils import cuda_build
    from ns_gls_tpu_torch.utils import segment as sg
    from ns_gls_tpu_torch.utils.roofline import bound, patch3d_cost
    from ns_gls_tpu_torch.utils.timer import (
        device_kernels_us,
        device_time_us,
        time_cuda,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cuda_build.build_libraries(["patch3d", "seam_sum"])
    for name in ("patch3d", "seam_sum"):
        for line in cuda_build.build_info[name]["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {line.strip()}", flush=True)
    base_fn = build_baseline(args.baseline) if args.baseline else None

    for label, tables, sc, (cdt, cw) in levels(args.no_fine):
        n_p = tables.jinv.shape[0]
        rng = np.random.default_rng(1)
        u, ul, vo = (torch.as_tensor(rng.standard_normal((tables.n_nodes, 4)),
                                     dtype=torch.float32, device="cuda")
                     for _ in range(3))
        case = (tables, sc, u, ul, vo, "increment", cdt, cw)
        ref = p3.patch3d_sweep_plain(*case)
        a = p3.Patch3DKernel.launch(*case)
        b = p3.Patch3DKernel.launch(*case)
        torch.cuda.synchronize()
        plan = tables.plans[("increment", cdt)]
        rec = dict(card=card, level=label, P=tables.P, m=tables.m, n_p=n_p,
                   cells=n_p * tables.m ** 3, plan=list(plan),
                   max_rel_err=rel_err(a, ref),
                   bit_identical=bool(torch.equal(a, b)),
                   **p3.Patch3DKernel.attributes(tables.P, tables.m, plan,
                                                 "increment", cdt))
        if not (rec["max_rel_err"] <= REL_TOL and rec["bit_identical"]):
            print(json.dumps(rec), flush=True)
            raise AssertionError(f"{label}: kernel disagrees with the "
                                 "plain version or with itself")

        def kernel():
            return p3.Patch3DKernel.launch(*case)

        def sweep():
            return sg.seam_sum(tables.seams, kernel().reshape(-1, 4))

        nodes_ref = sg.seam_sum_plain(tables.seams, ref.reshape(-1, 4))
        rec["sweep_max_rel_err"] = rel_err(sweep(), nodes_ref)
        rec["us"] = 1e3 * time_cuda(kernel, args.reps, warmup=5)
        rec["device_us"] = device_time_us(kernel, "patch3d_kernel")
        rec["sweep_us"] = 1e3 * time_cuda(sweep, args.reps, warmup=5)
        rec["sweep_device_us"] = device_kernels_us(sweep)[0]
        rec["seam_device_us"] = device_time_us(sweep, "seam_sum_kernel")
        nbytes, flops = patch3d_cost(tables, "increment", cdt, cw)
        bms, by = bound(nbytes, flops)
        rec.update(bound_us=1e3 * bms, bound_by=by, bound_bytes=nbytes)
        if base_fn is not None and plan.nbx == 1:
            def old_kernel():
                return baseline_kernel(base_fn, tables, plan, sc, u, ul, vo,
                                       "increment", cdt, cw)

            def old_sweep():
                return sg.seam_sum(tables.seams, old_kernel().reshape(-1, 4))

            old = old_kernel()
            rec["baseline_max_rel_err"] = rel_err(old, ref)
            rec["baseline_bit_identical"] = bool(torch.equal(old, a))
            rec["baseline_sweep_max_rel_err"] = rel_err(old_sweep(),
                                                        nodes_ref)

            rec["baseline_us"] = 1e3 * time_cuda(old_kernel, args.reps,
                                                 warmup=5)
            rec["baseline_device_us"] = device_time_us(old_kernel,
                                                       "patch3d_kernel")
            rec["baseline_sweep_us"] = 1e3 * time_cuda(old_sweep, args.reps,
                                                       warmup=5)
            rec["baseline_sweep_device_us"] = device_kernels_us(
                old_sweep)[0]
            rec["device_us_again"] = device_time_us(kernel, "patch3d_kernel")
            del old
        if args.sweep:
            rec["sweep"] = {}
            for zs in (1, 2, 3, 4, 8):
                for nzb in (1, 2, 4):
                    if zs > tables.m or nzb > tables.m:
                        continue
                    alt = plan._replace(zs=zs, zc=-(-tables.m // nzb),
                                        nzb=nzb)
                    try:
                        t = device_time_us(
                            lambda: p3.Patch3DKernel.launch(*case, plan=alt),
                            "patch3d_kernel", n=20)
                    except RuntimeError as e:
                        t = str(e)
                    rec["sweep"][f"zs{zs}_nzb{nzb}"] = t
        print(json.dumps(rec), flush=True)
        del u, ul, vo, ref, a, b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
