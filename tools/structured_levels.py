#!/usr/bin/env python3
"""Time the 3D structured kernel on every channel 3D level and the
gls-vmult lane's shape.

    python3 tools/structured_levels.py [--baseline FILE.cu]
                                       [--variant FILE.cu] [--sweep]
                                       [--reps N]

Sets up the port's channel 3D driver on the card (``input/channel.json``
with dim 3, degree 2, refinement 3: six GMG levels from 4 x 1 x 1 to
128 x 32 x 32 cells of Q2, every one on ``structured3d``) and builds the
operator of ``bench_gpu.py 3 5 2`` (32^3 cells).  At each of those
shapes, in the timing case of ``chip_smoke.py`` phase 9 (increment
flavor, BDF history, cell-wise delta, random lattices from
``numpy.random.default_rng(1)``):

- holds ``structured3d`` (``csrc/structured.cu``, folded by
  ``fold_bricks``) to ``structured_sweep_plain`` (max relative error, tol
  1e-5) and relaunches it for bit-identity,
- times the kernel alone by CUDA events (``us``: launches back to back,
  which at the coarse levels also holds the host's launch rate) and by the
  profiler's device time (``device_us``), the batched 3D kernel's device
  time on the same inputs (``batched_device_us``), and the sweep's bound
  (``utils/roofline.py`` ``structured_cost``),
- with ``--baseline FILE.cu``: builds FILE (another revision of
  ``csrc/structured.cu`` whose ``structured_sweep_launch`` takes the 3D
  kernel, e.g. from ``git show <commit>:ns_gls_tpu_torch/csrc/
  structured.cu``), holds it to the plain version and times it on the
  same inputs in the same process,
- with ``--variant FILE.cu``: the same for another revision with the
  brick layout (its ``structured3d_launch``, under this ``brick_plan``),
- with ``--sweep``: also holds and times the kernel under other brick
  plans than ``brick_plan``'s (bricks of 4, 8, 16 cells, slabs of 1-4
  layers, 1-8 z chunks).

Prints the card's name and power limit, the kernel's registers, spills
and shared memory per block, and one JSON line per shape.  Needs a CUDA
device.
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
SC = dict(weight=140.0, stau=140.0, nu=0.0, c1=2.0, c2=1.0)
CHANNEL3D = {"dim": 3, "fe degree": 2, "n global refinements": 3}


def build_other(path: str, tag: str):
    """ctypes handle of another revision of ``csrc/structured.cu`` in
    ``path``, built like the port's own kernels (same flags, the port's
    headers)."""
    from ns_gls_tpu_torch.utils import cuda_build as cb

    with open(path, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    os.makedirs(cb.BUILD_DIR, exist_ok=True)
    so = os.path.join(cb.BUILD_DIR, f"libstructured_{tag}-{digest}.so")
    if not os.path.exists(so):
        out = subprocess.run(
            [cb._nvcc(), *cb.NVCC_FLAGS, "-I", cb.CSRC, "-o", so, path],
            capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed on {path}:\n{out.stdout}"
                               f"{out.stderr}")
        for line in (out.stdout + out.stderr).splitlines():
            if "registers" in line or "spill" in line:
                print(f"{tag}: {line.strip()}", flush=True)
    return ctypes.CDLL(so)


def build_baseline(path: str):
    """The launcher of a revision whose ``structured_sweep_launch`` takes
    the 3D kernel (the design before the brick layout)."""
    fn = build_other(path, "baseline").structured_sweep_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 9 + [ci] * 10 + [cf] * 5 + [vp]
    fn.restype = ci
    return fn


def build_variant(path: str):
    """The ``structured3d_launch`` of a revision with the brick layout."""
    fn = build_other(path, "variant").structured3d_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 10 + [ci] * 8 + [cf] * 5 + [ci] * 3 + [vp]
    fn.restype = ci
    return fn


def variant_launch(fn, tables, sc, u, ul, vo, flavor, cdt, cw):
    """The variant's 3D kernel under ``brick_plan``, folded."""
    import torch

    from ns_gls_tpu_torch.ops import structured as st

    P = tables.P
    nx, ny, nz = tables.cell_shape
    plan = st.brick_plan(P, tables.cell_shape)
    shp = st.lattice_shape(P, tables.cell_shape)
    tiles = torch.empty((4, shp[0], ny, P + 1, shp[2]), dtype=torch.float32,
                        device=u.device)
    seams = torch.empty((4, shp[0], ny, P + 1, plan.nbx),
                        dtype=torch.float32, device=u.device)
    err = fn(*(t.data_ptr() for t in (u, ul, vo, tables.jinv, tables.jxw,
                                      tables.h, tables.S1, tables.D1, tiles,
                                      seams)),
             P, tables.NQ, nx, ny, nz, st.FLAVORS.index(flavor), int(cdt),
             int(cw), *(sc[k] for k in ("weight", "stau", "nu", "c1", "c2")),
             plan.xb, plan.zs, plan.nzb,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"variant launch failed: CUDA error {err}")
    return tiles, seams, plan.xb


def baseline_launch(fn, tables, sc, u, ul, vo, flavor, cdt, cw):
    """The baseline's 3D kernel; returns its cell-row tiles."""
    import torch

    from ns_gls_tpu_torch.ops.structured import FLAVORS

    P = tables.P
    nx, ny, nz = tables.cell_shape
    out = torch.empty((4, nz, ny, P + 1, P + 1, P * nx + 1),
                      dtype=torch.float32, device=u.device)
    err = fn(u.data_ptr(), ul.data_ptr(), vo.data_ptr(),
             tables.jinv.data_ptr(), tables.jxw.data_ptr(),
             tables.h.data_ptr(), tables.S1.data_ptr(), tables.D1.data_ptr(),
             out.data_ptr(), 3, P, tables.NQ, nx, ny, nz,
             FLAVORS.index(flavor), int(cdt), int(cw), 0,
             *(sc[k] for k in ("weight", "stau", "nu", "c1", "c2")),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline launch failed: CUDA error {err}")
    return out


def rel_err(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


def sweep_plans(tables):
    """Brick plans other than the default that the kernel may take."""
    from ns_gls_tpu_torch.ops.structured import BrickPlan

    nx, ny, nz = tables.cell_shape
    for xb in (4, 8, 16):
        for zs in (1, 2, 3, 4):
            for nzb in (1, 2, 4, 8):
                if xb > nx or zs > nz or nzb > nz:
                    continue
                zc = -(-nz // nzb)
                yield BrickPlan(xb, -(-nx // xb), zs, zc, -(-nz // zc))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="structured_levels.py")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("structured_levels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import bench_gpu
    from ns_gls_tpu_torch.config import Parameters, _load_json
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.ops import structured as st
    from ns_gls_tpu_torch.utils import cuda_build
    from ns_gls_tpu_torch.utils.logging import set_verbose
    from ns_gls_tpu_torch.utils.roofline import bound, structured_cost
    from ns_gls_tpu_torch.utils.timer import device_time_us, time_cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cuda_build.build_libraries(["structured"])
    for line in cuda_build.build_info["structured"]["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"structured: {line.strip()}", flush=True)
    base = build_baseline(args.baseline) if args.baseline else None
    var = build_variant(args.variant) if args.variant else None

    raw = _load_json(os.path.join(ROOT, "input", "channel.json"))
    raw.update(CHANNEL3D)
    raw.update({"paraview prefix": "", "output granularity": 0.0})
    set_verbose(False)
    drv = Driver(Parameters.from_dict(raw), device="cuda")
    drv.setup()
    shapes = [(f"channel level {lvl}", op._fast.tables)
              for lvl, op in enumerate(drv.mg_ops)]
    lane_op, _, _ = bench_gpu.build(3, 5, 2, increment=True)
    shapes.append(("gls-vmult 3 5 2", lane_op._fast.tables))

    for label, tables in shapes:
        rng = np.random.default_rng(1)
        shp = st.lattice_shape(tables.P, tables.cell_shape)

        def lattice(lead):
            return torch.as_tensor(rng.standard_normal((lead,) + shp),
                                   dtype=torch.float32, device="cuda")

        u, ul, vo = lattice(4), lattice(4), lattice(3)
        case = (tables, SC, u, ul, vo, "increment", True, True)
        plan = st.brick_plan(tables.P, tables.cell_shape)
        ref = st.structured_sweep_plain(*case)
        a = st.structured_sweep(*case)
        b = st.structured_sweep(*case)
        torch.cuda.synchronize()
        rec = dict(card=card, shape=label, cells=tables.cell_shape,
                   P=tables.P, plan=plan._asdict(),
                   max_rel_err=rel_err(a, ref),
                   bit_identical=bool(torch.equal(a, b)),
                   **st.StructuredKernel.attributes(tables.P, plan,
                                                    "increment", True))
        if not (rec["max_rel_err"] <= REL_TOL and rec["bit_identical"]):
            print(json.dumps(rec), flush=True)
            raise AssertionError(f"{label}: kernel disagrees with the plain "
                                 "version or with itself")

        def kernel():
            return st.StructuredKernel.launch(*case)

        rec["us"] = 1e3 * time_cuda(kernel, args.reps, warmup=5)
        rec["device_us"] = device_time_us(kernel, "structured3d_kernel")
        rec["batched_device_us"] = device_time_us(
            lambda: st.StructuredKernel.launch(*case, batched=True),
            "structured3d_batched_kernel")
        nbytes, flops = structured_cost(tables, "increment", True, True)
        bms, by = bound(nbytes, flops)
        rec.update(bound_us=1e3 * bms, bound_by=by)
        if base is not None:
            c = st.fold_tiles(tables, baseline_launch(base, *case))
            rec["baseline_max_rel_err"] = rel_err(c, ref)
            rec["baseline_us"] = 1e3 * time_cuda(
                lambda: baseline_launch(base, *case), args.reps, warmup=5)
            rec["baseline_device_us"] = device_time_us(
                lambda: baseline_launch(base, *case), "structured3d_kernel")
            rec["device_us_again"] = device_time_us(kernel,
                                                    "structured3d_kernel")
        if var is not None:
            c = st.fold_bricks(tables, *variant_launch(var, *case))
            rec["variant_max_rel_err"] = rel_err(c, ref)
            rec["variant_device_us"] = device_time_us(
                lambda: variant_launch(var, *case), "structured3d_kernel")
            rec["device_us_again2"] = device_time_us(kernel,
                                                     "structured3d_kernel")
        if args.sweep:
            rec["sweep"] = {}
            for p in sweep_plans(tables):
                key = f"xb{p.xb}_zs{p.zs}_nzb{p.nzb}"
                if key in rec["sweep"]:
                    continue
                try:
                    out = st.StructuredKernel.launch(*case, plan=p)
                    err = rel_err(st.fold_bricks(tables, *out, p.xb), ref)
                    if err > REL_TOL:
                        raise RuntimeError(f"max rel err {err:.3e}")
                    rec["sweep"][key] = device_time_us(
                        lambda: st.StructuredKernel.launch(*case, plan=p),
                        "structured3d_kernel", n=20)
                except RuntimeError as e:
                    rec["sweep"][key] = str(e)[:80]
        print(json.dumps(rec), flush=True)
        del u, ul, vo, ref, a, b
    return 0


if __name__ == "__main__":
    sys.exit(main())
