#!/usr/bin/env python3
"""Time the structured kernels on every channel level and the gls-vmult
lane's shape: the 3D kernel (default) or, with ``--dim 2``, the 2D one.

    python3 tools/structured_levels.py [--dim 3] [--baseline FILE.cu]
                                       [--variant FILE.cu] [--sweep]
                                       [--reps N]
    python3 tools/structured_levels.py --dim 2 [--baseline FILE.cu]
                                       [--variant FILE.cu] [--sweep]
                                       [--reps N]

3D: sets up the port's channel 3D driver on the card
(``input/channel.json`` with dim 3, degree 2, refinement 3: six GMG levels
from 4 x 1 x 1 to 128 x 32 x 32 cells of Q2, every one on
``structured3d``) and builds the operator of ``bench_gpu.py 3 5 2`` (32^3
cells).  At each of those shapes, in the timing case of ``chip_smoke.py``
phase 9 (increment flavor, BDF history, cell-wise delta, random lattices
from ``numpy.random.default_rng(1)``):

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

2D (``--dim 2``): the same for ``structured2d`` on the channel 2D driver
(dim 2, degree 2, refinement 6: nine levels from 4 x 1 to 1024 x 256 cells
of Q2) and the operator of ``bench_gpu.py 2 9 2`` (512 x 512 cells), in
the timing case of phase 11: the kernel alone (``us``, ``device_us``), the
sweep (kernel and the x-seam add of ``fold_seams_2d``: ``sweep_us`` by
events, ``sweep_device_us`` the device time of all its kernels), the
plan (``slab_plan_2d``) and the bound.  ``--baseline FILE.cu`` takes a
revision whose ``structured_sweep_launch`` runs the 2D kernel with
cell-row tiles (the x-only design, before ``structured2d_launch``): its
kernel and its sweep (kernel and ``fold_classes``) on the same inputs,
and then holds this revision's batched 3D kernel to FILE's bit for bit on
the state of the lane ``bench_gpu.py 3 5 2 --increment --batched`` in
every flavor x delta mode x consider_dt.  ``--variant FILE.cu``: another
revision's ``structured2d_launch`` under this ``slab_plan_2d`` (and under
the ``--sweep`` plans).  ``--sweep`` times other slab
plans (bricks of 8-48 cells, slabs of 1-4 rows, 1-24 y chunks; by CUDA
events) at the levels of 256 x 64 cells and up.

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
CHANNEL2D = {"dim": 2, "fe degree": 2, "n global refinements": 6}


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
    the 2D or 3D kernel (the designs before the brick and slab layouts)
    and the batched one."""
    fn = build_other(path, "baseline").structured_sweep_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 9 + [ci] * 10 + [cf] * 5 + [vp]
    fn.restype = ci
    return fn


def build_variant(path: str, dim: int = 3):
    """The ``structured3d_launch`` of a revision with the brick layout, or
    (``dim`` 2) the ``structured2d_launch`` of one with the slab layout."""
    lib = build_other(path, f"variant{dim}d")
    fn = lib.structured3d_launch if dim == 3 else lib.structured2d_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 10 + [ci] * (8 if dim == 3 else 7) + [cf] * 5 + [
        ci] * 3 + [vp]
    fn.restype = ci
    return fn


def variant2d_launch(fn, plan, tables, sc, u, ul, vo, flavor, cdt, cw):
    """The variant's 2D kernel under ``plan``, folded."""
    import torch

    from ns_gls_tpu_torch.ops import structured as st

    P = tables.P
    nx, ny = tables.cell_shape
    shp = st.lattice_shape(P, tables.cell_shape)
    lat = torch.empty((3,) + shp, dtype=torch.float32, device=u.device)
    seams = torch.empty((3, shp[0], plan.nbx), dtype=torch.float32,
                        device=u.device)
    err = fn(*(t.data_ptr() for t in (u, ul, vo, tables.jinv, tables.jxw,
                                      tables.h, tables.S1, tables.D1, lat,
                                      seams)),
             P, tables.NQ, nx, ny, st.FLAVORS.index(flavor), int(cdt),
             int(cw), *(sc[k] for k in ("weight", "stau", "nu", "c1", "c2")),
             plan.xb, plan.ys, plan.nyb,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"variant launch failed: CUDA error {err}")
    return st.fold_seams_2d(tables, lat, seams, plan.xb)


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


def baseline_launch(fn, tables, sc, u, ul, vo, flavor, cdt, cw,
                    batched=False):
    """The baseline's 2D or 3D kernel (``batched``: its batched 3D
    kernel); returns its cell-row tiles."""
    import torch

    from ns_gls_tpu_torch.ops.structured import FLAVORS

    d, P = tables.d, tables.P
    nx, ny = tables.cell_shape[:2]
    nz = tables.cell_shape[2] if d == 3 else 1
    rows = (nz, ny) if d == 3 else (ny,)
    out = torch.empty((d + 1,) + rows + (P + 1,) * (d - 1) + (P * nx + 1,),
                      dtype=torch.float32, device=u.device)
    err = fn(u.data_ptr(), ul.data_ptr(), vo.data_ptr(),
             tables.jinv.data_ptr(), tables.jxw.data_ptr(),
             tables.h.data_ptr(), tables.S1.data_ptr(), tables.D1.data_ptr(),
             out.data_ptr(), d, P, tables.NQ, nx, ny, nz,
             FLAVORS.index(flavor), int(cdt), int(cw), int(batched),
             *(sc[k] for k in ("weight", "stau", "nu", "c1", "c2")),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline launch failed: CUDA error {err}")
    return out


def fold_baseline(tables, tiles):
    """The baseline's cell-row tiles -> ``(C,) + lattice_shape``."""
    from ns_gls_tpu_torch.ops import structured as st

    if tables.d == 3:
        return st.fold_tiles(tables, tiles)
    return st.fold_classes(tiles, 1, 2, tables.P).unsqueeze(2)


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


def sweep_plans_2d(tables):
    """Slab plans other than the default that the 2D kernel may take."""
    from ns_gls_tpu_torch.ops.structured import SlabPlan2D

    nx, ny = tables.cell_shape
    cpw = max(1, 32 // (tables.P + 1) ** 2)
    for xb in (8, 12, 16, 24, 32, 48):
        for ys in (1, 2, 3, 4, 6, 8):
            if xb > nx or ys > ny or -(-xb * ys // cpw) > 32:
                continue
            nbx = -(-nx // xb)
            for nyb in (1, 2, 3, 4, 6, 8, 12, 16, 24):
                if nyb > ny or nbx * nyb > 800:
                    continue
                yc = -(-ny // nyb)
                yield SlabPlan2D(xb, nbx, ys, yc, -(-ny // yc))


def all_kernels_device_us(fn, n=50):
    """Device time in microseconds per call of ``fn`` of all the CUDA
    kernels it launches, under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / n


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def lattices(tables, seed=1):
    """Random u, u_lin, vec_old lattices on the card for ``tables``."""
    import numpy as np
    import torch

    from ns_gls_tpu_torch.ops.structured import lattice_shape

    rng = np.random.default_rng(seed)
    shp = lattice_shape(tables.P, tables.cell_shape)

    def lattice(lead):
        return torch.as_tensor(rng.standard_normal((lead,) + shp),
                               dtype=torch.float32, device="cuda")

    return lattice(tables.d + 1), lattice(tables.d + 1), lattice(tables.d)


def main2d(args, card, base, var) -> int:
    import torch

    import bench_gpu
    from ns_gls_tpu_torch.config import Parameters, _load_json
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.ops import structured as st
    from ns_gls_tpu_torch.utils.logging import set_verbose
    from ns_gls_tpu_torch.utils.roofline import bound, structured_cost
    from ns_gls_tpu_torch.utils.timer import device_time_us, time_cuda

    raw = _load_json(os.path.join(ROOT, "input", "channel.json"))
    raw.update(CHANNEL2D)
    raw.update({"paraview prefix": "", "output granularity": 0.0})
    set_verbose(False)
    drv = Driver(Parameters.from_dict(raw), device="cuda")
    drv.setup()
    shapes = [(f"channel 2D level {lvl}", op._fast.tables)
              for lvl, op in enumerate(drv.mg_ops)]
    lane_op, _, _ = bench_gpu.build(2, 9, 2, increment=True)
    shapes.append(("gls-vmult 2 9 2", lane_op._fast.tables))
    name = "structured2d_kernel"

    for label, tables in shapes:
        u, ul, vo = lattices(tables)
        case = (tables, SC, u, ul, vo, "increment", True, True)
        plan = st.slab_plan_2d(tables.P, tables.cell_shape)
        ref = st.structured_sweep_plain(*case)
        a = st.structured_sweep(*case)
        b = st.structured_sweep(*case)
        torch.cuda.synchronize()
        attrs = st.StructuredKernel.attributes(tables.P, plan, "increment",
                                               True)
        rec = dict(card=card, shape=label, cells=tables.cell_shape,
                   P=tables.P, plan=plan._asdict(),
                   max_rel_err=rel_err(a, ref),
                   bit_identical=bool(torch.equal(a, b)), **attrs)
        host_smem = st.slab_smem_2d(tables.P, plan.xb, plan.ys, "increment",
                                    True)
        if not (rec["max_rel_err"] <= REL_TOL and rec["bit_identical"]
                and attrs["dynamic_smem"] == host_smem):
            print(json.dumps(rec), flush=True)
            raise AssertionError(f"{label}: kernel disagrees with the plain "
                                 "version, with itself or with the host's "
                                 f"shared-memory formula ({host_smem} B)")

        def kernel():
            return st.StructuredKernel.launch(*case)

        def sweep():
            return st.structured_sweep(*case)

        rec["us"] = 1e3 * time_cuda(kernel, args.reps, warmup=5)
        rec["device_us"] = device_time_us(kernel, name)
        rec["sweep_us"] = 1e3 * time_cuda(sweep, args.reps, warmup=5)
        rec["sweep_device_us"] = all_kernels_device_us(sweep)
        nbytes, flops = structured_cost(tables, "increment", True, True)
        bms, by = bound(nbytes, flops)
        rec.update(bound_us=1e3 * bms, bound_by=by)
        if base is not None:
            def old_kernel():
                return baseline_launch(base, *case)

            def old_sweep():
                return fold_baseline(tables, old_kernel())

            rec["baseline_max_rel_err"] = rel_err(old_sweep(), ref)
            rec["baseline_us"] = 1e3 * time_cuda(old_kernel, args.reps,
                                                 warmup=5)
            rec["baseline_device_us"] = device_time_us(old_kernel, name)
            rec["baseline_sweep_us"] = 1e3 * time_cuda(old_sweep, args.reps,
                                                       warmup=5)
            rec["baseline_sweep_device_us"] = all_kernels_device_us(
                old_sweep)
            rec["device_us_again"] = device_time_us(kernel, name)
        if var is not None:
            rec["variant_max_rel_err"] = rel_err(
                variant2d_launch(var, plan, *case), ref)
            rec["variant_device_us"] = device_time_us(
                lambda: variant2d_launch(var, plan, *case), name)
            rec["device_us_again2"] = device_time_us(kernel, name)
        if args.sweep and tables.cell_shape[0] * tables.cell_shape[1] >= 16384:
            # by events: at these levels a launch's device time is far
            # above the host's launch path
            rec["sweep"] = {}
            for p in sweep_plans_2d(tables):
                key = f"xb{p.xb}_ys{p.ys}_nyb{p.nyb}"
                if key in rec["sweep"]:
                    continue
                try:
                    out = st.StructuredKernel.launch(*case, plan=p)
                    err = rel_err(st.fold_seams_2d(tables, *out, p.xb), ref)
                    if err > REL_TOL:
                        raise RuntimeError(f"max rel err {err:.3e}")
                    rec["sweep"][key] = 1e3 * time_cuda(
                        lambda: st.StructuredKernel.launch(*case, plan=p),
                        30, warmup=3)
                except RuntimeError as e:
                    rec["sweep"][key] = str(e)[:80]
                if var is None:
                    continue
                rec.setdefault("variant_sweep", {})
                try:
                    err = rel_err(variant2d_launch(var, p, *case), ref)
                    if err > REL_TOL:
                        raise RuntimeError(f"max rel err {err:.3e}")
                    rec["variant_sweep"][key] = 1e3 * time_cuda(
                        lambda: variant2d_launch(var, p, *case), 30,
                        warmup=3)
                except RuntimeError as e:
                    rec["variant_sweep"][key] = str(e)[:80]
        print(json.dumps(rec), flush=True)
        del u, ul, vo, ref, a, b
    del drv, lane_op
    torch.cuda.empty_cache()

    if base is not None:
        # the batched 3D kernel against the baseline's, bit for bit, on the
        # lane's state
        op, _, u = bench_gpu.build(3, 5, 2, increment=True, batched=True)
        own = bench_gpu.sweep_args(op, u / torch.linalg.vector_norm(u))
        rec = dict(card=card, shape="gls-vmult 3 5 2 --increment --batched",
                   cases={})
        for flavor in st.FLAVORS:
            for cw in (True, False):
                for cdt in (True, False):
                    case = own[:5] + (flavor, cdt, cw)
                    new = st.StructuredKernel.launch(*case, batched=True)
                    old = baseline_launch(base, *case, batched=True)
                    torch.cuda.synchronize()
                    rec["cases"][f"{flavor}_cw{int(cw)}_cdt{int(cdt)}"] = (
                        bool(torch.equal(new, old)))
        rec["bit_identical"] = all(rec["cases"].values())
        print(json.dumps(rec), flush=True)
        if not rec["bit_identical"]:
            raise AssertionError("the batched kernel's bits differ from the "
                                 "baseline's")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="structured_levels.py")
    ap.add_argument("--dim", type=int, choices=(2, 3), default=3)
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)

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

    card = card_line()
    print(card, flush=True)
    cuda_build.build_libraries(["structured"])
    for line in cuda_build.build_info["structured"]["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"structured: {line.strip()}", flush=True)
    base = build_baseline(args.baseline) if args.baseline else None
    var = build_variant(args.variant, args.dim) if args.variant else None
    if args.dim == 2:
        return main2d(args, card, base, var)

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
        u, ul, vo = lattices(tables)
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
            c = fold_baseline(tables, baseline_launch(base, *case))
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
