#!/usr/bin/env python3
"""Time the patch-2D sweep on every level of the Turek 2D configurations.

    python3 tools/patch2d_levels.py [--baseline FILE.cu] [--baseline-only]
                                    [--sweep] [--reps N] [--no-fine]

Builds f32 patch-2D operators on the Turek 2D cylinder mesh
(``SimulationCylinder(2)``) of ``input/turek_2d_re100.json``'s chain, Q2
at refinements 0-3 (m = 1, 2, 4, 8), and, unless ``--no-fine``, Q1 at
refinement 4 (``input/turek_2d_re20.json``, m = 16) and Q2 at refinements
4 and 5 (m = 16, 32); at each, in the Turek path's own flavor (increment,
q-wise delta, the BDF history; scalars of ``chip_smoke.py``'s phase 3;
random node-major vectors from ``numpy.random.default_rng(1)``):

- holds ``csrc/patch2d.cu`` to the plain version (max relative error,
  tol 1e-5) and relaunches it for bit-identity,
- times the kernel by CUDA events (``us``: launches back to back, which
  on these small shapes mostly measures how fast the host launches) and
  by the profiler's device time (``device_us``), beside the sweep's bound
  (``utils/roofline.py`` ``patch2d_cost``), and the whole sweep (kernel
  and seam sums, ``csrc/seam_sum.cu``): ``sweep_us`` by events,
  ``sweep_device_us`` the device time of all its kernels and
  ``sweep_launches`` the kernels one apply launches, by the profiler,
- with ``--baseline FILE.cu``: builds FILE (a revision of
  ``csrc/patch2d.cu`` that takes gathered node tiles and writes patch
  tiles, one block per patch, e.g. ``git show
  <commit>:ns_gls_tpu_torch/csrc/patch2d.cu > scratch/old.cu``; ``build/``
  is not copied to the card), holds it to the plain version and times it
  on the same inputs in the same process: the kernel alone, and its sweep
  as that revision ran it (the gather of u into tiles, the kernel, the
  class sums of ``utils/segment.py``); a shape it refuses is recorded as
  such; ``--baseline-only`` times FILE alone (before another revision of
  the kernel is built),
- with ``--sweep``: also times the kernel under other plans (brick, slab
  depth, y chunks) than ``ops/patch2d.py`` ``patch2d_plan``'s.

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
# chip_smoke.py phase 3's scalars
SC = dict(weight=187.5, stau=100.0, nu=0.001, c1=0.2, c2=0.3)
# (label, degree, refinement) of every level timed
LEVELS = [(f"turek 2D ref {r} Q2", 2, r) for r in range(4)]
FINE = [("turek_2d_re20 ref 4 Q1", 1, 4), ("turek 2D ref 4 Q2", 2, 4),
        ("turek 2D ref 5 Q2", 2, 5)]


def build_baseline(path: str):
    """ctypes function of the launcher in ``path``, built like the port's
    own kernels (same flags, the port's headers)."""
    from ns_gls_tpu_torch.utils import cuda_build as cb

    with open(path, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    os.makedirs(cb.BUILD_DIR, exist_ok=True)
    so = os.path.join(cb.BUILD_DIR, f"libpatch2d_baseline-{digest}.so")
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
    fn = ctypes.CDLL(so).patch2d_sweep_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 9 + [ci] * 7 + [cf] * 5 + [vp]
    fn.restype = ci
    return fn


class Baseline:
    """The previous revision's sweep on this level: node tiles (lead, n_p,
    Yn, Xn) gathered from the node-major vectors, the kernel's patch tiles
    (3, n_p, Yn, Xn), class sums back to the nodes."""

    def __init__(self, fn, tables):
        from ns_gls_tpu_torch.utils.segment import class_gather

        self.fn, self.tables = fn, tables
        self.pn = tables.patch_nodes.long()
        self.compress = class_gather(
            tables.patch_nodes.cpu().numpy().reshape(-1), tables.n_nodes,
            tables.jinv.device)

    def gather(self, v, lead):
        return v[:, :lead].T[:, self.pn]

    def kernel(self, sc, uP, ulP, voP, flavor, cdt, cw):
        import torch

        from ns_gls_tpu_torch.ops.patch2d import FLAVORS

        t = self.tables
        Xn = t.P * t.m + 1
        out = torch.empty((3, t.jinv.shape[0], Xn, Xn), dtype=torch.float32,
                          device=uP.device)
        err = self.fn(
            uP.data_ptr(), ulP.data_ptr(), voP.data_ptr(),
            t.jinv.data_ptr(), t.jxw.data_ptr(), t.h.data_ptr(),
            t.S1.data_ptr(), t.D1.data_ptr(), out.data_ptr(),
            t.jinv.shape[0], t.P, t.NQ, t.m, FLAVORS.index(flavor), int(cdt),
            int(cw), *(sc[k] for k in ("weight", "stau", "nu", "c1", "c2")),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline launch failed: CUDA error {err}")
        return out

    def sweep(self, sc, u, ulP, voP, flavor, cdt, cw):
        from ns_gls_tpu_torch.utils.segment import class_sum

        out = self.kernel(sc, self.gather(u, 3), ulP, voP, flavor, cdt, cw)
        return class_sum(self.compress, out.reshape(3, -1).T)


def rel_err(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


def level_tables(degree, refinement, device="cuda"):
    """The patch-2D tables of an f32 BDF-2 operator on the Turek 2D mesh
    refined ``refinement`` times, degree ``degree``, on ``device``."""
    import torch

    from ns_gls_tpu_torch.fem.constraints import AffineConstraints
    from ns_gls_tpu_torch.fem.space import FESpace
    from ns_gls_tpu_torch.models.cylinder import SimulationCylinder
    from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator
    from ns_gls_tpu_torch.ops.time_integration import BDFIntegrator

    space = FESpace(SimulationCylinder(2).create_mesh(refinement), degree)
    ca = AffineConstraints(space.n_nodes, 3).close(torch.float32, device)
    ti = BDFIntegrator(2)
    ti.update_dt(0.01)
    ti.update_dt(0.008)
    op = NavierStokesOperator(space, ca, ca, nu=0.001, c_1=0.2, c_2=0.0,
                              time_integrator=ti, dtype=torch.float32,
                              device=device)
    return op._fast.tables


def other_plans(tables):
    """Plans of other bricks, slab depths and y chunkings that the
    launcher takes, for ``--sweep``."""
    from ns_gls_tpu_torch.ops import patch2d as p2

    P, m = tables.P, tables.m
    out = []
    for xb in (d for d in range(m, 0, -1) if m % d == 0):
        for nyb in sorted({1, 2, 4, 8, m} & set(range(1, m + 1))):
            yc = -(-m // nyb)
            for ys in sorted({1, 2, 3, 4, 6, 8, 16} & set(range(1, yc + 1))):
                if not p2._plan_ok(P, xb, ys):
                    continue
                if p2.smem_bytes(P, xb, ys, yc, "increment",
                                 True) > p2.SMEM_PER_BLOCK:
                    continue
                plan = p2.Patch2DPlan(xb, m // xb, ys, yc, -(-m // yc))
                if plan != tables.plan:
                    out.append(plan)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="patch2d_levels.py")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--baseline-only", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--no-fine", action="store_true",
                    help="leave out the refinement 4 and 5 levels")
    args = ap.parse_args(argv)
    if args.baseline_only and not args.baseline:
        ap.error("--baseline-only needs --baseline")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("patch2d_levels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from ns_gls_tpu_torch.ops import patch2d as p2
    from ns_gls_tpu_torch.utils import cuda_build
    from ns_gls_tpu_torch.utils import segment as sg
    from ns_gls_tpu_torch.utils.roofline import bound, patch2d_cost
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
    if not args.baseline_only:
        cuda_build.build_libraries(["patch2d", "seam_sum"])
        for name in ("patch2d", "seam_sum"):
            for line in cuda_build.build_info[name]["log"].splitlines():
                if "registers" in line or "spill" in line:
                    print(f"{name}: {line.strip()}", flush=True)
    base_fn = build_baseline(args.baseline) if args.baseline else None

    flavor, cdt, cw = "increment", True, False
    for label, degree, refinement in LEVELS + ([] if args.no_fine else FINE):
        ft = level_tables(degree, refinement)
        (tables,) = ft.fams
        n_p = tables.jinv.shape[0]
        rng = np.random.default_rng(1)
        u, ul, vo = (torch.as_tensor(rng.standard_normal((tables.n_nodes, 3)),
                                     dtype=torch.float32, device="cuda")
                     for _ in range(3))
        case = (tables, SC, u, ul, vo, flavor, cdt, cw)
        ref = p2.patch2d_sweep_plain(*case)
        nodes_ref = sg.seam_sum_plain(ft.seams, ref.reshape(-1, 3))
        nbytes, flops = patch2d_cost(ft, flavor, cdt, cw)
        bms, by = bound(nbytes, flops)
        rec = dict(card=card, level=label, P=tables.P, m=tables.m, n_p=n_p,
                   n_nodes=tables.n_nodes, cells=n_p * tables.m ** 2,
                   bound_us=1e3 * bms, bound_by=by, bound_bytes=nbytes)

        def kernel():
            return p2.Patch2DKernel.launch(*case)

        def sweep():
            return sg.seam_sum(ft.seams, kernel().reshape(-1, 3))

        if not args.baseline_only:
            a, b = kernel(), kernel()
            torch.cuda.synchronize()
            rec.update(plan=list(tables.plan), max_rel_err=rel_err(a, ref),
                       bit_identical=bool(torch.equal(a, b)),
                       **p2.Patch2DKernel.attributes(tables.P, tables.plan,
                                                     flavor, cdt))
            if not (rec["max_rel_err"] <= REL_TOL and rec["bit_identical"]):
                print(json.dumps(rec), flush=True)
                raise AssertionError(f"{label}: kernel disagrees with the "
                                     "plain version or with itself")
            rec["sweep_max_rel_err"] = rel_err(sweep(), nodes_ref)
            rec["us"] = 1e3 * time_cuda(kernel, args.reps, warmup=5)
            rec["device_us"] = device_time_us(kernel, "patch2d_kernel")
            rec["sweep_us"] = 1e3 * time_cuda(sweep, args.reps, warmup=5)
            rec["sweep_device_us"], rec["sweep_launches"] = \
                device_kernels_us(sweep)
            rec["seam_device_us"] = device_time_us(sweep, "seam_sum_kernel")
            del a, b
        if base_fn is not None:
            base = Baseline(base_fn, tables)
            uP, ulP, voP = base.gather(u, 3), base.gather(ul, 3), \
                base.gather(vo, 2)

            def old_kernel():
                return base.kernel(SC, uP, ulP, voP, flavor, cdt, cw)

            def old_sweep():
                return base.sweep(SC, u, ulP, voP, flavor, cdt, cw)

            try:
                old = old_sweep()
            except RuntimeError as e:
                rec["baseline"] = f"refused: {e}"
            else:
                rec["baseline_sweep_max_rel_err"] = rel_err(old, nodes_ref)
                if not rec["baseline_sweep_max_rel_err"] <= REL_TOL:
                    print(json.dumps(rec), flush=True)
                    raise AssertionError(f"{label}: the baseline disagrees "
                                         "with the plain version")
                rec["baseline_us"] = 1e3 * time_cuda(old_kernel, args.reps,
                                                     warmup=5)
                rec["baseline_device_us"] = device_time_us(old_kernel,
                                                           "patch2d_kernel")
                rec["baseline_sweep_us"] = 1e3 * time_cuda(
                    old_sweep, args.reps, warmup=5)
                (rec["baseline_sweep_device_us"],
                 rec["baseline_sweep_launches"]) = device_kernels_us(old_sweep)
                if not args.baseline_only:
                    rec["device_us_again"] = device_time_us(kernel,
                                                            "patch2d_kernel")
            del uP, ulP, voP
        if args.sweep and not args.baseline_only:
            rec["sweep"] = {}
            for alt in other_plans(tables):
                # the kernel alone: its tiles' layout follows alt's brick
                alt_case = (tables._replace(plan=alt),) + case[1:]
                try:
                    t = device_time_us(
                        lambda: p2.Patch2DKernel.launch(*alt_case),
                        "patch2d_kernel", n=20)
                except RuntimeError as e:
                    t = str(e)
                rec["sweep"][f"xb{alt.xb}_ys{alt.ys}_nyb{alt.nyb}"] = t
        print(json.dumps(rec), flush=True)
        del u, ul, vo, ref, nodes_ref, tables, ft
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
