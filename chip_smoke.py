#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: require CUDA; print the card's name and power limit,
2. build: compile the CUDA kernels from ``ns_gls_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together),
3. patch-2D kernel vs plain: the patch-2D kernel against its plain
   PyTorch version on the card, on the Turek 2D ref-3 space (m = 8) and
   every GMG level space (m = 1, 2, 4), in every flavor x delta mode x
   consider_dt,
4. 2D main path: ``input/turek_2d_re100.json`` as given (refinement 3,
   f64 outer solve, f32 GMG levels, direct coarse solve) for 5 time steps
   through ``Driver.run``, output off; every Newton solve converges, the
   functionals are finite and the patch-2D kernel was launched,
5. 2D stored series: the corridor parameters (refinement 2, c1 = 2.0,
   c2 = 1.0, no coarse iteration) for 8 steps against the JAX package's
   CPU-f64 series ``validation/turek_2d_re100_ref2_q2_series.json``,
6. prism kernel vs plain: the Turek 3D driver is set up (its level
   spaces are built once and reused by phase 7); the prism kernel against
   its plain version on every level space (m = 1, 2, 4, 8) in every
   flavor x delta mode x consider_dt, two launches bit-identical,
7. 3D main path: ``input/turek_3d_re100.json`` as given (refinement 3,
   f64 outer, f32 prism GMG levels, AMG coarse iterated by GMRES) for 3
   steps through ``Driver.run``, output off; every Newton solve
   converges, the functionals are finite and the prism kernel was
   launched,
8. 3D stored series: refinement 1, 4 steps, against the JAX package's
   CPU series ``validation/turek_3d_re100_ref1_series.json``,
9. the kernel line (JSON) with launches, errors, times and bounds,
10. the result line (JSON).

Imports nothing of the JAX package; needs the repository around it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# card peaks for the bound (H100 SXM data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# phases 3 and 6: kernel vs plain version, relative to the plain max-abs
# (f32 with another summation order)
KERNEL_REL_TOL = 1e-5
# phase 5: the port's gap to the stored series measured on a CPU
# (f64 outer, f32 levels on the plain patch-2D sweep): 1.29e-7 of
# max(|ref|, 1) over these 8 steps; the card is held to 10x that
SERIES_CPU_GAP = 1.29e-7
SERIES_TOL = 10 * SERIES_CPU_GAP          # below the 1e-4 ceiling
MAIN_STEPS = 5
SERIES_STEPS = 8
# phase 8: the port's gap to the stored 3D series on a CPU (f64 outer,
# f32 levels on the plain prism sweep, AMG coarse): 8.70e-6 of
# max(|ref|, 1) over these 4 steps (the step-4 drag; Newton 0, 8, 4, 4
# and GMRES 0, 137, 16, 17); the card is held to 10x that, at most 1e-4
SERIES3D_CPU_GAP = 8.70e-6
SERIES3D_TOL = min(10 * SERIES3D_CPU_GAP, 1e-4)
MAIN3D_STEPS = 3
SERIES3D_STEPS = 4


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def config(overrides: dict, name: str = "turek_2d_re100.json"):
    from ns_gls_tpu_torch.config import Parameters, _load_json

    raw = _load_json(os.path.join(ROOT, "input", name))
    raw.update({"paraview prefix": "", "output granularity": 0.0})
    raw.update(overrides)
    return Parameters.from_dict(raw)


def kernel_counts() -> dict:
    """The launch counts of every kernel wrapper, by kernel name."""
    from ns_gls_tpu_torch.ops.patch2d import Patch2DKernel
    from ns_gls_tpu_torch.ops.prism import PrismKernel

    return {"patch2d_gls_sweep": Patch2DKernel.launches,
            "prism_gls_sweep": PrismKernel.launches}


def reset_kernel_counts():
    from ns_gls_tpu_torch.ops.patch2d import Patch2DKernel
    from ns_gls_tpu_torch.ops.prism import PrismKernel

    Patch2DKernel.launches = 0
    PrismKernel.launches = 0


# ---------------------------------------------------------------------------
# phase 3: patch-2D kernel against plain version
# ---------------------------------------------------------------------------
def level_operators(device):
    """f32 patch-2D operators on the Turek ref-3 chain (m = 1, 2, 4, 8)."""
    import torch

    from ns_gls_tpu_torch.fem.constraints import AffineConstraints
    from ns_gls_tpu_torch.fem.space import FESpace
    from ns_gls_tpu_torch.models.cylinder import SimulationCylinder
    from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator
    from ns_gls_tpu_torch.ops.time_integration import BDFIntegrator

    sim = SimulationCylinder(2)
    mesh = sim.create_mesh(3)
    meshes = [mesh]
    while meshes[0].prev is not None:
        meshes.insert(0, meshes[0].prev)
    ti = BDFIntegrator(2)
    ti.update_dt(0.01)
    ti.update_dt(0.008)
    ops = []
    for m in meshes:
        space = FESpace(m, 2)
        ca = AffineConstraints(space.n_nodes, 3).close(torch.float32, device)
        ops.append(NavierStokesOperator(
            space, ca, ca, nu=0.001, c_1=0.2, c_2=0.0, time_integrator=ti,
            dtype=torch.float32, device=device,
        ))
    return ops


def kernel_inputs(tables, seed=0):
    import numpy as np
    import torch

    n_p = tables.jinv.shape[0]
    Xn = tables.P * tables.m + 1
    rng = np.random.default_rng(seed)
    dev = tables.jinv.device

    def t(lead):
        return torch.as_tensor(
            rng.standard_normal((lead, n_p, Xn, Xn)), dtype=torch.float32,
            device=dev,
        ).contiguous()

    return t(3), t(3), t(2)


SC = dict(weight=187.5, stau=100.0, nu=0.001, c1=0.2, c2=0.3)


def compare_cases(name, launch, plain, cases):
    """Kernel against plain version on every case; returns (max abs err,
    max rel err) and raises past the tolerance."""
    import torch

    worst_rel = 0.0
    worst_abs = 0.0
    for case in cases:
        k = launch(*case)
        torch.cuda.synchronize()
        ref = plain(*case)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"non-finite {name} kernel output {case[-3:]}")
        err = float((k - ref).abs().max())
        rel = err / float(ref.abs().max())
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, rel)
        if rel > KERNEL_REL_TOL:
            raise AssertionError(
                f"{name} kernel vs plain (flavor, consider_dt, cell_wise) "
                f"= {case[-3:]}: rel err {rel:.3e} > {KERNEL_REL_TOL}"
            )
    return worst_abs, worst_rel


def phase_kernel_vs_plain(ops):
    from ns_gls_tpu_torch.ops import patch2d as p2

    worst_rel = 0.0
    worst_abs = 0.0
    n_cases = 0
    for op in ops:
        tables = op._fast.tables
        u, ul, vo = kernel_inputs(tables)
        cases = []
        for flavor in p2.FLAVORS:
            ulf = ul if flavor == "increment" else ul[:2].contiguous()
            for cell_wise in (True, False):
                for cdt in (True, False):
                    cases.append((tables, SC, u, ulf, vo, flavor, cdt,
                                  cell_wise))
        a, r = compare_cases("patch-2D", p2.Patch2DKernel.launch,
                             p2.patch2d_sweep_plain, cases)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        n_cases += len(cases)
        log(f"[3] m={tables.m} patches={tables.jinv.shape[0]}: "
            f"{len(cases)} cases ok")
    log(f"[3] kernel vs plain: {n_cases} cases, max abs err {worst_abs:.3e}, "
        f"max rel err {worst_rel:.3e} (tol {KERNEL_REL_TOL})")
    return worst_abs, worst_rel


def sumfac_fmas(n1, nodes, qpts, grads):
    """FMAs of evaluating one component of a node tile at its q-points by
    sum factorization: one axis at a time (``nodes``/``qpts``: extents per
    axis in the order contracted), each q-point touching n1 nodes per
    axis.  With ``grads`` the value and the reference derivative along
    every axis (k + 2 arrays after the k-th axis), else the value alone.
    Integration, the transpose, costs the same."""
    fmas = 0
    for k in range(len(nodes)):
        extent = math.prod(qpts[:k + 1]) * math.prod(nodes[k + 1:])
        fmas += (k + 2 if grads else 1) * extent * n1
    return fmas


def sweep_cost(d, n_tiles, n1, nodes, qpts, n_out, geometry, nq, cells,
               flavor, consider_dt, cell_wise):
    """(bytes, flops) of the least work of one fused GLS sweep with its
    seam compress: the input tiles read once, the compressed node-major
    output (n_out nodes) written once, ``geometry`` table floats read
    once; sum-factorized evaluation of u, u_lin and the history and
    integration of the test-function weights, plus the q-point work."""
    C = d + 1
    incr = flavor == "increment"
    dt_old = consider_dt and flavor in ("increment", "residual")
    lead_in = C + (C if incr else d) + (d if dt_old else 0)
    tile = math.prod(nodes)
    nbytes = 4 * (lead_in * n_tiles * tile + C * n_out + geometry)
    g = sumfac_fmas(n1, nodes, qpts, True)
    v = sumfac_fmas(n1, nodes, qpts, False)
    fmas = n_tiles * (C * g + (C * g if incr else d * v)
                      + (d * v if dt_old else 0) + C * g)
    # per q-point: reference -> physical gradients (per component, 6
    # flops in 2D, 7 with the prismatic J in 3D; u, and u_lin in
    # increment), |u*|^2, the physics (counted from gls_qpoint.cuh) and
    # the test-function weights
    grad_map = 6 if d == 2 else 7
    phys = {2: (75, 40), 3: (150, 80)}[d][0 if incr else 1]
    weights = 1 + C * (9 if d == 2 else 11)
    per_q = (C * grad_map * (2 if incr else 1) + 2 * d - 1 + phys + weights
             + (1 if cell_wise else 15))
    # delta: per cell from the max |u*|^2, or per q-point (in per_q)
    flops = 2 * fmas + nq * per_q + (cells * 10 if cell_wise else 0)
    return nbytes, flops


def patch2d_cost(tables, flavor, consider_dt, cell_wise):
    """(bytes, flops) of one patch-2D sweep (see ``sweep_cost``)."""
    n_p = tables.jinv.shape[0]
    P, NQ, m = tables.P, tables.NQ, tables.m
    Xn, Lq = P * m + 1, NQ * m
    geometry = sum(t.numel() for t in (tables.jinv, tables.jxw, tables.h,
                                       tables.S1, tables.D1))
    return sweep_cost(2, n_p, P + 1, (Xn, Xn), (Lq, Lq),
                      int(tables.patch_nodes.max()) + 1, geometry,
                      n_p * Lq * Lq, n_p * m * m, flavor, consider_dt,
                      cell_wise)


def time_sweep(fn, n=200):
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def bound(nbytes, flops):
    """(bound ms, what bounds it) from the card's peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


# ---------------------------------------------------------------------------
# phase 6: prism kernel against plain version
# ---------------------------------------------------------------------------
SC3 = dict(weight=187.5, stau=100.0, nu=0.001, c1=2.0, c2=1.0)


def prism_inputs(tables, seed=0):
    import numpy as np
    import torch

    n_p = tables.jinv.shape[0]
    Xn = tables.P * tables.m + 1
    Nzn = tables.P * tables.nz + 1
    rng = np.random.default_rng(seed)
    dev = tables.jinv.device

    def t(lead):
        return torch.as_tensor(
            rng.standard_normal((lead, n_p, Xn, Xn, Nzn)),
            dtype=torch.float32, device=dev,
        ).contiguous()

    return t(4), t(4), t(3)


def phase_prism_vs_plain(ops):
    import torch

    from ns_gls_tpu_torch.ops import prism as pr

    worst_rel = 0.0
    worst_abs = 0.0
    n_cases = 0
    for op in ops:
        tables = op._fast.tables
        u, ul, vo = prism_inputs(tables)
        cases = []
        for flavor in pr.FLAVORS:
            ulf = ul if flavor == "increment" else ul[:3].contiguous()
            for cell_wise in (True, False):
                for cdt in (True, False):
                    cases.append((tables, SC3, u, ulf, vo, flavor, cdt,
                                  cell_wise))
        a, r = compare_cases("prism", pr.PrismKernel.launch,
                             pr.prism_sweep_plain, cases)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        n_cases += len(cases)
        log(f"[6] m={tables.m} nz={tables.nz} "
            f"patches={tables.jinv.shape[0]}: {len(cases)} cases ok")
    # two launches on the same inputs give the same bits (no atomics)
    tables = ops[-1]._fast.tables
    u, ul, vo = prism_inputs(tables, seed=2)
    args = (tables, SC3, u, ul, vo, "increment", True, False)
    a = pr.PrismKernel.launch(*args)
    b = pr.PrismKernel.launch(*args)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("two prism launches on the same inputs differ")
    log(f"[6] kernel vs plain: {n_cases} cases, max abs err {worst_abs:.3e}, "
        f"max rel err {worst_rel:.3e} (tol {KERNEL_REL_TOL}); two m=8 "
        f"launches bit-identical")
    return worst_abs, worst_rel


def prism_cost(tables, flavor, consider_dt, cell_wise):
    """(bytes, flops) of one prism sweep (see ``sweep_cost``): z, then y,
    then x contracted on the (Yn, Xn, Nzn) patch columns; the output is
    the compressed (C, n2d, Nzn), not the kernel's cell-row tiles."""
    n_p = tables.jinv.shape[0]
    P, NQ, m, nz = tables.P, tables.NQ, tables.m, tables.nz
    Xn, Nzn = P * m + 1, P * nz + 1
    Lq, Lz = NQ * m, NQ * nz
    geometry = sum(t.numel() for t in (tables.jinv, tables.jxw, tables.h,
                                       tables.S1, tables.D1, tables.wz))
    n2d = int(tables.patch_nodes.max()) + 1
    return sweep_cost(3, n_p, P + 1, (Nzn, Xn, Xn), (Lz, Lq, Lq),
                      n2d * Nzn, geometry, n_p * Lq * Lq * Lz,
                      n_p * m * m * nz, flavor, consider_dt, cell_wise)


# ---------------------------------------------------------------------------
# phases 4, 5, 7, 8: the driver
# ---------------------------------------------------------------------------
def setup_driver(params):
    import torch

    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.utils.logging import set_verbose

    set_verbose(False)
    drv = Driver(params, device="cuda")
    t0 = time.perf_counter()
    drv.setup()
    drv._setup_done = True
    torch.cuda.synchronize()
    return drv, time.perf_counter() - t0


def run_steps(drv, steps):
    """Drive ``steps`` time steps with every kernel count set to 0 just
    before and read just after."""
    import torch

    reset_kernel_counts()
    t0 = time.perf_counter()
    recs = drv.run(max_steps=steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    return recs, run_s, kernel_counts()


def run_driver(params, steps):
    drv, setup_s = setup_driver(params)
    recs, run_s, launches = run_steps(drv, steps)
    return drv, recs, setup_s, run_s, launches


def check_run(params, drv, recs, steps):
    import math

    stats = drv.step_stats
    if len(stats) != steps or len(recs) != steps + 1:
        raise AssertionError(f"ran {len(stats)} steps, want {steps}")
    tol = params.nonlinear_tolerance
    for i, s in enumerate(stats):
        if not s["newton_residual"] <= tol:
            raise AssertionError(f"step {i + 1}: Newton residual "
                                 f"{s['newton_residual']:.3e} > {tol}")
    for r in recs:
        for k in ("drag", "lift", "p_diff"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"non-finite {k} at t={r['t']}")


def log_steps(tag, stats, recs):
    for i, (s, r) in enumerate(zip(stats, recs[1:])):
        log(f"[{tag}] step {i + 1}: {s['seconds']:.3f} s, Newton "
            f"{s['newton']} (residual {s['newton_residual']:.2e}), GMRES "
            f"{s['gmres']}, t={r['t']:.6g} drag={r['drag']:.8g} "
            f"lift={r['lift']:.8g} p_diff={r['p_diff']:.8g}")


def phase_main_path():
    params = config({})
    drv, recs, setup_s, run_s, counts = run_driver(params, MAIN_STEPS)
    launches = counts["patch2d_gls_sweep"]
    n_dofs = drv.space.n_nodes * 3
    check_run(params, drv, recs, MAIN_STEPS)
    if launches <= 0:
        raise AssertionError("the patch-2D kernel was not launched")
    stats = drv.step_stats
    log(f"[4] Turek 2D ref {params.n_global_refinements}: {drv.mesh.n_cells} cells, {n_dofs} DoFs, "
        f"setup {setup_s:.2f} s, {MAIN_STEPS} steps in {run_s:.2f} s")
    log_steps(4, stats, recs)
    # step 1 has no inflow yet and step 2 pays the first-use costs
    steady = [s["seconds"] for s in stats[2:]]
    log(f"[4] steady seconds per step (steps 3-{MAIN_STEPS}): "
        f"{sum(steady) / len(steady):.4f}; kernel launches {counts} "
        f"({launches / MAIN_STEPS:.1f} patch-2D per step)")
    return dict(launches=launches, n_dofs=n_dofs, stats=stats)


def check_series(tag, recs, ref, tol):
    worst = 0.0
    for r, q in zip(recs, ref):
        for k in ("t", "drag", "lift", "p_diff"):
            gap = abs(r[k] - q[k]) / max(abs(q[k]), 1.0)
            worst = max(worst, gap)
            if gap > tol:
                raise AssertionError(
                    f"[{tag}] t={q['t']:.6g} {k}: {r[k]!r} vs series "
                    f"{q[k]!r} (gap {gap:.3e} > {tol:.3e})"
                )
    if len(recs) != len(ref):
        raise AssertionError(f"[{tag}] {len(recs)} records, want {len(ref)}")
    return worst


def phase_series():
    ref = json.load(open(os.path.join(
        ROOT, "validation", "turek_2d_re100_ref2_q2_series.json")))
    params = config({"n global refinements": 2, "c1": 2.0, "c2": 1.0,
                     "gmg coarse grid iterate": False})
    drv, recs, _, run_s, _ = run_driver(params, SERIES_STEPS)
    worst = check_series(5, recs, ref[:SERIES_STEPS + 1], SERIES_TOL)
    log(f"[5] ref 2 corridor parameters: {SERIES_STEPS} steps in "
        f"{run_s:.2f} s; max |gap| / max(|ref|, 1) = {worst:.3e} "
        f"(tol {SERIES_TOL:.2e}); step 3 drag {recs[3]['drag']:.8g} vs "
        f"{ref[3]['drag']:.8g}")
    return worst


def phase_main_path_3d(drv, params, setup_s):
    import torch

    torch.cuda.reset_peak_memory_stats()
    recs, run_s, counts = run_steps(drv, MAIN3D_STEPS)
    launches = counts["prism_gls_sweep"]
    check_run(params, drv, recs, MAIN3D_STEPS)
    if launches <= 0:
        raise AssertionError("the prism kernel was not launched")
    stats = drv.step_stats
    amg = drv.preconditioner.coarse_amg
    log(f"[7] Turek 3D ref {params.n_global_refinements}: "
        f"{drv.mesh.n_cells} cells, {drv.space.n_nodes * 4} DoFs, setup "
        f"{setup_s:.2f} s, {MAIN3D_STEPS} steps in {run_s:.2f} s; coarse "
        f"AMG levels {amg.level_sizes if amg is not None else None}")
    log_steps(7, stats, recs)
    log(f"[7] kernel launches {counts} ({launches / MAIN3D_STEPS:.1f} prism "
        f"per step); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(launches=launches, stats=stats)


def phase_series_3d():
    ser = json.load(open(os.path.join(
        ROOT, "validation", "turek_3d_re100_ref1_series.json")))
    params = config({"n global refinements": 1}, "turek_3d_re100.json")
    drv, recs, _, run_s, counts = run_driver(params, SERIES3D_STEPS)
    if counts["prism_gls_sweep"] <= 0:
        raise AssertionError("the prism kernel was not launched")
    ref = ser["series"][:SERIES3D_STEPS + 1]
    worst = check_series(8, recs, ref, SERIES3D_TOL)
    log(f"[8] Turek 3D ref 1: {SERIES3D_STEPS} steps in {run_s:.2f} s "
        f"(Newton {[s['newton'] for s in drv.step_stats]}, GMRES "
        f"{[s['gmres'] for s in drv.step_stats]}); max |gap| / "
        f"max(|ref|, 1) = {worst:.3e} (tol {SERIES3D_TOL:.2e}); last drag "
        f"{recs[-1]['drag']:.8g} vs {ref[-1]['drag']:.8g}")
    return worst


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import ns_gls_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        t_start = time.perf_counter()
        # 1. device
        smi = nvidia_smi_line()
        log(f"[1] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

        # 2. build
        from ns_gls_tpu_torch.utils import cuda_build

        t0 = time.perf_counter()
        cuda_build.build_libraries(["patch2d", "prism"])
        log(f"[2] built patch2d and prism in {time.perf_counter() - t0:.1f} s")
        for name in ("patch2d", "prism"):
            for line in cuda_build.build_info[name]["log"].splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[2]   {name}: {line.strip()}")

        # 3. patch-2D kernel against plain version
        ops = level_operators("cuda")
        max_abs, max_rel = phase_kernel_vs_plain(ops)

        # kernel time at the ref-3 shape (m = 8), the main path's flavor
        from ns_gls_tpu_torch.ops import patch2d as p2

        tables = ops[-1]._fast.tables
        u, ul, vo = kernel_inputs(tables, seed=1)
        args = (tables, SC, u, ul, vo, "increment", True, False)
        ms = time_sweep(lambda: p2.Patch2DKernel.launch(*args))
        plain_ms = time_sweep(lambda: p2.patch2d_sweep_plain(*args), n=50)
        nbytes, flops = patch2d_cost(tables, "increment", True, False)
        bound_ms, bound_by = bound(nbytes, flops)
        log(f"[3] m=8 increment sweep: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by} "
            f"({nbytes} B, {flops} flop)")
        del ops, u, ul, vo, args, tables

        # 4. 2D main path
        main = phase_main_path()

        # 5. 2D stored series
        phase_series()
        log(f"[-] 2D phases done at {time.perf_counter() - t_start:.1f} s")

        # 6. 3D driver set-up, prism kernel against plain version
        from ns_gls_tpu_torch.ops import prism as pr

        params3 = config({}, "turek_3d_re100.json")
        drv3, setup3_s = setup_driver(params3)
        log(f"[6] Turek 3D ref {params3.n_global_refinements} driver set "
            f"up in {setup3_s:.2f} s")
        pmax_abs, _ = phase_prism_vs_plain(drv3.mg_ops)
        ptables = drv3.mg_ops[-1]._fast.tables
        u, ul, vo = prism_inputs(ptables, seed=1)
        pargs = (ptables, SC3, u, ul, vo, "increment", True, False)
        pms = time_sweep(lambda: pr.PrismKernel.launch(*pargs))
        pplain_ms = time_sweep(lambda: pr.prism_sweep_plain(*pargs), n=20)
        nbytes, flops = prism_cost(ptables, "increment", True, False)
        pbound_ms, pbound_by = bound(nbytes, flops)
        log(f"[6] m={ptables.m} increment sweep: kernel {pms:.4f} ms, plain "
            f"{pplain_ms:.4f} ms, bound {pbound_ms:.6f} ms by {pbound_by} "
            f"({nbytes} B, {flops} flop)")
        del u, ul, vo, pargs, ptables

        # 7. 3D main path
        main3 = phase_main_path_3d(drv3, params3, setup3_s)
        del drv3

        # 8. 3D stored series
        phase_series_3d()
        log(f"[-] all phases done at {time.perf_counter() - t_start:.1f} s")

        # 9. kernel line, card line, result line
        kernels = [dict(
            name="patch2d_gls_sweep",
            route="cuda",
            source="ns_gls_tpu_torch/csrc/patch2d.cu",
            replaces="ns_gls_tpu/ops/patch2d.py:309",
            launches=main["launches"],
            max_abs_err=max_abs,
            ms=ms,
            plain_ms=plain_ms,
            bound_ms=bound_ms,
            bound_by=bound_by,
            library_ms=None,
        ), dict(
            name="prism_gls_sweep",
            route="cuda",
            source="ns_gls_tpu_torch/csrc/prism.cu",
            replaces="ns_gls_tpu/ops/prism.py:334",
            launches=main3["launches"],
            max_abs_err=pmax_abs,
            ms=pms,
            plain_ms=pplain_ms,
            bound_ms=pbound_ms,
            bound_by=pbound_by,
            library_ms=None,
        )]
        log(smi)
        log(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
