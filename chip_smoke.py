#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: require CUDA; print the card's name and power limit,
2. build: compile the CUDA kernels from ``ns_gls_tpu_torch/csrc``,
3. kernel vs plain: the patch-2D kernel against its plain PyTorch
   version on the card, on the Turek 2D ref-3 space (m = 8) and every GMG
   level space (m = 1, 2, 4), in every flavor x delta mode x consider_dt,
4. main path: ``input/turek_2d_re100.json`` as given (refinement 3, f64
   outer solve, f32 GMG levels, direct coarse solve) for 5 time steps
   through ``Driver.run``, output off; every Newton solve converges, the
   functionals are finite and the kernel was launched,
5. stored series: the corridor parameters (refinement 2, c1 = 2.0,
   c2 = 1.0, no coarse iteration) for 8 steps against the JAX package's
   CPU-f64 series ``validation/turek_2d_re100_ref2_q2_series.json``,
6. the kernel line (JSON) with launches, errors, times and bound,
7. the result line (JSON).

Imports nothing of the JAX package; needs the repository around it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# card peaks for the bound (H100 SXM data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# phase 3: kernel vs plain version, relative to the plain max-abs (f32
# with another summation order)
KERNEL_REL_TOL = 1e-5
# phase 5: the port's gap to the stored series measured on a CPU
# (f64 outer, f32 levels on the plain patch-2D sweep): 1.29e-7 of
# max(|ref|, 1) over these 8 steps; the card is held to 10x that
SERIES_CPU_GAP = 1.29e-7
SERIES_TOL = 10 * SERIES_CPU_GAP          # below the 1e-4 ceiling
MAIN_STEPS = 5
SERIES_STEPS = 8


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def config(overrides: dict):
    from ns_gls_tpu_torch.config import Parameters, _load_json

    raw = _load_json(os.path.join(ROOT, "input", "turek_2d_re100.json"))
    raw.update({"paraview prefix": "", "output granularity": 0.0})
    raw.update(overrides)
    return Parameters.from_dict(raw)


# ---------------------------------------------------------------------------
# phase 3: kernel against plain version
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


def phase_kernel_vs_plain(ops):
    import torch

    from ns_gls_tpu_torch.ops import patch2d as p2

    worst_rel = 0.0
    worst_abs = 0.0
    n_cases = 0
    for op in ops:
        tables = op._p2sweep.tables
        u, ul, vo = kernel_inputs(tables)
        for flavor in p2.FLAVORS:
            ulf = ul if flavor == "increment" else ul[:2].contiguous()
            for cell_wise in (True, False):
                for cdt in (True, False):
                    k = p2.Patch2DKernel.launch(tables, SC, u, ulf, vo,
                                                flavor, cdt, cell_wise)
                    torch.cuda.synchronize()
                    ref = p2.patch2d_sweep_plain(tables, SC, u, ulf, vo,
                                                 flavor, cdt, cell_wise)
                    torch.cuda.synchronize()
                    if not bool(torch.isfinite(k).all()):
                        raise AssertionError(f"non-finite kernel output "
                                             f"m={tables.m} {flavor}")
                    err = float((k - ref).abs().max())
                    rel = err / float(ref.abs().max())
                    worst_abs = max(worst_abs, err)
                    worst_rel = max(worst_rel, rel)
                    n_cases += 1
                    if rel > KERNEL_REL_TOL:
                        raise AssertionError(
                            f"kernel vs plain m={tables.m} {flavor} "
                            f"cell_wise={cell_wise} consider_dt={cdt}: "
                            f"rel err {rel:.3e} > {KERNEL_REL_TOL}"
                        )
        log(f"[3] m={tables.m} patches={tables.jinv.shape[0]}: 12 cases ok")
    log(f"[3] kernel vs plain: {n_cases} cases, max abs err {worst_abs:.3e}, "
        f"max rel err {worst_rel:.3e} (tol {KERNEL_REL_TOL})")
    return worst_abs, worst_rel


def patch2d_cost(tables, flavor, consider_dt):
    """(bytes, flops) of one sweep: each input read once and the output
    written once; flops counted from the kernel's loops."""
    n_p = tables.jinv.shape[0]
    P, NQ, m = tables.P, tables.NQ, tables.m
    n1 = P + 1
    Xn = P * m + 1
    nn = n_p * Xn * Xn
    nq = n_p * (NQ * m) ** 2
    incr = flavor == "increment"
    dt_old = consider_dt and flavor in ("increment", "residual")
    lead = 3 + (3 if incr else 2) + (2 if dt_old else 0) + 3   # + output
    nbytes = 4 * (lead * nn + tables.jinv.numel() + tables.jxw.numel()
                  + tables.h.numel() + tables.S1.numel() + tables.D1.numel())
    # per q-point: per node 3 table products, 3 comps x 3 FMAs of u,
    # u_lin (3 x 3 FMAs in increment, else 2 values), history (2 values)
    per_node = 3 + 18 + (18 if incr else 4) + (4 if dt_old else 0)
    # reference -> physical gradients, delta, physics, weights
    per_q = n1 * n1 * per_node + (48 if incr else 24) + 20 + 70 + 30
    # integration: per (cell, node) pair and cell q-point, 3 products
    # and 3 comps x 3 FMAs
    pairs = n_p * m * m * n1 * n1
    flops = nq * per_q + pairs * NQ * NQ * 21
    return nbytes, flops


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


# ---------------------------------------------------------------------------
# phases 4 and 5: the driver
# ---------------------------------------------------------------------------
def run_driver(params, steps):
    import torch

    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.ops.patch2d import Patch2DKernel
    from ns_gls_tpu_torch.utils.logging import set_verbose

    set_verbose(False)
    drv = Driver(params, device="cuda")
    t0 = time.perf_counter()
    drv.setup()
    drv._setup_done = True
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    Patch2DKernel.launches = 0
    t0 = time.perf_counter()
    recs = drv.run(max_steps=steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = Patch2DKernel.launches
    return drv, recs, setup_s, run_s, launches


def phase_main_path():
    import math

    params = config({})
    drv, recs, setup_s, run_s, launches = run_driver(params, MAIN_STEPS)
    n_dofs = drv.space.n_nodes * 3
    stats = drv.step_stats
    if len(stats) != MAIN_STEPS or len(recs) != MAIN_STEPS + 1:
        raise AssertionError(f"ran {len(stats)} steps, want {MAIN_STEPS}")
    tol = params.nonlinear_tolerance
    for i, s in enumerate(stats):
        if not s["newton_residual"] <= tol:
            raise AssertionError(f"step {i + 1}: Newton residual "
                                 f"{s['newton_residual']:.3e} > {tol}")
    for r in recs:
        for k in ("drag", "lift", "p_diff"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"non-finite {k} at t={r['t']}")
    if launches <= 0:
        raise AssertionError("the patch-2D kernel was not launched")
    log(f"[4] Turek 2D ref {params.n_global_refinements}: {drv.mesh.n_cells} cells, {n_dofs} DoFs, "
        f"setup {setup_s:.2f} s, {MAIN_STEPS} steps in {run_s:.2f} s")
    for i, (s, r) in enumerate(zip(stats, recs[1:])):
        log(f"[4] step {i + 1}: {s['seconds']:.3f} s, Newton {s['newton']} "
            f"(residual {s['newton_residual']:.2e}), GMRES {s['gmres']}, "
            f"t={r['t']:.6g} drag={r['drag']:.8g} lift={r['lift']:.8g} "
            f"p_diff={r['p_diff']:.8g}")
    # step 1 has no inflow yet and step 2 pays the first-use costs
    steady = [s["seconds"] for s in stats[2:]]
    log(f"[4] steady seconds per step (steps 3-{MAIN_STEPS}): "
        f"{sum(steady) / len(steady):.4f}; kernel launches {launches} "
        f"({launches / MAIN_STEPS:.1f} per step)")
    return dict(launches=launches, n_dofs=n_dofs, stats=stats)


def phase_series():
    ref = json.load(open(os.path.join(
        ROOT, "validation", "turek_2d_re100_ref2_q2_series.json")))
    params = config({"n global refinements": 2, "c1": 2.0, "c2": 1.0,
                     "gmg coarse grid iterate": False})
    drv, recs, _, run_s, _ = run_driver(params, SERIES_STEPS)
    worst = 0.0
    for r, q in zip(recs, ref):
        for k in ("t", "drag", "lift", "p_diff"):
            gap = abs(r[k] - q[k]) / max(abs(q[k]), 1.0)
            worst = max(worst, gap)
            if gap > SERIES_TOL:
                raise AssertionError(
                    f"t={q['t']:.6g} {k}: {r[k]!r} vs series {q[k]!r} "
                    f"(gap {gap:.3e} > {SERIES_TOL:.3e})"
                )
    if len(recs) != SERIES_STEPS + 1:
        raise AssertionError(f"{len(recs) - 1} steps, want {SERIES_STEPS}")
    log(f"[5] ref 2 corridor parameters: {SERIES_STEPS} steps in "
        f"{run_s:.2f} s; max |gap| / max(|ref|, 1) = {worst:.3e} "
        f"(tol {SERIES_TOL:.2e}); step 3 drag {recs[3]['drag']:.8g} vs "
        f"{ref[3]['drag']:.8g}")
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
        # 1. device
        smi = nvidia_smi_line()
        log(f"[1] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

        # 2. build
        from ns_gls_tpu_torch.utils import cuda_build

        t0 = time.perf_counter()
        cuda_build.build_libraries(["patch2d"])
        log(f"[2] built patch2d in {time.perf_counter() - t0:.1f} s")
        for line in cuda_build.build_info["patch2d"]["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2]   {line.strip()}")

        # 3. kernel against plain version
        ops = level_operators("cuda")
        max_abs, max_rel = phase_kernel_vs_plain(ops)

        # kernel time at the ref-3 shape (m = 8), the main path's flavor
        from ns_gls_tpu_torch.ops import patch2d as p2

        tables = ops[-1]._p2sweep.tables
        u, ul, vo = kernel_inputs(tables, seed=1)
        args = (tables, SC, u, ul, vo, "increment", True, False)
        ms = time_sweep(lambda: p2.Patch2DKernel.launch(*args))
        plain_ms = time_sweep(lambda: p2.patch2d_sweep_plain(*args), n=50)
        nbytes, flops = patch2d_cost(tables, "increment", True)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_flops = flops / PEAK_F32_FLOPS * 1e3
        bound_ms = max(t_bytes, t_flops)
        log(f"[3] m=8 increment sweep: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
            f"({nbytes} B, {flops} flop)")

        # 4. main path
        main = phase_main_path()

        # 5. stored series
        phase_series()

        # 6. kernel line, card line, result line
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
            bound_by="bytes" if t_bytes >= t_flops else "operations",
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
