#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: require CUDA; print the card's name and power limit,
2. build: compile the CUDA kernels from ``ns_gls_tpu_torch/csrc`` (one
   ``nvcc`` per library, all started together: patch2d, prism, structured,
   patch3d, seam_sum, and the degree-7 libraries of the first four),
3. patch-2D kernel vs plain: the patch-2D kernel against its plain
   PyTorch version on the card, on every level space of the Turek 2D
   chains of ``input/turek_2d_re100.json`` (Q2, m = 1, 2, 4, 8) and
   ``input/turek_2d_re20.json`` (Q1, m = 1-16), and on Q2 at m = 16 and
   32, Q3 at m = 16 and Q5 and Q6 at m = 2 (the degrees the kernels
   gained last), in every flavor x delta mode x consider_dt, two
   launches bit-identical; the kernel's registers, spills and shared
   memory per block at each degree, its device time and bound at Q6; the whole sweep (the kernel reading
   node-major vectors, then one seam-sum launch) against the plain sweep
   at m = 8, the seam sums bit-identical to their plain version; kernel
   and sweep timed there by the profiler's device time in the main
   path's flavor, two launches an apply,
4. 2D main path: ``input/turek_2d_re100.json`` as given (refinement 3,
   f64 outer solve, f32 GMG levels, direct coarse solve) for 5 time steps
   through ``Driver.run``, output off; every Newton solve converges, the
   functionals are finite, the patch-2D kernel was launched, each launch
   followed by one seam sum, and no other fused kernel ran,
5. 2D stored series: the corridor parameters (refinement 2, c1 = 2.0,
   c2 = 1.0, no coarse iteration) for 8 steps against the JAX package's
   CPU-f64 series ``validation/turek_2d_re100_ref2_q2_series.json``,
6. prism kernel vs plain: the Turek 3D driver is set up (its level
   spaces are built once and reused by phase 7); the prism kernel against
   its plain version on every level space (m = 1, 2, 4, 8) and on
   synthetic single patch columns at the shapes the kernel refused before
   its x bricks ((P, m) = (3, 16), (4, 8), (4, 16)) and at P = 5 and 6
   (m = 2), in every flavor x delta mode x consider_dt, two launches
   bit-identical; its time and bound at each shape,
7. 3D main path: ``input/turek_3d_re100.json`` as given (refinement 3,
   f64 outer, f32 prism GMG levels, AMG coarse iterated by GMRES) for 3
   steps through ``Driver.run``, output off; every Newton solve
   converges, the functionals are finite and the prism kernel was
   launched; its launches per level and the time they take above their
   bounds; the fine level's f64 general sweep (a scatter by
   ``index_put_``) twice on equal inputs, bit for bit,
8. 3D stored series: refinement 1, 4 steps, against the JAX package's
   CPU series ``validation/turek_3d_re100_ref1_series.json``,
9. structured kernels vs plain: the channel 3D driver is set up
   (``input/channel.json`` with dim 3, degree 2, refinement 3); the 2D,
   3D and batched-3D structured kernels against the plain version on
   sheared lattices (P = 1-6, every degree the 2D and 3D kernels have a
   specialization for, timed at P = 6; the 2D kernel also under forced slab plans with
   ragged bricks, multi-row slabs and several y chunks) and on the
   channel's level spaces, in every flavor x delta mode x consider_dt,
   two launches bit-identical, each timed at the finest level's shape
   (the batched kernel too, though no driver path gives it that shape);
   the 2D, 3D and batched 3D kernels' registers, spills and shared
   memory per block (the 2D and batched ones' dynamic shared memory equal
   to the host's formulas their plans are chosen by),
10. channel 3D main path: 128 x 32 x 32 cells of Q2 (4,343,300 DoFs, six
    GMG levels, f64 outer, f32 levels on the 3D structured kernel, direct
    coarse) for 3 steps through ``Driver.run``; every Newton solve
    converges, the solution is finite, every f32 level launched the
    kernel and none ran the general sweep,
11. channel 2D: the 2D kernel against the plain version on all nine
    level spaces (4 x 1 to 1024 x 256 cells of Q2) in every flavor x
    delta mode x consider_dt, timed at the finest; then the main path:
    degree 2, refinement 6 (3,153,411 DoFs, nine GMG levels on the 2D
    structured kernel), 3 steps, the same checks as phase 10,
12. gls-vmult lane: what ``bench_gpu.py 3 5 2`` runs, fixed-point and
    increment flavor, each with the 3D and the batched 3D kernel, and
    refinement 6 where the script's time allows; each lane's kernel is
    first held to the plain version and timed at the lane's own shape,
    state and scalars (the batched kernel's line entry comes from here),
13. patch-3D kernel vs plain: the ``input/sphere_amg.json`` driver is set
    up as given (its level spaces are reused by phase 14) and the
    ``input/sphere.json`` one too (phase 15); the patch-3D kernel against
    its plain version on every patch-3D level space of the first (m = 2,
    4, 8), on the single-cell-patch Q1 space of the second (m = 1) and on
    the sphere at refinements 0 and 1 in degrees 3 and 4, and on synthetic
    single patches at the shapes it refused before its x bricks ((P, m) =
    (1, 64), (2, 32), (3, 16), (3, 32), (4, 8), (4, 16)) and at P = 5 and
    6 (m = 2; their time and bound logged), in every flavor x delta mode x consider_dt, two
    launches bit-identical; the kernel's
    registers, spills and shared memory per block; the whole sweep (the
    kernel reading node-major vectors, then one seam-sum launch) against
    the plain sweep at the finest level, the seam sums bit-identical to
    their plain version; kernel, seam sums and sweep timed at the m = 8
    shape in the path's own flavor,
14. sphere main path: ``input/sphere_amg.json`` as given (refinement 3,
    Q2, 811,272 DoFs, stationary exact Newton, f64 outer, f32 levels on
    the patch-3D kernel over an iso-Q1 coarsest level with AMG) through
    ``Driver.run``, output off; the Newton solve converges, the solution
    is finite, slip walls carry no normal flux and the sphere no
    velocity, the patch-3D kernel was launched and only the iso-Q1 level
    ran the general sweep in f32,
15. transient sphere: ``input/sphere.json`` as given (Q1, refinement 0,
    BDF-2, inexact Newton, direct coarse) for 3 steps, the same checks,
16. weak outflow: ``input/hoffmann_2d_reinf.json`` as given (Q2,
    refinement 2, u max 39, nu = 0, BDF-2, inexact Newton, Nitsche
    outflow; f64 fine level on the general sweep, f32 GMG levels on the
    patch-2D kernel, direct coarse) for 2 steps through ``Driver.run``,
    output off: every Newton solve ends by the solver's criteria, the
    solution is finite, no flux through the slip cylinder and walls, the
    patch-2D kernel ran with one seam sum a launch and no other fused
    kernel, the face sweep ran on every level; then the Q1 refinement-1
    configuration, Nitsche and cut, against the JAX package's stored
    series ``validation/hoffmann_2d_reinf_ref1_q1_series.json``; the face
    sweep's scatter twice on equal inputs, bit for bit (phase 7 does the
    same for the f64 general sweep on the Turek 3D fine level),
17. rotation: the patch-2D kernel against its plain version on
    several-family tables (the rotation mesh's finest GMG level at
    refinements 3 and 6, m = 1-16, and a Q2 adaptive rectangle, m = 1,
    2, 4) in every flavor x delta mode x consider_dt, two launches
    bit-identical; the whole several-family sweep (one kernel launch a
    family into one tile buffer, then one seam sum) against the plain
    sweep, its launches counted; ``input/rotation.json`` as given (Q1,
    refinement 3, BDF-1, GMG-LS with the direct coarse solve and the
    pressure pin) for 5 steps and at refinement 6 (18,688 nodes, 8 forest
    levels) for 3, through ``Driver.run``: every Newton solve converges,
    the inner ring rotates rigidly (u_theta = r to 1e-8), every applied
    f32 forest level launched the patch-2D kernel and no f32 operator ran
    the general sweep; the kernel's time and bound at the m = 1 forest
    level of refinement 6 (16,384 patches); the same config under GMG for
    3 steps, n_families + 1 launches an apply on its finest f32 level;
    stationary Couette flow (Q2, refinement 1) under GMG-LS and GMG
    against the analytic u_theta within 5e-3,
18. the solver stack, every run through ``Driver.run`` with output off,
    each logged with its seconds: Picard on ``input/turek_2d_re100.json``
    (linear tolerance 1e-12, 3 steps): every solve converges by its own
    criterion, the patch-2D kernel runs only in its fixed flavor and
    nothing else runs, the step-3 solution within ``PICARD_NEWTON_GAP`` of
    phase 4's Newton solution; ``input/channel.json`` under the ILU
    preconditioner (3 steps; Newton and GMRES per step within 1 of the
    same run on the CPU; the host apply's seconds and share of the
    steps), with the matrix-based operator against the matrix-free one
    (linearized, 2 steps, within 1e-7), standalone AMG with its ILU
    smoother under Picard (1 step), Richardson and the ILU GMG coarse
    solver (1 step each, the 2D structured kernel's launches counted);
    ``input/turek_2d_re100.json`` for 4 steps against 2 checkpointed
    steps and a fresh driver resumed to step 4 (within 1e-12),
19. sharding, four shards on the one card (``devices=["cuda:0"] * 4``;
    one process drives them, ``ns_gls_tpu_torch/parallel/``):
    ``input/turek_2d_re100.json`` (3 steps), ``input/sphere_amg.json``
    (the stationary solve) and ``input/turek_3d_re100.json`` (2 steps)
    as given under the halo strategy against phases 4, 14 and 7 (Newton
    equal, GMRES within 10% a step, functionals and solution within
    ``SHARD_TOL``; seconds a step beside each other); then each level's
    layout (halo share, rounds, bytes and time of an apply's
    exchanges), each shard's fused kernel on the finest level against its
    plain version with its device time and bound, every level's sharded
    applies and the f64 fine level's against the single-device
    operators; the replicated strategy on Turek 2D ref 2 (2 steps)
    against a single-device run,
20. degree 7: each of the six fused kernels' P = 7 instance, from the
    libraries built for that degree alone in phase 2 (``nvcc
    -DNS_KERNEL_DEGREE=7``), against its plain version within 1e-6 on one
    small shape in every flavor x delta mode x consider_dt, two launches
    bit-identical; registers, spills and shared memory (the prism
    kernel's from the build log), device time, plain time and bound,
21. the slab-sharded structured operator
    (``parallel/structured_sharded.py``) on four shards of the card, 3D
    (16^3 cells of Q2) and 2D (64^2): each shard's kernel against its
    plain version, one apply's exchange two class-0 planes a neighbour
    pair, the sharded apply within 1e-6 of the one-device kernel apply,
    each shard's device time and bound and the exchange's share
    (``bench_gpu.py --shards``'s measurement),
22. the kernel line (JSON) with launches, errors, times and bounds (and
    the fused kernels' sharded launches and per-shard times, and each
    kernel's P = 7 numbers),
23. the result line (JSON).

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
# the kernels' sources, ``ns_gls_tpu_torch/csrc/<name>.cu``
KERNEL_SOURCES = ["patch2d", "prism", "structured", "patch3d", "seam_sum"]

# phases 3, 6, 9 and 13: kernel vs plain version, relative to the plain
# max-abs (f32 with another summation order)
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
# phases 10 and 11: the channel (``input/channel.json``) at full width
CHANNEL3D = {"dim": 3, "fe degree": 2, "n global refinements": 3}
CHANNEL3D_DOFS = 4343300
CHANNEL2D = {"fe degree": 2, "n global refinements": 6}
CHANNEL2D_DOFS = 3153411
CHANNEL_STEPS = 3
# phase 12: refinement 6 of the gls-vmult lane only when the script has
# used less than this many seconds (its limit is 1200)
VMULT_REF6_BEFORE_S = 520.0
# phases 14 and 15: the sphere, and its boundary conditions as the JAX
# package's tests/test_sphere_checkpoint.py checks them
SPHERE_DOFS = 811272
SPHERE_STEPS = 3
SLIP_FLUX_TOL = 1e-9
NO_SLIP_TOL = 1e-12


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


# the fused kernels by name: their launches are the ``launch.<name>``
# counters of ``utils/timer.py``
KERNEL_NAMES = ("patch2d_gls_sweep", "prism_gls_sweep", "structured2d",
                "structured3d", "structured3d_batched", "patch3d_gls_sweep",
                "seam_sum")
# the counts at the last ``reset_kernel_counts``
_launch_base: dict = {}


def launch_count(name: str) -> int:
    """The launches of kernel ``name`` in this process."""
    from ns_gls_tpu_torch.utils.timer import counters

    return counters().get("launch." + name, 0)


def kernel_counts() -> dict:
    """The launch counts of every kernel wrapper since the last
    ``reset_kernel_counts``, by kernel name."""
    return {k: launch_count(k) - _launch_base.get(k, 0)
            for k in KERNEL_NAMES}


def reset_kernel_counts():
    _launch_base.update({k: launch_count(k) for k in KERNEL_NAMES})


# ---------------------------------------------------------------------------
# phase 3: patch-2D kernel against plain version
# ---------------------------------------------------------------------------
# (label, degree, refinements of the Turek 2D mesh) of the chains whose
# levels phase 3 checks: input/turek_2d_re100.json's (Q2, m = 1-8), the
# Q1 chain of input/turek_2d_re20.json (m = 1-16), and the shapes the
# previous design could not launch
PATCH2D_CHAINS = (("turek_2d_re100", 2, 3), ("turek_2d_re20", 1, 4))
PATCH2D_EXTRA = (("Q2 ref 4", 2, 4), ("Q2 ref 5", 2, 5), ("Q3 ref 4", 3, 4))
# the degrees the kernels gained last (P = 5, 6), each at one shape: the
# Turek 2D mesh refined once (m = 2)
PATCH2D_HIGH = (("Q5 ref 1", 5, 1), ("Q6 ref 1", 6, 1))


def patch2d_operator(mesh, degree, device):
    """An f32 BDF-2 patch-2D operator on ``mesh`` of degree ``degree``."""
    import torch

    from ns_gls_tpu_torch.fem.constraints import AffineConstraints
    from ns_gls_tpu_torch.fem.space import FESpace
    from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator
    from ns_gls_tpu_torch.ops.time_integration import BDFIntegrator

    ti = BDFIntegrator(2)
    ti.update_dt(0.01)
    ti.update_dt(0.008)
    space = FESpace(mesh, degree)
    ca = AffineConstraints(space.n_nodes, 3).close(torch.float32, device)
    return NavierStokesOperator(
        space, ca, ca, nu=0.001, c_1=0.2, c_2=0.0, time_integrator=ti,
        dtype=torch.float32, device=device,
    )


def patch2d_level_sets(device):
    """(label, patch-2D tables) of every level phase 3 checks: one patch
    family each."""
    from ns_gls_tpu_torch.models.cylinder import SimulationCylinder

    sim = SimulationCylinder(2)
    out = []
    for name, degree, ref in PATCH2D_CHAINS:
        meshes = [sim.create_mesh(ref)]
        while meshes[0].prev is not None:
            meshes.insert(0, meshes[0].prev)
        out += [(f"{name} level {l}",
                 patch2d_operator(mesh, degree, device)._fast.tables)
                for l, mesh in enumerate(meshes)]
    out += [(name, patch2d_operator(sim.create_mesh(ref), degree,
                                    device)._fast.tables)
            for name, degree, ref in PATCH2D_EXTRA + PATCH2D_HIGH]
    return out


def time_patch2d_high(level_sets):
    """The patch-2D kernel at its P = 6 shape of phase 3 (increment, the
    history, q-wise delta): device time and bound, logged; returns them
    for the kernel line."""
    from ns_gls_tpu_torch.ops import patch2d as p2
    from ns_gls_tpu_torch.utils.roofline import bound, patch2d_cost
    from ns_gls_tpu_torch.utils.timer import device_time_us

    label, ft = next((l, ft) for l, ft in level_sets
                     if l == PATCH2D_HIGH[-1][0])
    (tables,) = ft.fams
    u, ul, vo = patch2d_inputs(tables, seed=1)
    args = (tables, SC, u, ul, vo, "increment", True, False)
    us = device_time_us(lambda: p2.Patch2DKernel.launch(*args),
                        "patch2d_kernel", n=20)
    bound_ms, by = bound(*patch2d_cost(ft, "increment", True, False))
    label = f"{label} P={tables.P} m={tables.m}"
    log(f"[3] {label}: kernel device time {us:.3f} us, bound "
        f"{1e3 * bound_ms:.4f} us by {by} (increment, history, q-wise "
        f"delta)")
    return dict(label=label, ms=us / 1e3, bound_ms=bound_ms, bound_by=by)


def patch2d_inputs(tables, seed=0):
    """Random node-major u, u_lin and vec_old (n_nodes, 3) on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal((tables.n_nodes, 3)),
                                 dtype=torch.float32, device="cuda")
                 for _ in range(3))


SC = dict(weight=187.5, stau=100.0, nu=0.001, c1=0.2, c2=0.3)


def compare_cases(name, launch, plain, cases, tol=KERNEL_REL_TOL):
    """Kernel against plain version on every case; returns (max abs err,
    max rel err) and raises past the tolerance ``tol``."""
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
        if rel > tol:
            raise AssertionError(
                f"{name} kernel vs plain (flavor, consider_dt, cell_wise) "
                f"= {case[-3:]}: rel err {rel:.3e} > {tol}"
            )
    return worst_abs, worst_rel


def phase_kernel_vs_plain(level_sets, tag=3):
    """The patch-2D kernel against its plain version on every patch family
    of every level of ``level_sets`` in every flavor x delta mode x
    consider_dt; two launches on the same inputs give the same bits.
    Returns (max abs err, max rel err)."""
    import torch

    from ns_gls_tpu_torch.ops import patch2d as p2

    worst_rel = 0.0
    worst_abs = 0.0
    n_cases = 0
    for label, tables in ((f"{label} family m={t.m}" if len(ft.fams) > 1
                           else label, t)
                          for label, ft in level_sets for t in ft.fams):
        u, ul, vo = patch2d_inputs(tables)
        cases = [(tables, SC, u, ul, vo, flavor, cdt, cell_wise)
                 for flavor in p2.FLAVORS for cell_wise in (True, False)
                 for cdt in (True, False)]
        a, r = compare_cases("patch-2D", p2.Patch2DKernel.launch,
                             p2.patch2d_sweep_plain, cases)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        n_cases += len(cases)
        for case in (cases[4], cases[1]):
            x = p2.Patch2DKernel.launch(*case)
            y = p2.Patch2DKernel.launch(*case)
            torch.cuda.synchronize()
            if not torch.equal(x, y):
                raise AssertionError(f"two patch-2D launches on the same "
                                     f"inputs differ ({label})")
        log(f"[{tag}] {label}: P={tables.P} m={tables.m} "
            f"patches={tables.jinv.shape[0]} plan {tuple(tables.plan)}: "
            f"{len(cases)} cases ok, max rel err {r:.3e}")
    log(f"[{tag}] kernel vs plain: {n_cases} cases, max abs err "
        f"{worst_abs:.3e}, "
        f"max rel err {worst_rel:.3e} (tol {KERNEL_REL_TOL}); relaunches "
        f"bit-identical")
    return worst_abs, worst_rel


def log_patch2d_build(level_sets, flavor, consider_dt):
    """Registers, spills and shared memory per block of the patch-2D
    kernel as built, at each degree of ``level_sets`` under the plan of
    its finest level there, in the flavor given."""
    from ns_gls_tpu_torch.ops import patch2d as p2

    finest = {}
    for t in (t for _, ft in level_sets for t in ft.fams):
        if t.m >= finest.get(t.P, t).m:
            finest[t.P] = t
    for P, t in sorted(finest.items()):
        a = p2.Patch2DKernel.attributes(P, t.plan, flavor, consider_dt)
        log(f"[3] patch2d_kernel<{P}> at m={t.m}: {a['registers']} "
            f"registers, {a['spill_bytes']} B local memory (spills), "
            f"{a['static_smem']} B static + {a['dynamic_smem']} B dynamic "
            f"shared memory per block (plan {tuple(t.plan)}, {flavor}, "
            f"consider_dt {consider_dt})")


def phase_patch2d_sweep(ft, flavor, consider_dt, cell_wise, tag=3):
    """The whole sweep on the one-family tables ``ft`` (kernel, one
    seam-sum launch) against the plain kernel and plain seam sums; the
    seam sums bit-equal to their plain version on the kernel's own tiles,
    twice; its launches counted by the wrappers; times by the profiler's
    device time: the kernel, and the sweep as its kernels' mean times
    within it; the plain version by events and the bound.  Returns the
    kernel line's numbers."""
    import torch

    from ns_gls_tpu_torch.ops import patch2d as p2
    from ns_gls_tpu_torch.utils import segment as sg
    from ns_gls_tpu_torch.utils.roofline import bound, patch2d_cost
    from ns_gls_tpu_torch.utils.timer import device_time_us

    (tables,) = ft.fams
    u, ul, vo = patch2d_inputs(ft, seed=1)
    args = (tables, SC, u, ul, vo, flavor, consider_dt, cell_wise)
    tiles = p2.Patch2DKernel.launch(*args).reshape(-1, 3)
    got = sg.SeamSumKernel.launch(ft.seams, tiles)
    again = sg.SeamSumKernel.launch(ft.seams, tiles)
    plain_seams = sg.seam_sum_plain(ft.seams, tiles)
    ref = sg.seam_sum_plain(ft.seams,
                            p2.patch2d_sweep_plain(*args).reshape(-1, 3))
    torch.cuda.synchronize()
    if not (torch.equal(got, again) and torch.equal(got, plain_seams)):
        raise AssertionError("the seam sums differ from their plain version "
                             "or from themselves")
    rel = float((got - ref).abs().max() / ref.abs().max())
    if not rel <= KERNEL_REL_TOL:
        raise AssertionError(f"patch-2D sweep vs plain sweep: rel err "
                             f"{rel:.3e} > {KERNEL_REL_TOL}")

    def kernel():
        return p2.Patch2DKernel.launch(*args)

    def sweep():
        return sg.seam_sum(ft.seams, kernel().reshape(-1, 3))

    k0, s0 = launch_count("patch2d_gls_sweep"), launch_count("seam_sum")
    sweep()
    n_k = launch_count("patch2d_gls_sweep") - k0
    n_s = launch_count("seam_sum") - s0
    us = device_time_us(kernel, "patch2d_kernel")
    sweep_us = (device_time_us(sweep, "patch2d_kernel")
                + device_time_us(sweep, "seam_sum_kernel"))
    events_ms = time_sweep(kernel)
    plain_ms = time_sweep(lambda: p2.patch2d_sweep_plain(*args), n=50)
    nbytes, flops = patch2d_cost(ft, flavor, consider_dt, cell_wise)
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"[{tag}] sweep (kernel, seam sums) vs plain sweep at "
        f"m={tables.m}: max "
        f"rel err {rel:.3e}; seam sums bit-identical to their plain version "
        f"and to themselves")
    log(f"[{tag}] m={tables.m} {flavor} sweep (consider_dt {consider_dt}, "
        f"cell-wise {cell_wise}), device time: kernel {us:.3f} us, sweep "
        f"{sweep_us:.3f} us in {n_k + n_s} launches; kernel by events "
        f"{1e3 * events_ms:.3f} us (back-to-back launches: the host's rate); "
        f"plain {plain_ms:.4f} ms; bound {1e3 * bound_ms:.4f} us by "
        f"{bound_by} ({nbytes} B, {flops} flop)")
    if (n_k, n_s) != (1, 1):
        raise AssertionError(
            f"the patch-2D sweep launched {n_k} kernel and {n_s} seam-sum "
            f"launches, want 1 and 1")
    return dict(ms=us / 1e3, sweep_ms=sweep_us / 1e3, events_ms=events_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def time_sweep(fn, n=200):
    """Milliseconds per call over n launches by CUDA events, 5 warm-ups."""
    from ns_gls_tpu_torch.utils.timer import time_cuda

    return time_cuda(fn, n, warmup=5)


# ---------------------------------------------------------------------------
# phase 6: prism kernel against plain version
# ---------------------------------------------------------------------------
SC3 = dict(weight=187.5, stau=100.0, nu=0.001, c1=2.0, c2=1.0)


def tile_inputs(shape, device, seed=0):
    """Random u (4), u_lin (4) and vec_old (3) node tiles of ``shape``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(lead):
        return torch.as_tensor(rng.standard_normal((lead,) + shape),
                               dtype=torch.float32, device=device)

    return t(4), t(4), t(3)


def prism_inputs(tables, seed=0):
    Xn = tables.P * tables.m + 1
    Nzn = tables.P * tables.nz + 1
    return tile_inputs((tables.jinv.shape[0], Xn, Xn, Nzn),
                       tables.jinv.device, seed)


# the (P, m) the prism kernel refused before its x bricks, on synthetic
# single patch columns of PRISM_BRICK_NZ layers; then the degrees the
# kernel gained last, each at one shape
PRISM_BRICK_SHAPES = ((3, 16), (4, 8), (4, 16), (5, 2), (6, 2))
PRISM_BRICK_NZ = 16


def synthetic_prism_tables(P, m, nz, device, seed=0):
    """Prism tables of one patch column of m x m cells and nz layers of
    degree P, its prismatic geometry a random perturbation of the unit
    box's lattice (a shape no input config reaches)."""
    import numpy as np

    from ns_gls_tpu_torch.ops.prism import make_prism_tables

    rng = np.random.default_rng(seed)
    NQ, Xn = P + 1, P * m + 1
    Lq = NQ * m
    jinv = np.zeros((1, 5, Lq, Lq))
    jinv[0, 0] = jinv[0, 3] = m
    jinv[0, :4] += 0.1 * m * rng.standard_normal((4, Lq, Lq))
    jinv[0, 4] = nz
    jxw = (1.0 + 0.2 * rng.random((1, Lq, Lq))) / (m * NQ) ** 2
    h = np.empty((1, 2, m, m))
    h[0, 0], h[0, 1] = 1.0 / m, 1.0 / (m * P)
    pn = np.arange(Xn * Xn, dtype=np.int64).reshape(1, Xn, Xn)
    return make_prism_tables(P, NQ, m, nz, Xn * Xn, pn, jinv, jxw, h,
                             device)


def phase_prism_vs_plain(table_sets):
    """The prism kernel against its plain version on every tables of
    ``table_sets`` ((label, tables)) in every flavor x delta mode x
    consider_dt; two launches on the same inputs give the same bits at
    the last and at every synthetic shape.  Returns (max abs err, max rel
    err)."""
    import torch

    from ns_gls_tpu_torch.ops import prism as pr

    worst_rel = 0.0
    worst_abs = 0.0
    n_cases = 0
    for label, tables in table_sets:
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
        log(f"[6] {label}: P={tables.P} m={tables.m} nz={tables.nz} "
            f"patches={tables.jinv.shape[0]} plan {tuple(tables.plan)}: "
            f"{len(cases)} cases ok, max rel err {r:.3e}")
        if label.startswith("synthetic") or tables is table_sets[-1][1]:
            # two launches on the same inputs give the same bits (no
            # atomics)
            for case in (cases[4], cases[1]):
                x = pr.PrismKernel.launch(*case)
                y = pr.PrismKernel.launch(*case)
                torch.cuda.synchronize()
                if not torch.equal(x, y):
                    raise AssertionError(f"two prism launches on the same "
                                         f"inputs differ ({label})")
    log(f"[6] kernel vs plain: {n_cases} cases, max abs err {worst_abs:.3e}, "
        f"max rel err {worst_rel:.3e} (tol {KERNEL_REL_TOL}); relaunches "
        f"bit-identical")
    return worst_abs, worst_rel


def time_prism_levels(table_sets):
    """The prism kernel's time and bound at the shape of every tables of
    ``table_sets`` ((label, tables)), in the timing case (increment,
    history, q-wise delta): {label: dict}."""
    from ns_gls_tpu_torch.ops import prism as pr
    from ns_gls_tpu_torch.utils.roofline import bound, prism_cost
    from ns_gls_tpu_torch.utils.timer import device_time_us

    levels = {}
    for label, tables in table_sets:
        u, ul, vo = prism_inputs(tables, seed=1)
        args = (tables, SC3, u, ul, vo, "increment", True, False)
        ms = time_sweep(lambda: pr.PrismKernel.launch(*args))
        dev_us = device_time_us(lambda: pr.PrismKernel.launch(*args),
                                "prism_kernel")
        bound_ms, by = bound(*prism_cost(tables, "increment", True, False))
        levels[label] = dict(nz=tables.nz, us=1e3 * ms, device_us=dev_us,
                             bound_us=1e3 * bound_ms, bound_by=by)
        log(f"[6] {label}: P={tables.P} m={tables.m} nz={tables.nz}: "
            f"launches back to back "
            f"{1e3 * ms:.1f} us each, kernel device time {dev_us:.1f} us, "
            f"bound {1e3 * bound_ms:.2f} us by {by}")
    return levels


class PrismLaunchesByLevel:
    """Counts the prism kernel's launches by level (m) while installed."""

    def __enter__(self):
        from ns_gls_tpu_torch.ops.prism import PrismKernel

        self.counts = counts = {}
        self._attr = PrismKernel.__dict__["launch"]
        orig = PrismKernel.launch

        def launch(tables, *a, **kw):
            out = orig(tables, *a, **kw)
            counts[tables.m] = counts.get(tables.m, 0) + 1
            return out

        PrismKernel.launch = launch
        return self

    def __exit__(self, *exc):
        from ns_gls_tpu_torch.ops.prism import PrismKernel

        PrismKernel.launch = self._attr
        return False


# ---------------------------------------------------------------------------
# phases 4, 5, 7, 8: the driver
# ---------------------------------------------------------------------------
def setup_driver(params, devices=None):
    import torch

    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.utils.logging import set_verbose

    set_verbose(False)
    drv = (Driver(params, device="cuda") if devices is None
           else Driver(params, devices=devices))
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


def run_driver(params, steps, devices=None):
    drv, setup_s = setup_driver(params, devices)
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
    """Phase 4; also keeps the solution after step 3 for phase 18."""
    params = config({})
    drv, setup_s = setup_driver(params)
    kept = []
    post = drv.sim.postprocess

    def postprocess(t, u):
        # called at t = 0 and after every step
        if len(kept) == 3:
            kept.append(u.clone())
        else:
            kept.append(None)
        return post(t, u)

    drv.sim.postprocess = postprocess
    recs, run_s, counts = run_steps(drv, MAIN_STEPS)
    drv.sim.postprocess = post
    launches = counts["patch2d_gls_sweep"]
    n_dofs = drv.space.n_nodes * 3
    check_run(params, drv, recs, MAIN_STEPS)
    if launches <= 0:
        raise AssertionError("the patch-2D kernel was not launched")
    # every sweep is the kernel and one seam sum, and no other fused
    # kernel runs on this path
    others = {k: n for k, n in counts.items()
              if n and k not in ("patch2d_gls_sweep", "seam_sum")}
    if counts["seam_sum"] != launches or others:
        raise AssertionError(f"patch-2D path launches {counts}: want one "
                             f"seam sum per patch-2D kernel and nothing else")
    stats = drv.step_stats
    log(f"[4] Turek 2D ref {params.n_global_refinements}: {drv.mesh.n_cells} cells, {n_dofs} DoFs, "
        f"setup {setup_s:.2f} s, {MAIN_STEPS} steps in {run_s:.2f} s")
    log_steps(4, stats, recs)
    # step 1 has no inflow yet and step 2 pays the first-use costs
    steady = [s["seconds"] for s in stats[2:]]
    log(f"[4] steady seconds per step (steps 3-{MAIN_STEPS}): "
        f"{sum(steady) / len(steady):.4f}; kernel launches {counts} "
        f"({launches / MAIN_STEPS:.1f} patch-2D per step)")
    return dict(launches=launches, seam_launches=counts["seam_sum"],
                n_dofs=n_dofs, stats=stats, recs=recs, step3=kept[3])


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


def phase_main_path_3d(drv, params, setup_s, levels):
    import torch

    torch.cuda.reset_peak_memory_stats()
    kept = []
    post = drv.sim.postprocess

    def postprocess(t, u):
        # called at t = 0 and after every step; phase 19 reads the
        # solution after its steps
        kept.append(u.cpu() if len(kept) == SHARD_3D_STEPS else None)
        return post(t, u)

    drv.sim.postprocess = postprocess
    with PrismLaunchesByLevel() as by_level:
        recs, run_s, counts = run_steps(drv, MAIN3D_STEPS)
    drv.sim.postprocess = post
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
    # launches per level beside phase 6's device time and bound there
    above = 0.0
    for m in sorted(by_level.counts):
        n, lv = by_level.counts[m], levels[m]
        ms_above = n / MAIN3D_STEPS * (lv["device_us"] - lv["bound_us"]) / 1e3
        above += ms_above
        log(f"[7] m={m}: {n} launches ({n / MAIN3D_STEPS:.1f} per step) at "
            f"{lv['device_us']:.1f} us of device time against a bound of "
            f"{lv['bound_us']:.2f} us: {ms_above:.1f} ms per step above it")
    log(f"[7] prism kernel above its bounds: {above:.1f} ms per step")
    return dict(launches=launches, stats=stats, recs=recs,
                u=kept[SHARD_3D_STEPS])


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


# ---------------------------------------------------------------------------
# phases 9-12: the structured kernels, the channel, the gls-vmult lane
# ---------------------------------------------------------------------------
SC_CH = dict(weight=140.0, stau=140.0, nu=0.0, c1=2.0, c2=1.0)
SC_SHEAR = dict(weight=18.75, stau=12.5, nu=0.02, c1=4.0, c2=2.0)


def structured_inputs(tables, seed=0):
    import numpy as np
    import torch

    from ns_gls_tpu_torch.ops.structured import lattice_shape

    shp = lattice_shape(tables.P, tables.cell_shape)
    rng = np.random.default_rng(seed)
    dev = tables.jinv.device

    def t(lead):
        return torch.as_tensor(rng.standard_normal((lead,) + shp),
                               dtype=torch.float32, device=dev).contiguous()

    return t(tables.d + 1), t(tables.d + 1), t(tables.d)


def sheared_tables(dim, degree, device):
    """Tables of a sheared parallelogram lattice (full jinv): 37 x 5
    cells in 2D, 19 x 3 x 2 in 3D, so that a cell row splits into
    segments and ragged chunks."""
    import dataclasses

    import torch

    from ns_gls_tpu_torch.fem.constraints import AffineConstraints
    from ns_gls_tpu_torch.fem.space import FESpace
    from ns_gls_tpu_torch.mesh.generators import subdivided_hyper_rectangle
    from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator
    from ns_gls_tpu_torch.ops.time_integration import BDFIntegrator

    cs = (37, 5) if dim == 2 else (19, 3, 2)
    mesh = subdivided_hyper_rectangle(cs, (0.0,) * dim,
                                      (1.2, 1.0, 0.8)[:dim], colorize=True)
    v = mesh.vertices.copy()
    v[:, 0] = v[:, 0] + 0.35 * v[:, 1]
    if dim == 3:
        v[:, 1] = v[:, 1] + 0.2 * v[:, 2]
    mesh = dataclasses.replace(mesh, vertices=v)
    space = FESpace(mesh, degree)
    ca = AffineConstraints(space.n_nodes, dim + 1).close(torch.float32,
                                                        device)
    ti = BDFIntegrator(2)
    ti.update_dt(0.1)
    ti.update_dt(0.08)
    op = NavierStokesOperator(space, ca, ca, nu=0.02, c_1=4.0, c_2=2.0,
                              time_integrator=ti, dtype=torch.float32,
                              device=device)
    return op._fast.tables


def structured_cases(tables, sc, seed=0):
    from ns_gls_tpu_torch.ops.structured import FLAVORS

    u, ul, vo = structured_inputs(tables, seed)
    return [(tables, sc, u, ul, vo, flavor, cdt, cell_wise)
            for flavor in FLAVORS for cell_wise in (True, False)
            for cdt in (True, False)]


def compare_structured(label, cases, batched, errs):
    """One structured kernel (wrapper: kernel and fold) against the plain
    version on ``cases``, and two launches on the same inputs for equal
    bits.  Updates ``errs`` {kernel name: max abs err}; returns the max
    rel err."""
    import torch

    from ns_gls_tpu_torch.ops import structured as st

    name = st.StructuredKernel.kernel_name(cases[0][0].d, batched)
    a, r = compare_cases(
        name, lambda *c: st.structured_sweep(*c, batched=batched),
        st.structured_sweep_plain, cases)
    errs[name] = max(errs.get(name, 0.0), a)
    args = cases[1]
    x = st.structured_sweep(*args, batched=batched)
    y = st.structured_sweep(*args, batched=batched)
    torch.cuda.synchronize()
    if not torch.equal(x, y):
        raise AssertionError(f"two {name} launches on the same inputs "
                             f"differ ({label})")
    return r


def phase_structured_vs_plain(tag, table_sets, errs):
    """Every structured kernel that fits the tables' dimension against
    the plain version; ``table_sets``: (label, tables, scalars).  Updates
    ``errs`` {kernel name: max abs err}; returns the number of cases."""
    n_cases = 0
    worst_rel = 0.0
    for label, tables, sc in table_sets:
        for batched in ((False, True) if tables.d == 3 else (False,)):
            cases = structured_cases(tables, sc)
            worst_rel = max(worst_rel,
                            compare_structured(label, cases, batched, errs))
            n_cases += len(cases)
        log(f"[{tag}] {label}: cells {tables.cell_shape}, P={tables.P}: ok")
    log(f"[{tag}] structured kernels vs plain: {n_cases} cases, max abs err "
        f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} }, max rel err "
        f"{worst_rel:.3e} (tol {KERNEL_REL_TOL}); relaunches bit-identical")
    return n_cases


def time_structured(tag, tables, sc, batched):
    """Times of one structured sweep at the tables' shape in the main
    path's level flavor (increment, cell-wise delta, BDF history): the
    wrapper (kernel and fold), the kernel alone, the plain version, and
    the function's bound."""
    u, ul, vo = structured_inputs(tables, seed=1)
    return time_structured_args(
        tag, (tables, sc, u, ul, vo, "increment", True, True), batched)


def time_structured_args(tag, args, batched):
    """The same times for the sweep arguments ``args`` (tables, scalars,
    uT, u_linT, vec_oldT, flavor, consider_dt, cell_wise)."""
    from ns_gls_tpu_torch.ops import structured as st
    from ns_gls_tpu_torch.utils.roofline import bound, structured_cost

    tables, flavor = args[0], args[5]
    ms = time_sweep(lambda: st.structured_sweep(*args, batched=batched))
    kernel_ms = time_sweep(
        lambda: st.StructuredKernel.launch(*args, batched=batched))
    plain_ms = time_sweep(lambda: st.structured_sweep_plain(*args), n=10)
    nbytes, flops = structured_cost(tables, *args[5:])
    bound_ms, bound_by = bound(nbytes, flops)
    name = st.StructuredKernel.kernel_name(tables.d, batched)
    log(f"[{tag}] {name} at cells {tables.cell_shape}, P={tables.P}, "
        f"{flavor} sweep: kernel and fold {ms:.4f} ms (kernel alone "
        f"{kernel_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms by {bound_by} ({nbytes} B, {flops} flop)")
    return dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def log_structured_build(tag, table_sets):
    """Registers, spills and shared memory per block of the 2D, 3D and
    batched 3D kernels as built, at each dimension and degree among
    ``table_sets`` (under the plan of the largest lattice of that degree,
    in the main path's flavor); the 2D and batched kernels' dynamic shared
    memory must be the host's formula (``slab_smem_2d``,
    ``batched_smem``), which their plans are chosen by."""
    from ns_gls_tpu_torch.ops import structured as st

    largest = {}
    for t in table_sets:
        n = t.jinv.shape[0]
        if n > largest.get((t.d, t.P), (0, None))[0]:
            largest[(t.d, t.P)] = (n, t)
    for (d, P), (_, t) in sorted(largest.items()):
        if d == 2:
            plan = st.slab_plan_2d(P, t.cell_shape)
            host = st.slab_smem_2d(P, plan.xb, plan.ys, "increment", True)
        else:
            plan = st.brick_plan(P, t.cell_shape)
            host = None
        a = st.StructuredKernel.attributes(P, plan, "increment", True)
        log(f"[{tag}] structured{d}d_kernel<{P}>: {a['registers']} "
            f"registers, {a['local_bytes']} B local memory (spills), "
            f"{a['static_smem']} B static + {a['dynamic_smem']} B dynamic "
            f"shared memory per block (plan {tuple(plan)} at cells "
            f"{t.cell_shape}, increment with history)")
        if host is not None and a["dynamic_smem"] != host:
            raise AssertionError(f"structured2d_kernel<{P}>: the launcher's "
                                 f"{a['dynamic_smem']} B of shared memory, "
                                 f"the host's formula {host} B")
        if d == 3:
            plan = st.batched_plan(P, t.cell_shape)
            host = st.batched_smem(P, plan.xb, plan.zs, "increment", True)
            a = st.StructuredKernel.attributes(P, plan, "increment", True,
                                               batched=True)
            log(f"[{tag}] structured3d_batched_kernel<{P}>: "
                f"{a['registers']} registers, {a['local_bytes']} B local "
                f"memory (spills), {a['static_smem']} B static + "
                f"{a['dynamic_smem']} B dynamic shared memory per block "
                f"(plan {tuple(plan)} at cells {t.cell_shape}, increment "
                "with history)")
            if a["dynamic_smem"] != host:
                raise AssertionError(
                    f"structured3d_batched_kernel<{P}>: the launcher's "
                    f"{a['dynamic_smem']} B of shared memory, the host's "
                    f"formula {host} B")


def phase_structured2d_plans(tag, table_sets, errs):
    """The 2D kernel under forced slab plans (ragged last bricks, slabs of
    2 and 3 rows, several y chunks each recomputing the row below it) on
    each of ``table_sets`` (label, tables, scalars), against the plain
    version in every flavor x delta mode x consider_dt.  Updates
    ``errs``."""
    from ns_gls_tpu_torch.ops import structured as st

    for label, tables, sc in table_sets:
        nx, ny = tables.cell_shape
        cpw = max(1, 32 // (tables.P + 1) ** 2)
        xb = max(1, min(nx - 1, 2 * cpw if nx % (2 * cpw) else cpw + 1))
        plans = [st.SlabPlan2D(xb, -(-nx // xb), ys, -(-ny // nyb), nyb)
                 for ys, nyb in ((2, 2), (3, ny))]
        for plan in plans:
            cases = structured_cases(tables, sc, seed=2)
            a, _ = compare_cases(
                f"structured2d {label} plan {tuple(plan)}",
                lambda *c, p=plan: st.fold_seams_2d(
                    c[0], *st.StructuredKernel.launch(*c, plan=p), p.xb),
                st.structured_sweep_plain, cases)
            errs["structured2d"] = max(errs.get("structured2d", 0.0), a)
        log(f"[{tag}] {label}: structured2d under plans "
            f"{[tuple(p) for p in plans]}: ok")


class GeneralSweepCount:
    """Counts the calls of the general gather sweep by operator dtype
    while it is installed, and keeps the f32 operators that made them."""

    def __init__(self):
        self.calls = {}
        self.f32_ops = []

    def __enter__(self):
        from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator

        self._cls = NavierStokesOperator
        self._orig = orig = NavierStokesOperator._cell_sweep
        calls = self.calls
        f32_ops = self.f32_ops

        def counted(op, *a, **kw):
            import torch

            calls[op.dtype] = calls.get(op.dtype, 0) + 1
            if op.dtype == torch.float32 and not any(o is op
                                                     for o in f32_ops):
                f32_ops.append(op)
            return orig(op, *a, **kw)

        NavierStokesOperator._cell_sweep = counted
        return self

    def __exit__(self, *exc):
        self._cls._cell_sweep = self._orig
        return False


def phase_channel(tag, drv, params, setup_s, kernel, n_dofs):
    """Channel main path: ``CHANNEL_STEPS`` steps; every Newton solve
    converges, the solution is finite with the inflow enforced, every f32
    level holds the structured sweep, ``kernel`` was launched and no f32
    operator ran the general sweep."""
    import torch

    from ns_gls_tpu_torch.ops.structured import StructuredSweep

    dim = params.dim
    if drv.space.n_nodes * (dim + 1) != n_dofs:
        raise AssertionError(f"{drv.space.n_nodes * (dim + 1)} DoFs, want "
                             f"{n_dofs}")
    if not all(isinstance(op._fast, StructuredSweep) for op in drv.mg_ops):
        raise AssertionError("a channel level holds no structured sweep")
    torch.cuda.reset_peak_memory_stats()
    with GeneralSweepCount() as general:
        _, run_s, counts = run_steps(drv, CHANNEL_STEPS)
    stats = drv.step_stats
    if len(stats) != CHANNEL_STEPS:
        raise AssertionError(f"ran {len(stats)} steps, want {CHANNEL_STEPS}")
    tol = params.nonlinear_tolerance
    for i, s in enumerate(stats):
        log(f"[{tag}] step {i + 1}: {s['seconds']:.3f} s, Newton "
            f"{s['newton']} (residual {s['newton_residual']:.2e}), GMRES "
            f"{s['gmres']}")
        if not s["newton_residual"] <= tol:
            raise AssertionError(f"step {i + 1}: Newton residual "
                                 f"{s['newton_residual']:.3e} > {tol}")
    u = drv.solution.current
    if not bool(torch.isfinite(u).all()):
        raise AssertionError("non-finite channel solution")
    inflow = torch.as_tensor(drv.space.boundary_nodes([0]), device=u.device)
    if not abs(float(u[inflow, 0].max()) - 1.0) < 1e-12:
        raise AssertionError("the inflow value is not enforced")
    launches = counts[kernel]
    others = {k: v for k, v in counts.items() if k != kernel and v}
    if launches <= 0 or others:
        raise AssertionError(f"kernel launches {counts}: want {kernel} only")
    f32_general = general.calls.get(torch.float32, 0)
    if f32_general or not general.calls.get(torch.float64, 0):
        raise AssertionError(f"general sweep calls by dtype {general.calls}: "
                             "want none in f32 and some in f64")
    log(f"[{tag}] channel {dim}D degree {params.fe_degree} ref "
        f"{params.n_global_refinements}: {drv.mesh.n_cells} cells, {n_dofs} "
        f"DoFs, {len(drv.mg_ops)} GMG levels, setup {setup_s:.2f} s, "
        f"{CHANNEL_STEPS} steps in {run_s:.2f} s; max |u| "
        f"{float(u[:, :dim].abs().max()):.6g}")
    log(f"[{tag}] kernel launches {counts} ({launches / CHANNEL_STEPS:.1f} "
        f"{kernel} per step); general sweep calls: f32 {f32_general}, f64 "
        f"{general.calls[torch.float64]}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(launches=launches, stats=stats)


def phase_vmult_lane(t_start):
    """What ``bench_gpu.py`` runs (its own functions).  Each lane's
    operator is first held to the plain version at the lane's own shape,
    state and scalars (every flavor x delta mode x consider_dt, the
    lane's own combination among them; two launches bit-identical) and
    its sweep is timed there beside the plain version and the bound;
    then the kernel counts are set to 0, the lane is driven
    (``bench_gpu.measure``) and the counts are read.  Returns the
    launches by kernel name, the comparison errors {kernel name: max abs
    err} and, per lane, the measured numbers."""
    import torch

    import bench_gpu
    from ns_gls_tpu_torch.ops.structured import FLAVORS

    lanes = [(5, False, False), (5, True, False), (5, False, True),
             (5, True, True)]
    launches = {}
    errs = {}
    results = []
    worst_rel = 0.0
    for ref, increment, batched in lanes + [(6, False, False),
                                            (6, False, True)]:
        if ref == 6 and time.perf_counter() - t_start > VMULT_REF6_BEFORE_S:
            log("[12] refinement 6 left out: the script has run "
                f"{time.perf_counter() - t_start:.0f} s")
            break
        op, space, u = bench_gpu.build(3, ref, 2, increment, batched)
        n_dofs = space.n_nodes * 4
        label = (f"gls-vmult 3 {ref} 2{' --increment' if increment else ''}"
                 f"{' --batched' if batched else ''}")
        own = bench_gpu.sweep_args(op, u / torch.linalg.vector_norm(u))
        cases = [own[:5] + (flavor, cdt, cell_wise)
                 for flavor in FLAVORS for cell_wise in (True, False)
                 for cdt in (True, False)]
        if own[5:] not in [c[5:] for c in cases]:
            raise AssertionError(f"{label}: the lane's own combination "
                                 f"{own[5:]} is not among the cases")
        worst_rel = max(worst_rel,
                        compare_structured(label, cases, batched, errs))
        times = time_structured_args(12, own, batched)
        del cases, own
        reset_kernel_counts()
        res = bench_gpu.measure(op, u)
        for name, n in kernel_counts().items():
            launches[name] = launches.get(name, 0) + n
        results.append(dict(ref=ref, increment=increment, batched=batched,
                            n_dofs=n_dofs, times=times, **res))
        log(f"[12] {label}: {n_dofs} DoFs, "
            f"{n_dofs / res['apply_us']:.1f} MDoF/s, {res['apply_us']:.1f} "
            f"us/apply, sweep alone {res['sweep_us']:.1f} us, kernel "
            f"{res['kernel_us']:.1f} us, bound "
            f"{res['bound_us']:.1f} us by {res['bound_by']}")
        del op, space, u
        torch.cuda.empty_cache()
    for name in ("structured3d", "structured3d_batched"):
        if launches[name] <= 0:
            raise AssertionError(f"the gls-vmult lane did not launch {name}")
    log(f"[12] {12 * len(results)} cases vs plain at the lanes' own shapes "
        f"and state: max abs err "
        f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} }, max rel err "
        f"{worst_rel:.3e} (tol {KERNEL_REL_TOL}); relaunches bit-identical; "
        f"kernel launches while the lanes were driven {launches}")
    return launches, errs, results


# ---------------------------------------------------------------------------
# phases 13-15: the patch-3D kernel and the sphere
# ---------------------------------------------------------------------------
# the patch-3D path: the kernel, and the seam sums after it
PATCH3D_KERNELS = ("patch3d_gls_sweep", "seam_sum")


def patch3d_inputs(tables, seed=0):
    """Random node-major u, u_lin and vec_old (n_nodes, 4) on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal((tables.n_nodes, 4)),
                                 dtype=torch.float32,
                                 device=tables.jinv.device)
                 for _ in range(3))


def sweep_scalars(op):
    """The scalars the operator hands its fused sweep."""
    sw = op._fast
    return dict(weight=op._weight_host, stau=op._stau_host, nu=sw.nu,
                c1=sw.c1, c2=sw.c2)


# the (P, m) the patch-3D kernel refused before its x bricks, on synthetic
# single patches
# single patches; then the degrees the kernel gained last, each at one
# shape
PATCH3D_BRICK_SHAPES = ((1, 64), (2, 32), (3, 16), (3, 32), (4, 8), (4, 16),
                        (5, 2), (6, 2))


def synthetic_patch3d_tables(P, m, device, seed=0):
    """Patch-3D tables of one patch of m^3 cells of degree P, its geometry
    a random perturbation of the unit cube's lattice (a shape no input
    config reaches)."""
    import numpy as np

    from ns_gls_tpu_torch.ops.patch3d import make_patch3d_tables

    rng = np.random.default_rng(seed)
    NQ, XP = P + 1, P * m + 1
    # (patch, ey, entry, ez, qz, qy, ex, qx)
    jinv = 0.1 * m * rng.standard_normal((1, m, 9, m, NQ, NQ, m, NQ))
    for e in (0, 4, 8):
        jinv[:, :, e] += m
    jxw = ((1.0 + 0.2 * rng.random((1, m, m, NQ, NQ, m, NQ)))
           / (m * NQ) ** 3)
    h = np.empty((1, m, 2, m, m))
    h[:, :, 0], h[:, :, 1] = 1.0 / m, 1.0 / (m * P)
    pn = np.arange(XP ** 3, dtype=np.int64).reshape(1, XP, XP, XP)
    return make_patch3d_tables(P, NQ, m, XP ** 3, pn, jinv, jxw, h, device)


def time_patch3d_shapes(level_sets):
    """The patch-3D kernel's device time and bound at each shape of
    ``level_sets`` in the timing case of the other 3D kernels (increment,
    the history, q-wise delta); returns the numbers at the last shape."""
    from ns_gls_tpu_torch.ops import patch3d as p3
    from ns_gls_tpu_torch.utils.roofline import bound, patch3d_cost
    from ns_gls_tpu_torch.utils.timer import device_time_us

    for label, tables, sc in level_sets:
        u, ul, vo = patch3d_inputs(tables, seed=1)
        args = (tables, sc, u, ul, vo, "increment", True, False)
        dev_us = device_time_us(lambda: p3.Patch3DKernel.launch(*args),
                                "patch3d_kernel", n=20)
        bound_ms, by = bound(*patch3d_cost(tables, "increment", True, False))
        log(f"[13] {label}: P={tables.P} m={tables.m} plan "
            f"{tuple(tables.plans[('increment', True)])}: kernel device time "
            f"{dev_us:.1f} us, bound {1e3 * bound_ms:.2f} us by {by}")
    return dict(label=label, ms=dev_us / 1e3, bound_ms=bound_ms,
                bound_by=by)


def sphere_tables(ref, degree, device):
    """Patch-3D tables of the Gmsh sphere (spherical manifold on the
    sphere) refined ``ref`` times, degree ``degree``, f32, BDF-2."""
    import numpy as np
    import torch

    from ns_gls_tpu_torch.fem.constraints import AffineConstraints
    from ns_gls_tpu_torch.fem.space import FESpace
    from ns_gls_tpu_torch.mesh.core import SphericalManifold
    from ns_gls_tpu_torch.mesh.gmsh import read_msh
    from ns_gls_tpu_torch.models.sphere import MESH_FILE
    from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator
    from ns_gls_tpu_torch.ops.time_integration import BDFIntegrator

    mesh = read_msh(MESH_FILE)
    mesh.manifolds[0] = SphericalManifold(np.zeros(3))
    mesh.attach_manifold_to_boundary_id(0, 0)
    space = FESpace(mesh.refine_global(ref), degree)
    ca = AffineConstraints(space.n_nodes, 4).close(torch.float32, device)
    ti = BDFIntegrator(2)
    ti.update_dt(0.1)
    ti.update_dt(0.08)
    op = NavierStokesOperator(space, ca, ca, nu=0.02, c_1=4.0, c_2=2.0,
                              time_integrator=ti, dtype=torch.float32,
                              device=device)
    return op._fast.tables


def phase_patch3d_vs_plain(level_sets):
    """The patch-3D kernel against its plain version on every level space
    of ``level_sets`` ((label, tables, scalars)), in every flavor x delta
    mode x consider_dt; two launches on the same inputs give the same
    bits.  Returns (max abs err, max rel err)."""
    import torch

    from ns_gls_tpu_torch.ops import patch3d as p3

    worst_rel = 0.0
    worst_abs = 0.0
    n_cases = 0
    for label, tables, sc in level_sets:
        u, ul, vo = patch3d_inputs(tables)
        cases = [(tables, sc, u, ul, vo, flavor, cdt, cell_wise)
                 for flavor in p3.FLAVORS for cell_wise in (True, False)
                 for cdt in (True, False)]
        a, r = compare_cases("patch-3D", p3.Patch3DKernel.launch,
                             p3.patch3d_sweep_plain, cases)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        n_cases += len(cases)
        for case in (cases[4], cases[1]):
            x = p3.Patch3DKernel.launch(*case)
            y = p3.Patch3DKernel.launch(*case)
            torch.cuda.synchronize()
            if not torch.equal(x, y):
                raise AssertionError(f"two patch-3D launches on the same "
                                     f"inputs differ ({label})")
        log(f"[13] {label}: P={tables.P} m={tables.m} "
            f"patches={tables.jinv.shape[0]}: {len(cases)} cases ok, max "
            f"rel err {r:.3e}")
    log(f"[13] kernel vs plain: {n_cases} cases, max abs err "
        f"{worst_abs:.3e}, max rel err {worst_rel:.3e} (tol "
        f"{KERNEL_REL_TOL}); relaunches bit-identical")
    return worst_abs, worst_rel


def log_patch3d_build(level_sets, flavor, consider_dt):
    """Registers, spills and shared memory per block of the patch-3D
    kernel as built, at each degree and patch size of ``level_sets``
    under its plan in the flavor given."""
    from ns_gls_tpu_torch.ops import patch3d as p3

    seen = set()
    for _, t, _ in level_sets:
        if (t.P, t.m) in seen:
            continue
        seen.add((t.P, t.m))
        plan = t.plans[(flavor, consider_dt)]
        a = p3.Patch3DKernel.attributes(t.P, t.m, plan, flavor, consider_dt)
        log(f"[13] patch3d_kernel<{t.P}> at m={t.m}: {a['registers']} "
            f"registers, {a['spill_bytes']} B local memory (spills), "
            f"{a['static_smem']} B static + {a['dynamic_smem']} B dynamic "
            f"shared memory per block (plan {tuple(plan)}, {flavor}, "
            f"consider_dt {consider_dt})")


def phase_patch3d_sweep(tables, sc, flavor, consider_dt, cell_wise):
    """The whole sweep at ``tables``' shape: kernel then one seam-sum
    launch against the plain kernel then the plain seam sums; the seam
    sums against their plain version on the kernel's own tiles (the same
    order, so the same bits), twice.  Returns (max abs err of the seam
    sums, max rel err of the sweep)."""
    import torch

    from ns_gls_tpu_torch.ops import patch3d as p3
    from ns_gls_tpu_torch.utils import segment as sg

    u, ul, vo = patch3d_inputs(tables, seed=2)
    args = (tables, sc, u, ul, vo, flavor, consider_dt, cell_wise)
    tiles = p3.Patch3DKernel.launch(*args)
    got = sg.SeamSumKernel.launch(tables.seams, tiles.reshape(-1, 4))
    again = sg.SeamSumKernel.launch(tables.seams, tiles.reshape(-1, 4))
    plain_seams = sg.seam_sum_plain(tables.seams, tiles.reshape(-1, 4))
    ref = sg.seam_sum_plain(tables.seams,
                            p3.patch3d_sweep_plain(*args).reshape(-1, 4))
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("two seam-sum launches on the same tiles "
                             "differ")
    seam_abs = float((got - plain_seams).abs().max())
    if seam_abs > KERNEL_REL_TOL * float(plain_seams.abs().max()):
        raise AssertionError(f"seam sums vs plain: max abs err {seam_abs}")
    rel = float((got - ref).abs().max() / ref.abs().max())
    if not rel <= KERNEL_REL_TOL:
        raise AssertionError(f"patch-3D sweep vs plain sweep: rel err "
                             f"{rel:.3e} > {KERNEL_REL_TOL}")
    log(f"[13] sweep (kernel, seam sums) vs plain sweep at m={tables.m}: "
        f"max rel err {rel:.3e}; seam sums vs plain on the kernel's tiles: "
        f"max abs err {seam_abs:.3e}, relaunch bit-identical")
    return seam_abs, rel


def time_patch3d(tables, sc, flavor, consider_dt, cell_wise):
    """Kernel, seam sums, the whole sweep, the plain version and the
    bound of one patch-3D sweep at the tables' shape."""
    from ns_gls_tpu_torch.ops import patch3d as p3
    from ns_gls_tpu_torch.utils import segment as sg
    from ns_gls_tpu_torch.utils.roofline import bound, patch3d_cost

    u, ul, vo = patch3d_inputs(tables, seed=1)
    args = (tables, sc, u, ul, vo, flavor, consider_dt, cell_wise)
    tiles = p3.Patch3DKernel.launch(*args).reshape(-1, 4)
    ms = time_sweep(lambda: p3.Patch3DKernel.launch(*args))
    seam_ms = time_sweep(lambda: sg.SeamSumKernel.launch(tables.seams,
                                                         tiles))
    sweep_ms = time_sweep(lambda: sg.seam_sum(
        tables.seams, p3.patch3d_sweep(*args).reshape(-1, 4)))
    plain_ms = time_sweep(lambda: p3.patch3d_sweep_plain(*args), n=20)
    nbytes, flops = patch3d_cost(tables, flavor, consider_dt, cell_wise)
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"[13] m={tables.m} P={tables.P} {flavor} sweep (consider_dt "
        f"{consider_dt}, cell-wise {cell_wise}): kernel {ms:.4f} ms, seam "
        f"sums {seam_ms:.4f} ms, sweep {sweep_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by} "
        f"({nbytes} B, {flops} flop)")
    return dict(ms=ms, seam_ms=seam_ms, sweep_ms=sweep_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_slip(tag, drv, ids):
    """Finite solution and no flux through the slip boundaries ``ids``;
    returns the largest |u.n| there."""
    import torch

    u = drv.solution.current
    if not bool(torch.isfinite(u).all()):
        raise AssertionError(f"[{tag}] non-finite solution")
    nodes, normals = drv.space.boundary_node_normals(ids)
    d = drv.space.dim
    un = u[torch.as_tensor(nodes, device=u.device), :d]
    flux = float((un * torch.as_tensor(normals, dtype=u.dtype,
                                       device=u.device)).sum(1).abs().max())
    if not flux < SLIP_FLUX_TOL:
        raise AssertionError(f"[{tag}] slip flux {flux:.3e} on {ids}")
    return flux


def check_sphere_solution(tag, drv):
    """Finite solution; no normal flux through the slip walls (id 2), no
    velocity on the sphere (id 0).  Returns (max flux, max |u| there)."""
    import torch

    flux = check_slip(tag, drv, [2])
    u = drv.solution.current
    wall = torch.as_tensor(drv.space.boundary_nodes([0]), device=u.device)
    no_slip = float(u[wall, :3].abs().max())
    if not no_slip < NO_SLIP_TOL:
        raise AssertionError(f"[{tag}] velocity on the sphere {no_slip:.3e}")
    return flux, no_slip


def phase_sphere(tag, drv, params, setup_s, steps):
    """A sphere run of ``steps`` time steps (one stationary solve when the
    config has no time integration): every Newton solve converges, the
    boundary conditions hold, the patch-3D kernel was launched and no
    f32 level but the iso-Q1 coarsest ran the general sweep."""
    import torch

    from ns_gls_tpu_torch.ops.patch3d import Patch3DSweep

    iso = [op for op in drv.mg_ops if op.space.iso_q1]
    if not all(isinstance(op._fast, Patch3DSweep) for op in drv.mg_ops
               if not op.space.iso_q1):
        raise AssertionError("a sphere level holds no patch-3D sweep")
    torch.cuda.reset_peak_memory_stats()
    with GeneralSweepCount() as general:
        recs, run_s, counts = run_steps(drv, steps)
    stats = drv.step_stats
    if len(stats) != steps:
        raise AssertionError(f"ran {len(stats)} steps, want {steps}")
    tol = params.nonlinear_tolerance
    for i, s in enumerate(stats):
        log(f"[{tag}] step {i + 1}: {s['seconds']:.3f} s, Newton "
            f"{s['newton']} (residual {s['newton_residual']:.2e}), GMRES "
            f"{s['gmres']}")
        if not s["newton_residual"] <= tol:
            raise AssertionError(f"step {i + 1}: Newton residual "
                                 f"{s['newton_residual']:.3e} > {tol}")
    flux, no_slip = check_sphere_solution(tag, drv)
    launches = counts["patch3d_gls_sweep"]
    others = {k: v for k, v in counts.items()
              if k not in PATCH3D_KERNELS and v}
    if launches <= 0 or counts["seam_sum"] != launches or others:
        raise AssertionError(f"kernel launches {counts}: want "
                             "patch3d_gls_sweep and one seam_sum each only")
    if any(not any(op is o for o in iso) for op in general.f32_ops):
        raise AssertionError("an f32 level other than the iso-Q1 coarsest "
                             "ran the general sweep")
    n_dofs = drv.space.n_nodes * 4
    log(f"[{tag}] sphere Q{params.fe_degree} ref "
        f"{params.n_global_refinements}: {drv.mesh.n_cells} cells, {n_dofs} "
        f"DoFs, GMG levels {[op.space.n_nodes * 4 for op in drv.mg_ops]}, "
        f"setup {setup_s:.2f} s, {steps} step(s) in {run_s:.2f} s; max |u| "
        f"{float(drv.solution.current[:, :3].abs().max()):.6g}, slip flux "
        f"{flux:.2e}, velocity on the sphere {no_slip:.2e}")
    log(f"[{tag}] kernel launches {counts}; general sweep calls by dtype "
        f"{ {str(k): v for k, v in general.calls.items()} } (f32 on "
        f"{len(general.f32_ops)} iso-Q1 level(s)); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(launches=launches, seam_launches=counts["seam_sum"],
                stats=stats, n_dofs=n_dofs, recs=recs,
                u=drv.solution.current.cpu())


def phases_sphere():
    """Phases 13-15; returns the patch-3D kernel's entry of the kernel
    line (its error over phase 13, its time at the finest sphere level in
    the main path's flavor, its launches from phase 14; and the same of
    the seam sums after it) and phase 14's run for phase 19."""
    import torch

    # 13. sphere drivers set up, patch-3D kernel against plain version
    params_s = config({}, "sphere_amg.json")
    drv_s, setup_s = setup_driver(params_s)
    if drv_s.space.n_nodes * 4 != SPHERE_DOFS:
        raise AssertionError(f"{drv_s.space.n_nodes * 4} sphere DoFs, "
                             f"want {SPHERE_DOFS}")
    params_t = config({}, "sphere.json")
    drv_t, setup_t = setup_driver(params_t)
    log(f"[13] sphere_amg.json driver set up in {setup_s:.2f} s, "
        f"sphere.json in {setup_t:.2f} s")
    # the sphere_amg levels with the scalars the stationary path gives
    # them (weight 0, 1/dt 1), the transient level with BDF ones
    for op in drv_s.mg_ops:
        op.update_weight()
    level_sets = [(f"sphere_amg level {l}", op._fast.tables,
                   sweep_scalars(op))
                  for l, op in enumerate(drv_s.mg_ops)
                  if op._fast is not None]
    level_sets.append(("sphere level 0", drv_t.mg_ops[0]._fast.tables, SC3))
    # the degrees the configs do not use, on small spaces
    level_sets += [(f"sphere ref {ref} Q{degree}",
                    sphere_tables(ref, degree, "cuda"), SC_SHEAR)
                   for degree in (3, 4) for ref in (0, 1)]
    # the shapes the kernel refused before its x bricks
    brick_sets = [(f"synthetic P={P} m={m}",
                   synthetic_patch3d_tables(P, m, "cuda"), SC3)
                  for P, m in PATCH3D_BRICK_SHAPES]
    max_abs, _ = phase_patch3d_vs_plain(level_sets + brick_sets)
    high = time_patch3d_shapes(brick_sets)
    log_patch3d_build(brick_sets, "increment", True)
    del brick_sets
    fine = drv_s.mg_ops[-1]
    path = ("increment", fine.consider_time_derivative,
            fine.cell_wise_stabilization)
    log_patch3d_build(level_sets, *path[:2])
    seam_abs, _ = phase_patch3d_sweep(fine._fast.tables, sweep_scalars(fine),
                                      *path)
    t = time_patch3d(fine._fast.tables, sweep_scalars(fine), *path)
    del level_sets, fine

    # 14. sphere main path
    sph = phase_sphere(14, drv_s, params_s, setup_s, 1)
    del drv_s
    torch.cuda.empty_cache()

    # 15. transient sphere
    phase_sphere(15, drv_t, params_t, setup_t, SPHERE_STEPS)
    return sph, dict(
        name="patch3d_gls_sweep",
        route="cuda",
        source="ns_gls_tpu_torch/csrc/patch3d.cu",
        replaces="ns_gls_tpu/ops/patch3d.py:260",
        launches=sph["launches"],
        max_abs_err=max_abs,
        ms=t["ms"],
        plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"],
        bound_by=t["bound_by"],
        library_ms=None,
        # the sweep's seam sums: one launch after each kernel launch
        seam_sum_source="ns_gls_tpu_torch/csrc/seam_sum.cu",
        seam_sum_launches=sph["seam_launches"],
        seam_sum_max_abs_err=seam_abs,
        seam_sum_ms=t["seam_ms"],
        sweep_ms=t["sweep_ms"],
        # the last degree built (P = 6) at its one shape of phase 13
        p6=high,
    )


# ---------------------------------------------------------------------------
# phases 16-17: the weak outflow (Hoffmann/ReInf) and the general sweep's
# scatter order
# ---------------------------------------------------------------------------
# 2 steps of ~1,800-2,000 GMRES iterations each (5 before the solver-stack
# phase 18 came; every check is the same)
HOFFMANN_STEPS = 2
HOFFMANN_DOFS = 17592
# the stored JAX series of the Q1 refinement-1 configuration: the port on a
# CPU meets it to 2.7e-10 of the solution's max-abs (tests/test_torch_
# outflow.py); the card, with its own power-iteration start vectors and the
# patch-2D kernel's f32 sums, is held to the functionals' 1e-6 relative
HOFFMANN_SERIES_TOL = 1e-6


class BoundarySweepCount:
    """Counts the calls of the weak-outflow face sweep by operator while
    it is installed."""

    def __init__(self):
        self.calls = []          # (operator, calls)

    def count(self, op) -> int:
        return next((n for o, n in self.calls if o is op), 0)

    def __enter__(self):
        from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator

        self._cls = NavierStokesOperator
        self._orig = orig = NavierStokesOperator._boundary_sweep
        calls = self.calls

        def counted(op, *a, **kw):
            for i, (o, n) in enumerate(calls):
                if o is op:
                    calls[i] = (o, n + 1)
                    break
            else:
                calls.append((op, 1))
            return orig(op, *a, **kw)

        NavierStokesOperator._boundary_sweep = counted
        return self

    def __exit__(self, *exc):
        self._cls._boundary_sweep = self._orig
        return False


def check_converged(tag, drv, params):
    """Every step's Newton solve ended by the solver's own criteria: below
    the tolerance, or accepted at its f32 floors (the solver raises on
    anything else)."""
    tol = params.nonlinear_tolerance
    for i, s in enumerate(drv.step_stats):
        log(f"[{tag}] step {i + 1}: {s['seconds']:.3f} s, Newton "
            f"{s['newton']} (residual {s['newton_residual']:.2e}"
            f"{'' if s['newton_residual'] <= tol else ', accepted at the f32 floor'}"
            f"), GMRES {s['gmres']}")
        if not math.isfinite(s["newton_residual"]):
            raise AssertionError(f"[{tag}] step {i + 1}: Newton residual "
                                 f"{s['newton_residual']}")


def phase_hoffmann():
    """``input/hoffmann_2d_reinf.json`` as given (Q2, refinement 2, u max
    39, nu = 0, BDF-2, inexact Newton, Nitsche outflow, GMG on f32
    patch-2D levels, direct coarse solve) for ``HOFFMANN_STEPS`` steps;
    then the Q1 refinement-1 configuration against the JAX package's
    stored series where it exists.  Returns the main path's patch-2D
    launches and the driver."""
    import torch

    from ns_gls_tpu_torch.ops.patch2d import Patch2DSweep

    params = config({}, "hoffmann_2d_reinf.json")
    drv, setup_s = setup_driver(params)
    n_dofs = drv.space.n_nodes * 3
    if n_dofs != HOFFMANN_DOFS:
        raise AssertionError(f"{n_dofs} Hoffmann DoFs, want {HOFFMANN_DOFS}")
    if not all(isinstance(op._fast, Patch2DSweep) for op in drv.mg_ops):
        raise AssertionError("a Hoffmann GMG level holds no patch-2D sweep")
    ops = [drv.op] + list(drv.mg_ops)
    if not all(op.needs_face_integrals and op.face_blocks for op in ops):
        raise AssertionError("a Hoffmann level has no weak outflow faces")
    with BoundarySweepCount() as faces:
        recs, run_s, counts = run_steps(drv, HOFFMANN_STEPS)
    if len(drv.step_stats) != HOFFMANN_STEPS:
        raise AssertionError(f"ran {len(drv.step_stats)} steps")
    check_converged(16, drv, params)
    for r in recs:
        for k in ("drag", "lift", "p_diff"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"[16] non-finite {k} at t={r['t']}")
    flux = max(check_slip(16, drv, [2]), check_slip(16, drv, [3, 4]))
    launches = counts["patch2d_gls_sweep"]
    others = {k: n for k, n in counts.items()
              if n and k not in ("patch2d_gls_sweep", "seam_sum")}
    if launches <= 0 or counts["seam_sum"] != launches or others:
        raise AssertionError(f"Hoffmann path launches {counts}: want "
                             "patch2d_gls_sweep, one seam sum each, nothing "
                             "else")
    per_level = [faces.count(op) for op in ops]
    if min(per_level) <= 0:
        raise AssertionError(f"face sweep calls per level {per_level}: "
                             "want the face sweep on every level")
    stats = drv.step_stats
    steady = [s["seconds"] for s in stats[1:]]
    log(f"[16] Hoffmann/ReInf Q{params.fe_degree} ref "
        f"{params.n_global_refinements}: {drv.mesh.n_cells} cells, {n_dofs} "
        f"DoFs, GMG levels {[op.space.n_nodes * 3 for op in drv.mg_ops]} "
        f"(patch-2D m = {[op._fast.m for op in drv.mg_ops]}), setup "
        f"{setup_s:.2f} s, {HOFFMANN_STEPS} steps in {run_s:.2f} s; "
        f"seconds per step after the first (steps 2-{HOFFMANN_STEPS}) "
        f"{sum(steady) / len(steady):.4f}; Newton "
        f"{[s['newton'] for s in stats]}, GMRES {[s['gmres'] for s in stats]}"
        f"; slip flux {flux:.2e}")
    log(f"[16] kernel launches {counts} ({launches / HOFFMANN_STEPS:.1f} "
        f"patch-2D per step); face sweep calls fine, then levels coarse to "
        f"fine: {per_level[0]}, {per_level[:0:-1]}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    path = os.path.join(ROOT, "validation",
                        "hoffmann_2d_reinf_ref1_q1_series.json")
    if os.path.exists(path):
        with open(path) as f:
            ser = json.load(f)
        for name, ref in ser["variants"].items():
            from ns_gls_tpu_torch.config import Parameters

            prm = Parameters.from_dict(ser["config"] | ref["overrides"])
            d2, recs2, _, run2_s, c2 = run_driver(prm, ref["steps"])
            worst = check_series(f"16 {name}", recs2, ref["series"],
                                 HOFFMANN_SERIES_TOL)
            check_converged(f"16 {name}", d2, prm)
            check_slip(f"16 {name}", d2, [2])
            u_ref = torch.as_tensor(ref["solution"], dtype=torch.float64,
                                    device="cuda")
            gap = float((d2.solution.current - u_ref).abs().max()
                        / u_ref.abs().max())
            log(f"[16] Q1 ref 1 {name}: {ref['steps']} steps in "
                f"{run2_s:.2f} s, Newton "
                f"{[s['newton'] for s in d2.step_stats]} (JAX "
                f"{ref['newton']}), GMRES "
                f"{[s['gmres'] for s in d2.step_stats]} (JAX "
                f"{ref['gmres']}); max functional gap {worst:.3e} (tol "
                f"{HOFFMANN_SERIES_TOL:.0e}); solution gap {gap:.3e} of the "
                f"JAX max-abs; launches {c2}")
    return dict(launches=launches, seam_launches=counts["seam_sum"],
                stats=stats), drv


# ---------------------------------------------------------------------------
# phase 17: the rotation slice
# ---------------------------------------------------------------------------
# 17.2-17.4: input/rotation.json as given (refinement 3, GMG-LS), at
# refinement 6, and under GMG (the several-family path)
ROTATION_STEPS = 5
ROTATION6 = {"n global refinements": 6}
ROTATION6_STEPS = 3
ROTATION6_NODES = 18688
ROTATION6_LEVELS = 8
ROTATION_GMG_STEPS = 3
# the JAX package's tests/test_rotation.py: the inner ring's tangential
# velocity is its radius
INNER_RING_RTOL = 1e-8
# 17.5: stationary Couette flow (the JAX package's tests/test_couette.py),
# u_theta against (1/r - r) / 15 for 0.4 < r < 0.8 within that test's own
# tolerance
COUETTE = {
    "dim": 2, "fe degree": 2, "mapping degree": 0,
    "n global refinements": 1, "simulation name": "rotation",
    "time intration": "none", "c1": 2.0, "c2": 0.0, "nu": 6.25,
    "consider time derivative": False, "cell wise stabilization": False,
    "lin absolute tolerance": 1e-10, "lin relative tolerance": 1e-6,
    "gmg coarse grid solver": "direct",
    "gmg constraint coarse pressure dof": True,
    "nonlinear solver": "Newton", "output granularity": 0.0,
    "paraview prefix": "",
}
COUETTE_TOL = 5e-3


def adaptive_q2_mesh():
    """The JAX package's ``tests/test_patch2d.py`` ``adaptive_mesh``: a
    3 x 2 rectangle refined once, then its left half once more (patch
    families m = 1, 2, 4)."""
    from ns_gls_tpu_torch.mesh.generators import subdivided_hyper_rectangle

    m = subdivided_hyper_rectangle((3, 2), (0.0, 0.0), (1.1, 0.9))
    m.lattice = None
    m = m.refine_global(1)
    c = m.vertices[m.cells].mean(1)
    return m.refine(c[:, 0] < 0.5)


def family_table_sets(device):
    """(label, several-family patch-2D tables): the rotation mesh's finest
    GMG level (its final mesh, Q1) at refinements 3 and 6, and the Q2
    adaptive rectangle."""
    from ns_gls_tpu_torch.models.rotation import SimulationRotation

    sim = SimulationRotation(2)
    out = [(f"rotation ref {ref} finest GMG level",
            patch2d_operator(sim.create_mesh(ref), 1, device)._fast.tables)
           for ref in (3, 6)]
    out.append(("Q2 adaptive rectangle",
                patch2d_operator(adaptive_q2_mesh(), 2, device)._fast.tables))
    for label, ft in out:
        if len(ft.fams) < 2:
            raise AssertionError(f"{label}: one patch family, want several")
    return out


def phase_family_sweep(label, ft, flavor="increment", consider_dt=True,
                       cell_wise=False):
    """The whole sweep on several families (one kernel launch a family,
    each into its range of one tile buffer, then one seam sum) against
    the plain sweeps and plain seam sums; its launches counted by the
    wrappers; its device time as its kernels' mean times within it.
    Returns (launches an apply, max abs err)."""
    import torch

    from ns_gls_tpu_torch.ops import patch2d as p2
    from ns_gls_tpu_torch.utils import segment as sg
    from ns_gls_tpu_torch.utils.timer import device_time_us

    u, ul, vo = patch2d_inputs(ft, seed=1)
    args = (ft, SC, u, ul, vo, flavor, consider_dt, cell_wise)
    k0, s0 = launch_count("patch2d_gls_sweep"), launch_count("seam_sum")
    tiles = p2.patch2d_tiles(*args)
    got = sg.seam_sum(ft.seams, tiles)
    n_k = launch_count("patch2d_gls_sweep") - k0
    n_s = launch_count("seam_sum") - s0
    plain_tiles = torch.cat([
        p2.patch2d_sweep_plain(t, SC, u, ul, vo, flavor, consider_dt,
                               cell_wise).reshape(-1, 3) for t in ft.fams])
    ref = sg.seam_sum_plain(ft.seams, plain_tiles)
    plain_seams = sg.seam_sum_plain(ft.seams, tiles)
    torch.cuda.synchronize()
    if not torch.equal(got, plain_seams):
        raise AssertionError(f"[17] {label}: the seam sums differ from "
                             "their plain version")
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not rel <= KERNEL_REL_TOL:
        raise AssertionError(f"[17] {label}: several-family sweep vs plain "
                             f"sweep rel err {rel:.3e} > {KERNEL_REL_TOL}")

    def sweep():
        return sg.seam_sum(ft.seams, p2.patch2d_tiles(*args))

    want = len(ft.fams) + 1
    if (n_k, n_s) != (len(ft.fams), 1):
        raise AssertionError(
            f"[17] {label}: {n_k} kernel and {n_s} seam-sum launches an "
            f"apply; want {len(ft.fams)} and 1")
    us = (n_k * device_time_us(sweep, "patch2d_kernel", per_call=n_k)
          + device_time_us(sweep, "seam_sum_kernel"))
    log(f"[17] {label}: families m = {[t.m for t in ft.fams]} (patches "
        f"{[t.jinv.shape[0] for t in ft.fams]}), {ft.n_nodes} nodes; whole "
        f"{flavor} sweep vs plain: max rel err {rel:.3e}; {want} launches an "
        f"apply ({len(ft.fams)} kernels, 1 seam sum), {us:.3f} us of device "
        f"time; seam sums bit-identical to their plain version")
    return want, err


class Patch2DApplies:
    """While installed: for each operator given, the kernel and seam-sum
    launches of every apply of its fused patch-2D sweep."""

    def __init__(self, ops):
        self.ops = list(ops)
        self.applies = [[] for _ in self.ops]   # per op: (kernels, seams)

    def launches(self, i):
        return sum(k for k, _ in self.applies[i])

    def __enter__(self):
        for op, rec in zip(self.ops, self.applies):
            def counted(*a, apply=op._fast.apply, rec=rec, **kw):
                k0 = launch_count("patch2d_gls_sweep")
                s0 = launch_count("seam_sum")
                out = apply(*a, **kw)
                rec.append((launch_count("patch2d_gls_sweep") - k0,
                            launch_count("seam_sum") - s0))
                return out

            op._fast.apply = counted
        return self

    def __exit__(self, *exc):
        for op in self.ops:
            del op._fast.apply
        return False


def check_inner_ring(tag, drv):
    """The inner ring rotates rigidly: u_theta = r there."""
    import numpy as np

    u = drv.solution.current.cpu().numpy()
    if not np.isfinite(u).all():
        raise AssertionError(f"[{tag}] non-finite solution")
    pos = drv.space.node_pos
    r = np.linalg.norm(pos, axis=1)
    inner = r < r.min() + 1e-8
    uth = (-pos[:, 1] * u[:, 0] + pos[:, 0] * u[:, 1]) / r
    gap = float(np.abs(uth[inner] - r.min()).max() / r.min())
    if not gap <= INNER_RING_RTOL:
        raise AssertionError(f"[{tag}] inner ring u_theta vs r: rel gap "
                             f"{gap:.3e} > {INNER_RING_RTOL}")
    return gap


def phase_rotation(tag, params, steps, ls=True, n_nodes=None, n_levels=None):
    """``steps`` steps of the rotation case through ``Driver.run``: every
    Newton solve converges, the solution is finite, the inner ring
    rotates rigidly, every f32 level that the cycle applies launched the
    patch-2D kernel (under GMG-LS the coarse level is the dense LU and is
    never applied), each apply n_families kernels and one seam sum, no
    f32 operator ran the general sweep and no other fused kernel ran.
    Returns the driver, the patch-2D launches and the finest f32 level's
    launches an apply."""
    import torch

    from ns_gls_tpu_torch.ops.patch2d import Patch2DSweep

    drv, setup_s = setup_driver(params)
    want = "PreconditionerGMGLS" if ls else "PreconditionerGMG"
    if type(drv.preconditioner).__name__ != want:
        raise AssertionError(f"[{tag}] preconditioner "
                             f"{type(drv.preconditioner).__name__}, want "
                             f"{want}")
    if n_nodes is not None and drv.space.n_nodes != n_nodes:
        raise AssertionError(f"[{tag}] {drv.space.n_nodes} nodes, want "
                             f"{n_nodes}")
    if n_levels is not None and len(drv.mg_ops) != n_levels:
        raise AssertionError(f"[{tag}] {len(drv.mg_ops)} levels, want "
                             f"{n_levels}")
    if not all(isinstance(op._fast, Patch2DSweep) for op in drv.mg_ops):
        raise AssertionError(f"[{tag}] a level holds no patch-2D sweep")
    with GeneralSweepCount() as general, \
            Patch2DApplies(drv.mg_ops) as applies:
        _, run_s, counts = run_steps(drv, steps)
    stats = drv.step_stats
    if len(stats) != steps:
        raise AssertionError(f"[{tag}] ran {len(stats)} steps, want {steps}")
    tol = params.nonlinear_tolerance
    for i, st in enumerate(stats):
        log(f"[{tag}] step {i + 1}: {st['seconds']:.3f} s, Newton "
            f"{st['newton']} (residual {st['newton_residual']:.2e}), GMRES "
            f"{st['gmres']}")
        if not st["newton_residual"] <= tol:
            raise AssertionError(f"[{tag}] step {i + 1}: Newton residual "
                                 f"{st['newton_residual']:.3e} > {tol}")
    gap = check_inner_ring(tag, drv)
    first = 1 if ls else 0
    per_level = [applies.launches(i) for i in range(len(drv.mg_ops))]
    if min(per_level[first:]) <= 0:
        raise AssertionError(f"[{tag}] patch-2D launches per level "
                             f"{per_level}: want some on every applied "
                             "level")
    for i, op in enumerate(drv.mg_ops):
        n_fam = len(op._fast.tables.fams)
        bad = [a for a in applies.applies[i] if a != (n_fam, 1)]
        if bad:
            raise AssertionError(f"[{tag}] level {i}: applies launched "
                                 f"{bad[:3]}, want ({n_fam}, 1)")
    f32_general = general.calls.get(torch.float32, 0)
    if f32_general or not general.calls.get(torch.float64, 0):
        raise AssertionError(f"[{tag}] general sweep calls by dtype "
                             f"{general.calls}: want none in f32")
    launches = counts["patch2d_gls_sweep"]
    others = {k: n for k, n in counts.items()
              if n and k not in ("patch2d_gls_sweep", "seam_sum")}
    if launches != sum(per_level) or others:
        raise AssertionError(f"[{tag}] launches {counts}, by level "
                             f"{per_level}")
    fin = drv.mg_ops[-1]._fast
    per_apply = len(fin.tables.fams) + 1
    log(f"[{tag}] rotation Q{params.fe_degree} ref "
        f"{params.n_global_refinements} under {params.preconditioner}: "
        f"{drv.mesh.n_cells} cells, {drv.space.n_nodes * 3} DoFs, levels "
        f"(nodes) {[op.space.n_nodes for op in drv.mg_ops]} with families "
        f"m = {[[t.m for t in op._fast.tables.fams] for op in drv.mg_ops]}; "
        f"setup {setup_s:.2f} s, {steps} steps in {run_s:.2f} s "
        f"({run_s / steps:.3f} s a step); Newton "
        f"{[st['newton'] for st in stats]}, GMRES "
        f"{[st['gmres'] for st in stats]}; inner ring rel gap {gap:.1e}")
    log(f"[{tag}] patch-2D launches by level, coarse to fine: {per_level}"
        + (" (level 0: the dense LU, never applied)" if ls else "")
        + f"; {per_apply} launches an apply on the finest f32 level; "
        f"kernel launches {counts}; general sweep calls: f32 0, f64 "
        f"{general.calls[torch.float64]}")
    return drv, launches, per_apply


def phase_couette(preconditioner):
    """Stationary Couette flow under ``preconditioner``: u_theta against
    the analytic solution.  Returns (max error, patch-2D launches)."""
    import numpy as np

    from ns_gls_tpu_torch.config import Parameters

    params = Parameters.from_dict(COUETTE | {"preconditioner":
                                             preconditioner})
    drv, setup_s = setup_driver(params)
    reset_kernel_counts()
    t0 = time.perf_counter()
    drv.run()
    run_s = time.perf_counter() - t0
    counts = kernel_counts()
    st = drv.step_stats[-1]
    if not st["newton_residual"] <= params.nonlinear_tolerance:
        raise AssertionError(f"[17] Couette {preconditioner}: Newton "
                             f"residual {st['newton_residual']:.3e}")
    u = drv.solution.current.cpu().numpy()
    r = np.linalg.norm(drv.space.node_pos, axis=1)
    sel = (r > 0.4) & (r < 0.8)
    pos, rr = drv.space.node_pos[sel], r[sel]
    t_hat = np.stack([-pos[:, 1] / rr, pos[:, 0] / rr], axis=1)
    u_theta = (u[sel, :2] * t_hat).sum(axis=1)
    err = float(np.abs(u_theta - (1.0 / rr - rr) / 15.0).max())
    if not err < COUETTE_TOL:
        raise AssertionError(f"[17] Couette {preconditioner}: max |u_theta "
                             f"- exact| {err:.3e} >= {COUETTE_TOL}")
    if counts["patch2d_gls_sweep"] <= 0:
        raise AssertionError(f"[17] Couette {preconditioner}: no patch-2D "
                             "launch")
    log(f"[17] Couette Q2 ref 1 under {preconditioner}: "
        f"{drv.space.n_nodes * 3} DoFs, setup {setup_s:.2f} s, solve "
        f"{run_s:.2f} s, Newton "
        f"{st['newton']}, GMRES {st['gmres']}; max |u_theta - (1/r - r)/15|"
        f" over 0.4 < r < 0.8: {err:.3e} (tol {COUETTE_TOL}); launches "
        f"{counts}")
    return err, counts["patch2d_gls_sweep"]


def phase_rotation_slice():
    """Phase 17: the patch-2D kernel on several-family tables, the rotation
    paths through the driver and Couette flow.  Returns the kernel line's
    additions to the patch-2D entry."""
    import torch

    t_phase = time.perf_counter()
    sets = family_table_sets("cuda")
    max_abs, _ = phase_kernel_vs_plain(sets, tag=17)
    for label, ft in sets:
        _, err = phase_family_sweep(label, ft)
        max_abs = max(max_abs, err)
    del sets

    # 17.2 input/rotation.json as given
    params = config({}, "rotation.json")
    drv, launches, _ = phase_rotation("17", params, ROTATION_STEPS)
    del drv
    # 17.3 refinement 6; the kernel's time at its m = 1 forest level of
    # 16,384 patches, in the path's flavor (increment, the BDF history,
    # q-wise delta)
    params6 = config(ROTATION6, "rotation.json")
    drv6, l6, _ = phase_rotation("17", params6, ROTATION6_STEPS,
                                 n_nodes=ROTATION6_NODES,
                                 n_levels=ROTATION6_LEVELS)
    t16 = next(op._fast.tables for op in drv6.mg_ops
               if op._fast.tables.fams[0].jinv.shape[0] == 16384)
    m1 = phase_patch2d_sweep(t16, "increment", True, False, tag=17)
    del drv6, t16
    torch.cuda.empty_cache()
    # 17.4 under GMG: the several-family path in the driver
    params_g = config({"preconditioner": "GMG"}, "rotation.json")
    drv_g, lg, per_apply = phase_rotation("17", params_g, ROTATION_GMG_STEPS,
                                          ls=False)
    if per_apply < 3:
        raise AssertionError(f"[17] GMG finest level: {per_apply} launches "
                             "an apply, want several families")
    del drv_g
    # 17.5 Couette under both flavors
    c_ls, lc1 = phase_couette("GMG-LS")
    c_gc, lc2 = phase_couette("GMG")
    log(f"[17] rotation phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(max_abs=max_abs,
                launches=launches + l6 + lg + lc1 + lc2,
                m1=m1, per_apply=per_apply, couette=(c_ls, c_gc))


# ---------------------------------------------------------------------------
# phase 18: the solver stack (Picard, linearized, Richardson, ILU, AMG with
# its ILU smoother, the matrix-based operator, checkpoints)
# ---------------------------------------------------------------------------
PICARD_STEPS = 3
# Picard solves for the whole solution at every iteration, so its
# increment cannot fall below the linear tolerance times the solution:
# with the config's 1e-2 the increments stall near 1e-2 of ||u|| and the
# iteration fails (the port at refinement 1 on a CPU, tools/
# compare_runs.py: increments near 1e-2 for 31 iterations, then the
# solver raises; the JAX iteration is the same).  Its runs here solve to
# 1e-12, where the absolute criterion of 1e-7 is met (refinements 1 and 2
# on a CPU, tools/compare_runs.py: 10-11 iterations a step), so the
# relative mode is not needed.
PICARD_LIN_TOL = 1e-12
# the Picard step-3 solution against phase 4's Newton run at step 3: the
# JAX package's Picard iteration (copied) does not converge to Newton's
# root, so the gap is set by the formulation, not by the tolerances: on a
# CPU (tools/compare_runs.py) at refinement 1 it is 4.791e-4 with both
# solvers as here and
# 4.791e-4 with both tightened a thousandfold (Newton to 1e-11 with
# linear tolerance 1e-12, Picard to 1e-10 with 1e-13); at refinement 2
# 2.353e-4, half of it (ROADMAP queue 3).  The bound is twice the larger
# of the two, rounded up
PICARD_NEWTON_GAP = 1e-3
ILU_STEPS = 3
# the matrix-based and matrix-free linearized runs agree to 1e-7 (the
# tolerance of the JAX package's tests/test_e2e.py:87-101) only when both
# linear solves converge far below it: at the config's 1e-2 they differ
# by the solve tolerance (relative l2 2.0e-5 on a CPU), at 1e-13 by
# 6.0e-10 (max abs; CPU, tools/compare_runs.py)
MB_LIN_TOL = 1e-13
MB_STEPS = 2
MB_ABS_TOL = 1e-7
# standalone AMG with the ILU smoother under Picard: tight enough linear
# solves for Picard (1e-6) and its relative criterion (1e-7 of ||u||; the
# absolute one sits below the solve noise on a solution of norm ~8e3);
# 4 Picard iterations, 1,948 GMRES on a CPU (tools/compare_runs.py)
AMG_ILU = {"preconditioner": "AMG", "amg smoother": "ilu",
           "nonlinear solver": "Picard", "lin relative tolerance": 1e-6,
           "nonlinear tolerance relative": True}
CHECKPOINT_STEPS = 4
CHECKPOINT_TOL = 1e-12


class LaunchFlavors:
    """Counts the flavors a kernel wrapper is asked for while installed
    (the launches themselves are the wrapper's own count)."""

    def __init__(self, cls):
        self.cls = cls
        self.flavors = {}

    def __enter__(self):
        self._attr = self.cls.__dict__["launch"]
        orig = self.cls.launch
        flavors = self.flavors

        def launch(tables, sc, u, ul, vo, flavor, *a, **kw):
            flavors[flavor] = flavors.get(flavor, 0) + 1
            return orig(tables, sc, u, ul, vo, flavor, *a, **kw)

        self.cls.launch = launch
        return self

    def __exit__(self, *exc):
        self.cls.launch = self._attr
        return False


def check_solves(tag, drv, tol=None):
    """Every step's nonlinear solve ended by the solver's own criteria
    (the solvers raise on anything else), its last residual or increment
    at most ``tol`` where given, and the solution is finite."""
    import torch

    for i, s in enumerate(drv.step_stats):
        log(f"[{tag}] step {i + 1}: {s['seconds']:.3f} s, nonlinear "
            f"{s['newton']} (last residual or increment "
            f"{s['newton_residual']:.3e}), linear {s['gmres']}")
        if tol is not None and not s["newton_residual"] <= tol:
            raise AssertionError(f"[{tag}] step {i + 1}: not converged")
    if not bool(torch.isfinite(drv.solution.current).all()):
        raise AssertionError(f"[{tag}] non-finite solution")


def solver_run(tag, overrides, name, steps, device="cuda"):
    """A driver on ``input/<name>`` with ``overrides`` for ``steps``
    steps through ``Driver.run``, output off, every kernel count set to
    0 just before and read just after: (driver, seconds, counts)."""
    params = config(overrides, name)
    if device == "cuda":
        drv, setup_s = setup_driver(params)
        _, run_s, counts = run_steps(drv, steps)
    else:
        from ns_gls_tpu_torch.driver import Driver

        drv = Driver(params, device="cpu")
        t0 = time.perf_counter()
        drv.run(max_steps=steps)
        setup_s, run_s, counts = 0.0, time.perf_counter() - t0, {}
    log(f"[{tag}] {name} {overrides} on {device}: setup {setup_s:.2f} s, "
        f"{steps} steps in {run_s:.2f} s")
    return drv, params, run_s, counts


def phase_solver_stack(newton_step3):
    """Phase 18.  ``newton_step3``: phase 4's Newton solution after step
    3.  Returns the launches of the fused kernels on these paths."""
    import tempfile

    import torch

    from ns_gls_tpu_torch.ops.patch2d import Patch2DKernel
    from ns_gls_tpu_torch.ops.structured import StructuredKernel

    t_phase = time.perf_counter()
    out = {}
    # 18.1 Picard at full width: the patch-2D kernel in its fixed flavor
    log(f"[18] Picard on turek_2d_re100.json: linear tolerance "
        f"{PICARD_LIN_TOL}, held to phase 4's Newton step 3 within "
        f"{PICARD_NEWTON_GAP} (relative l2)")
    with LaunchFlavors(Patch2DKernel) as fl:
        drv, params, run_s, counts = solver_run(
            "18", {"nonlinear solver": "Picard",
                   "lin relative tolerance": PICARD_LIN_TOL},
            "turek_2d_re100.json", PICARD_STEPS)
    check_solves("18", drv, params.nonlinear_tolerance)
    launches = counts["patch2d_gls_sweep"]
    others = {k: n for k, n in counts.items()
              if n and k not in ("patch2d_gls_sweep", "seam_sum")}
    if (launches <= 0 or counts["seam_sum"] != launches or others
            or fl.flavors != {"fixed": launches}):
        raise AssertionError(f"[18] Picard launches {counts}, flavors "
                             f"{fl.flavors}: want the patch-2D kernel in "
                             f"its fixed flavor, one seam sum each, "
                             f"nothing else")
    u = drv.solution.current
    gap = float(torch.linalg.vector_norm(u - newton_step3)
                / torch.linalg.vector_norm(newton_step3))
    log(f"[18] Picard: {launches} patch-2D launches, all fixed flavor; "
        f"step-3 gap to Newton {gap:.3e} (bound {PICARD_NEWTON_GAP}), "
        f"{run_s:.2f} s")
    if not gap <= PICARD_NEWTON_GAP:
        raise AssertionError(f"[18] Picard vs Newton {gap:.3e}")
    out["picard_fixed_launches"] = launches
    del drv, u

    # 18.2 the reference's default preconditioner, on the card and on
    # the CPU
    d_cuda, params, run_s, _ = solver_run(
        "18", {"preconditioner": "ILU"}, "channel.json", ILU_STEPS)
    check_solves("18", d_cuda)
    # the CPU's run at one thread: its sums in a fixed order
    from ns_gls_tpu_torch.utils.device import torch_threads

    with torch_threads(1):
        d_cpu, _, _, _ = solver_run("18", {"preconditioner": "ILU"},
                                    "channel.json", ILU_STEPS, device="cpu")
    card = [(s["newton"], s["gmres"]) for s in d_cuda.step_stats]
    host = [(s["newton"], s["gmres"]) for s in d_cpu.step_stats]
    if any(abs(a - b) > 1 for x, y in zip(card, host)
           for a, b in zip(x, y)) or len(card) != len(host):
        raise AssertionError(f"[18] ILU (Newton, GMRES) per step: card "
                             f"{card}, CPU {host}")
    pre = d_cuda.preconditioner
    step_s = sum(s["seconds"] for s in d_cuda.step_stats)
    log(f"[18] ILU: (Newton, GMRES) per step card {card}, CPU {host}; "
        f"{pre.n_applies} host applies, {pre.apply_seconds / pre.n_applies:.6f}"
        f" s each (the copies and the card's wait included), "
        f"{pre.apply_seconds:.3f} s of {step_s:.3f} s of steps "
        f"({100 * pre.apply_seconds / step_s:.1f}%)")
    out["ilu_apply_s"] = pre.apply_seconds / pre.n_applies
    out["ilu_share"] = pre.apply_seconds / step_s
    del d_cuda, d_cpu, pre

    # 18.3 the matrix-based operator against the matrix-free one
    lin = {"nonlinear solver": "linearized",
           "lin relative tolerance": MB_LIN_TOL}
    d_mb, params, _, _ = solver_run(
        "18", lin | {"use matrix free ns operator": False}, "channel.json",
        MB_STEPS)
    check_solves("18", d_mb)
    d_mf, _, _, _ = solver_run("18", lin, "channel.json", MB_STEPS)
    diff = float((d_mb.solution.current - d_mf.solution.current).abs().max())
    log(f"[18] matrix-based vs matrix-free linearized: max abs diff "
        f"{diff:.3e} (tol {MB_ABS_TOL})")
    if not diff <= MB_ABS_TOL:
        raise AssertionError(f"[18] matrix-based vs matrix-free {diff:.3e}")
    del d_mb, d_mf

    # 18.4 standalone AMG with its ILU smoother, Picard
    d_amg, params, _, _ = solver_run("18", AMG_ILU, "channel.json", 1)
    check_solves("18", d_amg)
    log(f"[18] AMG with the ILU smoother: levels "
        f"{d_amg.preconditioner.level_sizes}")
    del d_amg

    # 18.5 Richardson and 18.6 the ILU coarse solver, under GMG on the
    # 2D structured kernel
    for key, over in (("richardson", {"linear solver": "Richardson"}),
                      ("ilu_coarse", {"gmg coarse grid solver": "ILU"})):
        drv, params, _, counts = solver_run("18", over, "channel.json", 1)
        check_solves("18", drv)
        n = counts["structured2d"]
        if n <= 0:
            raise AssertionError(f"[18] {key}: the 2D structured kernel "
                                 f"was not launched ({counts})")
        log(f"[18] {key}: {n} structured2d launches")
        out[f"{key}_launches"] = n
    del drv

    # 18.7 checkpoint and resume: 4 steps against 2 checkpointed steps and
    # a fresh driver resumed to step 4
    with tempfile.TemporaryDirectory() as tmp:
        ck = {"checkpoint prefix": os.path.join(tmp, "turek"),
              "checkpoint granularity": 1e-6}
        whole, _, _, _ = solver_run("18", {}, "turek_2d_re100.json",
                                    CHECKPOINT_STEPS)
        first, _, _, _ = solver_run("18", ck, "turek_2d_re100.json", 2)
        params = config(ck, "turek_2d_re100.json")
        resumed, _ = setup_driver(params)
        t0 = time.perf_counter()
        resumed.run(max_steps=CHECKPOINT_STEPS, resume=True)
        torch.cuda.synchronize()
        log(f"[18] resumed at cycle 3, {len(resumed.step_stats)} steps in "
            f"{time.perf_counter() - t0:.2f} s")
    diff = float((resumed.solution.current
                  - whole.solution.current).abs().max())
    equal = torch.equal(resumed.solution.current, whole.solution.current)
    log(f"[18] checkpoint: resumed vs uninterrupted max abs diff {diff:.3e} "
        f"(tol {CHECKPOINT_TOL}), bit-equal {equal}")
    if len(resumed.step_stats) != CHECKPOINT_STEPS - 2 \
            or not diff <= CHECKPOINT_TOL:
        raise AssertionError(f"[18] checkpoint resume {diff:.3e}")
    del whole, first, resumed
    torch.cuda.empty_cache()
    log(f"[18] solver-stack phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 19: sharding (``ns_gls_tpu_torch/parallel/``) on one card
# ---------------------------------------------------------------------------
# four shards on the one card: the layouts, the exchanges, each shard's
# fused kernel and the distributed V-cycle all run on it (two ranks of
# NCCL cannot share a card, so one process drives the shards)
SHARDS = 4
SHARD_DEVICES = ["cuda:0"] * SHARDS
SHARD_2D_STEPS = 3
SHARD_3D_STEPS = 2      # step 1 has no inflow yet: step 2 is the first solve
SHARD_2D_REF = 2        # the replicated strategy's run, 2 steps
SHARD_REP_STEPS = 2
# GMRES iterations a step within 10% of the single-device run's
SHARD_GMRES_REL = 0.10
# the sharded runs' functionals and solutions against the single-device
# ones, relative to max(|ref|, 1): on a CPU (plain sweeps) 4 shards meet 1
# shard within 1.3e-9 on Turek 2D ref 2 over 3 steps; on the card the
# shards' kernels and seam sums add in another order, under an inexact
# Newton whose linear tolerance is 1e-2 (the Newton tolerance bounds the
# gap)
SHARD_TOL = 1e-4
# sharded applies against the single-device operator, relative to its
# max-abs: f32 levels (each shard's kernel and seam sums, another order),
# and the f64 fine level's general sweep
SHARD_F32_TOL = 1e-5
SHARD_F64_TOL = 1e-12


def shard_kernel(sweep):
    """(wrapper, plain version, inputs, tables of each launch, cost,
    kernel name) of a shard's fused sweep."""
    from ns_gls_tpu_torch.ops import patch2d as p2
    from ns_gls_tpu_torch.ops import patch3d as p3
    from ns_gls_tpu_torch.ops import prism as pr
    from ns_gls_tpu_torch.utils import roofline as rf

    if isinstance(sweep, pr.PrismSweep):
        t = sweep.tables
        return (pr.PrismKernel.launch, pr.prism_sweep_plain, prism_inputs,
                [t], lambda *a: rf.prism_cost(t, *a), "prism_kernel")
    if isinstance(sweep, p3.Patch3DSweep):
        t = sweep.tables
        return (p3.Patch3DKernel.launch, p3.patch3d_sweep_plain,
                patch3d_inputs, [t], lambda *a: rf.patch3d_cost(t, *a),
                "patch3d_kernel")
    ft = sweep.tables
    return (p2.Patch2DKernel.launch, p2.patch2d_sweep_plain,
            lambda t, seed: patch2d_inputs(t, seed), list(ft.fams),
            lambda *a: rf.patch2d_cost(ft, *a), "patch2d_kernel")


def phase_shard_kernels(label, h):
    """Each shard's fused kernel on ``h``'s tables against its plain
    version in every flavor (the operator's delta mode and consider_dt),
    and its device time and bound in the main path's flavor (increment).
    Returns (max abs err, [per shard dict(us, bound_us, bound_by)])."""
    from ns_gls_tpu_torch.utils.roofline import bound
    from ns_gls_tpu_torch.utils.timer import device_time_us

    op = h.op
    sc = sweep_scalars(op)
    cdt, cw = op.consider_time_derivative, op.cell_wise_stabilization
    worst, shards = 0.0, []
    for i, s in enumerate(h.shards):
        launch, plain, inputs, tables, cost, kname = shard_kernel(s.fast)
        us = 0.0
        for t in tables:
            u, ul, vo = inputs(t, seed=i)
            # the prism kernel's patch tiles of u_lin: its velocity only
            # outside the increment flavor (node-major vectors keep all)
            cases = [(t, sc, u, ul if f == "increment" or ul.dim() == 2
                      else ul[:3].contiguous(), vo, f, cdt, cw)
                     for f in ("increment", "fixed", "residual")]
            a, r = compare_cases(f"{label} shard {i}", launch, plain, cases)
            worst = max(worst, a)
            us += device_time_us(lambda: launch(*cases[0]), kname, n=20)
        bound_ms, by = bound(*cost("increment", cdt, cw))
        shards.append(dict(us=us, bound_us=1e3 * bound_ms, bound_by=by,
                           n_loc=h.n_loc))
        log(f"[19] {label} shard {i}: {len(tables)} table set(s), kernel vs "
            f"plain max rel err {r:.3e}; kernel device time {us:.1f} us, "
            f"bound {1e3 * bound_ms:.2f} us by {by} (window {h.n_loc} "
            f"nodes)")
    return worst, shards


def phase_shard_layout(label, h):
    """The layout's measures and the exchanges' time per apply."""
    import torch

    st = h.stats()
    C = h.op.n_comp
    ws = [torch.zeros((h.n_loc, C), dtype=h.op.dtype, device=d)
          for d in h.devices]
    ms = time_sweep(lambda: (h.exchange_fill(ws), h.compress(ws)), n=20)
    log(f"[19] {label}: {st['local_sweep']} local sweep, halo share "
        f"{100 * st['halo_share']:.3f}% of the node vector, {st['rounds']} "
        f"rounds ({st['pairs']} pairs), {st['exchange_bytes']} B exchanged "
        f"an apply in {1e3 * ms:.1f} us (fill and reverse), window "
        f"{st['n_loc']} nodes ({st['n_own_max']} owned at most)")
    return dict(st, exchange_ms=ms)


def check_shard_applies(label, h, tol, seed=0):
    """The sharded vmult and residual against the wrapped operator's on
    one random input (the state the driver left)."""
    import numpy as np
    import torch

    op = h.op
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal((op.n_nodes, op.n_comp)),
                        dtype=op.dtype, device="cuda")
    worst = 0.0
    for what, a, b in (("vmult", h.vmult(v), op.vmult(v)),
                       ("residual", h.evaluate_residual(v),
                        op.evaluate_residual(v))):
        rel = float((a - b).abs().max() / b.abs().max())
        worst = max(worst, rel)
        if not rel <= tol:
            raise AssertionError(f"[19] {label} sharded {what}: rel err "
                                 f"{rel:.3e} > {tol}")
    log(f"[19] {label}: sharded vmult and residual vs single-device, max "
        f"rel err {worst:.3e} (tol {tol})")
    return worst


def compare_shard_run(label, drv, recs, ref):
    """The sharded run against the single-device one (``ref``: its step
    stats, records and solution after the same steps): Newton counts
    equal, GMRES within ``SHARD_GMRES_REL`` a step, functionals and
    solution within ``SHARD_TOL``; seconds a step beside each other."""
    stats = drv.step_stats
    for i, (s, r) in enumerate(zip(stats, ref["stats"])):
        log(f"[19] {label} step {i + 1}: {s['seconds']:.3f} s on {SHARDS} "
            f"shards vs {r['seconds']:.3f} s on one (Newton {s['newton']} "
            f"vs {r['newton']}, GMRES {s['gmres']} vs {r['gmres']})")
        if s["newton"] != r["newton"]:
            raise AssertionError(f"[19] {label} step {i + 1}: Newton "
                                 f"{s['newton']} vs {r['newton']}")
        if abs(s["gmres"] - r["gmres"]) > SHARD_GMRES_REL * r["gmres"]:
            raise AssertionError(f"[19] {label} step {i + 1}: GMRES "
                                 f"{s['gmres']} vs {r['gmres']}")
    gap = 0.0
    for a, b in zip(recs, ref["recs"]):
        for k in ("drag", "lift", "p_diff"):
            gap = max(gap, abs(a[k] - b[k]) / max(abs(b[k]), 1.0))
    u, u_ref = drv.solution.current, ref["u"].to(drv.solution.current.device)
    sol = float((u - u_ref).abs().max()) / max(float(u_ref.abs().max()), 1.0)
    log(f"[19] {label}: functionals within {gap:.3e}, solution within "
        f"{sol:.3e} of the single-device run (tol {SHARD_TOL}); four "
        f"shards on one card run each apply's shards one after the other, "
        f"so the run is slower than one shard")
    if not (gap <= SHARD_TOL and sol <= SHARD_TOL):
        raise AssertionError(f"[19] {label}: gap {gap:.3e} / {sol:.3e} > "
                             f"{SHARD_TOL}")
    return dict(gap=gap, sol=sol)


def phase_shard_case(label, params, steps, ref, kind):
    """A sharded driver of ``params`` set up and run for ``steps`` steps
    (the counts read around the run), held to the single-device ``ref``;
    then its operators: each level's layout, each shard's kernel on the
    finest level, every level's sharded applies and the f64 fine level's
    general sweep against the single-device operators."""
    from ns_gls_tpu_torch.parallel.halo import HaloShardedOperator

    drv, setup_s = setup_driver(params, SHARD_DEVICES)
    if not (isinstance(drv.op, HaloShardedOperator)
            and drv.preconditioner.distributed):
        raise AssertionError(f"[19] {label}: not the halo path")
    lv = drv.mg_ops_apply
    kinds = [h.local_sweep for h in lv]
    log(f"[19] {label}: {SHARDS} shards set up in {setup_s:.2f} s; level "
        f"local sweeps {kinds}, fine operator {drv.op.local_sweep} on the "
        f"{drv.op.partition.kind} partition")
    if kinds[-1] != kind:
        raise AssertionError(f"[19] {label}: finest level {kinds[-1]}, "
                             f"want {kind}")
    recs, run_s, counts = run_steps(drv, steps)
    launches = counts[f"{kind}_gls_sweep"]
    log(f"[19] {label}: {steps} step(s) in {run_s:.2f} s; kernel launches "
        f"{counts}")
    if launches <= 0:
        raise AssertionError(f"[19] {label}: the {kind} kernel was not "
                             "launched")
    if kind != "prism" and counts["seam_sum"] != launches:
        raise AssertionError(f"[19] {label}: want one seam sum per launch")
    out = dict(launches=launches, run=compare_shard_run(label, drv, recs,
                                                        ref))
    out["layout"] = [phase_shard_layout(f"{label} level {l}", h)
                     for l, h in enumerate(lv)]
    out["layout_fine"] = phase_shard_layout(f"{label} f64 fine operator",
                                            drv.op)
    out["max_abs"], out["shards"] = phase_shard_kernels(
        f"{label} finest level", lv[-1])
    out["f32_rel"] = max(check_shard_applies(f"{label} level {l}", h,
                                             SHARD_F32_TOL)
                         for l, h in enumerate(lv))
    out["f64_rel"] = check_shard_applies(f"{label} f64 fine level", drv.op,
                                         SHARD_F64_TOL)
    return out


def phase_shard_replicated():
    """The replicated strategy on Turek 2D at refinement ``SHARD_2D_REF``:
    a sharded and a single-device run against each other."""
    from ns_gls_tpu_torch.parallel.sharding import ShardedOperator

    over = {"n global refinements": SHARD_2D_REF}
    drv, recs1, _, _, _ = run_driver(config(over), SHARD_REP_STEPS)
    ref = dict(stats=drv.step_stats, recs=recs1,
               u=drv.solution.current.clone())
    del drv
    drv4, recs4, _, run_s, _ = run_driver(
        config(over | {"n devices": SHARDS,
                       "parallel strategy": "replicated"}),
        SHARD_REP_STEPS, SHARD_DEVICES)
    if not isinstance(drv4.op, ShardedOperator):
        raise AssertionError("[19] not the replicated strategy")
    log(f"[19] replicated strategy, Turek 2D ref {SHARD_2D_REF}: "
        f"{SHARD_REP_STEPS} steps in {run_s:.2f} s")
    return compare_shard_run("replicated Turek 2D", drv4, recs4, ref)


def phase_sharding(ref2d, ref3d, ref_sphere):
    """Phase 19: ``input/turek_2d_re100.json`` as given for
    ``SHARD_2D_STEPS`` steps, ``input/turek_3d_re100.json`` as given for
    ``SHARD_3D_STEPS`` and ``input/sphere_amg.json`` as given (one
    stationary solve), each on ``SHARDS`` shards of the card against
    phases 4, 7 and 14; then the replicated strategy on Turek 2D at
    refinement ``SHARD_2D_REF``.  Returns the kernels' sharded
    launches and per-shard numbers."""
    import torch

    t_phase = time.perf_counter()
    out = {}
    for key, label, name, steps, ref, kind in (
            ("patch2d", "Turek 2D", "turek_2d_re100.json", SHARD_2D_STEPS,
             ref2d, "patch2d"),
            ("sphere", "sphere_amg", "sphere_amg.json", 1, ref_sphere,
             "patch3d"),
            ("prism", "Turek 3D", "turek_3d_re100.json", SHARD_3D_STEPS,
             ref3d, "prism")):
        params = config({"n devices": SHARDS}, name)
        out[key] = phase_shard_case(label, params, steps, ref, kind)
        torch.cuda.empty_cache()
        log(f"[19] {label} done at {time.perf_counter() - t_phase:.1f} s "
            "of the phase")
    out["replicated"] = phase_shard_replicated()
    log(f"[19] sharding phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: every fused kernel at degree 7, from the libraries built for it
# ---------------------------------------------------------------------------
DEGREE7 = 7
# the sources whose kernels are templates over the degree
DEGREE_SOURCES = ["patch2d", "prism", "structured", "patch3d"]
# kernel vs plain version at P = 7, relative to the plain max-abs
DEGREE7_REL_TOL = 1e-6


def degree7_sets():
    """(kernel name, wrapper, plain version, cases, attributes or None,
    profiler name, cost of the timing case) of each of the six fused
    kernels at P = 7 on one small shape: the patch-2D kernel on the Turek
    2D mesh refined once (88 patches of 2 x 2 cells), the prism and
    patch-3D kernels on synthetic single patches of 2 x 2 (x 16 layers)
    and 2^3 cells, the structured kernels on the sheared lattices of
    phase 9 (37 x 5 and 19 x 3 x 2 cells).  Every case list is every
    flavor x delta mode x consider_dt; the first case is the timing
    case's (increment, the history, q-wise delta)."""
    from ns_gls_tpu_torch.models.cylinder import SimulationCylinder
    from ns_gls_tpu_torch.ops import patch2d as p2
    from ns_gls_tpu_torch.ops import patch3d as p3
    from ns_gls_tpu_torch.ops import prism as pr
    from ns_gls_tpu_torch.ops import structured as st
    from ns_gls_tpu_torch.utils import roofline as rf

    P = DEGREE7
    # increment first: the timing case
    combos = [(f, cdt, cw) for cw in (False, True) for cdt in (True, False)
              for f in ("increment", "fixed", "residual")]
    out = []
    ft = patch2d_operator(SimulationCylinder(2).create_mesh(1), P,
                          "cuda")._fast.tables
    (t2,) = ft.fams
    u, ul, vo = patch2d_inputs(t2)
    out.append(("patch2d_gls_sweep", p2.Patch2DKernel.launch,
                p2.patch2d_sweep_plain,
                [(t2, SC, u, ul, vo, *c) for c in combos],
                lambda f, cdt: p2.Patch2DKernel.attributes(P, t2.plan, f,
                                                           cdt),
                "patch2d_kernel", lambda *a: rf.patch2d_cost(ft, *a)))
    tp = synthetic_prism_tables(P, 2, PRISM_BRICK_NZ, "cuda")
    u, ul, vo = prism_inputs(tp)
    out.append(("prism_gls_sweep", pr.PrismKernel.launch,
                pr.prism_sweep_plain,
                [(tp, SC3, u, ul if c[0] == "increment"
                  else ul[:3].contiguous(), vo, *c) for c in combos],
                None, "prism_kernel", lambda *a: rf.prism_cost(tp, *a)))
    t3 = synthetic_patch3d_tables(P, 2, "cuda")
    u, ul, vo = patch3d_inputs(t3)
    out.append(("patch3d_gls_sweep", p3.Patch3DKernel.launch,
                p3.patch3d_sweep_plain,
                [(t3, SC3, u, ul, vo, *c) for c in combos],
                lambda f, cdt: p3.Patch3DKernel.attributes(
                    P, t3.m, t3.plans[(f, cdt)], f, cdt),
                "patch3d_kernel", lambda *a: rf.patch3d_cost(t3, *a)))
    for dim, batched in ((3, False), (2, False), (3, True)):
        ts = sheared_tables(dim, P, "cuda")
        u, ul, vo = structured_inputs(ts)
        name = st.StructuredKernel.kernel_name(dim, batched)
        plan = (st.slab_plan_2d if dim == 2 else
                st.batched_plan if batched else st.brick_plan)(
                    P, ts.cell_shape)
        out.append((name,
                    lambda *a, b=batched: st.structured_sweep(*a,
                                                              batched=b),
                    st.structured_sweep_plain,
                    [(ts, SC_SHEAR, u, ul, vo, *c) for c in combos],
                    lambda f, cdt, b=batched, pl=plan:
                        st.StructuredKernel.attributes(P, pl, f, cdt, b),
                    f"{name}_kernel",
                    lambda *a, t=ts: rf.structured_cost(t, *a)))
    return out


def phase_degree7():
    """Each fused kernel's P = 7 instance, from the libraries built for
    that degree alone (phase 2), against its plain version within
    ``DEGREE7_REL_TOL`` in every flavor x delta mode x consider_dt, two
    launches bit-identical; its registers, spills and shared memory, and
    its device time, plain time and bound in the timing case.  Returns
    {kernel name: numbers}."""
    import torch

    from ns_gls_tpu_torch.utils.roofline import bound
    from ns_gls_tpu_torch.utils.timer import device_time_us

    res = {}
    for (name, launch, plain, cases, attrs, kname,
         cost) in degree7_sets():
        a, r = compare_cases(f"{name} P={DEGREE7}", launch, plain, cases,
                             tol=DEGREE7_REL_TOL)
        x, y = launch(*cases[0]), launch(*cases[0])
        torch.cuda.synchronize()
        if not torch.equal(x, y):
            raise AssertionError(f"two {name} P={DEGREE7} launches on the "
                                 "same inputs differ")
        case = cases[0]
        us = device_time_us(lambda: launch(*case), kname, n=20)
        plain_ms = time_sweep(lambda: plain(*case), n=5)
        bound_ms, by = bound(*cost(*case[5:]))
        at = attrs(case[5], case[6]) if attrs else {}
        res[name] = dict(ms=us / 1e3, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=by, max_abs_err=a, max_rel_err=r,
                         registers=at.get("registers"),
                         spill_bytes=at.get("spill_bytes",
                                            at.get("local_bytes")),
                         dynamic_smem=at.get("dynamic_smem"))
        log(f"[20] {name} P={DEGREE7}: {len(cases)} cases, max rel err "
            f"{r:.3e} (tol {DEGREE7_REL_TOL}), relaunch bit-identical; "
            f"device time {us:.1f} us, plain {1e3 * plain_ms:.1f} us, "
            f"bound {1e3 * bound_ms:.2f} us by {by}; {at or 'attributes: '
            'the build log of phase 2'}")
    return res


# ---------------------------------------------------------------------------
# phase 21: the slab-sharded structured operator on four shards of the card
# ---------------------------------------------------------------------------
# (dim, refinements): the gls-vmult hypercube of degree 2, 16^3 cells (4
# slabs a shard) and 64^2 cells (16)
SHARDED_STRUCTURED = ((3, 4), (2, 6))
# the sharded apply against the one-device kernel apply, relative to its
# max-abs (the shared planes' partial sums add in another order)
SHARDED_STRUCTURED_TOL = 1e-6


def phase_sharded_structured():
    """``parallel/structured_sharded.py`` on ``SHARDS`` shards of the card
    at each shape of ``SHARDED_STRUCTURED``: each shard's kernel against
    its plain version in every flavor (the lane's delta mode and
    consider_dt), the sharded apply against the one-device kernel apply
    within ``SHARDED_STRUCTURED_TOL``, the exchange's elements, each
    shard's kernel device time and bound (``bench_gpu.measure_shards``).
    Returns (max abs err, {dim: numbers}, kernel launches)."""
    import torch

    import bench_gpu
    from ns_gls_tpu_torch.ops import structured as st

    worst, out, launches = 0.0, {}, {}
    for dim, ref in SHARDED_STRUCTURED:
        op, space, u = bench_gpu.build(dim, ref, 2)
        sop, args, (ud, uld, vod) = bench_gpu.sharded_setup(op, SHARDS)
        tables, sc, _, _, _, _, cdt, cw = args
        errs = {}
        for k, t in enumerate(sop.tables):
            cases = [(t, sc, ud[k], uld[k], vod[k], f, cdt, cw)
                     for f in st.FLAVORS]
            compare_structured(f"{dim}D shard {k}", cases, False, errs)
        worst = max([worst] + list(errs.values()))
        reset_kernel_counts()
        sop.elements_moved = 0
        sop.apply(sc["weight"], sc["stau"], ud, uld, vod, args[5])
        for name, n in kernel_counts().items():
            if n:
                launches[name] = launches.get(name, 0) + n
        if sop.elements_moved != sop.exchange_elements:
            raise AssertionError(f"{dim}D: the exchange moved "
                                 f"{sop.elements_moved} elements, not "
                                 f"{sop.exchange_elements}")
        res = bench_gpu.measure_shards(op, SHARDS)
        if not res["sharded_rel_err"] <= SHARDED_STRUCTURED_TOL:
            raise AssertionError(f"{dim}D sharded apply vs one device: rel "
                                 f"err {res['sharded_rel_err']:.3e} > "
                                 f"{SHARDED_STRUCTURED_TOL}")
        out[dim] = dict(res, n_dofs=space.n_nodes * (dim + 1))
        log(f"[21] {dim}D {tables.cell_shape} cells of Q2 on {SHARDS} "
            f"shards: shard kernels vs plain ok (max abs err "
            f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} }); sharded "
            f"apply {res['sharded_us']:.1f} us vs one device "
            f"{res['one_device_us']:.1f} us, rel err "
            f"{res['sharded_rel_err']:.3e} (tol {SHARDED_STRUCTURED_TOL}); "
            f"exchange {res['exchange_us']:.1f} us "
            f"({100 * res['exchange_share']:.1f}% of the apply, "
            f"{res['exchange_bytes']} B)")
        for k, x in enumerate(res["shards"]):
            log(f"[21]   shard {k} {x['cells']}: kernel device time "
                f"{x['kernel_us']:.1f} us, bound {x['bound_us']:.2f} us by "
                f"{x['bound_by']}")
        del op, sop, ud, uld, vod
        torch.cuda.empty_cache()
    return worst, out, launches


def scatter_bits(tag, label, fn):
    """Two calls of ``fn`` on equal inputs: the same bits?"""
    import torch

    a = fn()
    b = fn()
    torch.cuda.synchronize()
    same = bool(torch.equal(a, b))
    gap = float((a - b).abs().max())
    log(f"[{tag}] {label}: two calls on equal inputs "
        f"{'bit-identical' if same else f'differ (max |gap| {gap:.3e})'}")
    return same


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
        from ns_gls_tpu_torch.utils.roofline import bound, prism_cost

        t0 = time.perf_counter()
        # the common libraries and the degree-7 ones (phase 20), one nvcc
        # each, all started together
        degree7 = [(name, DEGREE7) for name in DEGREE_SOURCES]
        cuda_build.build_libraries(KERNEL_SOURCES + degree7)
        keys = KERNEL_SOURCES + [cuda_build.library_key(*k)
                                 for k in degree7]
        log(f"[2] built {', '.join(keys)} in "
            f"{time.perf_counter() - t0:.1f} s "
            f"({ {k: round(cuda_build.build_info[k]['seconds'], 1)
                 for k in keys} } s each)")
        for name in keys:
            for line in cuda_build.build_info[name]["log"].splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[2]   {name}: {line.strip()}")

        # 3. patch-2D kernel against plain version, then the sweep at the
        # ref-3 shape (m = 8) in the main path's flavor (increment, the
        # BDF history, q-wise delta)
        t0 = time.perf_counter()
        p2_levels = patch2d_level_sets("cuda")
        log(f"[3] {len(p2_levels)} patch-2D level spaces set up in "
            f"{time.perf_counter() - t0:.1f} s")
        max_abs, max_rel = phase_kernel_vs_plain(p2_levels)
        log_patch2d_build(p2_levels, "increment", True)
        p2_high = time_patch2d_high(p2_levels)
        p2_fine = next(t for label, t in p2_levels
                       if label == "turek_2d_re100 level 3")
        p2_times = phase_patch2d_sweep(p2_fine, "increment", True, False)
        del p2_levels, p2_fine

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
        turek_sets = [(f"Turek 3D level {l}", op._fast.tables)
                      for l, op in enumerate(drv3.mg_ops)]
        brick_sets = [(f"synthetic P={P} m={m}",
                       synthetic_prism_tables(P, m, PRISM_BRICK_NZ, "cuda"))
                      for P, m in PRISM_BRICK_SHAPES]
        pmax_abs, _ = phase_prism_vs_plain(turek_sets + brick_sets)
        tl = time_prism_levels(turek_sets)
        plevels = {t.m: tl[label] for label, t in turek_sets}
        high_label = brick_sets[-1][0]
        pr_high = time_prism_levels(brick_sets)[high_label]
        pr_high = dict(label=f"{high_label} nz={PRISM_BRICK_NZ}",
                       ms=pr_high["device_us"] / 1e3,
                       bound_ms=pr_high["bound_us"] / 1e3,
                       bound_by=pr_high["bound_by"])
        del turek_sets, brick_sets
        ptables = drv3.mg_ops[-1]._fast.tables
        u, ul, vo = prism_inputs(ptables, seed=1)
        pargs = (ptables, SC3, u, ul, vo, "increment", True, False)
        pms = plevels[ptables.m]["us"] / 1e3
        pplain_ms = time_sweep(lambda: pr.prism_sweep_plain(*pargs), n=20)
        nbytes, flops = prism_cost(ptables, "increment", True, False)
        pbound_ms, pbound_by = bound(nbytes, flops)
        log(f"[6] m={ptables.m} increment sweep: kernel {pms:.4f} ms, plain "
            f"{pplain_ms:.4f} ms, bound {pbound_ms:.6f} ms by {pbound_by} "
            f"({nbytes} B, {flops} flop)")
        del u, ul, vo, pargs, ptables

        # 7. 3D main path; the f64 fine level's general sweep (a scatter
        # by index_put_) twice on equal inputs
        main3 = phase_main_path_3d(drv3, params3, setup3_s, plevels)
        u3 = drv3.solution.current
        v3 = torch.ones_like(u3)
        for label, fn in (
                ("Turek 3D fine-level residual (f64 general sweep)",
                 lambda: drv3.op.evaluate_residual(u3)),
                ("Turek 3D fine-level vmult (f64 general sweep)",
                 lambda: drv3.op.vmult(v3))):
            if not scatter_bits(7, label, fn):
                raise AssertionError(f"{label}: not deterministic")
        del drv3, u3, v3

        # 8. 3D stored series
        phase_series_3d()
        torch.cuda.empty_cache()
        log(f"[-] Turek phases done at {time.perf_counter() - t_start:.1f} s")

        # 9. channel 3D set-up, structured kernels against plain version
        params_c3 = config(CHANNEL3D, "channel.json")
        drv_c3, setup_c3 = setup_driver(params_c3)
        log(f"[9] channel 3D driver set up in {setup_c3:.2f} s")
        errs = {}
        sheared = [(f"sheared {dim}D P={degree}",
                    sheared_tables(dim, degree, "cuda"), SC_SHEAR)
                   for dim in (2, 3) for degree in (1, 2, 3, 4, 5, 6)]
        levels3 = [(f"channel 3D level {l}", op._fast.tables, SC_CH)
                   for l, op in enumerate(drv_c3.mg_ops)]
        phase_structured_vs_plain(9, sheared + levels3, errs)
        phase_structured2d_plans(9, [c for c in sheared if c[1].d == 2],
                                 errs)
        fine3 = drv_c3.mg_ops[-1]._fast.tables
        log_structured_build(9, [t for _, t, _ in sheared + levels3])
        t_s3 = time_structured(9, fine3, SC_CH, False)
        # the batched kernel at the channel's finest shape, which no
        # driver path gives it: for its line in the kernels' JSON
        t_s3b_fine = time_structured(9, fine3, SC_CH, True)
        # the last degree built (P = 6) at the sheared lattices' shapes
        s_high = {}
        for label, tables, sc in sheared:
            if tables.P == 6:
                for batched in ((False, True) if tables.d == 3
                                else (False,)):
                    t = time_structured(9, tables, sc, batched)
                    s_high[(tables.d, batched)] = dict(
                        label=f"{label} cells {tables.cell_shape}",
                        ms=t["kernel_ms"], bound_ms=t["bound_ms"],
                        bound_by=t["bound_by"])
        del sheared, levels3, fine3

        # 10. channel 3D main path
        ch3 = phase_channel(10, drv_c3, params_c3, setup_c3, "structured3d",
                            CHANNEL3D_DOFS)
        del drv_c3
        torch.cuda.empty_cache()

        # 11. channel 2D: kernel on its level spaces, then the main path
        params_c2 = config(CHANNEL2D, "channel.json")
        drv_c2, setup_c2 = setup_driver(params_c2)
        levels2 = [(f"channel 2D level {l}", op._fast.tables, SC_CH)
                   for l, op in enumerate(drv_c2.mg_ops)]
        phase_structured_vs_plain(11, levels2, errs)
        t_s2 = time_structured(11, drv_c2.mg_ops[-1]._fast.tables, SC_CH,
                               False)
        del levels2
        ch2 = phase_channel(11, drv_c2, params_c2, setup_c2, "structured2d",
                            CHANNEL2D_DOFS)
        del drv_c2
        torch.cuda.empty_cache()
        log(f"[-] channel phases done at "
            f"{time.perf_counter() - t_start:.1f} s")

        # 12. gls-vmult lane
        vmult_counts, vmult_errs, vmult = phase_vmult_lane(t_start)
        # the batched kernel's row: the lane ``3 5 2 --increment
        # --batched`` (the other rows' flavor), the only path that
        # launches it
        t_s3b = next(r["times"] for r in vmult
                     if r["ref"] == 5 and r["increment"] and r["batched"])
        errs["structured3d_batched"] = vmult_errs["structured3d_batched"]
        log(f"[-] gls-vmult phase done at "
            f"{time.perf_counter() - t_start:.1f} s")

        # 13-15. the patch-3D kernel and the sphere
        sph, p3_line = phases_sphere()
        torch.cuda.empty_cache()
        log(f"[-] sphere phases done at "
            f"{time.perf_counter() - t_start:.1f} s")

        # 16. the weak outflow: Hoffmann/ReInf as given, the Q1 series;
        # the face sweep's scatter twice on equal inputs
        hoff, drv_h = phase_hoffmann()
        uh = drv_h.solution.current
        label = "Hoffmann fine-level face sweep (f64, index_put_ scatter)"
        if not scatter_bits(16, label, lambda: drv_h.op._boundary_sweep(
                uh, torch.zeros_like(uh), residual_form=True)):
            raise AssertionError(f"{label}: not deterministic")
        del drv_h, uh
        torch.cuda.empty_cache()
        log(f"[-] weak outflow phase done at "
            f"{time.perf_counter() - t_start:.1f} s")

        # 17. the rotation slice: several-family tables, GMG-LS, GMG on
        # the adaptive annulus, Couette flow
        rot = phase_rotation_slice()
        log(f"[-] rotation phase done at "
            f"{time.perf_counter() - t_start:.1f} s")

        # 18. the solver stack: Picard, ILU, the matrix-based operator, AMG
        # with its ILU smoother, Richardson, the ILU coarse solver,
        # checkpoints
        stack = phase_solver_stack(main["step3"])
        log(f"[-] solver-stack phase done at "
            f"{time.perf_counter() - t_start:.1f} s")

        # 19. sharding: four shards on the card against phases 4, 7, 14
        shard = phase_sharding(
            dict(stats=main["stats"], recs=main["recs"], u=main["step3"]),
            main3, sph)
        log(f"[-] sharding phase done at "
            f"{time.perf_counter() - t_start:.1f} s")

        # 20. every fused kernel at degree 7
        p7 = phase_degree7()
        # 21. the slab-sharded structured operator on four shards
        ss_err, ss, ss_launches = phase_sharded_structured()
        log(f"[-] all phases done at {time.perf_counter() - t_start:.1f} s")

        # 22. kernel line, card line; 23. result line
        # the patch-2D kernel: device time at m = 8 in the main path's
        # flavor, alone (ms) and with its seam sum (sweep_ms); launches
        # from phase 4, one seam sum after each
        kernels = [dict(
            name="patch2d_gls_sweep",
            route="cuda",
            source="ns_gls_tpu_torch/csrc/patch2d.cu",
            replaces="ns_gls_tpu/ops/patch2d.py:309",
            launches=main["launches"],
            max_abs_err=max(max_abs, rot["max_abs"]),
            ms=p2_times["ms"],
            plain_ms=p2_times["plain_ms"],
            bound_ms=p2_times["bound_ms"],
            bound_by=p2_times["bound_by"],
            library_ms=None,
            sweep_ms=p2_times["sweep_ms"],
            events_ms=p2_times["events_ms"],
            seam_sum_launches=main["seam_launches"],
            # the Hoffmann/ReInf path's launches (phase 16)
            hoffmann_launches=hoff["launches"],
            # the rotation paths' launches (phase 17: rotation.json as
            # given, refinement 6, GMG, Couette), the kernel and sweep at
            # the m = 1 forest level of refinement 6 (16,384 patches), and
            # the launches an apply of the several-family GMG level
            rotation_launches=rot["launches"],
            rotation_m1_ms=rot["m1"]["ms"],
            rotation_m1_sweep_ms=rot["m1"]["sweep_ms"],
            rotation_m1_plain_ms=rot["m1"]["plain_ms"],
            rotation_m1_bound_ms=rot["m1"]["bound_ms"],
            rotation_m1_bound_by=rot["m1"]["bound_by"],
            families_launches_per_apply=rot["per_apply"],
            # Picard on turek_2d_re100.json (phase 18): every launch in the
            # fixed flavor
            picard_fixed_launches=stack["picard_fixed_launches"],
            # the last degree built (P = 6) at its one shape of phase 3
            p6=p2_high,
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
            # the last degree built (P = 6) at its one shape of phase 6
            p6=pr_high,
        )]
        # the structured kernels: time of the wrapper (kernel and fold).
        # 2D and 3D: at the finest channel level, errors over phases 9
        # and 11, launches from the channel main paths.  Batched, which
        # no driver path selects: error, times and bound at the gls-vmult
        # lane's shape (32^3 cells) and state, launches from that lane
        for name, line, t, launches, high in (
                ("structured3d", 540, t_s3, ch3["launches"],
                 s_high[(3, False)]),
                ("structured2d", 1131, t_s2, ch2["launches"],
                 s_high[(2, False)]),
                ("structured3d_batched", 910, t_s3b,
                 vmult_counts["structured3d_batched"], s_high[(3, True)])):
            kernels.append(dict(
                name=name,
                route="cuda",
                source="ns_gls_tpu_torch/csrc/structured.cu",
                replaces=f"ns_gls_tpu/ops/structured.py:{line}",
                launches=launches,
                max_abs_err=errs[name],
                ms=t["ms"],
                kernel_ms=t["kernel_ms"],
                plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"],
                bound_by=t["bound_by"],
                library_ms=None,
                # the last degree built (P = 6), sheared lattice of phase 9
                p6=high,
            ))
        # the batched kernel's times at 128 x 32 x 32 cells (phase 9)
        kernels[-1].update(channel_fine={
            k: t_s3b_fine[k] for k in ("ms", "kernel_ms", "plain_ms",
                                       "bound_ms", "bound_by")})
        # the 2D structured kernel on phase 18's Richardson and ILU
        # coarse-solver channel paths
        kernels[-2].update(richardson_launches=stack["richardson_launches"],
                           ilu_coarse_launches=stack["ilu_coarse_launches"])
        kernels.append(p3_line)
        # the sharded paths of phase 19: each fused kernel's launches
        # there, its error against its plain version on the shards'
        # tables, and its device time and bound on each shard of the
        # finest level in the main path's flavor
        for k, key in ((kernels[0], "patch2d"), (kernels[1], "prism"),
                       (p3_line, "sphere")):
            sh = shard[key]
            k["max_abs_err"] = max(k["max_abs_err"], sh["max_abs"])
            k.update(sharded_launches=sh["launches"],
                     sharded_shard_ms=[x["us"] / 1e3 for x in sh["shards"]],
                     sharded_bound_ms=[x["bound_us"] / 1e3
                                       for x in sh["shards"]],
                     sharded_bound_by=sh["shards"][0]["bound_by"])
        # phase 20: each kernel's P = 7 instance at its one shape
        for k in kernels:
            k["p7"] = p7[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"],
                                   p7[k["name"]]["max_abs_err"])
        # phase 21: the slab-sharded structured operator's launches, and
        # each shard's kernel time and bound at the 3D and 2D shapes
        for k in kernels:
            dim = {"structured3d": 3, "structured2d": 2}.get(k["name"])
            if dim is None:
                continue
            sh = ss[dim]
            k["max_abs_err"] = max(k["max_abs_err"], ss_err)
            k.update(sharded_structured_launches=ss_launches.get(k["name"],
                                                                 0),
                     sharded_shard_ms=[x["kernel_us"] / 1e3
                                       for x in sh["shards"]],
                     sharded_bound_ms=[x["bound_us"] / 1e3
                                       for x in sh["shards"]],
                     sharded_bound_by=sh["shards"][0]["bound_by"],
                     sharded_apply_ms=sh["sharded_us"] / 1e3,
                     sharded_exchange_ms=sh["exchange_us"] / 1e3,
                     one_device_sweep_ms=sh["one_device_us"] / 1e3)
        for k in kernels:
            if k["launches"] <= 0:
                raise AssertionError(f"{k['name']} was not launched on its "
                                     "path")
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
