#!/usr/bin/env python3
"""gls-vmult operator benchmark of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 bench_gpu.py [dim] [ref] [degree] [--increment] [--batched]
    python3 bench_gpu.py --sphere [ref] [degree]
    python3 bench_gpu.py --turek [ref] [degree]

The reference's second executable (``performance.cc``): a hypercube
refined ``ref`` times (default 3 5 2: 32^3 cells of Q2, 1,098,500 DoFs),
no constraints, BDF-2 weights, nu = 0.1, c1 = 4, c2 = 2, cell-wise
delta, a random state from ``numpy.random.default_rng(0)``, and chained
``vmult``s of the f32 operator (each apply consumes the previous,
normalized, output), timed with CUDA events.  The operator runs the
structured sweep (``ops/structured.py``); ``--increment`` times the
Newton-increment flavor instead of the fixed-point one, ``--batched`` the
3D kernel that contracts all components together.

``--sphere`` is the general-mesh lane (the JAX package's ``bench.py
--sphere``): the Gmsh sphere mesh ``meshes/sphere.msh`` refined ``ref``
times (default 3 2: 24,576 cells of Q2, 811,272 DoFs), no constraints,
BDF-2, the Newton-increment flavor, q-wise delta, nu = 0.001, c1 = 2,
c2 = 1, on the patch-3D sweep (``ops/patch3d.py``).

``--turek`` is the flagship-geometry lane (the JAX package's ``bench.py
--turek``): the curved, extruded Turek 3D mesh refined ``ref`` times
(default 3 2: 204,800 cells of Q2, 6,789,120 DoFs, the finest level of
``input/turek_3d_re100.json``), no constraints, BDF-2, the
Newton-increment flavor, q-wise delta, nu = 0.001, c1 = 2, c2 = 1, on
the prism sweep (``ops/prism.py``).

Prints the card's name and power limit, MDoF/s and microseconds per
apply, the sweep alone (kernel and fold), its kernel alone and the
sweep's bound on this card, then one JSON line with the same numbers.
Needs a CUDA device: without one it exits non-zero (``--device cpu`` is a rehearsal of the
control flow and prints no device metric).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


# timed calls per window (three windows, the best counts)
REPS = 100


def build(dim=3, refinements=5, degree=2, increment=False, batched=False,
          device="cuda"):
    """The benchmark operator (f32, structured sweep) with its state set,
    the space, and the start vector (n_nodes, dim + 1)."""
    import torch

    from ns_gls_tpu_torch.fem.constraints import AffineConstraints
    from ns_gls_tpu_torch.fem.space import FESpace
    from ns_gls_tpu_torch.mesh.generators import subdivided_hyper_rectangle
    from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator
    from ns_gls_tpu_torch.ops.structured import StructuredSweep
    from ns_gls_tpu_torch.ops.time_integration import BDFIntegrator

    dtype = torch.float32
    mesh = subdivided_hyper_rectangle(
        (1,) * dim, (0.0,) * dim, (1.0,) * dim, colorize=True
    ).refine_global(refinements)
    space = FESpace(mesh, degree)
    C = dim + 1
    ca = AffineConstraints(space.n_nodes, C).close(dtype, device)
    ti = BDFIntegrator(2)
    ti.update_dt(0.1)
    ti.update_dt(0.1)
    op = NavierStokesOperator(
        space, ca, ca, nu=0.1, c_1=4.0, c_2=2.0, time_integrator=ti,
        consider_time_derivative=True, increment_form=increment,
        cell_wise_stabilization=True, dtype=dtype, device=device,
    )
    if not isinstance(op._fast, StructuredSweep):
        raise RuntimeError("the benchmark operator did not take the "
                           "structured sweep")
    if batched:
        op._fast = StructuredSweep(op, op._fast.tables, batched=True)
    return op, space, random_state(op)


def random_state(op):
    """Set a BDF-2 history and linearization point from
    ``numpy.random.default_rng(0)`` (u, 0.9 u, 0.8 u); returns u."""
    import numpy as np
    import torch

    from ns_gls_tpu_torch.ops.time_integration import SolutionHistory

    rng = np.random.default_rng(0)
    u = rng.standard_normal((op.n_nodes, op.n_comp)).astype(np.float32)
    op.set_previous_solution(SolutionHistory.from_numpy(
        [u, u * np.float32(0.9), u * np.float32(0.8)], op.dtype, op.device))
    u = torch.as_tensor(u, device=op.device)
    op.set_linearization_point(u)
    return u


def build_sphere(refinements=3, degree=2, device="cuda"):
    """The sphere lane's operator (f32, patch-3D sweep) with its state
    set, the space, and the start vector (n_nodes, 4): the operator of
    the JAX package's ``bench.py`` ``build_sphere``."""
    import torch

    from ns_gls_tpu_torch.fem.constraints import AffineConstraints
    from ns_gls_tpu_torch.fem.space import FESpace
    from ns_gls_tpu_torch.mesh.gmsh import read_msh
    from ns_gls_tpu_torch.models.sphere import MESH_FILE
    from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator
    from ns_gls_tpu_torch.ops.patch3d import Patch3DSweep
    from ns_gls_tpu_torch.ops.time_integration import BDFIntegrator

    dtype = torch.float32
    space = FESpace(read_msh(MESH_FILE).refine_global(refinements), degree)
    ca = AffineConstraints(space.n_nodes, 4).close(dtype, device)
    ti = BDFIntegrator(2)
    ti.update_dt(0.1)
    ti.update_dt(0.1)
    op = NavierStokesOperator(
        space, ca, ca, nu=0.001, c_1=2.0, c_2=1.0, time_integrator=ti,
        consider_time_derivative=True, increment_form=True,
        cell_wise_stabilization=False, dtype=dtype, device=device,
    )
    if not isinstance(op._fast, Patch3DSweep):
        raise RuntimeError("the sphere operator did not take the patch-3D "
                           "sweep")
    return op, space, random_state(op)


def build_turek(refinements=3, degree=2, device="cuda"):
    """The Turek lane's operator (f32, prism sweep) with its state set,
    the space, and the start vector (n_nodes, 4): the operator of the JAX
    package's ``bench.py`` ``build_turek``."""
    import torch

    from ns_gls_tpu_torch.fem.constraints import AffineConstraints
    from ns_gls_tpu_torch.fem.space import FESpace
    from ns_gls_tpu_torch.mesh.cylinder import cylinder_mesh_3d
    from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator
    from ns_gls_tpu_torch.ops.prism import PrismSweep
    from ns_gls_tpu_torch.ops.time_integration import BDFIntegrator

    dtype = torch.float32
    space = FESpace(cylinder_mesh_3d().refine_global(refinements), degree)
    ca = AffineConstraints(space.n_nodes, 4).close(dtype, device)
    ti = BDFIntegrator(2)
    ti.update_dt(0.1)
    ti.update_dt(0.1)
    op = NavierStokesOperator(
        space, ca, ca, nu=0.001, c_1=2.0, c_2=1.0, time_integrator=ti,
        consider_time_derivative=True, increment_form=True,
        cell_wise_stabilization=False, dtype=dtype, device=device,
    )
    if not isinstance(op._fast, PrismSweep):
        raise RuntimeError("the Turek operator did not take the prism "
                           "sweep")
    return op, space, random_state(op)


def chained_applies(op, v, n):
    """n chained applies, each on the previous, normalized, output."""
    import torch

    for _ in range(n):
        w = op.vmult(v)
        v = w / torch.linalg.vector_norm(w)
    return v


def sweep_args(op, v):
    """The arguments the operator's apply gives its fused sweep on the
    vector v: (tables, scalars, uT, u_linT, vec_oldT, flavor,
    consider_dt, cell_wise), with the operator's own state and scalars."""
    sw = op._fast
    st = op.state
    sc = dict(weight=op._weight_host, stau=op._stau_host, nu=sw.nu,
              c1=sw.c1, c2=sw.c2)
    flavor = "increment" if op.increment_form else "fixed"
    uT = sw.gather_nodes(v, op.n_comp).contiguous()
    return (sw.tables, sc, uT, st.u_linT.contiguous(),
            st.vec_oldT.contiguous(), flavor, sw.consider_dt, sw.cell_wise)


def kernel_of(op):
    """(kernel wrapper, cost function, launch counts) of the operator's
    fused sweep: the structured kernels, the patch-3D or the prism one."""
    from ns_gls_tpu_torch.ops.patch3d import Patch3DKernel, Patch3DSweep
    from ns_gls_tpu_torch.ops.prism import PrismKernel, PrismSweep
    from ns_gls_tpu_torch.ops.structured import StructuredKernel
    from ns_gls_tpu_torch.utils.roofline import (
        patch3d_cost,
        prism_cost,
        structured_cost,
    )

    sw = op._fast
    if isinstance(sw, Patch3DSweep):
        from ns_gls_tpu_torch.utils.segment import SeamSumKernel

        return (Patch3DKernel.launch, patch3d_cost,
                lambda: {"patch3d_gls_sweep": Patch3DKernel.launches,
                         "seam_sum": SeamSumKernel.launches})
    if isinstance(sw, PrismSweep):
        return (PrismKernel.launch, prism_cost,
                lambda: {"prism_gls_sweep": PrismKernel.launches})
    return ((lambda *a: StructuredKernel.launch(*a, sw.batched)),
            structured_cost, lambda: dict(StructuredKernel.launches))


def measure(op, u):
    """Device times of the apply chain, of the sweep alone (kernel and
    seam sum or fold) and of the kernel alone, best of three windows
    each; the sweep's bound from this operator's tables."""
    import torch

    from ns_gls_tpu_torch.utils.roofline import bound
    from ns_gls_tpu_torch.utils.timer import time_cuda

    reps = REPS
    v = u / torch.linalg.vector_norm(u)
    v = chained_applies(op, v, 5)                    # warm up, build
    if not bool(torch.isfinite(v).all()):
        raise RuntimeError("the apply chain left non-finite values")
    apply_ms = min(
        time_cuda(lambda: chained_applies(op, v, reps), 1) / reps
        for _ in range(3))
    sw = op._fast
    args = sweep_args(op, v)
    tables, sc, uT, ulT, voT, flavor = args[:6]

    def sweep():
        return sw.apply(sc["weight"], sc["stau"], uT, ulT, voT, flavor)

    launch, cost, _ = kernel_of(op)

    def kernel():
        return launch(*args)

    sweep()
    sweep_ms = min(time_cuda(sweep, reps) for _ in range(3))
    kernel_ms = min(time_cuda(kernel, reps) for _ in range(3))
    nbytes, flops = cost(tables, flavor, sw.consider_dt, sw.cell_wise)
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(apply_us=apply_ms * 1e3, sweep_us=sweep_ms * 1e3,
                kernel_us=kernel_ms * 1e3, bound_us=bound_ms * 1e3,
                bound_by=bound_by,
                bound_bytes=nbytes, bound_flops=flops)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_gpu.py")
    ap.add_argument("dim", nargs="?", type=int, default=None)
    ap.add_argument("ref", nargs="?", type=int, default=None)
    ap.add_argument("degree", nargs="?", type=int, default=None)
    ap.add_argument("--increment", action="store_true")
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--sphere", action="store_true",
                    help="the sphere lane: the numbers are [ref] [degree]")
    ap.add_argument("--turek", action="store_true",
                    help="the Turek 3D lane: the numbers are [ref] [degree]")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.sphere and args.turek:
        ap.error("--sphere and --turek are two lanes: give one")
    if args.sphere or args.turek:
        lane_name = "--sphere" if args.sphere else "--turek"
        kernel = "patch-3D" if args.sphere else "prism"
        if args.degree is not None or args.increment or args.batched:
            ap.error(f"{lane_name} takes [ref] [degree] and runs the "
                     f"increment flavor on the {kernel} kernel")
        args.dim, args.ref, args.degree = (
            3, 3 if args.dim is None else args.dim,
            2 if args.ref is None else args.ref)
        args.increment = True
    else:
        args.dim = 3 if args.dim is None else args.dim
        args.ref = 5 if args.ref is None else args.ref
        args.degree = 2 if args.degree is None else args.degree
    if args.batched and args.dim != 3:
        ap.error("--batched selects the batched 3D kernel: it needs dim 3")

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("bench_gpu: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    if args.sphere:
        op, space, u = build_sphere(args.ref, args.degree, args.device)
    elif args.turek:
        op, space, u = build_turek(args.ref, args.degree, args.device)
    else:
        op, space, u = build(args.dim, args.ref, args.degree,
                             args.increment, args.batched, args.device)
    n_dofs = space.n_nodes * (args.dim + 1)
    lane = dict(dim=args.dim, ref=args.ref, degree=args.degree,
                flavor="increment" if args.increment else "fixed",
                batched=args.batched, sphere=args.sphere, turek=args.turek,
                n_cells=space.mesh.n_cells, n_dofs=n_dofs)
    tag = " (sphere)" if args.sphere else (" (turek)" if args.turek else "")
    print(f"gls-vmult{tag}: "
          f"{space.mesh.n_cells} cells, degree {args.degree}, "
          f"{n_dofs} DoFs, {lane['flavor']} flavor"
          f"{', batched kernel' if lane['batched'] else ''}; set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.device == "cpu":
        v = chained_applies(op, u / torch.linalg.vector_norm(u), 2)
        ok = bool(torch.isfinite(v).all())
        print(f"CPU rehearsal: two chained applies, finite = {ok}; "
              "device metrics: not measured")
        return 0 if ok else 1

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    res = measure(op, u)
    mdofs = n_dofs / res["apply_us"]
    print(card)
    print(f"{mdofs:.1f} MDoF/s, {res['apply_us']:.1f} us/apply (chained, "
          f"normalized); sweep alone {res['sweep_us']:.1f} us, its kernel "
          f"{res['kernel_us']:.1f} us; bound "
          f"{res['bound_us']:.1f} us by {res['bound_by']} "
          f"({res['bound_bytes']} B, {res['bound_flops']} flop)")
    print(json.dumps(dict(lane, card=card, mdofs_per_s=mdofs, **res,
                          launches=kernel_of(op)[2]())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
