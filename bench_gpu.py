#!/usr/bin/env python3
"""gls-vmult operator benchmark of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 bench_gpu.py [dim] [ref] [degree] [--increment] [--batched]
    python3 bench_gpu.py [dim] [ref] [degree] [--increment] --shards N
    python3 bench_gpu.py [dim] [ref] [degree] --all
    python3 bench_gpu.py --sphere [ref] [degree]
    python3 bench_gpu.py --turek [ref] [degree]
    python3 bench_gpu.py --turek2d [ref] [degree]
    python3 bench_gpu.py --turek2d-adaptive [ref] [degree]

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

``--turek2d`` is the general-2D-mesh lane (the JAX package's ``bench.py
--turek2d``): the curved Turek 2D mesh refined ``ref`` times (default 4
2: 22,528 cells of Q2), no constraints, BDF-2, the Newton-increment
flavor, q-wise delta, nu = 0.001, c1 = 2, c2 = 1, on the patch-2D sweep
(``ops/patch2d.py``); the same operator on the general gather sweep
(``use_structured=False``) is timed beside it.  ``--turek2d-adaptive``
refines the cells of the wake (0.3 < x < 1.2, |y| < 0.12) once more on
top of ``ref`` global refinements (default 3 2, ``bench.py``'s
``build_turek2d`` at -3: 9,508 cells of Q2): mixed-depth cells, so the
patch-2D sweep runs several patch families, one launch each.

``--shards N`` runs the hypercube operator's structured sweep sharded by
cell slabs over N shards of the one card
(``parallel/structured_sharded.py``; the slab count must be divisible by
N, e.g. ``3 6 2 --shards 4``: 64^3 cells, 16 slabs a shard): the sharded
apply (local sweeps and the plane exchange) beside the one-device sweep,
the exchange alone, and each shard's kernel against its bound at the
shard's shape.  ``--all`` adds the reference's two other lanes beside
the matrix-free apply (``performance.cc:83-142``, ``bench.py --all``):
``ns::vmult::mb``, the assembled operator's SpMV
(``ops/matrix_based.py``), and ``poisson::vmult::mf``, a vector
mass+Laplace matrix-free apply over the same cells (plain PyTorch tensor
code, as the JAX package computes it outside any Pallas kernel); it
needs the fixed-point flavor, the assembled operator's only one.

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


def build_turek2d(refinements=4, degree=2, adaptive=False, device="cuda",
                  use_structured=True):
    """The Turek 2D lane's operator (f32, on the patch-2D sweep, or with
    ``use_structured=False`` on the general gather sweep) with its state
    set, the space, and the start vector (n_nodes, 3): the operator of the
    JAX package's ``bench.py`` ``build_turek2d``; ``adaptive`` refines the
    wake once more (its negative ``refinements``)."""
    import numpy as np
    import torch

    from ns_gls_tpu_torch.fem.constraints import AffineConstraints
    from ns_gls_tpu_torch.fem.space import FESpace
    from ns_gls_tpu_torch.mesh.cylinder import cylinder_mesh_2d
    from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator
    from ns_gls_tpu_torch.ops.patch2d import Patch2DSweep
    from ns_gls_tpu_torch.ops.time_integration import BDFIntegrator

    dtype = torch.float32
    mesh = cylinder_mesh_2d().refine_global(refinements)
    if adaptive:
        c = mesh.vertices[mesh.cells].mean(axis=1)
        mesh = mesh.refine((c[:, 0] > 0.3) & (c[:, 0] < 1.2)
                           & (np.abs(c[:, 1]) < 0.12))
    space = FESpace(mesh, degree)
    ca = AffineConstraints(space.n_nodes, 3).close(dtype, device)
    ti = BDFIntegrator(2)
    ti.update_dt(0.1)
    ti.update_dt(0.1)
    op = NavierStokesOperator(
        space, ca, ca, nu=0.001, c_1=2.0, c_2=1.0, time_integrator=ti,
        consider_time_derivative=True, increment_form=True,
        cell_wise_stabilization=False, dtype=dtype, device=device,
        use_structured=use_structured,
    )
    if use_structured and not isinstance(op._fast, Patch2DSweep):
        raise RuntimeError("the Turek 2D operator did not take the "
                           "patch-2D sweep")
    if not use_structured and op._fast is not None:
        raise RuntimeError("the general-sweep operator holds a fused sweep")
    return op, space, random_state(op)


def poisson_apply(op, v):
    """The vector mass+Laplace matrix-free apply over the operator's
    cells (``performance.cc:97-142``; the JAX package's ``bench.py``
    ``poisson_apply``): gather, evaluate values and gradients, integrate
    them back with the quadrature weights, and the scatter of the
    operator's general sweep (its fixed-order transpose gather-sum, or
    ``index_put_`` where the space has no gather classes)."""
    import torch

    from ns_gls_tpu_torch.ops.navier_stokes import fe_evaluate, fe_integrate

    b = op.batch
    val, grad = fe_evaluate(b.S, b.D, b.jinv, v[b.cell_nodes])
    r_loc = fe_integrate(b.S, b.D, b.jinv, b.jxw, val, grad)
    C = v.shape[1]
    if not b.node_gather:
        r = r_loc.new_zeros(v.shape)
        r.index_put_((b.cell_nodes,), r_loc, accumulate=True)
        return r
    flat = r_loc.reshape(-1, C)
    flat = torch.cat([flat, flat.new_zeros((1, C))], dim=0)
    out = torch.cat([flat[idx].sum(dim=1) for idx in b.node_gather], dim=0)
    if b.node_gather_perm is not None:
        out = out[b.node_gather_perm]
    return out


def time_chain(apply, u):
    """Milliseconds per apply of ``apply`` in a chain of ``REPS``
    (each on the previous, normalized, output), best of three windows,
    after five warm-up applies."""
    import torch

    from ns_gls_tpu_torch.utils.timer import time_cuda

    def chain(v, n):
        for _ in range(n):
            w = apply(v)
            v = w / torch.linalg.vector_norm(w)
        return v

    v = chain(u / torch.linalg.vector_norm(u), 5)
    if not bool(torch.isfinite(v).all()):
        raise RuntimeError("the apply chain left non-finite values")
    return min(time_cuda(lambda: chain(v, REPS), 1) / REPS
               for _ in range(3))


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
    sc = dict(weight=op.weight_host, stau=op.stau_host, nu=sw.nu,
              c1=sw.c1, c2=sw.c2)
    flavor = "increment" if op.increment_form else "fixed"
    uT = sw.gather_nodes(v, op.n_comp).contiguous()
    return (sw.tables, sc, uT, st.u_linT.contiguous(),
            st.vec_oldT.contiguous(), flavor, sw.consider_dt, sw.cell_wise)


def kernel_of(op):
    """(kernel wrapper, cost function, launch counts) of the operator's
    fused sweep: the structured kernels, the patch-2D (every family's
    launch), patch-3D or prism one."""
    from ns_gls_tpu_torch.ops.patch2d import Patch2DSweep, patch2d_tiles
    from ns_gls_tpu_torch.ops.patch3d import Patch3DKernel, Patch3DSweep
    from ns_gls_tpu_torch.ops.prism import PrismKernel, PrismSweep
    from ns_gls_tpu_torch.ops.structured import KERNEL_NAMES, StructuredKernel
    from ns_gls_tpu_torch.utils.roofline import (
        patch2d_cost,
        patch3d_cost,
        prism_cost,
        structured_cost,
    )

    from ns_gls_tpu_torch.utils.timer import counters

    def launches(*names):
        return lambda: {k: counters().get("launch." + k, 0) for k in names}

    sw = op._fast
    if isinstance(sw, Patch2DSweep):
        return (patch2d_tiles, patch2d_cost,
                launches("patch2d_gls_sweep", "seam_sum"))
    if isinstance(sw, Patch3DSweep):
        return (Patch3DKernel.launch, patch3d_cost,
                launches("patch3d_gls_sweep", "seam_sum"))
    if isinstance(sw, PrismSweep):
        return (PrismKernel.launch, prism_cost, launches("prism_gls_sweep"))
    return ((lambda *a: StructuredKernel.launch(*a, sw.batched)),
            structured_cost, launches(*KERNEL_NAMES))


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


def sharded_setup(op, n_shards):
    """The operator's structured sweep sharded by cell slabs over
    ``n_shards`` shards of the current card, and the sharded inputs of the
    lane's apply: (operator, sweep arguments on the whole lattice, the
    scattered u, u_lin, vec_old)."""
    import torch

    from ns_gls_tpu_torch.parallel.structured_sharded import (
        StructuredShardedOperator,
    )

    dev = op.device if op.device.type == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    sop = StructuredShardedOperator(op, [dev] * n_shards)
    u = random_state(op)
    args = sweep_args(op, u / torch.linalg.vector_norm(u))
    _, _, uT, ulT, voT = args[:5]
    return sop, args, (sop.scatter(uT), sop.scatter(ulT), sop.scatter(voT))


def measure_shards(op, n_shards):
    """The sharded apply beside the one-device sweep on the same inputs
    (their max abs difference relative to the one-device max-abs), the
    exchange alone, and each shard's kernel (device time by the profiler)
    against its bound at the shard's shape; best of three windows of
    ``REPS`` calls each."""
    import torch

    from ns_gls_tpu_torch.ops.structured import (
        StructuredKernel,
        structured_sweep,
    )
    from ns_gls_tpu_torch.utils.roofline import bound, structured_cost
    from ns_gls_tpu_torch.utils.timer import device_time_us, time_cuda

    sop, args, (ud, uld, vod) = sharded_setup(op, n_shards)
    tables, sc, uT, ulT, voT, flavor, cdt, cw = args
    w, st = sc["weight"], sc["stau"]

    def one():
        return structured_sweep(tables, sc, uT, ulT, voT, flavor, cdt, cw)

    def sharded():
        return sop.apply(w, st, ud, uld, vod, flavor)

    ref = one()
    got = sop.gather_global(sharded())
    rel = float((got - ref).abs().max() / ref.abs().max())
    rs = sop.local_sweeps(w, st, ud, uld, vod, flavor)
    one_ms = min(time_cuda(one, REPS, 1) for _ in range(3))
    sharded_ms = min(time_cuda(sharded, REPS, 1) for _ in range(3))
    exchange_ms = min(time_cuda(lambda: sop.exchange(rs), REPS, 1)
                      for _ in range(3))
    d = tables.d
    shards = []
    for k, t in enumerate(sop.tables):
        a = (t, sc, ud[k], uld[k], vod[k], flavor, cdt, cw)
        us = device_time_us(lambda: StructuredKernel.launch(*a),
                            f"structured{d}d_kernel")
        nbytes, flops = structured_cost(t, flavor, cdt, cw)
        b_ms, b_by = bound(nbytes, flops)
        shards.append(dict(cells=list(t.cell_shape), kernel_us=us,
                           bound_us=b_ms * 1e3, bound_by=b_by))
    return dict(n_shards=n_shards, one_device_us=one_ms * 1e3,
                sharded_us=sharded_ms * 1e3, exchange_us=exchange_ms * 1e3,
                exchange_share=exchange_ms / sharded_ms,
                exchange_bytes=sop.exchange_elements * 4,
                sharded_rel_err=rel, shards=shards)


def measure_other_lanes(op, u):
    """The ``--all`` lanes: ms per apply of the assembled operator's SpMV
    (``ns::vmult::mb``, after one assembly, timed apart) and of the vector
    mass+Laplace matrix-free apply (``poisson::vmult::mf``)."""
    import torch

    from ns_gls_tpu_torch.ops.matrix_based import (
        NavierStokesOperatorMatrixBased,
    )

    mb = NavierStokesOperatorMatrixBased(op)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mb.ell                          # assembles the matrix
    torch.cuda.synchronize()
    assemble_s = time.perf_counter() - t0
    return dict(mb_ms=time_chain(mb.vmult, u),
                poisson_ms=time_chain(lambda v: poisson_apply(op, v), u),
                mb_assemble_s=assemble_s)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_gpu.py")
    ap.add_argument("dim", nargs="?", type=int, default=None)
    ap.add_argument("ref", nargs="?", type=int, default=None)
    ap.add_argument("degree", nargs="?", type=int, default=None)
    ap.add_argument("--increment", action="store_true")
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--shards", type=int, default=0,
                    help="shard the structured sweep by cell slabs over N "
                         "shards of the card")
    ap.add_argument("--all", action="store_true",
                    help="also the assembled SpMV and the vector "
                         "mass+Laplace lanes")
    ap.add_argument("--sphere", action="store_true",
                    help="the sphere lane: the numbers are [ref] [degree]")
    ap.add_argument("--turek", action="store_true",
                    help="the Turek 3D lane: the numbers are [ref] [degree]")
    ap.add_argument("--turek2d", action="store_true",
                    help="the Turek 2D lane: the numbers are [ref] [degree]")
    ap.add_argument("--turek2d-adaptive", action="store_true",
                    help="the wake-refined Turek 2D lane: [ref] [degree]")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh_lanes = {"--sphere": (args.sphere, "patch-3D", (3, 2)),
                  "--turek": (args.turek, "prism", (3, 2)),
                  "--turek2d": (args.turek2d, "patch-2D", (4, 2)),
                  "--turek2d-adaptive": (args.turek2d_adaptive, "patch-2D",
                                         (3, 2))}
    chosen = [k for k, v in mesh_lanes.items() if v[0]]
    if len(chosen) > 1:
        ap.error(f"{' and '.join(chosen)} are {len(chosen)} lanes: give one")
    lane_name = chosen[0] if chosen else None
    if lane_name:
        _, kernel, (ref0, deg0) = mesh_lanes[lane_name]
        if (args.degree is not None or args.increment or args.batched
                or args.shards or args.all):
            ap.error(f"{lane_name} takes [ref] [degree] and runs the "
                     f"increment flavor on the {kernel} kernel")
        args.dim, args.ref, args.degree = (
            2 if lane_name.startswith("--turek2d") else 3,
            ref0 if args.dim is None else args.dim,
            deg0 if args.ref is None else args.ref)
        args.increment = True
    else:
        args.dim = 3 if args.dim is None else args.dim
        args.ref = 5 if args.ref is None else args.ref
        args.degree = 2 if args.degree is None else args.degree
    if args.batched and args.dim != 3:
        ap.error("--batched selects the batched 3D kernel: it needs dim 3")
    if args.shards and args.batched:
        ap.error("--shards runs the 2D or 3D structured kernel per shard, "
                 "not the batched one")
    if args.shards < 0 or args.shards == 1:
        ap.error("--shards takes a count of at least 2")
    if args.all and (args.increment or args.batched or args.shards):
        ap.error("--all runs the fixed-point flavor (the assembled "
                 "operator's only one) on the structured kernel")

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("bench_gpu: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    adaptive = bool(args.turek2d_adaptive)
    if args.sphere:
        op, space, u = build_sphere(args.ref, args.degree, args.device)
    elif args.turek:
        op, space, u = build_turek(args.ref, args.degree, args.device)
    elif lane_name:
        op, space, u = build_turek2d(args.ref, args.degree, adaptive,
                                     args.device)
    else:
        op, space, u = build(args.dim, args.ref, args.degree,
                             args.increment, args.batched, args.device)
    n_dofs = space.n_nodes * (args.dim + 1)
    lane = dict(dim=args.dim, ref=args.ref, degree=args.degree,
                flavor="increment" if args.increment else "fixed",
                batched=args.batched, sphere=args.sphere, turek=args.turek,
                turek2d=args.turek2d, turek2d_adaptive=adaptive,
                shards=args.shards, n_cells=space.mesh.n_cells,
                n_dofs=n_dofs)
    if lane_name and lane_name.startswith("--turek2d"):
        lane["patch_families"] = len(op._fast.tables.fams)
    tag = f" ({lane_name[2:]})" if lane_name else ""
    print(f"gls-vmult{tag}: "
          f"{space.mesh.n_cells} cells, degree {args.degree}, "
          f"{n_dofs} DoFs, {lane['flavor']} flavor"
          f"{', batched kernel' if lane['batched'] else ''}"
          f"{f', {args.shards} shards' if args.shards else ''}; set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.device == "cpu":
        v = chained_applies(op, u / torch.linalg.vector_norm(u), 2)
        ok = bool(torch.isfinite(v).all())
        if args.shards:
            sop, sargs, (ud, uld, vod) = sharded_setup(op, args.shards)
            tables, sc, uT, ulT, voT, flavor, cdt, cw = sargs
            got = sop.gather_global(sop.apply(sc["weight"], sc["stau"], ud,
                                              uld, vod, flavor))
            ok = ok and bool(torch.isfinite(got).all())
        if lane_name and lane_name.startswith("--turek2d"):
            og, _, ug = build_turek2d(args.ref, args.degree, adaptive,
                                      args.device, use_structured=False)
            ok = ok and bool(torch.isfinite(chained_applies(
                og, ug / torch.linalg.vector_norm(ug), 1)).all())
        if args.all:
            from ns_gls_tpu_torch.ops.matrix_based import (
                NavierStokesOperatorMatrixBased,
            )

            mb = NavierStokesOperatorMatrixBased(op)
            ok = (ok and bool(torch.isfinite(mb.vmult(u)).all())
                  and bool(torch.isfinite(poisson_apply(op, u)).all()))
        print(f"CPU rehearsal: the lane's applies, finite = {ok}; "
              "device metrics: not measured")
        return 0 if ok else 1

    card = card_line()
    res = measure(op, u)
    mdofs = n_dofs / res["apply_us"]
    print(card)
    print(f"{mdofs:.1f} MDoF/s, {res['apply_us']:.1f} us/apply (chained, "
          f"normalized); sweep alone {res['sweep_us']:.1f} us, its kernel "
          f"{res['kernel_us']:.1f} us; bound "
          f"{res['bound_us']:.1f} us by {res['bound_by']} "
          f"({res['bound_bytes']} B, {res['bound_flops']} flop)")
    extra = {}
    if lane_name and lane_name.startswith("--turek2d"):
        og, _, ug = build_turek2d(args.ref, args.degree, adaptive,
                                  args.device, use_structured=False)
        g_ms = time_chain(og.vmult, ug)
        extra.update(general_us=g_ms * 1e3,
                     general_mdofs_per_s=n_dofs / (g_ms * 1e3),
                     speedup_vs_general=g_ms * 1e3 / res["apply_us"])
        print(f"general sweep: {n_dofs / (g_ms * 1e3):.1f} MDoF/s "
              f"({g_ms * 1e3:.1f} us/apply); patch-2D "
              f"{extra['speedup_vs_general']:.2f}x")
        del og, ug
    if args.all:
        o = measure_other_lanes(op, u)
        extra.update(mb_us=o["mb_ms"] * 1e3,
                     mb_mdofs_per_s=n_dofs / (o["mb_ms"] * 1e3),
                     mb_assemble_s=o["mb_assemble_s"],
                     poisson_us=o["poisson_ms"] * 1e3,
                     poisson_mdofs_per_s=n_dofs / (o["poisson_ms"] * 1e3))
        print(f"ns::vmult::mb  {extra['mb_mdofs_per_s']:10.1f} MDoF/s  "
              f"({extra['mb_us']:.1f} us; assembled in "
              f"{o['mb_assemble_s']:.2f} s)")
        print(f"ns::vmult::mf  {mdofs:10.1f} MDoF/s  "
              f"({res['apply_us']:.1f} us)")
        print(f"poisson::vmult::mf {extra['poisson_mdofs_per_s']:7.1f} "
              f"MDoF/s  ({extra['poisson_us']:.1f} us)")
    if args.shards:
        sh = measure_shards(op, args.shards)
        extra["sharded"] = sh
        print(f"{args.shards} shards: sharded apply {sh['sharded_us']:.1f} "
              f"us (one device {sh['one_device_us']:.1f} us), exchange "
              f"{sh['exchange_us']:.1f} us ({100 * sh['exchange_share']:.1f}"
              f"% of the apply, {sh['exchange_bytes']} B); rel err vs one "
              f"device {sh['sharded_rel_err']:.2e}")
        for k, x in enumerate(sh["shards"]):
            print(f"  shard {k} {x['cells']}: kernel {x['kernel_us']:.1f} "
                  f"us, bound {x['bound_us']:.1f} us by {x['bound_by']}")
    print(json.dumps(dict(lane, card=card, mdofs_per_s=mdofs, **res,
                          **extra, launches=kernel_of(op)[2]())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
