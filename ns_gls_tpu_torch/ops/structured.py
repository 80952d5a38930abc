"""Structured-lattice fused GLS sweep and the q-point physics it shares.

Port of ``ns_gls_tpu/ops/structured.py``.  On a structured patch
(``FESpace.structured``: a subdivided rectangle or box, refined globally)
the nodes are a lattice, so the whole operator apply (unfold, sum-
factorized evaluate, q-point GLS physics, integrate, fold) needs no index
tables: the node vector reshapes freely to ``(C,) + lattice_shape``.  The
FESpace numbers the lattice x-innermost, with y (and z) grouped by
residue class mod the degree P: classes 1..P-1 of n entries each, then
class 0 of n+1 entries, so local node j of cell e sits at
``offset[j % P] + e + (j == P)`` (:func:`class_offsets`).

What this module holds:

- :func:`_physics` / :func:`_delta`: the q-point algebra of the
  fixed-point / residual and Newton-increment flavors (mirrors
  ``qpoint_fixed_point`` / ``qpoint_increment`` of
  ``ops/navier_stokes.py``, which mirror ``operator_ns.cc:949-1182``) and
  the stabilization parameters delta_1/delta_2
  (``compute_penalty_parameters``, ``operator_ns.cc:357-420``), on lists
  of tensors of one common shape; shared with the patch-2D and prism
  sweeps.  The CUDA kernels inline the same algebra from
  ``csrc/gls_qpoint.cuh``.
- :class:`StructuredTables` / :func:`build_structured_tables`: the 1D
  tables and the per-cell affine geometry in lattice cell order.
- :func:`structured_sweep_plain`: the plain PyTorch version of the sweep
  (gather by the lattice, ``einsum``-style 1D contractions, physics,
  integrate, ``index_add_``), for tensors on the CPU and as the
  reference the kernels are held to on the card.
- :class:`StructuredKernel`: the ctypes binding of ``csrc/structured.cu``
  (three kernels: 2D, 3D, and the batched 3D variant, whose 1D
  contractions are products over all components stacked);
  :func:`fold_classes`, which sums cell-row tiles into the class-grouped
  lattice in a fixed order;
  :func:`brick_plan` and :func:`batched_plan`, the 3D kernels' splits into
  thread blocks, and :func:`fold_bricks`, which sums their output;
  :func:`slab_plan_2d`, the 2D kernel's, and :func:`fold_seams_2d`, which
  adds its x seams to the lattice it writes.
- :class:`StructuredSweep`: the host wrapper one operator holds.

The TPU layout machinery of the JAX module is not carried over: banded
MXU matrices, lane tiling of the cell tables, the wide / merged / qz-
stacked schedules, the bf16-split precision modes and the diagonal- and
uniform-geometry compile-time variants.  The port is exact f32 with the
full per-cell ``jinv``.

Supported: dim 2/3, any degree whose smallest thread block fits the
card's shared memory (:func:`raise_smem`; degrees 1-6 are built into the
kernels' common library, any other into a library of its own at first
use, ``utils/cuda_build.py`` ``degree_library``), affine cells,
BDF/stationary (theta = 1), cell- or q-wise stabilization, fixed-point /
Newton-increment / residual flavors, f32.  The operator uses another
sweep for anything else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ns_gls_tpu_torch.utils.timer import count

FLAVORS = ("fixed", "increment", "residual")
# the opt-in shared memory of one thread block on an H100 (227 KB).  Like
# the JAX package's Pallas kernels, the port's have no degree limit of
# their own (``utils/cuda_build.py`` ``degree_library``): a degree is
# refused only where the smallest thread block of its kernel needs more
# than this (raise_smem)
SMEM_PER_BLOCK = 232448


def check_degree(kernel: str, P: int):
    """Raise, when the tables are built and before any launch, for a
    degree no kernel instance can exist for (below 1)."""
    if P < 1:
        raise ValueError(f"the port's {kernel} kernel takes degrees 1 and "
                         f"up, not {P}")


def raise_smem(kernel: str, P: int, need: int):
    """Raise, when the tables are built and before any launch, for a
    degree whose smallest block of ``kernel`` needs ``need`` bytes of
    shared memory, more than the card's limit."""
    raise ValueError(
        f"the {kernel} kernel at degree {P} needs {need} bytes of shared "
        f"memory at its smallest thread block, above the card's "
        f"{SMEM_PER_BLOCK} bytes a block (an H100's opt-in limit)")


def _physics(d, flavor, sc, u_val, u_grad, p_val, p_grad,
             u_star, gus, gps, dt_old, d1, d2, consider_dt):
    w = sc["weight"]
    nu = sc["nu"]

    if flavor in ("fixed", "residual"):
        residual = flavor == "residual"
        u_dt = [w * u_val[a] for a in range(d)]
        if residual and dt_old is not None:
            u_dt = [u_dt[a] + dt_old[a] for a in range(d)]
        div = sum(u_grad[a][a] for a in range(d))
        sgb = [sum(u_grad[a][b] * u_star[b] for b in range(d))
               for a in range(d)]
        val_res_u = [u_dt[a] + sgb[a] for a in range(d)]
        pspg = u_dt if consider_dt else [0.0 * u_dt[a] for a in range(d)]
        res0 = [d1 * (pspg[a] + p_grad[a] + sgb[a]) for a in range(d)]
        grad_res_u = [
            [
                nu * (u_grad[a][x] + u_grad[x][a])
                + res0[a] * u_star[x]
                + ((d2 * div - p_val) if a == x else 0.0)
                for x in range(d)
            ]
            for a in range(d)
        ]
        return val_res_u + [div], grad_res_u + [res0]

    # Newton increment flavor
    u_dt = [w * u_val[a] for a in range(d)]
    div = sum(u_grad[a][a] for a in range(d))
    sgu = [sum(u_grad[a][b] * u_star[b] for b in range(d)) for a in range(d)]
    ugs = [sum(gus[a][b] * u_val[b] for b in range(d)) for a in range(d)]
    sgs = [sum(gus[a][b] * u_star[b] for b in range(d)) for a in range(d)]
    val_res_u = [u_dt[a] + sgu[a] + ugs[a] for a in range(d)]
    if consider_dt:
        pspg0 = u_dt
        pspg1 = [w * u_star[a] + dt_old[a] for a in range(d)]
    else:
        pspg0 = [0.0 * u_dt[a] for a in range(d)]
        pspg1 = pspg0
    res0 = [d1 * (pspg0[a] + p_grad[a] + sgu[a] + ugs[a]) for a in range(d)]
    res1 = [d1 * (pspg1[a] + gps[a] + sgs[a]) for a in range(d)]
    grad_res_u = [
        [
            nu * (u_grad[a][x] + u_grad[x][a])
            + res0[a] * u_star[x]
            + res1[a] * u_val[x]
            + ((d2 * div - p_val) if a == x else 0.0)
            for x in range(d)
        ]
        for a in range(d)
    ]
    return val_res_u + [div], grad_res_u + [res0]


def _delta(sc, h1, hq, usq_max, usq_q, cell_wise):
    """delta_1/delta_2: cell-wise (from the cell's max |u*|^2, with the
    viscous switch nu >= h) or per q-point."""
    stau = sc["stau"]
    nu = sc["nu"]
    c1 = sc["c1"]
    c2 = sc["c2"]
    if cell_wise:
        d1_adv = c1 * torch.rsqrt(stau * stau + usq_max / (h1 * h1))
        visc = nu >= h1
        d1 = torch.where(visc, c1 * h1 * h1, d1_adv)
        d2 = torch.where(visc, c2 * h1 * h1, c2 * h1)
        return d1, d2
    u2 = 1e-12 + usq_q
    d1 = torch.rsqrt(stau * stau + 4.0 * u2 / (hq * hq)
                     + 9.0 * (4.0 * nu / (hq * hq)) ** 2)
    d2 = torch.sqrt(u2) * hq * 0.5
    return d1, d2


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------
class StructuredTables(NamedTuple):
    """Device tables of the structured sweep; cells in lattice order
    (x fastest, then y, then z)."""

    d: int
    P: int
    NQ: int
    cell_shape: tuple       # (nx, ny[, nz])
    S1: torch.Tensor        # (NQ, P+1) 1D values at the Gauss points
    D1: torch.Tensor        # (NQ, P+1) 1D derivatives
    jinv: torch.Tensor      # (n_c, d*d): entry r*d + x = dxi_r/dx_x
    jxw: torch.Tensor       # (n_c, NQ^d): q = qx + NQ*qy (+ NQ^2*qz)
    h: torch.Tensor         # (n_c, 2): h_min_vertex, measure-based h / P


def class_offsets(P: int, n: int) -> list:
    """Offset of residue class k in the class-grouped axis layout
    (classes 1..P-1 of n entries each, then class 0 of n+1 entries)."""
    return [(k - 1) * n if k >= 1 else (P - 1) * n for k in range(P)]


def class_index(P: int, n: int) -> np.ndarray:
    """(n, P+1) class-grouped position of local node j of cell e on an
    axis of n cells: ``offset[j % P] + e + (j == P)``."""
    off = np.asarray(class_offsets(P, n))
    j = np.arange(P + 1)
    return off[j % P][None, :] + np.arange(n)[:, None] + (j == P)[None, :]


def lattice_shape(P: int, cell_shape) -> tuple:
    """Shape the flat node vector of a structured space reshapes to:
    (P*nz+1, P*ny+1, P*nx+1) in 3D, (P*ny+1, 1, P*nx+1) in 2D; all axes
    but x class-grouped."""
    nx, ny = cell_shape[0], cell_shape[1]
    if len(cell_shape) == 3:
        return (P * cell_shape[2] + 1, P * ny + 1, P * nx + 1)
    return (P * ny + 1, 1, P * nx + 1)


@functools.lru_cache(maxsize=16)
def lattice_cell_nodes(P: int, cell_shape: tuple) -> np.ndarray:
    """(n_c, (P+1)^d) flat lattice index of every cell's local nodes,
    cells in lattice order, local nodes x fastest."""
    nx = cell_shape[0]
    Nx = P * nx + 1
    idx = (P * np.arange(nx)[:, None] + np.arange(P + 1)[None, :])  # (nx, i)
    mult = Nx
    for n in cell_shape[1:]:
        ci = class_index(P, n) * mult                   # (n, j)
        # new cell axis outermost, new local axis outermost
        idx = ci[:, None, :, None] + idx[None, :, None, :]
        idx = idx.reshape(ci.shape[0] * idx.shape[1], -1)
        mult *= P * n + 1
    return idx


def build_structured_tables(op):
    """Host-side packing; None when the operator/space is unsupported
    (the gates of the JAX package: structured space, affine geometry,
    theta = 1, f32, dim 2 or 3)."""
    space = op.space
    if not getattr(space, "structured", False):
        return None
    if not op.affine_geometry or op.theta != 1.0:
        return None
    if op.dtype != torch.float32:
        return None
    d = space.dim
    if d not in (2, 3):
        return None

    from ns_gls_tpu_torch.fem.lagrange import (
        eval_lagrange,
        gauss_lobatto_points_1d,
        gauss_points_1d,
    )

    P = space.degree
    check_degree(f"structured {d}D", P)
    # the plan of the dimension's kernel: raises where no block fits
    (slab_plan_2d if d == 2 else brick_plan)(
        P, tuple(int(n) for n in space.cell_shape))
    NQ = space.n_q1d
    nodes = gauss_lobatto_points_1d(P + 1)
    qpts, _ = gauss_points_1d(NQ)
    S1, D1 = eval_lagrange(tuple(nodes), np.asarray(qpts))  # (NQ, P+1)

    # cells in lattice order: x fastest, then y, then z
    lat = space.mesh.lattice
    perm = np.lexsort(tuple(lat[:, k] for k in range(d)))
    n_c = space.mesh.n_cells
    jinv = np.asarray(space.jinv)[perm, 0].reshape(n_c, d * d)
    jxw = np.asarray(space.jxw)[perm]
    h1 = np.asarray(space.cell_h_min_vertex)
    if d == 2:
        hq = np.sqrt(4.0 * space.cell_measure / np.pi) / P
    else:
        hq = np.cbrt(6.0 * space.cell_measure / np.pi) / P
    h = np.stack([h1, hq], axis=1)[perm]

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=op.device)

    return StructuredTables(
        d=d, P=P, NQ=NQ, cell_shape=tuple(int(n) for n in space.cell_shape),
        S1=f32(S1), D1=f32(D1), jinv=f32(jinv), jxw=f32(jxw), h=f32(h),
    )


# ---------------------------------------------------------------------------
# the sweep: plain version
# ---------------------------------------------------------------------------
def _need_dt_old(flavor: str, consider_dt: bool) -> bool:
    """The history term enters the increment and residual flavors, and
    only with the time derivative in the stabilization (as in the JAX
    kernels: the residual without it drops the history)."""
    return consider_dt and flavor in ("increment", "residual")


def _contract(t, mats, transpose=False):
    """Apply one 1D table per trailing axis of ``t`` (outermost axis
    first): (NQ, P+1) tables map nodes to q-points, transposed they map
    q-points back to nodes."""
    nd = len(mats)
    for a, M in enumerate(mats):
        axis = t.dim() - nd + a
        t = torch.tensordot(t, M, dims=([axis], [0 if transpose else 1]))
        t = t.movedim(-1, axis)
    return t


def structured_sweep_plain(tables: StructuredTables, sc: dict, uT, ulT, voT,
                           flavor: str, consider_dt: bool, cell_wise: bool):
    """Plain PyTorch version of the structured sweep, for d = 2 and 3.
    ``sc``: weight, stau, nu, c1, c2 (floats, used in f32).  uT, ulT
    ``(C,) + lattice_shape``, voT ``(d,) + lattice_shape`` -> the operator
    apply in the same layout."""
    d, P, NQ = tables.d, tables.P, tables.NQ
    C = d + 1
    dev = uT.device
    sc = {k: torch.tensor(v, dtype=torch.float32, device=dev)
          for k, v in sc.items()}
    S1, D1 = tables.S1, tables.D1
    idx = torch.as_tensor(lattice_cell_nodes(P, tables.cell_shape),
                          device=dev)
    n_c = idx.shape[0]
    need_lin_grads = flavor == "increment"
    need_dt_old = _need_dt_old(flavor, consider_dt)
    cell = (n_c,) + (1,) * d

    def tabs(deriv_axis=None):
        # tables for the trailing axes ([z,] y, x); reference direction r
        # (0 = x) is trailing axis d - 1 - r
        return [D1 if a == deriv_axis else S1 for a in range(d)]

    def fwd(t, grads):
        # t (lattice) -> value and reference gradient [d/dxi_x, d/dxi_y,
        # ...] at the q-points, each (n_c, [NQ,] NQ, NQ)
        loc = t.reshape(-1)[idx].reshape((n_c,) + (P + 1,) * d)
        val = _contract(loc, tabs())
        if not grads:
            return val, None
        return val, [_contract(loc, tabs(d - 1 - r)) for r in range(d)]

    ji = [tables.jinv[:, e].reshape(cell) for e in range(d * d)]

    def to_phys(ref):
        return [sum(ref[r] * ji[r * d + x] for r in range(d))
                for x in range(d)]

    u = [fwd(uT[c], True) for c in range(C)]
    ul = [fwd(ulT[c], need_lin_grads)
          for c in range(C if need_lin_grads else d)]
    dt_old = ([fwd(voT[a], False)[0] for a in range(d)]
              if need_dt_old else None)

    ustar = [ul[a][0] for a in range(d)]
    usq = sum(s * s for s in ustar)
    h1 = tables.h[:, 0].reshape(cell)
    hq = tables.h[:, 1].reshape(cell)
    if cell_wise:
        msq = usq.amax(dim=tuple(range(1, d + 1)), keepdim=True)
        d1_q, d2_q = _delta(sc, h1, hq, msq, None, True)
    else:
        d1_q, d2_q = _delta(sc, h1, hq, None, usq, False)

    u_grad = [to_phys(u[a][1]) for a in range(d)]
    p_grad = to_phys(u[d][1])
    gus = gps = None
    if need_lin_grads:
        gus = [to_phys(ul[a][1]) for a in range(d)]
        gps = to_phys(ul[d][1])

    val_res, grad_res = _physics(
        d, flavor, sc, [u[a][0] for a in range(d)], u_grad, u[d][0], p_grad,
        ustar, gus, gps, dt_old, d1_q, d2_q, consider_dt,
    )

    jxw = tables.jxw.reshape((n_c,) + (NQ,) * d)
    out = torch.zeros((C, uT[0].numel()), dtype=uT.dtype, device=dev)
    flat = idx.reshape(-1)
    for c in range(C):
        r_loc = _contract(val_res[c] * jxw, tabs(), transpose=True)
        for r in range(d):
            gref = sum(grad_res[c][x] * ji[r * d + x] for x in range(d)) * jxw
            r_loc = r_loc + _contract(gref, tabs(d - 1 - r), transpose=True)
        out[c].index_add_(0, flat, r_loc.reshape(-1))
    return out.reshape(uT.shape)


# ---------------------------------------------------------------------------
# the sweep: kernels
# ---------------------------------------------------------------------------
def fold_classes(t, cell_dim: int, loc_dim: int, P: int):
    """Sum cell-row tiles along one axis into the class-grouped lattice:
    ``t`` holds, at (cell e, local node j) of dims (cell_dim, loc_dim),
    the integrals over cell e only; the result has one axis of P*n+1
    class-grouped entries in place of cell_dim, and loc_dim is gone.
    Interior classes copy; class 0 adds the two cells that share the
    node, always in the same order."""
    n = t.shape[cell_dim]
    shape = list(t.shape)
    shape[cell_dim] = P * n + 1
    del shape[loc_dim]
    out = t.new_empty(shape)
    for k in range(1, P):
        out.narrow(cell_dim, (k - 1) * n, n).copy_(t.select(loc_dim, k))
    lo, hi = t.select(loc_dim, 0), t.select(loc_dim, P)
    c0 = out.narrow(cell_dim, (P - 1) * n, n + 1)
    c0.narrow(cell_dim, 0, 1).copy_(lo.narrow(cell_dim, 0, 1))
    c0.narrow(cell_dim, n, 1).copy_(hi.narrow(cell_dim, n - 1, 1))
    if n > 1:
        torch.add(lo.narrow(cell_dim, 1, n - 1), hi.narrow(cell_dim, 0, n - 1),
                  out=c0.narrow(cell_dim, 1, n - 1))
    return out


class BrickPlan(NamedTuple):
    """How the 3D kernel splits a lattice into thread blocks: one block per
    (x brick of ``xb`` cells, cell row, z chunk of ``zc`` cell layers),
    walking its chunk in slabs of ``zs`` layers."""

    xb: int     # cells per brick along x (the last brick may hold fewer)
    nbx: int    # bricks per cell row
    zs: int     # cell layers per slab
    zc: int     # cell layers per z chunk
    nzb: int    # z chunks per column


# per degree: brick shapes (cells along x, cell layers per slab) of about
# 250 to 512 q-points per slab of 256 threads, within ~113 KB of shared
# memory (two blocks per SM)
BRICKS = {1: ((8, 8), (16, 4)), 2: ((8, 2), (4, 4)), 3: ((4, 1), (2, 2)),
          4: ((2, 1), (1, 2))}
# blocks of the 3D kernel resident at once on an H100: two per SM
WAVE = 2 * 132


def brick_smem(P: int, xb: int, zs: int, flavor: str,
               consider_dt: bool) -> int:
    """Dynamic shared memory of one block of the 3D kernel in bytes, as its
    launcher computes it (``csrc/structured.cu`` ``s3_smem``): two buffers
    of the slab's node planes of every staged field and of its cells'
    geometry, the two regions the contraction stages alternate between,
    and the cells' max |u*|^2."""
    n1 = nq = P + 1
    incr = flavor == "increment"
    nf = 4 + (4 if incr else 3) + (3 if _need_dt_old(flavor, consider_dt)
                                   else 0)
    ng = 8 if incr else 4
    xn, lx = P * xb + 1, nq * xb
    zn, lz = P * zs + 1, nq * zs
    pl, qs, xf = n1 * xn, lz * nq * lx, lz * n1 * lx
    floats = (2 * nf * zn * pl + 2 * zs * xb * (11 + nq ** 3)
              + max((nf + ng) * lz * pl, 16 * qs, 8 * lz * pl)
              + max((nf + 2 * ng) * xf, 12 * xf) + zs * xb)
    return 4 * floats


def fitting_shapes(kernel: str, P: int, shapes, smem) -> tuple:
    """Of the block shapes ``shapes`` (cells along x, cell layers or rows
    per slab), those whose shared memory ``smem(P, xb, zs, flavor,
    consider_dt)`` in the flavor that needs the most fits the card, else
    the smallest block (1, 1) alone where that fits; raises
    (:func:`raise_smem`) where not even that does."""
    def need(s):
        return smem(P, *s, "increment", True)

    fit = tuple(s for s in shapes if need(s) <= SMEM_PER_BLOCK)
    if fit:
        return fit
    if need((1, 1)) > SMEM_PER_BLOCK:
        raise_smem(kernel, P, need((1, 1)))
    return ((1, 1),)


def _plan_3d(P: int, cell_shape: tuple, shapes, wave: int) -> BrickPlan:
    """Of the brick shapes ``shapes`` (cells along x, cell layers per slab)
    and the z chunkings (a chunk recomputes the layer below it for its
    carry), the plan of least estimated time, waves of ``wave`` resident
    blocks x slabs per block x a slab's time (a fixed part as long as 256
    q-points, plus its q-points); ties go to fewer blocks, then longer
    bricks.  A slab is no deeper than the chunk's walk."""
    nx, ny, nz = cell_shape
    nq3 = (P + 1) ** 3
    best = None
    for xb0, zs0 in shapes:
        xb = min(xb0, nx)
        nbx = -(-nx // xb)
        nzb = 1
        while nzb <= nz:
            zc = -(-nz // nzb)
            n_chunks = -(-nz // zc)
            walk = zc + (1 if n_chunks > 1 else 0)
            zs = min(zs0, walk)
            blocks = nbx * ny * n_chunks
            cost = (-(-blocks // wave) * -(-walk // zs)
                    * (256 + xb * zs * nq3), blocks, -xb)
            if best is None or cost < best[0]:
                best = (cost, BrickPlan(xb, nbx, zs, zc, n_chunks))
            nzb *= 2
    return best[1]


@functools.lru_cache(maxsize=64)
def brick_plan(P: int, cell_shape: tuple) -> BrickPlan:
    """The 3D kernel's blocks for a lattice of ``cell_shape`` (nx, ny, nz)
    cells of degree P (:func:`_plan_3d` over the shapes of ``BRICKS`` that
    fit the card, :func:`fitting_shapes`)."""
    shapes = fitting_shapes("structured 3D", P, BRICKS.get(P, ((1, 1),)),
                            brick_smem)
    return _plan_3d(P, cell_shape, shapes, WAVE)


# per degree: the batched 3D kernel's brick shapes (cells along x, cell
# layers per slab), about 216 to 324 q-points a slab of 256 threads; every
# one fits two blocks per SM but at P = 6 (one cell a slab, 115 KB).  At P
# = 2, (4, 3) first: the fastest of the plans tools/structured_levels.py
# --sweep timed at 32^3, 64 x 16 x 16 and 128 x 32 x 32 cells
BATCHED_BRICKS = {1: ((16, 2), (8, 4), (32, 1)),
                  2: ((4, 3), (8, 1), (4, 2), (2, 4)),
                  3: ((4, 1), (2, 2), (1, 4)), 4: ((2, 1), (1, 2)),
                  5: ((1, 1),), 6: ((1, 1),)}
# the dynamic shared memory per block within which two blocks fit on an
# H100's SM (228 KB, 1 KB of it reserved per block, and the kernel's static
# shared memory)
SMEM_TWO_BLOCKS = 112 * 1024


def batched_smem(P: int, xb: int, zs: int, flavor: str,
                 consider_dt: bool) -> int:
    """Dynamic shared memory of one block of the batched 3D kernel in
    bytes, as its launcher computes it (``csrc/structured.cu``
    ``sb_smem``): two buffers of the slab's node planes of every staged
    field and of its cells' geometry, the two regions the contraction
    stages alternate between, and the cells' max |u*|^2."""
    n1 = nq = P + 1
    incr = flavor == "increment"
    nf = 4 + (4 if incr else 3) + (3 if _need_dt_old(flavor, consider_dt)
                                   else 0)
    ng = 8 if incr else 4
    xn, lx = P * xb + 1, nq * xb
    zn, lz = P * zs + 1, nq * zs
    pl, qs, xf = n1 * xn, lz * nq * lx, lz * n1 * lx
    r1 = max((nf + ng) * lz * pl, (nf + 3 * ng) * qs, 12 * xf,
             4 * n1 * zs * xn * n1)
    r2 = max((nf + 2 * ng) * xf, 16 * qs, 8 * lz * n1 * xb * n1)
    floats = (2 * nf * zn * pl + 2 * zs * xb * (11 + nq ** 3) + r1 + r2
              + zs * xb)
    return 4 * floats


@functools.lru_cache(maxsize=64)
def batched_plan(P: int, cell_shape: tuple) -> BrickPlan:
    """The batched 3D kernel's blocks for a lattice of ``cell_shape`` (nx,
    ny, nz) cells of degree P: :func:`_plan_3d` over the shapes of
    ``BATCHED_BRICKS`` that fit the card (:func:`fitting_shapes`), two
    blocks a wave per SM where the shapes' shared memory (in the flavor
    that needs the most) allows it, one where not."""
    shapes = fitting_shapes("batched structured 3D", P,
                            BATCHED_BRICKS.get(P, ((1, 1),)), batched_smem)
    two = all(batched_smem(P, *s, "increment", True) <= SMEM_TWO_BLOCKS
              for s in shapes)
    return _plan_3d(P, cell_shape, shapes, (2 if two else 1) * 132)


def fold_bricks(tables: StructuredTables, tiles, seams, xb: int):
    """The 3D kernel's output -> ``(C,) + lattice_shape``: ``tiles`` (C, Zr,
    ny, P+1, Nx) hold each cell row's integrals but the first node column
    of bricks 1.., which ``seams`` (C, Zr, ny, P+1, nbx) hold at their
    brick's index; those are added at the x seams (in place), then the
    node rows shared by two cell rows are summed (:func:`fold_classes`)."""
    P = tables.P
    nbx = seams.shape[-1]
    if nbx > 1:
        step = P * xb
        tiles[..., step:step * (nbx - 1) + 1:step] += seams[..., 1:]
    return fold_classes(tiles, 2, 3, P)


class SlabPlan2D(NamedTuple):
    """How the 2D kernel splits a lattice into thread blocks: one block per
    (x brick of ``xb`` cells, y chunk of ``yc`` cell rows), walking its
    chunk in slabs of ``ys`` cell rows."""

    xb: int     # cells per brick along x (the last brick may hold fewer)
    nbx: int    # bricks per cell row
    ys: int     # cell rows per slab
    yc: int     # cell rows per y chunk
    nyb: int    # y chunks


# per degree: brick shapes (cells along x, cell rows per slab) of 1-4 passes
# of the kernel's E2 stage (a warp takes 32 // (P+1)^2 cells a pass, one
# cell above 32 q-points)
SLABS_2D = {1: ((32, 8), (16, 8), (64, 2), (16, 4)),
            2: ((12, 8), (24, 4), (16, 6), (12, 4), (8, 3)),
            3: ((12, 4), (16, 2), (8, 4), (8, 2)),
            4: ((8, 4), (16, 2), (8, 2), (4, 2)),
            5: ((8, 2), (4, 4), (4, 2), (8, 1)),
            6: ((8, 1), (4, 2), (4, 1)), 7: ((8, 1), (4, 2), (4, 1))}
# blocks of the 2D kernel resident at once on an H100: two per SM
WAVE_2D = 2 * 132
# the shared memory per block the plans stay within: two blocks per SM
SMEM_2D = 113 * 1024


def slab_smem_2d(P: int, xb: int, ys: int, flavor: str,
                 consider_dt: bool) -> int:
    """Dynamic shared memory of one 2D block in bytes, as the launcher
    computes it (``csrc/structured.cu`` ``s2_smem``): two buffers of the
    slab's node rows of every staged field and of its cells' geometry, the
    y-contracted fields and the test-function weights."""
    n1 = NQ = P + 1
    incr = flavor == "increment"
    nf = 3 + (3 if incr else 2) + (2 if _need_dt_old(flavor, consider_dt)
                                   else 0)
    ng = 6 if incr else 3
    xn, lx = P * xb + 1, NQ * xb
    yn, ly = P * ys + 1, NQ * ys
    floats = (2 * nf * yn * xn + 2 * ys * xb * (6 + n1 * n1)
              + max((nf + ng) * ly * xn, 6 * ly * xn) + 9 * ly * lx)
    return 4 * floats


@functools.lru_cache(maxsize=64)
def slab_plan_2d(P: int, cell_shape: tuple) -> SlabPlan2D:
    """The 2D kernel's blocks for a lattice of ``cell_shape`` (nx, ny)
    cells of degree P: of the brick shapes of ``SLABS_2D`` (those within
    ``SMEM_2D`` in every flavor, else those within the card's limit,
    :func:`fitting_shapes`) and the y chunkings (a chunk recomputes
    the cell row below it for its carry), the one of least estimated time,
    waves of resident blocks x slabs per block x a slab's time (a fixed
    part as long as 256 q-points, plus its q-points); ties go to taller
    slabs (fewer node rows staged twice), then fewer blocks, then longer
    bricks.  A slab is no deeper than the chunk's walk."""
    nx, ny = cell_shape
    nq2 = (P + 1) ** 2
    shapes = SLABS_2D.get(P, ((1, 1),))
    two = tuple(s for s in shapes
                if slab_smem_2d(P, *s, "increment", True) <= SMEM_2D)
    best = None
    for xb0, ys0 in two or fitting_shapes("structured 2D", P, shapes,
                                          slab_smem_2d):
        xb = min(xb0, nx)
        nbx = -(-nx // xb)
        yc_seen = set()
        for nyb in range(1, ny + 1):
            yc = -(-ny // nyb)
            if yc in yc_seen:
                continue
            yc_seen.add(yc)
            n_chunks = -(-ny // yc)
            walk = yc + (1 if n_chunks > 1 else 0)
            ys = min(ys0, walk)
            blocks = nbx * n_chunks
            cost = (-(-blocks // WAVE_2D) * -(-walk // ys)
                    * (256 + xb * ys * nq2), -ys, blocks, -xb)
            if best is None or cost < best[0]:
                best = (cost, SlabPlan2D(xb, nbx, ys, yc, n_chunks))
    return best[1]


def fold_seams_2d(tables: StructuredTables, out, seams, xb: int):
    """The 2D kernel's output -> ``(C,) + lattice_shape``: ``out`` (C, Yr,
    1, Nx) is the lattice, complete but for the first node column of
    bricks 1.., which ``seams`` (C, Yr, nbx) hold at their brick's index;
    those are added at the x seams, in place, and ``out`` is returned."""
    nbx = seams.shape[-1]
    if nbx > 1:
        step = tables.P * xb
        out[:, :, 0, step:step * (nbx - 1) + 1:step] += seams[..., 1:]
    return out


# launches of each CUDA kernel in this process: one per successful
# ``StructuredKernel.launch``, nowhere else (``utils/timer.py`` counters)
LAUNCH_PREFIX = "launch."
KERNEL_NAMES = ("structured2d", "structured3d", "structured3d_batched")
for _name in KERNEL_NAMES:
    count(LAUNCH_PREFIX + _name, 0)


class StructuredKernel:
    """ctypes binding of ``csrc/structured.cu``; the library is built at
    first use (``utils/cuda_build.py``)."""

    # per degree: the library that holds its instances
    _libs: dict = {}

    @classmethod
    def _load(cls, P: int):
        if P not in cls._libs:
            from ns_gls_tpu_torch.utils.cuda_build import degree_library

            lib = degree_library("structured", P)
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            for fn in (lib.structured3d_launch,
                       lib.structured3d_batched_launch):
                fn.argtypes = [vp] * 10 + [ci] * 8 + [cf] * 5 + [ci] * 3 + [
                    vp]
                fn.restype = ci
            fn = lib.structured2d_launch
            fn.argtypes = [vp] * 10 + [ci] * 7 + [cf] * 5 + [ci] * 3 + [vp]
            fn.restype = ci
            for fn in (lib.structured3d_attributes,
                       lib.structured3d_batched_attributes,
                       lib.structured2d_attributes):
                fn.argtypes = [ci] * 5 + [ctypes.POINTER(ci)] * 3 + [
                    ctypes.POINTER(ctypes.c_longlong)]
                fn.restype = ci
            cls._libs[P] = lib
        return cls._libs[P]

    @staticmethod
    def kernel_name(d: int, batched: bool) -> str:
        if d == 2:
            return "structured2d"
        return "structured3d_batched" if batched else "structured3d"

    @classmethod
    def attributes(cls, P: int, plan, flavor: str, consider_dt: bool,
                   batched: bool = False) -> dict:
        """Registers per thread, local memory (spills) and static shared
        memory of ``structured3d_kernel<P>`` (``plan`` a
        :class:`BrickPlan`; ``batched``: ``structured3d_batched_kernel<P>``)
        or ``structured2d_kernel<P>`` (a :class:`SlabPlan2D`) as built, and
        the dynamic shared memory of one block under ``plan`` in that
        flavor."""
        vals = [ctypes.c_int() for _ in range(3)] + [ctypes.c_longlong()]
        lib = cls._load(P)
        if isinstance(plan, SlabPlan2D):
            name, depth = "structured2d_attributes", plan.ys
        elif batched:
            name, depth = "structured3d_batched_attributes", plan.zs
        else:
            name, depth = "structured3d_attributes", plan.zs
        fn = getattr(lib, name)
        err = fn(P, plan.xb, depth, FLAVORS.index(flavor), int(consider_dt),
                 *(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return dict(registers=vals[0].value, local_bytes=vals[1].value,
                    static_smem=vals[2].value, dynamic_smem=vals[3].value)

    @classmethod
    def launch(cls, tables: StructuredTables, sc: dict, uT, ulT, voT,
               flavor: str, consider_dt: bool, cell_wise: bool,
               batched: bool = False, plan=None):
        """Launch the kernel of the tables' dimension and return its
        output: the 2D kernel (lattice, seams) under ``plan`` (default
        :func:`slab_plan_2d`; see :func:`fold_seams_2d`), the 3D kernels
        (tiles, seams) under ``plan`` (default :func:`brick_plan`, batched
        :func:`batched_plan`; see :func:`fold_bricks`).  Raises on what the
        kernel does not take."""
        d, P, NQ = tables.d, tables.P, tables.NQ
        C = d + 1
        shp = lattice_shape(P, tables.cell_shape)
        for name, t, lead in (("u", uT, C), ("u_lin", ulT, C),
                              ("vec_old", voT, d)):
            if not t.is_cuda or t.dtype != torch.float32:
                raise TypeError(f"{name}: need a float32 CUDA tensor")
            if tuple(t.shape) != (lead,) + shp:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, need "
                                 f"{(lead,) + shp}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: need a contiguous tensor")
        for t in (tables.jinv, tables.jxw, tables.h, tables.S1, tables.D1):
            if t.device != uT.device or not t.is_contiguous():
                raise ValueError("tables must be contiguous on u's device")
        nx, ny = tables.cell_shape[0], tables.cell_shape[1]
        nz = tables.cell_shape[2] if d == 3 else 1
        lib = cls._load(P)
        scal = [sc[k] for k in ("weight", "stau", "nu", "c1", "c2")]
        ptrs = [t.data_ptr() for t in (uT, ulT, voT, tables.jinv, tables.jxw,
                                       tables.h, tables.S1, tables.D1)]
        case = [FLAVORS.index(flavor), int(consider_dt), int(cell_wise)]
        stream = torch.cuda.current_stream(uT.device).cuda_stream
        f32 = dict(dtype=torch.float32, device=uT.device)
        if d == 2:
            plan = plan or slab_plan_2d(P, tables.cell_shape)
            lat = torch.empty((C,) + shp, **f32)
            seams = torch.empty((C, shp[0], plan.nbx), **f32)
            out = (lat, seams)
            err = lib.structured2d_launch(
                *ptrs, lat.data_ptr(), seams.data_ptr(), P, NQ, nx, ny,
                *case, *scal, plan.xb, plan.ys, plan.nyb, stream)
            hint = (f" (degree {P} with {NQ} Gauss points, or the plan "
                    f"{tuple(plan)}, is not one the kernel takes)")
        else:
            plan = plan or (batched_plan if batched else brick_plan)(
                P, tables.cell_shape)
            tiles = torch.empty((C, shp[0], ny, P + 1, shp[2]), **f32)
            seams = torch.empty((C, shp[0], ny, P + 1, plan.nbx), **f32)
            out = (tiles, seams)
            fn = (lib.structured3d_batched_launch if batched
                  else lib.structured3d_launch)
            err = fn(*ptrs, tiles.data_ptr(), seams.data_ptr(), P, NQ, nx,
                     ny, nz, *case, *scal, plan.xb, plan.zs, plan.nzb, stream)
            hint = (f" (degree {P} with {NQ} Gauss points, or the plan "
                    f"{tuple(plan)}, is not one the kernel takes)")
        if err != 0:
            raise RuntimeError(f"structured kernel launch failed: CUDA error "
                               f"{err}{hint if err == 1 else ''}")
        count(LAUNCH_PREFIX + cls.kernel_name(d, batched))
        return out


def structured_sweep(tables: StructuredTables, sc: dict, uT, ulT, voT,
                     flavor: str, consider_dt: bool, cell_wise: bool,
                     batched: bool = False):
    """The structured sweep: a CUDA kernel and the sum of what its blocks
    share (the 2D kernel's x seams; the 3D kernels' x seams and node rows)
    for tensors on the card, the plain version for tensors on the CPU.
    ``batched`` selects the batched 3D kernel (2D has one kernel)."""
    if uT.is_cuda:
        out = StructuredKernel.launch(tables, sc, uT, ulT, voT, flavor,
                                      consider_dt, cell_wise, batched)
        if tables.d == 2:
            return fold_seams_2d(tables, *out,
                                 slab_plan_2d(tables.P, tables.cell_shape).xb)
        plan = (batched_plan if batched else brick_plan)(tables.P,
                                                         tables.cell_shape)
        return fold_bricks(tables, *out, plan.xb)
    if uT.device.type != "cpu":
        raise TypeError(f"structured sweep: unsupported device {uT.device}")
    return structured_sweep_plain(tables, sc, uT, ulT, voT, flavor,
                                  consider_dt, cell_wise)


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------
class StructuredSweep:
    """Applies the fused structured sweep for one operator, with the
    interface of ``ops/patch2d.py`` ``Patch2DSweep``: ``gather_nodes(v,
    lead)`` views the first ``lead`` components of a node-major vector
    (n_nodes, C) as ``(lead,) + lattice_shape`` (a transpose and a
    reshape of the class-grouped numbering: no index table, which is the
    point of this path), and ``apply(...)`` runs the sweep on such views
    and returns (n_nodes, C).  ``batched=True`` selects the 3D kernel
    that contracts all components together; nothing in the driver sets
    it, as in the JAX package.
    """

    def __init__(self, op, tables: StructuredTables, batched: bool = False):
        self.tables = tables
        self.lattice_shape = lattice_shape(tables.P, tables.cell_shape)
        self.batched = bool(batched)
        if self.batched:
            batched_plan(tables.P, tables.cell_shape)   # raises if no fit
        self.consider_dt = op.consider_time_derivative
        self.cell_wise = op.cell_wise_stabilization
        self.nu = op.nu
        self.c1 = op.c_1
        self.c2 = op.c_2

    def view_shape(self, lead: int):
        return (lead,) + self.lattice_shape

    def gather_nodes(self, v, lead: int):
        """(n_nodes, C) -> (lead,) + lattice_shape, contiguous (one
        transpose copy here, so that ``apply`` makes none)."""
        return v[:, :lead].T.contiguous().reshape(self.view_shape(lead))

    def apply(self, weight: float, stau: float, uT, ulT, voT, flavor: str):
        sc = dict(weight=weight, stau=stau, nu=self.nu, c1=self.c1,
                  c2=self.c2)
        out = structured_sweep(self.tables, sc, uT.contiguous(),
                               ulT.contiguous(), voT.contiguous(), flavor,
                               self.consider_dt, self.cell_wise,
                               self.batched)
        return out.reshape(out.shape[0], -1).T
