"""The least time the card could take for one fused GLS sweep.

Counts the work the FUNCTION needs, not a kernel's own loops: every input
read once and the output written once, over the card's memory rate; a
sum-factorized evaluation and integration plus the q-point algebra, over
the card's f32 rate.  The bound is the larger of the two times.  Used by
``chip_smoke.py`` and ``bench_gpu.py`` beside every measured kernel time.
"""

from __future__ import annotations

import math

# card peaks (H100 SXM data sheet, dense, at a 700 W power limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


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


def sweep_cost(d, n_tiles, n1, nodes, qpts, n_in, n_out, geometry, nq,
               cells, flavor, consider_dt, cell_wise, full_jinv=False):
    """(bytes, flops) of the least work of one fused GLS sweep with its
    seam compress over ``n_tiles`` tiles of ``nodes`` nodes: the inputs
    read once at ``n_in`` nodes (the whole tiles where the kernel takes
    gathered tiles, each node once where it reads node-major vectors),
    the compressed node-major output (n_out nodes) written once,
    ``geometry`` 4-byte table entries (floats, int32 lattice ids) read
    once; sum-factorized evaluation of u, u_lin and the history and
    integration of the test-function weights, plus the q-point work.
    ``full_jinv``: a full d x d inverse Jacobian per cell (the structured
    sweep) instead of the prismatic one in 3D."""
    C = d + 1
    incr = flavor == "increment"
    dt_old = consider_dt and flavor in ("increment", "residual")
    lead_in = C + (C if incr else d) + (d if dt_old else 0)
    nbytes = 4 * (lead_in * n_in + C * n_out + geometry)
    g = sumfac_fmas(n1, nodes, qpts, True)
    v = sumfac_fmas(n1, nodes, qpts, False)
    fmas = n_tiles * (C * g + (C * g if incr else d * v)
                      + (d * v if dt_old else 0) + C * g)
    # per q-point: reference -> physical gradients (per component, 6
    # flops in 2D, 7 with the prismatic J in 3D, 15 with a full 3 x 3; u,
    # and u_lin in increment), |u*|^2, the physics (counted from
    # gls_qpoint.cuh) and the test-function weights
    full3 = full_jinv and d == 3
    grad_map = 6 if d == 2 else (15 if full3 else 7)
    phys = {2: (75, 40), 3: (150, 80)}[d][0 if incr else 1]
    weights = 1 + C * (9 if d == 2 else (19 if full3 else 11))
    per_q = (C * grad_map * (2 if incr else 1) + 2 * d - 1 + phys + weights
             + (1 if cell_wise else 15))
    # delta: per cell from the max |u*|^2, or per q-point (in per_q)
    flops = 2 * fmas + nq * per_q + (cells * 10 if cell_wise else 0)
    return nbytes, flops


def patch2d_cost(tables, flavor, consider_dt, cell_wise):
    """(bytes, flops) of one patch-2D sweep (see ``sweep_cost``) over
    every patch family of ``tables`` (``ops/patch2d.py``
    ``Patch2DFamilies``): y, then x contracted on the (Xn, Xn) patch
    tiles; the node-major inputs read once and the seam-compressed node
    vector written once over all families, each family's int32 lattice
    ids and geometry once."""
    nbytes = flops = 0
    for i, t in enumerate(tables.fams):
        n_p = t.jinv.shape[0]
        P, NQ, m = t.P, t.NQ, t.m
        Xn, Lq = P * m + 1, NQ * m
        geometry = sum(a.numel() for a in (t.jinv, t.jxw, t.h, t.S1, t.D1,
                                           t.patch_nodes))
        n_io = tables.n_nodes if i == 0 else 0
        b, f = sweep_cost(2, n_p, P + 1, (Xn, Xn), (Lq, Lq), n_io, n_io,
                          geometry, n_p * Lq * Lq, n_p * m * m, flavor,
                          consider_dt, cell_wise)
        nbytes += b
        flops += f
    return nbytes, flops


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
                      n_p * Xn * Xn * Nzn, n2d * Nzn, geometry,
                      n_p * Lq * Lq * Lz, n_p * m * m * nz, flavor,
                      consider_dt, cell_wise)


def patch3d_cost(tables, flavor, consider_dt, cell_wise):
    """(bytes, flops) of one patch-3D sweep (see ``sweep_cost``): z, then
    y, then x contracted on the (Xn, Xn, Xn) patch lattices, a full 3 x 3
    J^-1 per cell and q-point; the node-major inputs read once through
    the int32 lattice ids, the output the seam-compressed node vector,
    not the kernel's cell-row tiles."""
    n_p = tables.jinv.shape[0]
    P, NQ, m = tables.P, tables.NQ, tables.m
    Xn, Lq = P * m + 1, NQ * m
    geometry = sum(t.numel() for t in (tables.jinv, tables.jxw, tables.h,
                                       tables.S1, tables.D1,
                                       tables.patch_nodes))
    n = int(tables.patch_nodes.max()) + 1
    return sweep_cost(3, n_p, P + 1, (Xn, Xn, Xn), (Lq, Lq, Lq), n, n,
                      geometry,
                      n_p * Lq ** 3, n_p * m ** 3, flavor, consider_dt,
                      cell_wise, full_jinv=True)


def structured_cost(tables, flavor, consider_dt, cell_wise):
    """(bytes, flops) of one structured sweep (see ``sweep_cost``): the
    whole lattice is one tile, contracted z, then y, then x; the output
    is the folded lattice, not the kernels' cell-row tiles."""
    d, P, NQ = tables.d, tables.P, tables.NQ
    cs = tables.cell_shape[::-1]                  # ([nz,] ny, nx)
    nodes = tuple(P * n + 1 for n in cs)
    qpts = tuple(NQ * n for n in cs)
    geometry = sum(t.numel() for t in (tables.jinv, tables.jxw, tables.h,
                                       tables.S1, tables.D1))
    cells = math.prod(cs)
    return sweep_cost(d, 1, P + 1, nodes, qpts, math.prod(nodes),
                      math.prod(nodes), geometry,
                      math.prod(qpts), cells, flavor, consider_dt, cell_wise,
                      full_jinv=True)


def bound(nbytes, flops):
    """(bound ms, what bounds it) from the card's peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")
