"""The least work of one operator apply, from the problem alone.

Copied from the program's ``ns_gls_tpu_torch/utils/roofline.py``
(``sumfac_fmas``, ``sweep_cost``, ``structured_cost``, ``bound``) and
changed so that it reads the same whatever implements the apply: the
shapes come from the problem (cells per axis, degree, Gauss points per
axis, flavor), not from the program's tables, and the geometry of an
affine lattice is one inverse Jacobian, one weight and one cell size,
not the tables a kernel happens to keep.  Every input is read once and
the output written once (4-byte floats); the operations are a
sum-factorized evaluation and integration plus the q-point algebra, at
the card's f32 rate outside the tensor cores.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at a 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def sumfac_fmas(n1, nodes, qpts, grads):
    """FMAs of evaluating one component at the q-points by sum
    factorization, one axis at a time (extents per axis in the order
    contracted), each q-point touching n1 nodes per axis; with ``grads``
    the value and the reference derivative along every axis (k + 2 arrays
    after the k-th axis), else the value alone.  Integration, the
    transpose, costs the same."""
    fmas = 0
    for k in range(len(nodes)):
        extent = math.prod(qpts[:k + 1]) * math.prod(nodes[k + 1:])
        fmas += (k + 2 if grads else 1) * extent * n1
    return fmas


def lattice_apply_work(dim, cells, degree, n_q1d, flavor, consider_dt,
                       cell_wise):
    """(bytes, flops) of one apply of the GLS operator on an affine
    lattice of ``cells`` (per axis, x first) of Q``degree`` with
    ``n_q1d`` Gauss points per axis, in ``flavor`` ("fixed",
    "increment" or "residual")."""
    d, P, NQ = dim, degree, n_q1d
    C = d + 1
    cs = tuple(cells)[::-1]
    nodes = tuple(P * n + 1 for n in cs)
    qpts = tuple(NQ * n for n in cs)
    n_nodes = math.prod(nodes)
    nq = math.prod(qpts)
    n_cells = math.prod(cs)
    incr = flavor == "increment"
    dt_old = consider_dt and flavor in ("increment", "residual")
    # u, the linearization point (all of it for the increment's grad u*,
    # its velocity otherwise) and the history's velocity
    lead_in = C + (C if incr else d) + (d if dt_old else 0)
    geometry = d * d + 2 + 2 * NQ * (P + 1)
    nbytes = 4 * (lead_in * n_nodes + C * n_nodes + geometry)
    g = sumfac_fmas(P + 1, nodes, qpts, True)
    v = sumfac_fmas(P + 1, nodes, qpts, False)
    fmas = (C * g + (C * g if incr else d * v) + (d * v if dt_old else 0)
            + C * g)
    # per q-point: reference -> physical gradients (15 flops a component
    # with a full 3 x 3 J^-1, 6 in 2D; u, and u* in the increment), |u*|^2,
    # the physics (3D: 150 increment, 80 fixed; 2D: 75, 40), the
    # test-function weights, delta
    grad_map = 6 if d == 2 else 15
    phys = {2: (75, 40), 3: (150, 80)}[d][0 if incr else 1]
    weights = 1 + C * (9 if d == 2 else 19)
    per_q = (C * grad_map * (2 if incr else 1) + 2 * d - 1 + phys + weights
             + (1 if cell_wise else 15))
    flops = 2 * fmas + nq * per_q + (n_cells * 10 if cell_wise else 0)
    return nbytes, flops


def least_time_s(nbytes, flops):
    """(seconds, what bounds it) at the card's published peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_flops = flops / PEAK_F32_FLOPS
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")
