"""Prism fused GLS sweep for EXTRUDED 3D meshes.

Port of ``ns_gls_tpu/ops/prism.py``.  The Turek/Hoffmann 3D meshes are
(unstructured 2D mesh) x (z lattice) products.  The 2D factor is tiled
into per-coarse-cell refinement PATCHES (an m x m lattice of cells with
(P*m+1)^2 nodes), and each patch carries the whole z extrusion (nz cell
layers, Nzn = P*nz + 1 node planes).  The product numbering
(``fem/space.py`` ``_build_prism_numbering``) stores each 2D node's z-run
contiguously, so the patch gather is a row gather of whole z-runs.

Geometry is prismatic (J = [[J2d, 0], [0, dz]], checked by
:func:`prism_cell_geometry`): per 2D cell and 2D q-point the sweep needs
J2d^-1 (4 entries), 1/dz and the 2D factor of |det J| * weight; the z
quadrature weight is applied inside the sweep.

Layout (per patch, no TPU grouping or padding):

- node tiles ``(lead, n_patches, Yn, Xn, Nzn)`` with Xn = Yn = P*m + 1,
  z fastest,
- geometry ``jinv (n_patches, 5, Lq, Lq)`` (entries J00, J01, J10, J11
  of J2d^-1 = dxi_r/dx_x, then 1/dz), ``jxw (n_patches, Lq, Lq)`` with
  Lq = NQ*m in natural order (q-point row iy = ey*NQ + qy, column
  ix = ex*NQ + qx), ``h (n_patches, 2, m, m)`` (h_min_vertex,
  measure-based h) per 2D cell,
- output CELL-ROW tiles ``(C, n_patches, m, nbx, P+1, XN, Nzn)``: cell
  row ey, x brick bx of ``xb`` cells (XN = P*xb + 1 nodes, the plan's),
  its node row j (patch node row P*ey + j), node P*xb*bx + x: the
  integrals over the cells of cell row ey in brick bx only.  Node rows
  shared by two cell rows and node columns shared by two bricks appear in
  both; the seam compress sums them together with the patch seams, so
  the sweep itself needs no cross-row or cross-brick reduction.

The seam compress gathers whole z-runs in dense multiplicity classes and
sums each class in a fixed order (``utils/segment.py``, deterministic on
the card).

The sweep is the CUDA kernel ``csrc/prism.cu`` for tensors on the card
and :func:`prism_sweep_plain` (its plain PyTorch version, the same
arithmetic with dense 1D band matrices) for tensors on the CPU;
:func:`prism_plan` splits the work into the kernel's thread blocks when
the tables are built.

Supported: dim 3, degrees 1-6 (the kernel's; the tables refuse others),
any m, curved (prismatic) cells, BDF/stationary (theta = 1), cell- or
q-wise stabilization, fixed/increment/residual flavors, f32.  The
operator uses the general sweep for anything else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ns_gls_tpu_torch.fem.lagrange import (
    eval_lagrange,
    gauss_lobatto_points_1d,
    gauss_points_1d,
)
from ns_gls_tpu_torch.ops.structured import (
    SMEM_PER_BLOCK,
    _delta,
    _physics,
    check_degree,
    raise_smem,
)
from ns_gls_tpu_torch.utils.segment import ClassGather, class_gather, class_sum
from ns_gls_tpu_torch.utils.timer import count

FLAVORS = ("fixed", "increment", "residual")


# ---------------------------------------------------------------------------
# the kernel's split into thread blocks
# ---------------------------------------------------------------------------
class PrismPlan(NamedTuple):
    """One block per (patch, cell row, x brick of ``xb`` cells, z chunk of
    ``zc`` cell layers), walking its chunk in slabs of ``zs`` layers.  The
    brick sets the output tiles' layout; slabs and chunks do not change a
    bit of the output."""

    xb: int     # cells per x brick (divides m)
    nbx: int    # bricks per cell row
    zs: int     # cell layers per slab
    zc: int     # cell layers per z chunk
    nzb: int    # z chunks per column


THREADS = 256
MAX_COLS = 4                   # I1 columns (component, node) per thread
SLAB_Q = 512                   # q-points per slab the plan aims for
STATIC_SMEM = 11 * 8           # the kernel's field pointer table


def smem_bytes(P: int, xb: int, zs: int, flavor: str,
               consider_dt: bool) -> int:
    """Dynamic shared memory of one block (``csrc/prism.cu`` prism_smem):
    two buffers of a slab's node columns of every staged field, region 1
    (A, Az -> W -> V), region 2 (X, XD, XZ -> Y) and |u*|^2 per q-point."""
    incr = flavor == "increment"
    dt_old = consider_dt and flavor in ("increment", "residual")
    nf = 4 + _lead_ul(flavor) + (3 if dt_old else 0)
    ng = 8 if incr else 4
    n1 = nq = P + 1
    nr, zn, lz = n1 * (P * xb + 1), P * zs + 1, nq * zs
    qs = nq * nq * xb * lz
    xs = n1 * nq * xb * lz
    floats = (2 * nf * nr * zn + max((nf + ng) * nr * lz, 16 * qs,
                                     8 * nr * lz)
              + max((nf + 2 * ng) * xs, 12 * xs) + qs)
    return 4 * floats


@functools.lru_cache(maxsize=64)
def prism_plan(P: int, m: int, nz: int) -> PrismPlan:
    """The kernel's blocks for patch columns of m x m cells and nz layers
    of degree P: the whole cell row as one brick where it fits, else the
    longest brick (a divisor of m) within the launcher's limits (I1
    columns per thread, shared memory of the largest flavor, increment
    with the history), with slabs of about ``SLAB_Q`` q-points and each
    column in two z chunks when each still holds two slabs (the measured
    best on the Turek 3D levels, ``tools/prism_levels.py --sweep``).
    Raises where not even the smallest block fits the card's shared
    memory, or for a shape nothing fits."""
    check_degree("prism", P)
    nq3 = (P + 1) ** 3
    for xb in (d for d in range(m, 0, -1) if m % d == 0):
        if 4 * (P + 1) * (P * xb + 1) > MAX_COLS * THREADS:
            continue
        zs = max(1, min(nz, SLAB_Q // (xb * nq3)))
        while zs > 1 and (smem_bytes(P, xb, zs, "increment", True)
                          + STATIC_SMEM > SMEM_PER_BLOCK):
            zs -= 1
        if smem_bytes(P, xb, zs, "increment", True) + STATIC_SMEM \
                > SMEM_PER_BLOCK:
            continue
        nzb = min(2 if nz >= 4 * zs else 1, nz)
        zc = -(-nz // nzb)
        return PrismPlan(xb, m // xb, zs, zc, -(-nz // zc))
    need = smem_bytes(P, 1, 1, "increment", True) + STATIC_SMEM
    if need > SMEM_PER_BLOCK:
        raise_smem("prism", P, need)
    raise ValueError(f"no prism plan fits: P={P}, m={m}, nz={nz}")


class PrismTables(NamedTuple):
    """Device tables for the prism sweep (per-patch layout)."""

    P: int
    NQ: int
    m: int
    nz: int
    plan: PrismPlan
    S1: torch.Tensor        # (NQ, P+1) 1D values at the Gauss points
    D1: torch.Tensor        # (NQ, P+1) 1D derivatives
    wz: torch.Tensor        # (NQ,) 1D Gauss weights (the z factor of jxw)
    bS: torch.Tensor        # (Lq, Xn) patch band: bS[e*NQ+q, P*e+l] = S1[q, l]
    bD: torch.Tensor        # (Lq, Xn)
    xS: torch.Tensor        # (NQ*xb, P*xb+1) the band of one x brick
    xD: torch.Tensor
    zS: torch.Tensor        # (Lz, Nzn) z band, Lz = NQ*nz
    zD: torch.Tensor        # (Lz, Nzn)
    jinv: torch.Tensor      # (n_patches, 5, Lq, Lq)
    jxw: torch.Tensor       # (n_patches, Lq, Lq)
    h: torch.Tensor         # (n_patches, 2, m, m)  (h_min_vertex, hq)
    patch_nodes: torch.Tensor   # (n_patches, Yn, Xn) int64 2D node ids
    compress: ClassGather   # cell-row tile rows -> 2D nodes (seam sums)


def band_1d(P, NQ, m):
    """1D tables and the single-patch band (NQ*m, P*m+1) in natural q
    order (row = e*NQ + q): basis values / reference derivatives of the
    lattice nodes at the Gauss points of m cells."""
    nodes = gauss_lobatto_points_1d(P + 1)
    qpts, qw = gauss_points_1d(NQ)
    S1, D1 = eval_lagrange(tuple(nodes), np.asarray(qpts))  # (NQ, P+1)
    bS = np.zeros((NQ * m, P * m + 1))
    bD = np.zeros((NQ * m, P * m + 1))
    for e in range(m):
        bS[e * NQ:(e + 1) * NQ, P * e:P * e + P + 1] = S1
        bD[e * NQ:(e + 1) * NQ, P * e:P * e + P + 1] = D1
    return S1, D1, np.asarray(qw), bS, bD


def prism_cell_geometry(op):
    """Per-2D-cell prismatic geometry (qz-independent factors), or None
    when the operator/space is unsupported.  Returns a dict with ``ji``
    (n_c2d, NQ^2, r, x), ``jxw_col`` (n_c2d, NQ^2), ``h1``/``hq``
    (n_c2d,).  Same gates as the JAX package: prism space, theta = 1,
    f32, and a Jacobian that is block-diagonal (x-y | z) and constant in
    qz on every cell; the layer-0 cell of each column stands for the
    column."""
    space = op.space
    if not getattr(space, "prism", False):
        return None
    if op.theta != 1.0 or op.dtype != torch.float32:
        return None
    NQ = space.n_q1d
    _, qw = gauss_points_1d(NQ)
    mesh = space.mesh
    n_c2d = mesh.extr_mesh2d.n_cells
    col0 = np.full(n_c2d, -1, np.int64)   # a layer-0 3D cell per 2D cell
    sel = mesh.extr_layer == 0
    col0[mesh.extr_cell2d[sel]] = np.nonzero(sel)[0]
    assert (col0 >= 0).all()

    J = np.linalg.inv(space.jinv)        # (c, q, x, r)
    scale = np.abs(J).max()
    if np.abs(J[:, :, :2, 2]).max() > 1e-9 * scale:
        return None
    if np.abs(J[:, :, 2, :2]).max() > 1e-9 * scale:
        return None
    J_col = J.reshape(mesh.n_cells, NQ, NQ * NQ, 3, 3)
    if np.abs(J_col - J_col[:, :1]).max() > 1e-9 * scale:
        return None
    ji = space.jinv[col0][:, : NQ * NQ]   # (n_c2d, NQ^2, r, x), qz = 0
    jxw_col = space.jxw[col0][:, : NQ * NQ] / qw[0]
    h1 = space.cell_h_min_vertex[col0]
    hq = np.cbrt(6.0 * space.cell_measure[col0] / np.pi) / space.degree
    return dict(ji=np.asarray(ji), jxw_col=np.asarray(jxw_col),
                h1=np.asarray(h1), hq=np.asarray(hq))


def cell_row_index(P: int, m: int) -> np.ndarray:
    """(m, P+1) patch node row of local row j of cell row ey: P*ey + j."""
    return P * np.arange(m)[:, None] + np.arange(P + 1)[None, :]


def tile_nodes(pn: np.ndarray, P: int, m: int, xb: int) -> np.ndarray:
    """(n_p, m, nbx, P+1, P*xb+1, ...) node of every tile row: row (p, ey,
    bx, j, x) holds lattice node pn[p, P*ey + j, P*xb*bx + x] (with pn's
    trailing axes, if any, after it)."""
    ey = np.arange(m)[:, None, None, None]
    bx = np.arange(m // xb)[None, :, None, None]
    j = np.arange(P + 1)[None, None, :, None]
    x = np.arange(P * xb + 1)[None, None, None, :]
    return pn[:, P * ey + j, P * xb * bx + x]


def build_prism_tables(op, xb=None):
    """Host-side packing; None when the operator/space is unsupported.
    ``xb`` overrides the x brick (tests, tools)."""
    arrays = prism_patch_arrays(op)
    if arrays is None:
        return None
    space = op.space
    return make_prism_tables(space.degree, space.n_q1d,
                             int(space.patch_cells), int(space.nz_cells),
                             space.n2d, *arrays, op.device, xb)


def prism_patch_arrays(op):
    """The per-patch arrays of :func:`make_prism_tables` for the whole
    space (the lattices ``pn`` (n_p, Yn, Xn) of 2D node ids, ``jinv_t``
    (n_p, 5, Lq, Lq), ``jxw_t`` (n_p, Lq, Lq), ``h_t`` (n_p, 2, m, m)),
    or None when the operator/space is unsupported."""
    space = op.space
    geo = prism_cell_geometry(op)
    if geo is None:
        return None
    P = space.degree
    NQ = space.n_q1d
    m = int(space.patch_cells)
    nz = int(space.nz_cells)
    Lq = NQ * m
    pn = np.asarray(space.patch_nodes, np.int64)      # (n_p, Yn, Xn)
    n_p = pn.shape[0]

    patch = np.asarray(space.patch_of_cell2d)
    lat = np.asarray(space.lattice_of_cell2d)         # (n_c2d, 2) = (ex, ey)
    n_c = len(patch)
    ji = geo["ji"]                                    # (c, q2d, r, x)
    # element q2d numbering q = qx + NQ*qy  ->  patch q-point (iy, ix)
    qx = np.arange(NQ)
    qy = np.arange(NQ)
    iy = lat[:, 1:2, None] * NQ + qy[None, :, None]   # (c, NQ, 1)
    ix = lat[:, 0:1, None] * NQ + qx[None, None, :]   # (c, 1, NQ)
    q_idx = qx[None, None, :] + NQ * qy[None, :, None]
    cidx = np.arange(n_c)[:, None, None]
    pb = patch[:, None, None]
    jinv_t = np.zeros((n_p, 5, Lq, Lq))
    for e, (r, x) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1), (2, 2))):
        jinv_t[pb, e, iy, ix] = ji[cidx, q_idx, r, x]
    jxw_t = np.zeros((n_p, Lq, Lq))
    jxw_t[pb, iy, ix] = geo["jxw_col"][cidx, q_idx]
    h_t = np.ones((n_p, 2, m, m))
    h_t[patch, 0, lat[:, 1], lat[:, 0]] = geo["h1"]
    h_t[patch, 1, lat[:, 1], lat[:, 0]] = geo["hq"]
    return pn, jinv_t, jxw_t, h_t


def make_prism_tables(P, NQ, m, nz, n2d, pn, jinv_t, jxw_t, h_t, dev,
                      xb=None):
    """The tables from the per-patch arrays (``jinv_t`` (n_p, 5, Lq, Lq),
    ``jxw_t`` (n_p, Lq, Lq), ``h_t`` (n_p, 2, m, m), the lattices ``pn``
    (n_p, Yn, Xn) of 2D node ids), under :func:`prism_plan`'s plan, made
    here so that a shape the kernel cannot take raises before any launch
    (``xb``: the tests' and tools' override of its brick)."""
    plan = prism_plan(P, m, nz)
    if xb is not None:
        plan = plan._replace(xb=xb, nbx=m // xb)
    S1, D1, qw, bS, bD = band_1d(P, NQ, m)
    _, _, _, xS, xD = band_1d(P, NQ, plan.xb)
    _, _, _, zS, zD = band_1d(P, NQ, nz)
    rows = tile_nodes(pn, P, m, plan.xb)      # (n_p, m, nbx, P+1, XN)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return PrismTables(
        P=P, NQ=NQ, m=m, nz=nz, plan=plan,
        S1=f32(S1), D1=f32(D1), wz=f32(qw), bS=f32(bS), bD=f32(bD),
        xS=f32(xS), xD=f32(xD), zS=f32(zS), zD=f32(zD),
        jinv=f32(jinv_t), jxw=f32(jxw_t), h=f32(h_t),
        patch_nodes=torch.as_tensor(pn, device=dev),
        compress=class_gather(rows.reshape(-1), n2d, dev),
    )


# ---------------------------------------------------------------------------
# the sweep: plain version and kernel
# ---------------------------------------------------------------------------
def _lead_ul(flavor: str) -> int:
    """Components of u_lin the flavor reads: all four in increment (with
    gradients), the velocity otherwise."""
    return 4 if flavor == "increment" else 3


def evaluate_tiles(t, bS, bD, zS, zD, grads: bool):
    """Node tiles (n_p, Yn, Xn, Zn) -> value and reference derivatives
    (x, y, z) at the q-points (n_p, Lq_y, Lq_x, Lz), contracted z, then
    x, then y with the 1D bands (x and y: bS/bD, z: zS/zD)."""
    tz = torch.einsum("az,pyxz->pyxa", zS, t)
    xs = torch.einsum("qx,pyxa->pyqa", bS, tz)
    val = torch.einsum("ky,pyqa->pkqa", bS, xs)
    if not grads:
        return val, None, None, None
    dx = torch.einsum("ky,pyqa->pkqa", bS,
                      torch.einsum("qx,pyxa->pyqa", bD, tz))
    dy = torch.einsum("ky,pyqa->pkqa", bD, xs)
    tzd = torch.einsum("az,pyxz->pyxa", zD, t)
    dz = torch.einsum("ky,pyqa->pkqa", bS,
                      torch.einsum("qx,pyxa->pyqa", bS, tzd))
    return val, dx, dy, dz


def integrate_tiles(w_val, gx, gy, gz, xS, xD, zS, zD, S1, D1, m: int):
    """Adjoint of :func:`evaluate_tiles`: the test-function weights at the
    q-points (value, and reference x, y, z gradient weights, each
    (n_p, Lq_y, Lq_x, Lz)) -> cell-row tiles (n_p, m, nbx, P+1, XN, Zn)
    of x bricks (``xS``/``xD``: the band (NQ*xb, P*xb+1) of one brick).
    The z then x adjoints (within each brick) of the terms with y-test
    values (A) and y-test derivatives (B), then y per cell row with the
    1D tables."""
    n_p, lqy, lqx, lz = w_val.shape
    nbx = lqx // xS.shape[0]

    def bricks(t):
        return t.reshape(n_p, lqy, nbx, -1, t.shape[-1])

    zs = torch.einsum("az,pkqa->pkqz", zS, w_val)
    zs = zs + torch.einsum("az,pkqa->pkqz", zD, gz)
    A = (torch.einsum("qx,pkbqz->pkbxz", xS, bricks(zs))
         + torch.einsum("qx,pkbqz->pkbxz", xD, bricks(
             torch.einsum("az,pkqa->pkqz", zS, gx))))
    B = torch.einsum("qx,pkbqz->pkbxz", xS, bricks(
        torch.einsum("az,pkqa->pkqz", zS, gy)))
    Yq = (n_p, m, S1.shape[0]) + tuple(A.shape[2:])
    return (torch.einsum("qj,peqbxz->pebjxz", S1, A.reshape(Yq))
            + torch.einsum("qj,peqbxz->pebjxz", D1, B.reshape(Yq)))


def prism_sweep_plain(tables: PrismTables, sc: dict, uP, ulP, voP,
                      flavor: str, consider_dt: bool, cell_wise: bool):
    """Plain PyTorch version of the prism sweep (the CUDA kernel's
    reference).  ``sc``: weight, stau, nu, c1, c2 (floats, used in f32).
    uP (4, n_p, Yn, Xn, Nzn), ulP (4 or 3, ...), voP (3, ...) ->
    cell-row tiles (4, n_p, m, nbx, P+1, XN, Nzn) under the tables'
    plan."""
    d, C = 3, 4
    dev = uP.device
    sc = {k: torch.tensor(v, dtype=torch.float32, device=dev)
          for k, v in sc.items()}
    bS, bD, zS, zD = tables.bS, tables.bD, tables.zS, tables.zD
    NQ, m, nz = tables.NQ, tables.m, tables.nz
    n_p = uP.shape[1]
    need_lin_grads = flavor == "increment"
    need_dt_old = consider_dt and flavor in ("increment", "residual")

    def fwd(t, grads):
        return evaluate_tiles(t, bS, bD, zS, zD, grads)

    u = [fwd(uP[c], True) for c in range(C)]
    ul = [fwd(ulP[c], need_lin_grads) for c in range(_lead_ul(flavor))]
    dt_old = ([fwd(voP[c], False)[0] for c in range(d)]
              if need_dt_old else None)

    ustar = [ul[a][0] for a in range(d)]
    usq = ustar[0] * ustar[0] + ustar[1] * ustar[1] + ustar[2] * ustar[2]

    def per_q(t):
        # (n_p, m, m) per 2D cell -> (n_p, Lq, Lq, 1)
        return t.repeat_interleave(NQ, 1).repeat_interleave(NQ, 2)[..., None]

    h1 = per_q(tables.h[:, 0])
    hq = per_q(tables.h[:, 1])
    if cell_wise:
        msq = usq.reshape(n_p, m, NQ, m, NQ, nz, NQ).amax(dim=(2, 4, 6))
        msq = (msq.repeat_interleave(NQ, 1).repeat_interleave(NQ, 2)
               .repeat_interleave(NQ, 3))
        d1_q, d2_q = _delta(sc, h1, hq, msq, None, True)
    else:
        d1_q, d2_q = _delta(sc, h1, hq, None, usq, False)

    a00, a01, a10, a11, idz = (tables.jinv[:, e, :, :, None]
                               for e in range(5))

    def to_phys(rx, ry, rz):
        return [rx * a00 + ry * a10, rx * a01 + ry * a11, rz * idz]

    u_grad = [to_phys(*u[a][1:]) for a in range(d)]
    p_grad = to_phys(*u[d][1:])
    gus = gps = None
    if need_lin_grads:
        gus = [to_phys(*ul[a][1:]) for a in range(d)]
        gps = to_phys(*ul[d][1:])

    val_res, grad_res = _physics(
        d, flavor, sc, [u[a][0] for a in range(d)], u_grad, u[d][0], p_grad,
        ustar, gus, gps, dt_old, d1_q, d2_q, consider_dt,
    )

    wz_row = tables.wz.repeat(nz)                     # (Lz,) = w(qz)
    jxw = tables.jxw[..., None] * wz_row
    out = []
    for c in range(C):
        g0, g1, g2 = grad_res[c]
        out.append(integrate_tiles(
            val_res[c] * jxw, (g0 * a00 + g1 * a01) * jxw,
            (g0 * a10 + g1 * a11) * jxw, (g2 * idz) * jxw,
            tables.xS, tables.xD, zS, zD, tables.S1, tables.D1, m))
    return torch.stack(out)


# launches of the CUDA kernel in this process: one per successful
# ``PrismKernel.launch``, nowhere else (``utils/timer.py`` counters)
LAUNCH_COUNTER = "launch.prism_gls_sweep"
count(LAUNCH_COUNTER, 0)


class PrismKernel:
    """ctypes binding of ``csrc/prism.cu``; the library is built at first
    use (``utils/cuda_build.py``)."""

    # per degree: the launcher of the library that holds its instance
    _fns: dict = {}

    @classmethod
    def _load(cls, P: int):
        if P not in cls._fns:
            from ns_gls_tpu_torch.utils.cuda_build import degree_library

            fn = degree_library("prism", P).prism_sweep_launch
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            fn.argtypes = [vp] * 10 + [ci] * 8 + [cf] * 5 + [ci] * 3 + [vp]
            fn.restype = ci
            cls._fns[P] = fn
        return cls._fns[P]

    @classmethod
    def launch(cls, tables: PrismTables, sc: dict, uP, ulP, voP,
               flavor: str, consider_dt: bool, cell_wise: bool,
               plan: PrismPlan | None = None):
        """The kernel on the patch tiles under ``plan`` (the tools'
        override of the slab depth and z chunks), by default the tables'
        (the brick is the tables': it sets the output layout)."""
        n_p = tables.jinv.shape[0]
        P, NQ, m, nz = tables.P, tables.NQ, tables.m, tables.nz
        plan = tables.plan if plan is None else plan
        if plan.xb != tables.plan.xb:
            raise ValueError("a plan must keep the tables' x brick")
        Xn = P * m + 1
        Nzn = P * nz + 1
        C = 4
        if NQ != P + 1:
            raise ValueError(f"prism kernel: degree {P} with {NQ} Gauss "
                             "points; it is built for degree + 1 points")
        lead_ul = _lead_ul(flavor)
        for name, t, lead in (("u", uP, C), ("u_lin", ulP, lead_ul),
                              ("vec_old", voP, 3)):
            if not t.is_cuda or t.dtype != torch.float32:
                raise TypeError(f"{name}: need a float32 CUDA tensor")
            if tuple(t.shape) != (lead, n_p, Xn, Xn, Nzn):
                raise ValueError(
                    f"{name}: shape {tuple(t.shape)}, need "
                    f"({lead}, {n_p}, {Xn}, {Xn}, {Nzn})"
                )
            if not t.is_contiguous():
                raise ValueError(f"{name}: need a contiguous tensor")
        for t in (tables.jinv, tables.jxw, tables.h, tables.S1, tables.D1,
                  tables.wz):
            if t.device != uP.device or not t.is_contiguous():
                raise ValueError("tables must be contiguous on u's device")
        out = torch.empty((C, n_p, m, plan.nbx, P + 1, P * plan.xb + 1,
                           Nzn), dtype=torch.float32, device=uP.device)
        fn = cls._load(P)
        err = fn(
            uP.data_ptr(), ulP.data_ptr(), voP.data_ptr(),
            tables.jinv.data_ptr(), tables.jxw.data_ptr(),
            tables.h.data_ptr(), tables.S1.data_ptr(), tables.D1.data_ptr(),
            tables.wz.data_ptr(), out.data_ptr(),
            n_p, P, NQ, m, nz, FLAVORS.index(flavor), int(consider_dt),
            int(cell_wise),
            sc["weight"], sc["stau"], sc["nu"], sc["c1"], sc["c2"],
            plan.xb, plan.zs, plan.nzb,
            torch.cuda.current_stream(uP.device).cuda_stream,
        )
        if err != 0:
            hint = (" (a degree, plan or input the kernel does not take)"
                    if err == 1 else "")
            raise RuntimeError(
                f"prism kernel launch failed: CUDA error {err}{hint}"
            )
        count(LAUNCH_COUNTER)
        return out


def prism_sweep(tables: PrismTables, sc: dict, uP, ulP, voP,
                flavor: str, consider_dt: bool, cell_wise: bool):
    """The prism sweep: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU."""
    if uP.is_cuda:
        return PrismKernel.launch(tables, sc, uP, ulP, voP, flavor,
                                  consider_dt, cell_wise)
    if uP.device.type != "cpu":
        raise TypeError(f"prism sweep: unsupported device {uP.device}")
    return prism_sweep_plain(tables, sc, uP, ulP, voP, flavor, consider_dt,
                             cell_wise)


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------
class PrismSweep:
    """Applies the fused prism sweep for one operator, with the interface
    of ``ops/patch2d.py`` ``Patch2DSweep``: ``gather_nodes(v, lead)``
    maps the first ``lead`` components of a node-major vector
    (n_nodes, C) to the patch tiles (the product numbering makes the
    node-major vector a (lead, n2d, Nzn) view), and ``apply(...)`` runs
    the sweep and seam-compresses the cell-row tiles back to (n_nodes, C).
    """

    def __init__(self, op, tables: PrismTables):
        space = op.space
        self.tables = tables
        self.d = space.dim
        self.m = tables.m
        self.n2d = space.n2d
        self.Nzn = space.nz_nodes
        self.consider_dt = op.consider_time_derivative
        self.cell_wise = op.cell_wise_stabilization
        self.nu = op.nu
        self.c1 = op.c_1
        self.c2 = op.c_2

    def view_shape(self, lead: int):
        return (lead,) + tuple(self.tables.patch_nodes.shape) + (self.Nzn,)

    def gather_nodes(self, v, lead: int):
        """(n_nodes, C) -> (lead, n_patches, Yn, Xn, Nzn)."""
        v2d = v[:, :lead].T.reshape(lead, self.n2d, self.Nzn)
        return v2d[:, self.tables.patch_nodes]

    def compress(self, rows):
        """Cell-row tiles (C, n_p, m, nbx, P+1, XN, Nzn) -> (C, n2d, Nzn)."""
        flat = rows.reshape(rows.shape[0], -1, self.Nzn)
        return class_sum(self.tables.compress, flat, dim=1)

    def apply(self, weight: float, stau: float, uP, ulP, voP, flavor: str):
        """uP/ulP/voP: (lead, n_patches, Yn, Xn, Nzn) patch tiles (from
        ``gather_nodes``).  Returns (n_nodes, C)."""
        sc = dict(weight=weight, stau=stau, nu=self.nu, c1=self.c1,
                  c2=self.c2)
        if flavor != "increment":
            ulP = ulP[: self.d]
        rows = prism_sweep(self.tables, sc, uP.contiguous(),
                           ulP.contiguous(), voP.contiguous(), flavor,
                           self.consider_dt, self.cell_wise)
        out = self.compress(rows)
        return out.reshape(out.shape[0], -1).T
