"""Patch-lattice fused GLS sweep for GENERAL (non-extruded) 3D meshes.

Port of ``ns_gls_tpu/ops/patch3d.py``.  General 3D hex meshes (the Gmsh
sphere family, ``models/sphere.py``) decompose into per-coarse-cell
refinement PATCHES: each coarse cell refined r times is an m x m x m
lattice of cells (m = 2^r) with (P*m+1)^3 nodes
(``fem/space.py`` ``_build_patch3d_numbering``).  Every patch lies in its
coarse cell's own frame, so neighbours meet under any orientation and a
node may lie in any number of patches; the seam compress works from the
global node ids of every patch lattice, whatever the multiplicity.

Geometry is fully general per cell AND per q-point (sphere cells are
curved): the sweep reads the nine entries of J^-1 and |det J| * weight at
every q-point of every cell.

Layout (per patch, no TPU grouping or padding):

- the node vectors u, u_lin and vec_old stay node-major ``(n_nodes, 4)``:
  the kernel reads them through the patch lattices ``patch_nodes
  (n_patches, Yn, Xn, Zn)`` (int32 node ids, Xn = Yn = Zn = P*m + 1, z
  fastest), one 16-byte word a node, so no tile is gathered per apply,
- geometry per patch cell row ey and x brick bx of ``xb`` cells (the
  plan's; the whole row where it fits): ``jinv (n_patches, m, nbx, 9,
  QB)`` (entry r*3 + x of J^-1 = dxi_r/dx_x), ``jxw (n_patches, m, nbx,
  QB)``, with the QB = m*NQ^3*xb q-points of the brick's row in the order
  ``(((ez*NQ + qz)*NQ + qy)*xb + ex)*NQ + qx`` (ex within the brick), and
  ``h (n_patches, m, nbx, 2, m*xb)`` (h_min_vertex, measure-based h) per
  cell ez*xb + ex of the brick's row,
- output CELL-ROW tiles ``(n_patches, m, nbx, Zn, P+1, XN, 4)``: cell row
  ey, x brick bx (XN = P*xb + 1 nodes), node plane z, its node row j
  (patch node row P*ey + j), node P*xb*bx + x, the four components: the
  integrals over the cells of cell row ey in brick bx only.  Node rows
  shared by two cell rows and node columns shared by two bricks appear in
  both; one seam-sum launch (``utils/segment.py`` ``seam_sum``, a fixed
  order per node) adds them together with the patch seams, so the sweep
  needs no cross-row or cross-brick reduction.

The sweep is the CUDA kernel ``csrc/patch3d.cu`` for tensors on the card
and :func:`patch3d_sweep_plain` (its plain PyTorch version, the same
arithmetic with dense 1D band matrices) for tensors on the CPU;
:func:`patch3d_brick` and :func:`patch3d_plan` split the work into the
kernel's thread blocks when the tables are built.

Supported: dim 3, degrees 1-6 (the kernel's; the tables refuse others),
any m, curved cells,
BDF/stationary (theta = 1), cell- or q-wise stabilization,
fixed/increment/residual flavors, f32.  The operator uses the general
sweep for anything else (f64, the theta method, iso-Q1 spaces, which
have no patch numbering).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ns_gls_tpu_torch.ops.prism import (
    FLAVORS,
    _lead_ul,
    band_1d,
    evaluate_tiles,
    integrate_tiles,
    tile_nodes,
)
from ns_gls_tpu_torch.ops.structured import (
    SMEM_PER_BLOCK,
    _delta,
    _physics,
    check_degree,
    raise_smem,
)
from ns_gls_tpu_torch.utils.segment import SeamSums, seam_sum, seam_sums
from ns_gls_tpu_torch.utils.timer import count


# ---------------------------------------------------------------------------
# the kernel's split into thread blocks
# ---------------------------------------------------------------------------
class Patch3DPlan(NamedTuple):
    """One block per (patch, cell row, x brick of ``xb`` cells, z chunk of
    ``zc`` cell layers), walking its chunk in slabs of ``zs`` layers.  The
    brick sets the geometry's and the output tiles' layout; slabs and
    chunks do not change a bit of the output."""

    xb: int     # cells per x brick (divides m)
    nbx: int    # bricks per cell row
    zs: int     # cell layers per slab
    zc: int     # cell layers per z chunk
    nzb: int    # z chunks per column


# SMs of an H100 SXM; the kernel's blocks of 256 threads (at most 128
# registers) fit two to an SM when their shared memory does
N_SM = 132
SMEM_PER_SM = 233472           # bytes; each block also reserves 1 KB
THREADS = 256
MAX_COLS = 2                   # I1 columns (component, node) per thread


def smem_bytes(P: int, xb: int, zs: int, walk: int, flavor: str,
               consider_dt: bool) -> int:
    """Dynamic shared memory of one block (``csrc/patch3d.cu`` p3_smem):
    slabs of ``zs`` layers of a brick of ``xb`` cells, walks of at most
    ``walk`` layers."""
    incr = flavor == "increment"
    dt_old = consider_dt and flavor in ("increment", "residual")
    nk = 3 if dt_old else 2
    nf = 4 + _lead_ul(flavor) + (3 if dt_old else 0)
    ng = 8 if incr else 4
    n1 = nq = P + 1
    xn, lx = P * xb + 1, nq * xb
    zn, lz = P * zs + 1, nq * zs
    pl = n1 * xn
    qs, xf = lz * nq * lx, lz * n1 * lx

    def r4(a):
        return -(-a // 4) * 4

    words = (2 * nk * 4 * zn * pl + r4(10 * qs)
             + r4(max((nf + ng) * lz * pl, 16 * qs, 8 * lz * pl))
             + r4(max((nf + 2 * ng) * xf, 12 * xf)) + r4(zs * xb)
             + (P * walk + 1) * pl)
    return 4 * words


def _z_plans(P: int, m: int, xb: int, n_patches: int, flavor: str,
             consider_dt: bool):
    """(estimated cost, plan) of every slab depth and z chunking that fits
    a brick of ``xb`` cells."""
    nq3 = (P + 1) ** 3
    for zs0 in range(1, m + 1):
        nzb = 1
        while nzb <= m:
            zc = -(-m // nzb)
            n_chunks = -(-m // zc)
            walk = zc + (1 if n_chunks > 1 else 0)
            zs = min(zs0, walk)
            smem = smem_bytes(P, xb, zs, walk, flavor, consider_dt)
            if smem <= SMEM_PER_BLOCK:
                per_sm = 2 if 2 * (smem + 1024) <= SMEM_PER_SM else 1
                blocks = n_patches * (m // xb) * m * n_chunks
                cost = (-(-blocks // (N_SM * per_sm)) * -(-walk // zs)
                        * (256 + zs * xb * nq3), blocks, -zs)
                yield cost, Patch3DPlan(xb, m // xb, zs, zc, n_chunks)
            nzb *= 2


@functools.lru_cache(maxsize=64)
def patch3d_brick(P: int, m: int, n_patches: int) -> int:
    """The x brick of patches of m^3 cells of degree P: the whole cell row
    where it fits, else the longest divisor of m with at most ``MAX_COLS``
    I1 columns per thread and a plan for every flavor x consider_dt.
    Raises where not even the smallest block fits the card's shared
    memory, or for a shape nothing fits."""
    check_degree("patch-3D", P)
    for xb in (d for d in range(m, 0, -1) if m % d == 0):
        if 4 * (P + 1) * (P * xb + 1) > MAX_COLS * THREADS:
            continue
        if all(any(True for _ in _z_plans(P, m, xb, n_patches, f, c))
               for f in FLAVORS for c in (True, False)):
            return xb
    need = smem_bytes(P, 1, 1, min(m, 2), "increment", True)
    if need > SMEM_PER_BLOCK:
        raise_smem("patch-3D", P, need)
    raise ValueError(f"no patch-3D plan fits: P={P}, m={m}")


@functools.lru_cache(maxsize=64)
def patch3d_plan(P: int, m: int, n_patches: int, flavor: str,
                 consider_dt: bool, xb: int | None = None) -> Patch3DPlan:
    """The kernel's blocks for ``n_patches`` patches of m^3 cells of degree
    P in ``flavor``: the brick ``xb`` (the tests' and tools' override), by
    default :func:`patch3d_brick`'s, and of the slab
    depths and z chunkings (a chunk recomputes the layer below it for its
    carry), the one of least estimated time, waves of resident blocks (two
    per SM where the shared memory allows, else one) x slabs per block x a
    slab's time (a fixed part as long as 256 q-points, plus its q-points);
    ties go to fewer blocks, then deeper slabs.  A slab is no deeper than
    the chunk's walk."""
    if xb is None:
        xb = patch3d_brick(P, m, n_patches)
    return min(_z_plans(P, m, xb, n_patches, flavor, consider_dt))[1]


class Patch3DTables(NamedTuple):
    """Device tables for the patch-3D sweep (per-patch layout)."""

    P: int
    NQ: int
    m: int
    n_nodes: int
    plans: dict             # (flavor, consider_dt) -> Patch3DPlan
    S1: torch.Tensor        # (NQ, P+1) 1D values at the Gauss points
    D1: torch.Tensor        # (NQ, P+1) 1D derivatives
    bS: torch.Tensor        # (Lq, Xn) patch band: bS[e*NQ+q, P*e+l] = S1[q, l]
    bD: torch.Tensor        # (Lq, Xn)
    xS: torch.Tensor        # (NQ*xb, P*xb+1) the band of one x brick
    xD: torch.Tensor
    jinv: torch.Tensor      # (n_patches, m, nbx, 9, QB)
    jxw: torch.Tensor       # (n_patches, m, nbx, QB)
    h: torch.Tensor         # (n_patches, m, nbx, 2, m*xb)  (h_min_vertex, hq)
    patch_nodes: torch.Tensor   # (n_patches, Yn, Xn, Zn) int32 node ids
    seams: SeamSums         # cell-row tile rows -> nodes

    @property
    def xb(self) -> int:
        return next(iter(self.plans.values())).xb


def build_patch3d_tables(op, xb=None):
    """Host-side packing; None when the operator/space is unsupported
    (the JAX package's gates: a patch-3D space, theta = 1, f32).  ``xb``
    overrides the x brick (tests, tools)."""
    space = op.space
    if not getattr(space, "patch3d", False):
        return None
    if op.theta != 1.0 or op.dtype != torch.float32:
        return None
    return make_patch3d_tables(space.degree, space.n_q1d,
                               int(space.patch_cells), space.n_nodes,
                               *patch3d_geometry(space), op.device, xb)


def patch3d_geometry(space):
    """The per-patch arrays of a patch-3D space in the patch's own order:
    the lattices ``pn`` (n_p, y, x, z) of node ids, ``jinv_t`` (n_p, ey,
    9, ez, qz, qy, ex, qx), ``jxw_t`` (n_p, ey, ez, qz, qy, ex, qx) and
    ``h_t`` (n_p, ey, 2, ez, ex)."""
    P = space.degree
    NQ = space.n_q1d
    m = int(space.patch_cells)
    pn3 = np.asarray(space.patch_nodes3, np.int64)     # (n_p, z, y, x)
    n_p = pn3.shape[0]
    pn = np.ascontiguousarray(pn3.transpose(0, 2, 3, 1))  # (n_p, y, x, z)

    patch = np.asarray(space.patch_of_cell3)
    lat = np.asarray(space.lattice_of_cell3)           # (c, 3) = (ex, ey, ez)
    n_c = len(patch)
    ex, ey, ez = lat[:, 0], lat[:, 1], lat[:, 2]
    # element q numbering q = qx + NQ*qy + NQ^2*qz  ->  (qz, qy, qx)
    ji = np.asarray(space.jinv).reshape(n_c, NQ, NQ, NQ, 9)
    jinv_t = np.zeros((n_p, m, 9, m, NQ, NQ, m, NQ))
    # advanced indices (patch, ey, ez, ex) lead: (c, 9, qz, qy, qx)
    jinv_t[patch, ey, :, ez, :, :, ex, :] = ji.transpose(0, 4, 1, 2, 3)
    jxw_t = np.zeros((n_p, m, m, NQ, NQ, m, NQ))
    jxw_t[patch, ey, ez, :, :, ex, :] = np.asarray(space.jxw).reshape(
        n_c, NQ, NQ, NQ)
    h_t = np.ones((n_p, m, 2, m, m))
    h_t[patch, ey, 0, ez, ex] = space.cell_h_min_vertex
    h_t[patch, ey, 1, ez, ex] = np.cbrt(6.0 * space.cell_measure / np.pi) / P
    return pn, jinv_t, jxw_t, h_t


def make_patch3d_tables(P, NQ, m, n_nodes, pn, jinv_t, jxw_t, h_t, dev,
                        xb=None, every_node=True):
    """The tables from the per-patch arrays of :func:`patch3d_geometry`:
    the plans of every flavor x consider_dt, made here so that a shape
    the kernel cannot take raises before any launch, and the geometry
    split into the plans' x bricks (``xb``: the tests' and tools'
    override of :func:`patch3d_brick`; ``every_node``: see
    ``utils/segment.py`` ``seam_sums``)."""
    n_p = pn.shape[0]
    if xb is None:
        xb = patch3d_brick(P, m, n_p)
    nbx = m // xb
    plans = {(f, c): patch3d_plan(P, m, n_p, f, c, xb)
             for f in FLAVORS for c in (True, False)}
    S1, D1, _, bS, bD = band_1d(P, NQ, m)
    _, _, _, xS, xD = band_1d(P, NQ, xb)
    # ex = bx*xb + exl: the brick axis goes ahead of the entries
    jinv_b = (np.asarray(jinv_t).reshape(n_p, m, 9, m, NQ, NQ, nbx, xb, NQ)
              .transpose(0, 1, 6, 2, 3, 4, 5, 7, 8))
    jxw_b = (np.asarray(jxw_t).reshape(n_p, m, m, NQ, NQ, nbx, xb, NQ)
             .transpose(0, 1, 5, 2, 3, 4, 6, 7))
    h_b = (np.asarray(h_t).reshape(n_p, m, 2, m, nbx, xb)
           .transpose(0, 1, 4, 2, 3, 5))
    # tile row (p, ey, bx, z, j, x) holds node pn[p, P*ey + j, P*xb*bx + x, z]
    rows = tile_nodes(pn, P, m, xb).transpose(0, 1, 2, 5, 3, 4)

    def f32(a, shape):
        # contiguous: a reshape of the brick transposes may be a strided
        # view, and the kernel reads every table as contiguous
        return torch.as_tensor(np.ascontiguousarray(
            np.asarray(a, np.float32).reshape(shape)), device=dev)

    QB = m * NQ ** 3 * xb
    return Patch3DTables(
        P=P, NQ=NQ, m=m, n_nodes=n_nodes, plans=plans,
        S1=f32(S1, S1.shape), D1=f32(D1, D1.shape), bS=f32(bS, bS.shape),
        bD=f32(bD, bD.shape), xS=f32(xS, xS.shape), xD=f32(xD, xD.shape),
        jinv=f32(jinv_b, (n_p, m, nbx, 9, QB)),
        jxw=f32(jxw_b, (n_p, m, nbx, QB)),
        h=f32(h_b, (n_p, m, nbx, 2, m * xb)),
        patch_nodes=torch.as_tensor(pn.astype(np.int32), device=dev),
        seams=seam_sums(rows, n_nodes, dev, every_node),
    )


# ---------------------------------------------------------------------------
# the sweep: plain version and kernel
# ---------------------------------------------------------------------------
def patch3d_sweep_plain(tables: Patch3DTables, sc: dict, u, ul, vo,
                        flavor: str, consider_dt: bool, cell_wise: bool):
    """Plain PyTorch version of the patch-3D kernel (its reference).
    ``sc``: weight, stau, nu, c1, c2 (floats, used in f32).  u, ul, vo:
    node-major (n_nodes, 4) (ul: the first 4 components read in
    increment, 3 otherwise; vo: 3) -> cell-row tiles (n_p, m, nbx, Zn,
    P+1, XN, 4) of the tables' x bricks."""
    d, C = 3, 4
    dev = u.device
    sc = {k: torch.tensor(v, dtype=torch.float32, device=dev)
          for k, v in sc.items()}
    bS, bD = tables.bS, tables.bD
    NQ, m, xb = tables.NQ, tables.m, tables.xb
    nbx = m // xb
    pn = tables.patch_nodes.long()
    n_p = pn.shape[0]
    Lq = NQ * m
    need_lin_grads = flavor == "increment"
    need_dt_old = consider_dt and flavor in ("increment", "residual")

    def fwd(v, c, grads):
        # component c of a node vector on the patch lattices (n_p, Yn, Xn,
        # Zn) -> (n_p, Lq_y, Lq_x, Lq_z); z has x's band
        return evaluate_tiles(v[:, c][pn], bS, bD, bS, bD, grads)

    uq = [fwd(u, c, True) for c in range(C)]
    ulq = [fwd(ul, c, need_lin_grads) for c in range(_lead_ul(flavor))]
    dt_old = ([fwd(vo, c, False)[0] for c in range(d)]
              if need_dt_old else None)

    ustar = [ulq[a][0] for a in range(d)]
    usq = ustar[0] * ustar[0] + ustar[1] * ustar[1] + ustar[2] * ustar[2]

    def per_q(t):
        # (n_p, ey, nbx, m*xb) per cell (ez, ex within the brick) ->
        # (n_p, Lq_y, Lq_x, Lq_z)
        t = (t.reshape(n_p, m, nbx, m, xb).permute(0, 1, 2, 4, 3)
             .reshape(n_p, m, m, m))                      # (p, ey, ex, ez)
        for dim in (1, 2, 3):
            t = t.repeat_interleave(NQ, dim)
        return t

    h1 = per_q(tables.h[:, :, :, 0])
    hq = per_q(tables.h[:, :, :, 1])
    if cell_wise:
        msq = usq.reshape(n_p, m, NQ, m, NQ, m, NQ).amax(dim=(2, 4, 6))
        for dim in (1, 2, 3):
            msq = msq.repeat_interleave(NQ, dim)
        d1_q, d2_q = _delta(sc, h1, hq, msq, None, True)
    else:
        d1_q, d2_q = _delta(sc, h1, hq, None, usq, False)

    # geometry (n_p, ey, bx, e, ez, qz, qy, ex, qx) -> e, (n_p, Lq_y,
    # Lq_x, Lq_z)
    ji = (tables.jinv.reshape(n_p, m, nbx, 9, m, NQ, NQ, xb, NQ)
          .permute(3, 0, 1, 6, 2, 7, 8, 4, 5).reshape(9, n_p, Lq, Lq, Lq))
    jxw = (tables.jxw.reshape(n_p, m, nbx, m, NQ, NQ, xb, NQ)
           .permute(0, 1, 5, 2, 6, 7, 3, 4).reshape(n_p, Lq, Lq, Lq))

    def to_phys(rx, ry, rz):
        return [rx * ji[x] + ry * ji[3 + x] + rz * ji[6 + x]
                for x in range(3)]

    u_grad = [to_phys(*uq[a][1:]) for a in range(d)]
    p_grad = to_phys(*uq[d][1:])
    gus = gps = None
    if need_lin_grads:
        gus = [to_phys(*ulq[a][1:]) for a in range(d)]
        gps = to_phys(*ulq[d][1:])

    val_res, grad_res = _physics(
        d, flavor, sc, [uq[a][0] for a in range(d)], u_grad, uq[d][0],
        p_grad, ustar, gus, gps, dt_old, d1_q, d2_q, consider_dt,
    )

    out = []
    for c in range(C):
        g0, g1, g2 = grad_res[c]
        # value weights, then the reference x, y, z gradient weights
        gx, gy, gz = ((g0 * ji[3 * r] + g1 * ji[3 * r + 1]
                       + g2 * ji[3 * r + 2]) * jxw for r in range(3))
        out.append(integrate_tiles(val_res[c] * jxw, gx, gy, gz, tables.xS,
                                   tables.xD, bS, bD, tables.S1, tables.D1,
                                   m))
    # (n_p, m, nbx, P+1, XN, Zn, C) -> (n_p, m, nbx, Zn, P+1, XN, C)
    return (torch.stack(out, dim=-1).permute(0, 1, 2, 5, 3, 4, 6)
            .contiguous())


# launches of the CUDA kernel in this process: one per successful
# ``Patch3DKernel.launch``, nowhere else (``utils/timer.py`` counters)
LAUNCH_COUNTER = "launch.patch3d_gls_sweep"
count(LAUNCH_COUNTER, 0)


class Patch3DKernel:
    """ctypes binding of ``csrc/patch3d.cu``; the library is built at
    first use (``utils/cuda_build.py``)."""

    # per degree: the library that holds its instance
    _libs: dict = {}

    @classmethod
    def _load(cls, P: int):
        if P not in cls._libs:
            from ns_gls_tpu_torch.utils.cuda_build import degree_library

            lib = degree_library("patch3d", P)
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            fn = lib.patch3d_sweep_launch
            fn.argtypes = [vp] * 10 + [ci] * 7 + [cf] * 5 + [ci] * 3 + [vp]
            fn.restype = ci
            at = lib.patch3d_attributes
            ip = ctypes.POINTER(ci)
            at.argtypes = [ci] * 7 + [ip, ip, ip,
                                      ctypes.POINTER(ctypes.c_longlong)]
            at.restype = ci
            cls._libs[P] = lib
        return cls._libs[P]

    @classmethod
    def launch(cls, tables: Patch3DTables, sc: dict, u, ul, vo,
               flavor: str, consider_dt: bool, cell_wise: bool,
               plan: Patch3DPlan | None = None):
        """The kernel on node-major u, ul, vo (n_nodes, 4) under ``plan``
        (the tools' override of the slab depth and z chunks), by default
        the tables' plan of the flavor (the brick is the tables': it sets
        the layouts)."""
        n_p = tables.jinv.shape[0]
        P, NQ, m = tables.P, tables.NQ, tables.m
        if plan is None:
            plan = tables.plans[(flavor, bool(consider_dt))]
        if plan.xb != tables.xb:
            raise ValueError("a plan must keep the tables' x brick")
        for name, t in (("u", u), ("u_lin", ul), ("vec_old", vo)):
            if not t.is_cuda or t.dtype != torch.float32:
                raise TypeError(f"{name}: need a float32 CUDA tensor")
            if tuple(t.shape) != (tables.n_nodes, 4):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, need "
                                 f"({tables.n_nodes}, 4)")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{name}: need a contiguous tensor on a "
                                 "16-byte boundary")
        for t in (tables.jinv, tables.jxw, tables.h, tables.S1, tables.D1,
                  tables.patch_nodes):
            if t.device != u.device or not t.is_contiguous():
                raise ValueError("tables must be contiguous on u's device")
        out = torch.empty((n_p, m, plan.nbx, P * m + 1, P + 1,
                           P * plan.xb + 1, 4), dtype=torch.float32,
                          device=u.device)
        err = cls._load(P).patch3d_sweep_launch(
            u.data_ptr(), ul.data_ptr(), vo.data_ptr(),
            tables.patch_nodes.data_ptr(), tables.jinv.data_ptr(),
            tables.jxw.data_ptr(), tables.h.data_ptr(),
            tables.S1.data_ptr(), tables.D1.data_ptr(), out.data_ptr(),
            n_p, P, NQ, m, FLAVORS.index(flavor), int(consider_dt),
            int(cell_wise),
            sc["weight"], sc["stau"], sc["nu"], sc["c1"], sc["c2"],
            plan.xb, plan.zs, plan.nzb,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
        if err != 0:
            hint = (" (a degree, plan or input the kernel does not take)"
                    if err == 1 else "")
            raise RuntimeError(
                f"patch-3D kernel launch failed: CUDA error {err}{hint}"
            )
        count(LAUNCH_COUNTER)
        return out

    @classmethod
    def attributes(cls, P: int, m: int, plan: Patch3DPlan, flavor: str,
                   consider_dt: bool) -> dict:
        """Registers per thread, spills (local memory) and static shared
        memory per block of the built kernel for degree P, and its dynamic
        shared memory per block under ``plan``, in bytes."""
        regs, local, static = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        dyn = ctypes.c_longlong()
        err = cls._load(P).patch3d_attributes(
            P, m, plan.xb, plan.zs, plan.nzb, FLAVORS.index(flavor),
            int(consider_dt),
            ctypes.byref(regs), ctypes.byref(local), ctypes.byref(static),
            ctypes.byref(dyn))
        if err != 0:
            raise RuntimeError(f"patch3d_attributes: CUDA error {err}")
        return dict(registers=regs.value, spill_bytes=local.value,
                    static_smem=static.value, dynamic_smem=dyn.value)


def patch3d_sweep(tables: Patch3DTables, sc: dict, u, ul, vo, flavor: str,
                  consider_dt: bool, cell_wise: bool):
    """The patch-3D kernel for tensors on the card, its plain version for
    tensors on the CPU: node-major vectors -> cell-row tiles."""
    if u.is_cuda:
        return Patch3DKernel.launch(tables, sc, u, ul, vo, flavor,
                                    consider_dt, cell_wise)
    if u.device.type != "cpu":
        raise TypeError(f"patch-3D sweep: unsupported device {u.device}")
    return patch3d_sweep_plain(tables, sc, u, ul, vo, flavor, consider_dt,
                               cell_wise)


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------
class Patch3DSweep:
    """Applies the fused patch-3D sweep for one operator, with the
    interface of ``ops/prism.py`` ``PrismSweep``.  The kernel reads the
    node-major vectors through the patch lattices itself, so
    ``gather_nodes(v, lead)`` only makes v a contiguous (n_nodes, 4)
    array, and ``apply(...)`` runs the sweep and the seam sums back to
    (n_nodes, C)."""

    def __init__(self, op, tables: Patch3DTables):
        self.tables = tables
        self.d = 3
        self.m = tables.m
        self.consider_dt = op.consider_time_derivative
        self.cell_wise = op.cell_wise_stabilization
        self.nu = op.nu
        self.c1 = op.c_1
        self.c2 = op.c_2

    def view_shape(self, lead: int):
        return (self.tables.n_nodes, 4)

    def gather_nodes(self, v, lead: int):
        """(n_nodes, 4) -> the same, contiguous (every component is kept:
        the kernel reads a node's four as one word and uses ``lead``)."""
        return v.contiguous()

    def compress(self, tiles):
        """Cell-row tiles (n_p, m, nbx, Zn, P+1, XN, 4) -> (n_nodes, 4)."""
        return seam_sum(self.tables.seams, tiles.reshape(-1, 4))

    def apply(self, weight: float, stau: float, u, ul, vo, flavor: str):
        """u, ul, vo: node-major (n_nodes, 4) (from ``gather_nodes``).
        Returns (n_nodes, C)."""
        sc = dict(weight=weight, stau=stau, nu=self.nu, c1=self.c1,
                  c2=self.c2)
        tiles = patch3d_sweep(self.tables, sc, u.contiguous(),
                              ul.contiguous(), vo.contiguous(), flavor,
                              self.consider_dt, self.cell_wise)
        return self.compress(tiles)
