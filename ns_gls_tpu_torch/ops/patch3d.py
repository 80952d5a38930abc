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

Layout (per patch, no TPU grouping or padding; the same axis order as the
prism sweep, ``ops/prism.py``, with the patch's z axis in the place of the
extrusion):

- node tiles ``(lead, n_patches, Yn, Xn, Zn)`` with Xn = Yn = Zn =
  P*m + 1, z fastest,
- geometry per patch cell row ey: ``jinv (n_patches, m, 9, QB)`` (entry
  r*3 + x of J^-1 = dxi_r/dx_x), ``jxw (n_patches, m, QB)``, with the QB =
  m*NQ^3*m q-points of the row in the order
  ``(((ez*NQ + qz)*NQ + qy)*m + ex)*NQ + qx``, and ``h (n_patches, m, 2,
  m*m)`` (h_min_vertex, measure-based h) per cell ez*m + ex of the row,
- output CELL-ROW tiles ``(C, n_patches, m, P+1, Xn, Zn)``: row (ey, j)
  holds the integrals of the test functions of patch node row P*ey + j
  over the cells of cell row ey only.  Node rows shared by two cell rows
  appear in both; the seam compress sums them together with the patch
  seams in a fixed order (``utils/segment.py``, deterministic on the
  card), so the sweep itself needs no cross-row reduction.

The sweep is the CUDA kernel ``csrc/patch3d.cu`` for tensors on the card
and :func:`patch3d_sweep_plain` (its plain PyTorch version, the same
arithmetic with dense 1D band matrices) for tensors on the CPU.

Supported: dim 3, any degree, curved cells, BDF/stationary (theta = 1),
cell- or q-wise stabilization, fixed/increment/residual flavors, f32.
The operator uses the general sweep for anything else (f64, the theta
method, iso-Q1 spaces, which have no patch numbering).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ns_gls_tpu_torch.ops.prism import (
    FLAVORS,
    _lead_ul,
    band_1d,
    cell_row_index,
    evaluate_tiles,
    integrate_tiles,
)
from ns_gls_tpu_torch.ops.structured import _delta, _physics
from ns_gls_tpu_torch.utils.segment import ClassGather, class_gather, class_sum


class Patch3DTables(NamedTuple):
    """Device tables for the patch-3D sweep (per-patch layout)."""

    P: int
    NQ: int
    m: int
    S1: torch.Tensor        # (NQ, P+1) 1D values at the Gauss points
    D1: torch.Tensor        # (NQ, P+1) 1D derivatives
    bS: torch.Tensor        # (Lq, Xn) patch band: bS[e*NQ+q, P*e+l] = S1[q, l]
    bD: torch.Tensor        # (Lq, Xn)
    jinv: torch.Tensor      # (n_patches, m, 9, QB)
    jxw: torch.Tensor       # (n_patches, m, QB)
    h: torch.Tensor         # (n_patches, m, 2, m*m)  (h_min_vertex, hq)
    patch_nodes: torch.Tensor   # (n_patches, Yn, Xn, Zn) int64 node ids
    compress: ClassGather   # cell-row tile nodes -> nodes (seam sums)


def build_patch3d_tables(op):
    """Host-side packing; None when the operator/space is unsupported
    (the JAX package's gates: a patch-3D space, theta = 1, f32)."""
    space = op.space
    if not getattr(space, "patch3d", False):
        return None
    if op.theta != 1.0 or op.dtype != torch.float32:
        return None
    dev = op.device
    P = space.degree
    NQ = space.n_q1d
    m = int(space.patch_cells)
    pn3 = np.asarray(space.patch_nodes3, np.int64)     # (n_p, z, y, x)
    n_p = pn3.shape[0]
    pn = np.ascontiguousarray(pn3.transpose(0, 2, 3, 1))  # (n_p, y, x, z)

    S1, D1, _, bS, bD = band_1d(P, NQ, m)

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

    rows = pn[:, cell_row_index(P, m)]                # (n_p, m, P+1, Xn, Zn)
    compress = class_gather(rows.reshape(-1), space.n_nodes, dev)

    def f32(a, shape=None):
        a = np.asarray(a, np.float32)
        return torch.as_tensor(a if shape is None else a.reshape(shape),
                               device=dev)

    QB = m * NQ ** 3 * m
    return Patch3DTables(
        P=P, NQ=NQ, m=m,
        S1=f32(S1), D1=f32(D1), bS=f32(bS), bD=f32(bD),
        jinv=f32(jinv_t, (n_p, m, 9, QB)), jxw=f32(jxw_t, (n_p, m, QB)),
        h=f32(h_t, (n_p, m, 2, m * m)),
        patch_nodes=torch.as_tensor(pn, device=dev),
        compress=compress,
    )


# ---------------------------------------------------------------------------
# the sweep: plain version and kernel
# ---------------------------------------------------------------------------
def patch3d_sweep_plain(tables: Patch3DTables, sc: dict, uP, ulP, voP,
                        flavor: str, consider_dt: bool, cell_wise: bool):
    """Plain PyTorch version of the patch-3D sweep (the CUDA kernel's
    reference).  ``sc``: weight, stau, nu, c1, c2 (floats, used in f32).
    uP (4, n_p, Yn, Xn, Zn), ulP (4 or 3, ...), voP (3, ...) -> cell-row
    tiles (4, n_p, m, P+1, Xn, Zn)."""
    d, C = 3, 4
    dev = uP.device
    sc = {k: torch.tensor(v, dtype=torch.float32, device=dev)
          for k, v in sc.items()}
    bS, bD = tables.bS, tables.bD
    NQ, m = tables.NQ, tables.m
    n_p = uP.shape[1]
    Lq = NQ * m
    need_lin_grads = flavor == "increment"
    need_dt_old = consider_dt and flavor in ("increment", "residual")

    def fwd(t, grads):
        # (n_p, Yn, Xn, Zn) -> (n_p, Lq_y, Lq_x, Lq_z); z has x's band
        return evaluate_tiles(t, bS, bD, bS, bD, grads)

    u = [fwd(uP[c], True) for c in range(C)]
    ul = [fwd(ulP[c], need_lin_grads) for c in range(_lead_ul(flavor))]
    dt_old = ([fwd(voP[c], False)[0] for c in range(d)]
              if need_dt_old else None)

    ustar = [ul[a][0] for a in range(d)]
    usq = ustar[0] * ustar[0] + ustar[1] * ustar[1] + ustar[2] * ustar[2]

    def per_q(t):
        # (n_p, ey, m*m) per cell (ez, ex) -> (n_p, Lq_y, Lq_x, Lq_z)
        t = t.reshape(n_p, m, m, m).permute(0, 1, 3, 2)   # (p, ey, ex, ez)
        for dim in (1, 2, 3):
            t = t.repeat_interleave(NQ, dim)
        return t

    h1 = per_q(tables.h[:, :, 0])
    hq = per_q(tables.h[:, :, 1])
    if cell_wise:
        msq = usq.reshape(n_p, m, NQ, m, NQ, m, NQ).amax(dim=(2, 4, 6))
        for dim in (1, 2, 3):
            msq = msq.repeat_interleave(NQ, dim)
        d1_q, d2_q = _delta(sc, h1, hq, msq, None, True)
    else:
        d1_q, d2_q = _delta(sc, h1, hq, None, usq, False)

    # geometry (n_p, ey, e, ez, qz, qy, ex, qx) -> e, (n_p, Lq_y, Lq_x, Lq_z)
    ji = (tables.jinv.reshape(n_p, m, 9, m, NQ, NQ, m, NQ)
          .permute(2, 0, 1, 5, 6, 7, 3, 4).reshape(9, n_p, Lq, Lq, Lq))
    jxw = (tables.jxw.reshape(n_p, m, m, NQ, NQ, m, NQ)
           .permute(0, 1, 4, 5, 6, 2, 3).reshape(n_p, Lq, Lq, Lq))

    def to_phys(rx, ry, rz):
        return [rx * ji[x] + ry * ji[3 + x] + rz * ji[6 + x]
                for x in range(3)]

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

    out = []
    for c in range(C):
        g0, g1, g2 = grad_res[c]
        # value weights, then the reference x, y, z gradient weights
        gx, gy, gz = ((g0 * ji[3 * r] + g1 * ji[3 * r + 1]
                       + g2 * ji[3 * r + 2]) * jxw for r in range(3))
        out.append(integrate_tiles(val_res[c] * jxw, gx, gy, gz, bS, bD,
                                   bS, bD, tables.S1, tables.D1, m))
    return torch.stack(out)


class Patch3DKernel:
    """ctypes binding of ``csrc/patch3d.cu``; the library is built at
    first use (``utils/cuda_build.py``)."""

    # launches of the CUDA kernel in this process: one per successful
    # ``launch``, nowhere else
    launches = 0
    _fn = None

    @classmethod
    def _load(cls):
        if cls._fn is None:
            from ns_gls_tpu_torch.utils.cuda_build import load_library

            lib = load_library("patch3d")
            fn = lib.patch3d_sweep_launch
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            fn.argtypes = [vp] * 9 + [ci] * 7 + [cf] * 5 + [vp]
            fn.restype = ci
            cls._fn = fn
        return cls._fn

    @classmethod
    def launch(cls, tables: Patch3DTables, sc: dict, uP, ulP, voP,
               flavor: str, consider_dt: bool, cell_wise: bool):
        n_p = tables.jinv.shape[0]
        P, NQ, m = tables.P, tables.NQ, tables.m
        Xn = P * m + 1
        C = 4
        lead_ul = _lead_ul(flavor)
        for name, t, lead in (("u", uP, C), ("u_lin", ulP, lead_ul),
                              ("vec_old", voP, 3)):
            if not t.is_cuda or t.dtype != torch.float32:
                raise TypeError(f"{name}: need a float32 CUDA tensor")
            if tuple(t.shape) != (lead, n_p, Xn, Xn, Xn):
                raise ValueError(
                    f"{name}: shape {tuple(t.shape)}, need "
                    f"({lead}, {n_p}, {Xn}, {Xn}, {Xn})"
                )
            if not t.is_contiguous():
                raise ValueError(f"{name}: need a contiguous tensor")
        for t in (tables.jinv, tables.jxw, tables.h, tables.S1, tables.D1):
            if t.device != uP.device or not t.is_contiguous():
                raise ValueError("tables must be contiguous on u's device")
        out = torch.empty((C, n_p, m, P + 1, Xn, Xn), dtype=torch.float32,
                          device=uP.device)
        fn = cls._load()
        err = fn(
            uP.data_ptr(), ulP.data_ptr(), voP.data_ptr(),
            tables.jinv.data_ptr(), tables.jxw.data_ptr(),
            tables.h.data_ptr(), tables.S1.data_ptr(), tables.D1.data_ptr(),
            out.data_ptr(),
            n_p, P, NQ, m, FLAVORS.index(flavor), int(consider_dt),
            int(cell_wise),
            sc["weight"], sc["stau"], sc["nu"], sc["c1"], sc["c2"],
            torch.cuda.current_stream(uP.device).cuda_stream,
        )
        if err != 0:
            hint = (" (the slab's shared-memory tiles exceed the card's "
                    "per-block limit)" if err == 1 else "")
            raise RuntimeError(
                f"patch-3D kernel launch failed: CUDA error {err}{hint}"
            )
        cls.launches += 1
        return out


def patch3d_sweep(tables: Patch3DTables, sc: dict, uP, ulP, voP,
                  flavor: str, consider_dt: bool, cell_wise: bool):
    """The patch-3D sweep: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU."""
    if uP.is_cuda:
        return Patch3DKernel.launch(tables, sc, uP, ulP, voP, flavor,
                                    consider_dt, cell_wise)
    if uP.device.type != "cpu":
        raise TypeError(f"patch-3D sweep: unsupported device {uP.device}")
    return patch3d_sweep_plain(tables, sc, uP, ulP, voP, flavor, consider_dt,
                               cell_wise)


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------
class Patch3DSweep:
    """Applies the fused patch-3D sweep for one operator, with the
    interface of ``ops/prism.py`` ``PrismSweep``: ``gather_nodes(v,
    lead)`` maps the first ``lead`` components of a node-major vector
    (n_nodes, C) to the patch tiles, and ``apply(...)`` runs the sweep and
    seam-compresses the cell-row tiles back to (n_nodes, C)."""

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
        return (lead,) + tuple(self.tables.patch_nodes.shape)

    def gather_nodes(self, v, lead: int):
        """(n_nodes, C) -> (lead, n_patches, Yn, Xn, Zn)."""
        return v[:, :lead].T[:, self.tables.patch_nodes]

    def compress(self, rows):
        """Cell-row tiles (C, n_p, m, P+1, Xn, Zn) -> (C, n_nodes)."""
        return class_sum(self.tables.compress,
                         rows.reshape(rows.shape[0], -1), dim=1)

    def apply(self, weight: float, stau: float, uP, ulP, voP, flavor: str):
        """uP/ulP/voP: (lead, n_patches, Yn, Xn, Zn) patch tiles (from
        ``gather_nodes``).  Returns (n_nodes, C)."""
        sc = dict(weight=weight, stau=stau, nu=self.nu, c1=self.c1,
                  c2=self.c2)
        if flavor != "increment":
            ulP = ulP[: self.d]
        rows = patch3d_sweep(self.tables, sc, uP.contiguous(),
                             ulP.contiguous(), voP.contiguous(), flavor,
                             self.consider_dt, self.cell_wise)
        return self.compress(rows).T
